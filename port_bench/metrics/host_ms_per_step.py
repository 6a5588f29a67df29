"""The host's own time in a step: the harness's span around each ``run(1)``
less the time the trace shows the host thread blocked in calls that wait
for the device (stream syncs, device-to-host copies), mean over the
traced steps. It is read under the profiler, whose own cost a call is in
it: compare it only with readings taken the same way."""

UNIT, LAYER, SOURCE, MOVES = "ms", "trainer loop", "device_trace", "train_rays_per_s"


def read(ctx):
    own = ctx.trace.host_self_us()
    return sum(own) / len(own) / 1e3 if own else None

"""Host time a step inside the program's ``batch`` span: the stage's
batch drawn and put on the device and its draws made (``NeusTrainer.run``,
``Stage2RunnerBase.run``); nothing where the program has no such span. Read
under the profiler, as ``host_ms_per_step`` is."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "ms", "trainer loop", "device_trace", "train_rays_per_s"


def read(ctx):
    if not spans.spans(ctx.trace, "batch"):
        return None
    return spans.host_us(ctx.trace, "batch") / len(ctx.trace.steps) / 1e3

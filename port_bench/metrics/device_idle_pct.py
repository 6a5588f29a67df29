"""The share of the traced window in which no device event (kernel, copy,
set) runs, over the union of their intervals."""

UNIT, LAYER, SOURCE, MOVES = "%", "device", "device_trace", "train_rays_per_s"


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us())

"""Device time a step of the grid tracer's kernels (``layers/tracer/``);
nothing where a step launches none."""

UNIT, LAYER, SOURCE, MOVES = "ms", "tracer", "device_trace", "train_rays_per_s"


def read(ctx):
    us = ctx.trace.device_us(ctx.kernels("tracer"))
    return us / len(ctx.trace.steps) / 1e3 if us > 0 else None

"""Device idle time a step in the gaps whose middle lies inside the
program's ``forward`` span (the loss call of a step, its render included):
the host issuing the forward slower than the device runs it, or waiting
inside it; nothing where the program has no such span."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "ms", "stage forward", "device_trace", "train_rays_per_s"


def read(ctx):
    if not spans.spans(ctx.trace, "forward"):
        return None
    return spans.idle_us(ctx.trace, "forward") / len(ctx.trace.steps) / 1e3

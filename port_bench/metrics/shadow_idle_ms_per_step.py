"""Device idle time a step in the gaps whose middle lies inside the
program's ``cesr.shadow_net`` span (``stages/cesr.py:cesr_sg_render``):
the host issuing the shadow net's forward slower than the device runs it;
nothing where the program has no such span."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "ms", "CESR shadow net", "device_trace", "train_rays_per_s"


def read(ctx):
    if not spans.spans(ctx.trace, "cesr.shadow_net"):
        return None
    return spans.idle_us(ctx.trace, "cesr.shadow_net") / len(ctx.trace.steps) / 1e3

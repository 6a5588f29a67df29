"""Device idle time a step in the gaps whose middle lies inside the
program's ``hash.encode`` span (``robir_tpu_torch/fields/hashgrid.py:
hashgrid_encode``, around its level loop): the host issuing the encoding
slower than the device runs it; nothing where the program has no such
span."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "ms", "hash encoding", "device_trace", "train_rays_per_s"


def read(ctx):
    if not spans.spans(ctx.trace, "hash.encode"):
        return None
    return spans.idle_us(ctx.trace, "hash.encode") / len(ctx.trace.steps) / 1e3

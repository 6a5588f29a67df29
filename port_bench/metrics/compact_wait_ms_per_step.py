"""Host time a step inside the program's ``compact.wait`` span: compaction
finding the needed rows (``core/compact.py:compact_apply``), which waits
for the device; nothing where the program has no such span."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "ms", "compaction", "device_trace", "train_rays_per_s"


def read(ctx):
    if not spans.spans(ctx.trace, "compact.wait"):
        return None
    return spans.host_us(ctx.trace, "compact.wait") / len(ctx.trace.steps) / 1e3

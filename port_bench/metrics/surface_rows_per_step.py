"""Rows a step that compaction shades: the program's ``compact.rows``
counts (``core/compact.py:compact_apply``, one after each ``compact.wait``
span) of the traced window, over its steps; nothing where the program
keeps no such counter."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "rows", "compaction", "device_trace", "train_rays_per_s"


def read(ctx):
    from robir_tpu_torch.tools import profiler

    log = getattr(profiler, "count_log", None)
    if log is None:
        return None
    rows = spans.rows_in_window(ctx.trace, [n for _, n in log("compact.rows")])
    return None if rows is None else rows / len(ctx.trace.steps)

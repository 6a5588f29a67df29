"""Points a step that the hash encoding encodes: the program's
``hash.points`` counts (``robir_tpu_torch/fields/hashgrid.py:
hashgrid_encode``, one just after each ``hash.encode`` span) of the traced
window, over its steps; nothing where the program keeps no such counter.
Each count goes with the span before it: the log and the trace end
together, so they are paired from the end."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "rows", "hash encoding", "program_counter", "train_rays_per_s"


def read(ctx):
    from robir_tpu_torch.tools import profiler

    opened = spans.spans(ctx.trace, "hash.encode")
    counts = [n for _, n in profiler.count_log("hash.points")]
    k = min(len(opened), len(counts))
    if not k:
        return None
    lo, hi = ctx.trace.window
    points = sum(n for (s, e), n in zip(opened[len(opened) - k:], counts[len(counts) - k:])
                 if s >= lo and e <= hi)
    return points / len(ctx.trace.steps)

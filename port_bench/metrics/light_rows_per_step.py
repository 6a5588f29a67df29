"""(Row, light) pairs a step that the CESR shadow net evaluates: the
program's ``cesr.light_rows`` counts (``stages/cesr.py:cesr_sg_render``,
one just after each ``cesr.shadow_net`` span) of the traced window, over
its steps; nothing where the program keeps no such counter. Each count
goes with the span before it: the log and the trace end together, so they
are paired from the end."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "rows", "CESR shadow net", "program_counter", "train_rays_per_s"


def read(ctx):
    from robir_tpu_torch.tools import profiler

    log = getattr(profiler, "count_log", None)
    opened = spans.spans(ctx.trace, "cesr.shadow_net")
    counts = [n for _, n in log("cesr.light_rows")] if log is not None else []
    k = min(len(opened), len(counts))
    if not k:
        return None
    lo, hi = ctx.trace.window
    pairs = sum(n for (s, e), n in zip(opened[len(opened) - k:], counts[len(counts) - k:])
                if s >= lo and e <= hi)
    return pairs / len(ctx.trace.steps)

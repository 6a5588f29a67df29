"""The share of the traced window's steps that the program replayed from
the CUDA graphs of its padded PBR or CESR step: its ``stage2.graph`` spans
(``robir_tpu_torch/stages/material_graph.py``, one around each replay)
that open in the window, over the window's steps, x 100; nothing where the
program has no such span."""

from port_bench import spans

UNIT, LAYER, SOURCE, MOVES = "%", "trainer loop", "program_span", "train_rays_per_s"


def read(ctx):
    lo, hi = ctx.trace.window
    opened = [s for s, _ in spans.spans(ctx.trace, "stage2.graph") if lo <= s < hi]
    if not opened:
        return None
    return 100.0 * len(opened) / len(ctx.trace.steps)

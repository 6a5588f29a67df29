"""The whole step's share of the card's peak: the least time of the step's
matrix work at the peak of the precision each part runs in (``flops.py``)
over the mean time a step of the untraced steps that a traced run times
before its trace (the profiler slows the host)."""

from port_bench.flops import least_seconds

UNIT, LAYER, SOURCE, MOVES = "%", "whole step", "host_clock", "train_rays_per_s"


def read(ctx):
    flops = ctx.work.get("flops")
    if not flops or not ctx.step_s:
        return None
    return 100.0 * least_seconds(flops) / ctx.step_s

"""The CESR normal net's share of its fp32 roofline: the least time of the
work the net needs a step (``normal_net_flops``, counted from the cell's
shapes by ``flops_cesr.py``) at 67 TFLOP/s over the device time a step of
K1's and K2's kernels (``layers/normal_net/``), which a CESR step launches
at the normal net alone. Nothing where the stage gives no such count or
no such kernel ran."""

from port_bench.flops import PEAK_FLOPS

UNIT, LAYER, SOURCE, MOVES = "%", "CESR normal net", "device_trace", "train_rays_per_s"


def read(ctx):
    work = ctx.work.get("normal_net_flops")
    us = ctx.trace.device_us(ctx.kernels("normal_net")) / len(ctx.trace.steps)
    if not work or us <= 0:
        return None
    return 100.0 * (work / PEAK_FLOPS["fp32"]) / (us / 1e6)

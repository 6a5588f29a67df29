"""The SDF trunk's share of its fp32 roofline: the least time of the work
the step's trunk needs (counted from the cell's shapes, ``flops.py``: not
what the kernels launch, so that a kernel which stops recomputing reads
as a gain) at 67 TFLOP/s over the device time a step of the trunk
kernels (``layers/trunk/``). Nothing where the stage gives no trunk count
or no trunk kernel ran."""

from port_bench.flops import PEAK_FLOPS

UNIT, LAYER, SOURCE, MOVES = "%", "trunk kernels", "device_trace", "train_rays_per_s"


def read(ctx):
    work = ctx.work.get("trunk_flops")
    us = ctx.trace.device_us(ctx.kernels("trunk")) / len(ctx.trace.steps)
    if not work or us <= 0:
        return None
    return 100.0 * (work / PEAK_FLOPS["fp32"]) / (us / 1e6)

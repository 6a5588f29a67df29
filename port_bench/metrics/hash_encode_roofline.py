"""The hash encoding's share of its bandwidth roofline: the least time of
the bytes the step's encoding needs (``hash_bytes``, counted from the
cell's shapes by ``flops_hash.py``) at 3.35 TB/s over the device time a
step of the encoding's gathers, integer hashing and index backward
(``layers/hash_encoding/``). Nothing where the stage gives no such count
or no such kernel ran."""

from port_bench.flops_hash import PEAK_BYTES_S

UNIT, LAYER, SOURCE, MOVES = "%", "hash encoding", "device_trace", "train_rays_per_s"


def read(ctx):
    work = ctx.work.get("hash_bytes")
    us = ctx.trace.device_us(ctx.kernels("hash_encoding")) / len(ctx.trace.steps)
    if not work or us <= 0:
        return None
    return 100.0 * (work / PEAK_BYTES_S) / (us / 1e6)

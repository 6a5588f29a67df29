"""Device time a step of the scans (``layers/hash_scans/``) in the
hash-grid NeuS: the backward of ``torch.prod`` over the encoding's
trilinear weights, in the gradient pass of d sdf/dx and in the loss's
backward, the encoding's own arithmetic beside its gathers and scatters
(``hash_encode_roofline``). Nothing where the stage gives no
``hash_bytes`` (no hash encoding) or no such kernel ran."""

UNIT, LAYER, SOURCE, MOVES = "ms", "hash encoding", "device_trace", "train_rays_per_s"


def read(ctx):
    if not ctx.work.get("hash_bytes"):
        return None
    us = ctx.trace.device_us(ctx.kernels("hash_scans"))
    if us <= 0:
        return None
    return us / len(ctx.trace.steps) / 1e3

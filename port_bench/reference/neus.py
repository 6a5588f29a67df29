"""Plain PyTorch reference of the stage-1 NeuS train step.

The NeuS renderer of ``neus/models/renderer.py`` (stratified samples, four
rounds of up-sampling at inv_s 64 * 2^i, sigmoid-CDF alpha compositing on
white), the SDF trunk (positional encoding, weight-normalised softplus-100
layers with the 1/sqrt(2) concatenation skip) with its spatial gradient
by autograd, the IDR colour net, the masked MSE + eikonal + silhouette
loss, and Adam on the mip-NeRF log-linear learning rate with its delay.

Precision as the configuration states it: the trunk, the compositing and
Adam in fp32 with TF32 off; the colour net at bf16 storage (each product
of bf16 operands rounded to bf16, its first layer as two products over
[points, PE(direction), normal] and [feature] added in bf16, as the JAX
package's storage path does). ``control=True`` runs every fp32 matrix
product in TF32 instead: the precision one step below the stated one.

The draws are the program's: the ray batch ``rng.integers(0, N, (B,))``
of a numpy generator seeded with the seed, the stratified jitter
``torch.rand((B, 1)) - 0.5`` of a device generator seeded with it.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import scenes
from ..weights import neus_weights


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    feats = [x]
    for f in 2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs):
        xf = x * float(np.float32(f))
        feats += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(feats, -1)


def softplus100(h: torch.Tensor) -> torch.Tensor:
    t = 100.0 * h
    return (torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))) / 100.0


def wn(p: dict, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    v = p[f"{name}.v"]
    return v * (p[f"{name}.g"] / torch.linalg.norm(v, dim=0)), p[f"{name}.b"]


def sdf_trunk(p: dict, sdf: dict, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, d_out]: [sdf, feature]."""
    enc = positional_encoding(x, sdf["multires"])
    h = enc
    n = sdf["n_layers"] + 1
    for i in range(n):
        w, b = wn(p, f"sdf_network.lin{i}")
        if i in sdf["skip_in"]:
            h = torch.cat([h, enc], -1) / math.sqrt(2)
        h = h @ w + b
        if i < n - 1:
            h = softplus100(h)
    return h


def sdf_value_and_grad(p, sdf, x, create_graph=True):
    x = x.detach().requires_grad_(True)
    full = sdf_trunk(p, sdf, x)
    g, = torch.autograd.grad(full[:, 0].sum(), x, create_graph=create_graph)
    return full, g


def color_net(p: dict, color: dict, pts, normals, dirs, feature) -> torch.Tensor:
    bf = torch.bfloat16
    small = torch.cat([pts, positional_encoding(dirs, color["multires_view"]), normals], -1)
    w, b = wn(p, "color_network.lin0")
    k = small.shape[-1]
    h = small.to(bf) @ w[:k].to(bf) + feature.to(bf) @ w[k:].to(bf) + b.to(bf)
    for i in range(1, color["n_layers"] + 1):
        w, b = wn(p, f"color_network.lin{i}")
        h = torch.relu(h).to(bf) @ w.to(bf) + b.to(bf)
    return torch.sigmoid(h.float())


def sample_pdf(bins, weights, n):
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.linspace(0.5 / n, 1 - 0.5 / n, n, device=bins.device).expand(bins.shape[0], n)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(1, below), cdf.gather(1, above)
    bins_b, bins_a = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def transmittance(alpha):
    return torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1 - alpha + 1e-7], -1),
                         -1)[:, :-1]


def up_sample(o, d, z, sdf, n, inv_s, radius):
    pts = o[:, None] + d[:, None] * z[..., None]
    r = torch.linalg.norm(pts, dim=-1)
    inside = (r[:, :-1] < radius) | (r[:, 1:] < radius)
    mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    cos = torch.minimum(torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1), cos)
    cos = torch.clamp(cos, -1e3, 0.0) * inside
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return sample_pdf(z, alpha * transmittance(alpha), n)


def sample_z(p, cfg, o, d, near, far, t_rand):
    render, sdf_cfg = cfg["render"], cfg["model"]["sdf"]
    ns, steps = render["n_samples"], render["up_sample_steps"]
    radius = cfg["model"]["radius"]
    z = near + (far - near) * torch.linspace(0.0, 1.0, ns, device=o.device)[None]
    z = z + t_rand * 2.0 / ns
    with torch.no_grad():
        b = o.shape[0]
        sdf = sdf_trunk(p, sdf_cfg, (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3))
        sdf = sdf[:, 0].reshape(b, -1)
        for i in range(steps):
            new_z = up_sample(o, d, z, sdf, render["n_importance"] // steps, 64 * 2 ** i, radius)
            z, order = torch.sort(torch.cat([z, new_z], -1), dim=-1, stable=True)
            if i + 1 < steps:
                new = sdf_trunk(p, sdf_cfg, (o[:, None] + d[:, None] * new_z[..., None])
                                .reshape(-1, 3))[:, 0].reshape(b, -1)
                sdf = torch.cat([sdf, new], -1).gather(1, order)
    return z


def render(p, cfg, o, d, near, far, t_rand, cos_anneal):
    """rgb [B, 3], acc [B], eikonal error (scalar)."""
    model, ns = cfg["model"], cfg["render"]["n_samples"]
    z = sample_z(p, cfg, o, d, near, far, t_rand)
    b, n = z.shape
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 2.0 / ns)], -1)
    mid = z + dists * 0.5
    pts = (o[:, None] + d[:, None] * mid[..., None]).reshape(-1, 3)
    dirs = d[:, None].expand(b, n, 3).reshape(-1, 3)
    full, grad = sdf_value_and_grad(p, model["sdf"], pts)
    sdf, feature = full[:, :1], full[:, 1:]
    color = color_net(p, model["color"], pts, grad, dirs, feature).reshape(b, n, 3)
    inv_s = torch.clamp(torch.exp(p["deviation_network.variance"] * 10.0), 1e-6, 1e6)
    cos = (dirs * grad).sum(-1, keepdim=True)
    iter_cos = -(torch.relu(-cos * 0.5 + 0.5) * (1.0 - cos_anneal) + torch.relu(-cos) * cos_anneal)
    half = iter_cos * dists.reshape(-1, 1) * 0.5
    prev_cdf, next_cdf = torch.sigmoid((sdf - half) * inv_s), torch.sigmoid((sdf + half) * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(b, n), 0, 1)
    r = torch.linalg.norm(pts, dim=-1).reshape(b, n)
    radius = model["radius"]
    alpha = alpha * (r < radius).float()
    weights = alpha * transmittance(alpha)
    acc = weights.sum(-1)
    rgb = (color * weights[..., None]).sum(1)
    if cfg["render"]["white_bkgd"]:
        rgb = rgb + (1.0 - acc[:, None])
    relax = (r < radius * 1.2).float()
    gnorm = torch.sqrt((grad.reshape(b, n, 3) ** 2).sum(-1) + 1e-12)
    eikonal = (relax * (gnorm - 1.0) ** 2).sum() / (relax.sum() + 1e-5)
    return rgb, acc, eikonal


def loss_fn(rgb, acc, eikonal, pixels, mask, train: dict) -> torch.Tensor:
    mse = (mask * (rgb - pixels) ** 2).sum() / (mask.sum() + 1e-5)
    silhouette = ((acc - mask[:, 0]) ** 2).sum() / mask.shape[0]
    return mse + eikonal * train["eikonal_weight"] + silhouette * train["silhouette_weight"]


def learning_rate(train: dict, step: int) -> float:
    """The mip-NeRF log-linear decay with its reverse-cosine delay, in
    float32."""
    f = np.float32
    s = f(step)
    delay = f(train["lr_delay_mult"]) + f(1 - train["lr_delay_mult"]) * np.sin(
        f(0.5 * np.pi) * np.clip(s / f(train["lr_delay_steps"]), f(0), f(1)))
    t = np.clip(s / f(train["max_steps"]), f(0), f(1))
    lr = np.exp(f(np.log(train["lr_init"])) * (f(1) - t) + f(np.log(train["lr_final"])) * t)
    return float(f(delay * lr))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def adam(params: dict, grads: dict, m: dict, v: dict, lr: float, t: int) -> None:
    """Adam's update t (from 1) in place, betas (0.9, 0.999), eps 1e-8."""
    with torch.no_grad():
        for k, g in grads.items():
            m[k].mul_(0.9).add_(g, alpha=0.1)
            v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = v[k].sqrt() / math.sqrt(1 - 0.999 ** t) + 1e-8
            params[k].addcdiv_(m[k], denom, value=-lr / (1 - 0.9 ** t))


def train(config: dict, traffic: dict, scene, seed: int, n_steps: int, device,
          variant: str | None = None) -> dict:
    """``n_steps`` train steps from the seeded weights: ``losses`` (floats),
    ``first_grads`` (the first step's gradients by leaf), ``initial`` and
    ``params`` (the weights before and after). ``variant``: ``"control"``
    runs the fp32 products in TF32; ``"half_batch"`` plants a fault, the
    second half of each batch left out and the means taken over the rest."""
    cfg = {**config, "train": {**config["train"], "batch_size": traffic["batch"]}}
    batch = traffic["batch"]
    d = config["dataset"]
    pool = {k: torch.as_tensor(v, device=device)
            for k, v in scenes.rays(scene, d["near"], d["far"]).items()}
    initial = neus_weights(config["model"], seed, device)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in initial.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    tr = cfg["train"]
    losses, first = [], None
    with matmul_precision(variant == "control"):
        for step in range(n_steps):
            idx = torch.as_tensor(rng.integers(0, pool["origins"].shape[0], (batch,)),
                                  device=device)
            t_rand = torch.rand((batch, 1), generator=gen, device=device) - 0.5
            keep = batch // 2 if variant == "half_batch" else batch
            r = {k: v[idx[:keep]] for k, v in pool.items()}
            t_rand = t_rand[:keep]
            anneal = float(min(np.float32(1.0), np.float32(step) / np.float32(tr["anneal_end"])))
            rgb, acc, eik = render(p, cfg, r["origins"], r["directions"], r["near"], r["far"],
                                   t_rand, anneal)
            loss = loss_fn(rgb, acc, eik, r["pixels"], r["mask"], tr)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam(p, grads, m, v2, learning_rate(tr, step), step + 1)
    return {"losses": losses, "first_grads": first, "initial": initial,
            "params": {k: v.detach() for k, v in p.items()}}

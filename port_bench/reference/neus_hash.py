"""Plain PyTorch reference of the hash-grid NeuS's stage-1 train step.

The field is instant-NGP's multiresolution hash encoding (Müller et al.,
"Instant Neural Graphics Primitives", SIGGRAPH 2022, section 3) under a
ReLU head: L levels, level l a grid of N_l = floor(N_min * b^l) nodes a
side over the box; a point's cell corners at that level are hashed as
(x * 1) xor (y * 2654435761) xor (z * 805459861), each product taken
modulo 2^32, then modulo the table's T entries; the point's F features at
the level are the corners' entries weighted trilinearly; the L levels'
features, concatenated, go through ``depth`` ReLU layers of ``width`` to
[sdf, feature]. Written from that description, not from the program.

Departures from the paper, which the program makes too:
- every level is hashed, the coarse ones too, where instant-NGP indexes a
  level 1:1 while its nodes fit the table;
- the corners of a level sit at u * (N_l - 1) for u in [0, 1] over the box
  (the paper scales by N_l and offsets by a half);
- a point outside the box is clamped to it, so its encoding is the box
  face's and its spatial gradient along a clamped axis is zero.

d sdf/dx is computed analytically, not by autograd: at each level
sum over corners c of table[h_c] (x) dw_c/dx, where
dw_c/dx_i = +-(N_l - 1) / (hi_i - lo_i) * prod_{j != i} w_{c,j} (+ at the
corner's upper side of axis i), zero where u_i is clamped; then through
the head's ReLU masks from the sdf column back to the encoding. So the
eikonal term's second-order backward runs through a graph the program
never builds (it takes the gradient from ``autograd.grad(create_graph=
True)`` through its gathers).

The sampler, the compositing, the colour net, the loss, the learning rate
and Adam are ``reference/neus.py``'s, with this field in the trunk's
place. Precision as the configuration states it: tables, encoding and
head in fp32 with TF32 off, the colour net at bf16 storage;
``variant="control"`` runs the fp32 matrix products (the head's) in TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import scenes
from ..weights import _weight_norm, color_layers
from .neus import (adam, color_net, learning_rate, loss_fn, matmul_precision, transmittance,
                   up_sample)

PRIMES = (1, 2654435761, 805459861)
# instant-nsr-pl's sphere_init_radius, and the benchmark scene's sphere
SPHERE_RADIUS = 0.5
# above the largest -(|p| - SPHERE_RADIUS) over the box
SPHERE_LIFT = 2.0


def resolution(grid: dict, level: int) -> int:
    return int(np.floor(grid["base_resolution"] * grid["per_level_scale"] ** level))


def head_dims(hash_sdf: dict) -> list[int]:
    """The head's widths: L x F features in, ``depth`` x ``width``, ``d_out``."""
    grid = hash_sdf["grid"]
    return ([grid["n_levels"] * grid["n_features"]] + [hash_sdf["width"]] * hash_sdf["depth"]
            + [hash_sdf["d_out"]])


def sphere_rows(grid: dict, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """The coarsest level's table rows and the sdf of a sphere of
    ``radius`` at the origin, |p| - radius, at the level's nodes p: one
    value a row, the lowest-numbered node's where nodes share a row."""
    n = resolution(grid, 0)
    ax = np.arange(n)
    ijk = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    lo, hi = np.asarray(grid["bbox_min"], float), np.asarray(grid["bbox_max"], float)
    p = lo + ijk / (n - 1) * (hi - lo)
    rows = corner_hash(ijk, 1 << grid["log2_hashmap_size"])
    rows, first = np.unique(rows, return_index=True)
    return rows, (np.linalg.norm(p, axis=-1) - radius)[first]


def weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The hash NeuS tree by the program's parameter paths, fp32 on
    ``device``, from a sphere init: the tables ~ U(-1e-4, 1e-4)
    (instant-NGP's init), but the coarsest level's first feature holds
    the sdf of a sphere of radius ``SPHERE_RADIUS`` at its nodes
    (``sphere_rows``); the head and the weight-normed colour net at
    ``torch.nn.Linear``'s init, but the head's unit 0 passes that
    feature f to the sdf as relu(f + SPHERE_LIFT) - SPHERE_LIFT and sees
    nothing else; the variance. So the field starts as a sphere, as instant-nsr-pl's
    ``sphere_init`` and NeuS's geometric init start it, where the plain
    init leaves it flat to ~1e-5 and the up-sampler's draws then turn on
    fp32 rounding."""
    hs, grid = model["hash_sdf"], model["hash_sdf"]["grid"]
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (grid["n_levels"], 1 << grid["log2_hashmap_size"], grid["n_features"])
    tables = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * 1e-4
    rows, sdf = sphere_rows(grid, SPHERE_RADIUS)
    tables[0, torch.as_tensor(rows, device=device), 0] = torch.as_tensor(
        sdf, dtype=tables.dtype, device=device)
    out = {"sdf_network.hash.tables": tables}
    dims = head_dims(hs)
    layers = [(f"sdf_network.mlp.lin{i}", dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    layers += [(f"color_network.lin{i}", n_in, n_out)
               for i, (n_in, n_out) in enumerate(color_layers(model["color"]))]
    u = torch.rand(sum((i + 1) * o for _, i, o in layers), generator=gen, device=device) * 2 - 1
    off = 0
    for name, n_in, n_out in layers:
        bound = 1.0 / math.sqrt(n_in)
        w = (u[off:off + n_in * n_out] * bound).reshape(n_in, n_out)
        b = u[off + n_in * n_out:off + (n_in + 1) * n_out] * bound
        off += (n_in + 1) * n_out
        out.update(_weight_norm(name, w, b) if name.startswith("color_network.")
                   else {f"{name}.w": w, f"{name}.b": b})
    # the sdf's pass: unit 0 of each hidden layer holds f + SPHERE_LIFT,
    # f the coarsest level's first feature (input 0), positive over the
    # box, so its ReLU never turns; the sdf column takes the lift off
    for i in range(len(dims) - 1):
        w, b = out[f"sdf_network.mlp.lin{i}.w"], out[f"sdf_network.mlp.lin{i}.b"]
        w[:, 0], b[0] = 0.0, SPHERE_LIFT if i == 0 else 0.0
        w[0, 0] = 1.0
    out[f"sdf_network.mlp.lin{len(dims) - 2}.b"][0] = -SPHERE_LIFT
    out["deviation_network.variance"] = torch.tensor(model["variance"]["init_val"],
                                                     device=device)
    return out


def corner_hash(idx: torch.Tensor, table_size: int) -> torch.Tensor:
    """[..., 3] non-negative integer corners -> [...] table rows: the xor
    of the three products, each masked to 32 bits, masked to the table."""
    m = 0xFFFFFFFF
    h = (idx[..., 0] * PRIMES[0]) & m
    h = h ^ ((idx[..., 1] * PRIMES[1]) & m)
    h = h ^ ((idx[..., 2] * PRIMES[2]) & m)
    return h & (table_size - 1)


def encode(tables: torch.Tensor, grid: dict, x: torch.Tensor, with_grad: bool):
    """[N, 3] -> ([N, L x F] features, [N, 3, L x F] their x-derivatives
    or None), every level at once."""
    n_levels, table_size, nf = tables.shape
    lo = torch.tensor(grid["bbox_min"], dtype=x.dtype, device=x.device)
    hi = torch.tensor(grid["bbox_max"], dtype=x.dtype, device=x.device)
    v = (x - lo) / (hi - lo)
    u = v.clamp(0.0, 1.0)
    scale = torch.tensor([resolution(grid, lv) - 1 for lv in range(n_levels)],
                         dtype=x.dtype, device=x.device)                     # [L]
    g = u[:, None, :] * scale[None, :, None]                                 # [N, L, 3]
    base = torch.floor(g)
    t = g - base
    bits = torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                        device=x.device)                                     # [8, 3]
    idx = base.long()[:, :, None, :] + bits                                  # [N, L, 8, 3]
    rows = corner_hash(idx, table_size) + table_size * torch.arange(
        n_levels, device=x.device)[:, None]                                  # [N, L, 8]
    vals = tables.reshape(-1, nf)[rows]                                      # [N, L, 8, F]
    up = bits.bool()
    # a_{c,j}: t_j on the corner's upper side of axis j, 1 - t_j on its lower
    a = torch.where(up, t[:, :, None, :], 1.0 - t[:, :, None, :])            # [N, L, 8, 3]
    w = a[..., 0] * a[..., 1] * a[..., 2]
    feats = (vals * w[..., None]).sum(2).reshape(x.shape[0], n_levels * nf)
    if not with_grad:
        return feats, None
    # dw_c/dx_i = +-(N_l - 1) / (hi_i - lo_i) * prod_{j != i} a_{c,j}, 0 where clamped
    others = torch.stack([a[..., 1] * a[..., 2], a[..., 0] * a[..., 2], a[..., 0] * a[..., 1]],
                         -1)
    sign = torch.where(up, 1.0, -1.0)
    inside = ((v >= 0.0) & (v <= 1.0)).to(x.dtype)
    dudx = (inside / (hi - lo))[:, None, None, :] * scale[None, :, None, None]  # [N, L, 1, 3]
    dw = sign * others * dudx                                                # [N, L, 8, 3]
    jac = (vals[:, :, :, None, :] * dw[..., None]).sum(2)                    # [N, L, 3, F]
    return feats, jac.permute(0, 2, 1, 3).reshape(x.shape[0], 3, n_levels * nf)


def field(p: dict, hash_sdf: dict, x: torch.Tensor, with_grad: bool = False):
    """[N, 3] -> ([N, d_out] [sdf, feature], [N, 3] d sdf/dx or None)."""
    enc, jac = encode(p["sdf_network.hash.tables"], hash_sdf["grid"], x, with_grad)
    h, masks = enc, []
    n = hash_sdf["depth"] + 1
    for i in range(n):
        h = h @ p[f"sdf_network.mlp.lin{i}.w"] + p[f"sdf_network.mlp.lin{i}.b"]
        if i < n - 1:
            masks.append(h > 0)
            h = torch.relu(h)
    if not with_grad:
        return h, None
    # d sdf / d(encoding): the sdf column back through the ReLU masks
    delta = p[f"sdf_network.mlp.lin{n - 1}.w"][:, 0].expand(x.shape[0], -1)
    for i in range(n - 2, -1, -1):
        delta = (delta * masks[i]) @ p[f"sdf_network.mlp.lin{i}.w"].T
    return h, (jac * delta[:, None, :]).sum(-1)


def sample_z(p, cfg, o, d, near, far, t_rand):
    """``reference/neus.py``'s stratified samples and up-sampling rounds
    over this field."""
    render, hs = cfg["render"], cfg["model"]["hash_sdf"]
    ns, steps = render["n_samples"], render["up_sample_steps"]
    radius = cfg["model"]["radius"]
    z = near + (far - near) * torch.linspace(0.0, 1.0, ns, device=o.device)[None]
    z = z + t_rand * 2.0 / ns
    with torch.no_grad():
        b = o.shape[0]
        sdf = field(p, hs, (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3))[0]
        sdf = sdf[:, 0].reshape(b, -1)
        for i in range(steps):
            new_z = up_sample(o, d, z, sdf, render["n_importance"] // steps, 64 * 2 ** i, radius)
            z, order = torch.sort(torch.cat([z, new_z], -1), dim=-1, stable=True)
            if i + 1 < steps:
                new = field(p, hs, (o[:, None] + d[:, None] * new_z[..., None])
                            .reshape(-1, 3))[0][:, 0].reshape(b, -1)
                sdf = torch.cat([sdf, new], -1).gather(1, order)
    return z


def render(p, cfg, o, d, near, far, t_rand, cos_anneal):
    """rgb [B, 3], acc [B], eikonal error (scalar): ``reference/neus.py``'s
    compositing over this field."""
    model, ns = cfg["model"], cfg["render"]["n_samples"]
    z = sample_z(p, cfg, o, d, near, far, t_rand)
    b, n = z.shape
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 2.0 / ns)], -1)
    mid = z + dists * 0.5
    pts = (o[:, None] + d[:, None] * mid[..., None]).reshape(-1, 3)
    dirs = d[:, None].expand(b, n, 3).reshape(-1, 3)
    full, grad = field(p, model["hash_sdf"], pts, with_grad=True)
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
    weights_ = alpha * transmittance(alpha)
    acc = weights_.sum(-1)
    rgb = (color * weights_[..., None]).sum(1)
    if cfg["render"]["white_bkgd"]:
        rgb = rgb + (1.0 - acc[:, None])
    relax = (r < radius * 1.2).float()
    gnorm = torch.sqrt((grad.reshape(b, n, 3) ** 2).sum(-1) + 1e-12)
    eikonal = (relax * (gnorm - 1.0) ** 2).sum() / (relax.sum() + 1e-5)
    return rgb, acc, eikonal


def train(config: dict, traffic: dict, scene, seed: int, n_steps: int, device,
          variant: str | None = None) -> dict:
    """``reference/neus.py:train`` over this field: ``losses``,
    ``first_grads``, ``initial``, ``params``; ``variant`` ``"control"``
    (the head's products in TF32) or ``"half_batch"`` (the second half of
    each batch left out)."""
    cfg = {**config, "train": {**config["train"], "batch_size": traffic["batch"]}}
    batch = traffic["batch"]
    d = config["dataset"]
    pool = {k: torch.as_tensor(v, device=device)
            for k, v in scenes.rays(scene, d["near"], d["far"]).items()}
    initial = weights(config["model"], seed, device)
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
            anneal = float(min(np.float32(1.0), np.float32(step) / np.float32(tr["anneal_end"])))
            rgb, acc, eik = render(p, cfg, r["origins"], r["directions"], r["near"], r["far"],
                                   t_rand[:keep], anneal)
            loss = loss_fn(rgb, acc, eik, r["pixels"], r["mask"], tr)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam(p, grads, m, v2, learning_rate(tr, step), step + 1)
    return {"losses": losses, "first_grads": first, "initial": initial,
            "params": {k: v.detach() for k, v in p.items()}}

"""Plain PyTorch reference of the PBR train step (RobIR's ``train_pbr.py``).

From the seeded stage-2 tree: the grid baked from the frozen NeuS and
traced for each batch; at the traced pixels the indirect net's SG sets and
integral under the tone map's shift; at the surface rows the material
autoencoders, the direct light (the 128 SG lights, their visibility swept
over 32 samples each through the visibility net, and the specular
visibility over 8) and the indirect light (8 specular samples, the
integral for the diffuse part), tone-mapped; the L1 loss over the batch,
the spec latents' KL sparsity, 0.1 x the latent smoothness and the white
light term; Adam on ``gamma`` and ``envmap_material_network``.

``variant``: ``"control"`` runs every fp32 matrix product in TF32;
``"half_batch"`` plants a fault, the second half of each batch left out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import stage2 as s2
from .neus import adam, matmul_precision, positional_encoding

TRAINABLE = ("gamma.", "envmap_material_network.")


def as_input(p) -> torch.Tensor:
    return torch.clamp(p["gamma.adapt_illum"] * 10 + 0.5, 0, 1).reshape(1, 1)


def loss_fn(p: dict, config: dict, grid: s2.Grid, batch: dict, stream: s2.Stream,
            half: bool = False) -> tuple[torch.Tensor, int]:
    """The step's loss on ``batch`` and its surface rows."""
    model, lcfg = config["model"], config["pbr"]["loss"]
    o, d, obj, rgb = batch["origins"], batch["dirs"], batch["mask"], batch["rgb"]
    if half:
        k = o.shape[0] // 2
        o, d, obj, rgb = o[:k], d[:k], obj[:k], rgb[:k]
    n = o.shape[0]
    t, hit = grid.cast(o, d)
    surf = hit & obj
    t = torch.where(surf, t, 0.0)
    points = o + t[:, None] * d
    h_in = as_input(p).expand(n, 1)
    isgs, iint = s2.indirect(p, model["indirect_illum_network"], points, h_in, stream)
    rows = torch.nonzero(surf).squeeze(1)
    k = rows.numel()
    # no surface row: the program shades row 0 and drops it (draws of one row)
    shaded = rows if k else rows.new_zeros(1)
    x, vd = points[shaded], -d[shaded]
    vd = vd / (torch.linalg.norm(vd, dim=-1, keepdim=True) + s2.TINY)
    env = model["envmap_material_network"]
    mat = s2.material(p, env, x, stream)
    shade_n = mat["normal_map"].detach()
    vis = model["visibility_network"]
    spec = torch.abs(mat["specular_reflectance"])
    direct = s2.sg_shade(p, vis, stream, x.detach(), shade_n, vd, mat["lgt_sgs"], spec,
                               mat["roughness"], mat["diffuse_albedo"], comp_vis=True)
    indir = s2.sg_shade(p, vis, stream, x.detach(), shade_n, vd, isgs[shaded], spec,
                              mat["roughness"], mat["diffuse_albedo"], comp_vis=False,
                              indir_integral=iint[shaded] * 2 * np.pi)

    def full(v):
        return torch.ones((n, v.shape[1]), device=v.device).index_copy(0, rows, v[:k])

    pred = s2.hdr2ldr(full(direct) + full(indir), s2.shift(p).reshape(1, 1))
    rgb_loss = torch.sum(torch.abs(pred - rgb) * surf[:, None]) / n
    latent = s2.chain(p, "envmap_material_network.spec_brdf_encoder_layer.encoder",
                      positional_encoding(points, env["multires"]), 5, s2.leaky)
    w = surf.to(latent.dtype)[:, None]
    rho_hat = torch.sum(torch.sigmoid(latent) * w, 0) / torch.clamp(w.sum(), min=1.0)
    rho = 0.05
    kl = torch.mean(rho * torch.log(rho / (rho_hat + 1e-4))
                    + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat + 1e-4)))
    smooth = (torch.sum(torch.abs(full(mat["diffuse_albedo"]) - full(mat["xi_diffuse_albedo"])))
              / (n * 3)
              + torch.sum(torch.abs(full(mat["roughness"]) - full(mat["xi_roughness"]))) / n
              * 0.2)
    lgt = torch.abs(p["envmap_material_network.lgtSGs"][:, -3:])
    white = torch.var(lgt / (torch.linalg.norm(lgt, dim=-1, keepdim=True) + 1e-4), dim=-1,
                      correction=1).mean() * 0.01
    total = (lcfg["sg_rgb_weight"] * rgb_loss + kl * lcfg["kl_weight"]
             + smooth * lcfg["latent_smooth_weight"] * 0.1 + white)
    return total, k


def batches(config: dict, traffic: dict, scene, seed: int, device, n_steps: int):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        b = s2.pixel_batch(rng, scene, traffic["batch"], config["dataset"]["pose_scale"])
        yield {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def train(config: dict, traffic: dict, scene, seed: int, n_steps: int, device,
          variant: str | None = None) -> dict:
    """``n_steps`` PBR steps: ``losses``, ``first_grads`` and ``params`` of
    the trainable leaves, ``initial`` (their values before), ``rows`` (the
    surface rows a step)."""
    weights, grid = s2.setup(config, traffic, seed, device)
    p = {k: v.clone() for k, v in weights.items()}
    names = [k for k in p if k.startswith(TRAINABLE)]
    initial = {k: p[k].clone() for k in names}
    for k in names:
        p[k].requires_grad_(True)
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    stream = s2.Stream(seed, device)
    lr = config["pbr"]["opt"]["lr"]
    losses, first, rows = [], None, []
    with matmul_precision(variant == "control"):
        for step, batch in enumerate(batches(config, traffic, scene, seed, device, n_steps)):
            loss, r = loss_fn(p, config, grid, batch, stream, variant == "half_batch")
            grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
            grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, grads)}
            losses.append(float(loss.detach()))
            rows.append(r)
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam(p, grads, m, v, lr, step + 1)
    return {"losses": losses, "first_grads": first, "initial": initial, "rows": rows,
            "params": {k: p[k].detach() for k in names}}


def surface_rows(config: dict, traffic: dict, scene, seed: int, steps, device) -> list[int]:
    """The surface rows of the given steps' batches (the reference's own
    bake and trace), for the step's work."""
    _, grid = s2.setup(config, traffic, seed, device)
    out = []
    for i, b in enumerate(batches(config, traffic, scene, seed, device, max(steps) + 1)):
        if i in steps:
            _, hit = grid.cast(b["origins"], b["dirs"])
            out.append(int((hit & b["mask"]).sum()))
    return out

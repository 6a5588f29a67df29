"""Plain PyTorch reference of the CESR train step (RobIR's ``train_cesr.py``).

From the seeded stage-2 tree (``reference/stage2.py``) and two fresh nets,
the per-light diffuse-visibility ``shadow_net`` and the refined
``normal_net`` (each an SDF-style chain: weight norm, softplus(beta=100),
the input concatenated again at the skip layer and the pair scaled by
1/sqrt(2); ``train_cesr.py:492-504``, ``model/cesr.py``): the grid baked
from the frozen NeuS and traced for each batch (``reference/pbr.py``'s
batches), the indirect net at the traced pixels, and at the surface rows
- the spec-BRDF and normal autoencoders;
- the shadow net on the concatenated [rows x L, PE10(x) (+) one-hot(l)]
  input, unfactorised, as ``train_cesr.py`` evaluates it; its softmax's
  column 1 is each light's visibility;
- the normal net, PE10(x) -> 3, made unit;
- the SG render with ``lin_diff``: the direct lights' diffuse part with the
  shadow net's visibility in place of the sampled one, the specular part
  with its 8-sample visibility sweep, the indirect SGs, their integral
  for the diffuse part; each diffuse part times albedo / pi;
- the supervision: the Bernoulli KL (rate 0.01) of each light's batch-mean
  |swept visibility - shadow net| (the sweep of the frozen visibility net,
  8 samples a light, keeps its graph to the lights outside the warmup),
  times 1 (explore), 0.2 (project) or 0.1 (warmup, the sweep detached
  and shading the diffuse part), plus the masked mean square of the
  (detached) AE normal against the refined one;
- past the warmup, the tone-mapped L1 rgb loss, the spec latents' KL and
  the latent smoothness at the phase's weights.
Adam (optax's defaults) at the configuration's learning rate on
``gamma``, ``envmap_material_network``, ``shadow_net`` and
``normal_net``. The phase and the normal switch follow ``cur_iter``
(the mix's ``start_iter`` plus the step): warmup up to 500, then explore
(the cycle's ``proj_iter`` is 0), the refined normal shading past 1,000.

Departures from ``train_cesr.py``, each the program's as well:
- fp32 matrix products with TF32 off; the visibility net at bf16 storage
  (``configs/hotdog_cesr.json``);
- the geometry normals of the frozen NeuS are not computed: the step's
  loss does not read them;
- the batch's draws are the program's, in its order, from one device
  generator seeded with the seed (``stage2.Stream``): the indirect
  autoencoder's noise at every pixel, then at the shaded rows the two
  material noises, the lights' sweep draws (8 a light), the direct and
  the indirect specular sweeps' (8 a row);
Where the configuration compacts (``cesr.compact_chunk`` below the batch)
the step shades the surface rows alone, as the program's row mode; else
every pixel, its per-row draws at every pixel, misses weighing nothing.

``variant``: ``"control"`` runs every fp32 matrix product in TF32;
``"half_batch"`` plants a fault, the second half of each batch left out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pbr
from . import stage2 as s2
from ..weights import sdf_layers
from .neus import adam, matmul_precision, positional_encoding, sdf_trunk

TRAINABLE = ("gamma.", "envmap_material_network.", "shadow_net.", "normal_net.")
# train_cesr.py's schedule: the warmup's last iteration, the normal switch's
WARMUP_ITERS, NORMAL_SWITCH_ITER = 500, 1000
SPEC_NSAMP, LIGHT_NSAMP = 8, 8


def net_inputs(config: dict) -> dict[str, tuple[int, int]]:
    """{net: (input width, output width)}: PE10(x) (+) the one-hot light
    label -> 2 logits; PE10(x) -> 3."""
    nets = config["cesr_nets"]
    lights = config["model"]["envmap_material_network"]["num_lgt_sgs"]
    pe = 3 + 6 * nets["pe_multires"]
    return {"shadow_net": (pe + lights, 2), "normal_net": (pe, 3)}


def net_sdf(config: dict, name: str) -> dict:
    """Net ``name`` as an SDF trunk's section whose encoded input is its
    input (``neus.sdf_trunk``, ``weights.sdf_layers``)."""
    d_in, d_out = net_inputs(config)[name]
    return {**config["cesr_nets"][name], "d_in": d_in, "d_out": d_out, "multires": 0}


def cesr_net(p: dict, config: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Net ``name`` of ``p`` (leaves ``<name>.lin<i>.{v,g,b}``) on ``x``."""
    return sdf_trunk({f"sdf_network.{k}": v for k, v in s2.sub(p, name).items()},
                     net_sdf(config, name), x)


def net_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The shadow and normal nets as ``CESRRunner`` makes them, flat by
    path: from a CPU generator seeded ``seed + 77``, the shadow net first,
    each layer's weight drawn in turn (SAL's geometric init without a
    positional encoding inside the net: N(0, 2 / out) weights and zero
    biases, the last layer sqrt(pi / in) + 1e-4 N(0, 1) with bias
    -``bias``), weight norm (``v``, ``g = |v|`` a column, ``b``)."""
    gen = torch.Generator().manual_seed(seed + 77)
    out = {}
    for name in net_inputs(config):
        net = net_sdf(config, name)
        layers = sdf_layers(net)
        for i, (n_in, n_out) in enumerate(layers):
            if i == len(layers) - 1:
                w = float(np.sqrt(np.pi) / np.sqrt(n_in)) + 1e-4 * torch.randn(
                    (n_in, n_out), generator=gen)
                b = torch.full((n_out,), -float(net["bias"]))
            else:
                w = float(np.sqrt(2) / np.sqrt(n_out)) * torch.randn((n_in, n_out), generator=gen)
                b = torch.zeros(n_out)
            out[f"{name}.lin{i}.v"] = w
            out[f"{name}.lin{i}.g"] = torch.linalg.norm(w, dim=0)
            out[f"{name}.lin{i}.b"] = b
    return {k: v.to(device) for k, v in out.items()}


def shadow_visibility(p: dict, config: dict, pe: torch.Tensor, lights: int) -> torch.Tensor:
    """[rows, L] visibility of the shadow net on [rows x L, PE (+) one-hot]."""
    rows = pe.shape[0]
    onehot = torch.eye(lights, device=pe.device)
    x = torch.cat([pe[:, None, :].expand(rows, lights, pe.shape[-1]),
                   onehot[None].expand(rows, lights, lights)], -1).reshape(rows * lights, -1)
    return torch.softmax(cesr_net(p, config, "shadow_net", x), -1)[:, 1].reshape(rows, lights)


def phase(cesr: dict, cur_iter: int) -> str:
    """The prefit phase of iteration ``cur_iter`` (train_cesr.py:546-559)."""
    if cur_iter <= WARMUP_ITERS:
        return "warmup"
    cycle = cesr["explore_iter"] + cesr["proj_iter"]
    if cycle > 0 and cur_iter % cycle >= cesr["proj_iter"]:
        return "explore"
    return "project"


def split_sgs(sgs: torch.Tensor):
    """[..., 7] -> (unit lobes, |lambda|, |mu|)."""
    return (sgs[..., :3] / (torch.linalg.norm(sgs[..., :3], dim=-1, keepdim=True) + s2.TINY),
            torch.abs(sgs[..., 3:4]), torch.abs(sgs[..., -3:]))


def specular(p, vis, stream, points, normal, vd, rough, spec, lobes, lambdas, mus, inv):
    """The specular part of one light set [K, 3]: the BRDF's warped SG, the
    visibility swept over 8 samples around the reflection (its two draws),
    each light's product with it integrated against the cosine."""
    s_t, s_p = stream.uniform(points.shape[0], SPEC_NSAMP), stream.uniform(
        points.shape[0], SPEC_NSAMP)
    w_lobes, w_lambdas, w_mus = s2.specular_sg(normal, vd, rough, spec)
    brdf_vis = s2.specular_visibility(p, vis, points, normal, vd, w_lambdas[:, 0], s_t, s_p,
                                      inv)
    final = s2.lambda_trick(lobes, lambdas, mus * brdf_vis[:, None, None], w_lobes[:, None],
                            w_lambdas[:, None], w_mus[:, None])
    return s2.cos_integral(normal, *final)


def loss_fn(p: dict, config: dict, grid: s2.Grid, batch: dict, stream: s2.Stream,
            cur_iter: int, half: bool = False):
    """The step's loss on ``batch`` and its surface rows."""
    model, cesr, nets = config["model"], config["cesr"], config["cesr_nets"]
    lcfg = cesr["loss"]
    prefit = phase(cesr, cur_iter)
    use_rgb, new_normal = cur_iter > WARMUP_ITERS, cur_iter > NORMAL_SWITCH_ITER
    o, d, obj, rgb = batch["origins"], batch["dirs"], batch["mask"], batch["rgb"]
    if half:
        k = o.shape[0] // 2
        o, d, obj, rgb = o[:k], d[:k], obj[:k], rgb[:k]
    n = o.shape[0]
    t, hit = grid.cast(o, d)
    surf = hit & obj
    t = torch.where(surf, t, 0.0)
    points = o + t[:, None] * d
    isgs, iint = s2.indirect(p, model["indirect_illum_network"], points,
                             pbr.as_input(p).expand(n, 1), stream)
    rows = torch.nonzero(surf).squeeze(1)
    k = rows.numel()
    chunk = cesr["compact_chunk"]
    if 0 < chunk < n:
        # row mode; no surface row: the program shades row 0 and drops it
        shaded = rows if k else rows.new_zeros(1)
    else:
        shaded = torch.arange(n, device=o.device)
    live = surf[shaded].to(torch.float32)
    x, vd = points[shaded], -d[shaded]
    vd = vd / (torch.linalg.norm(vd, dim=-1, keepdim=True) + s2.TINY)
    env, vis = model["envmap_material_network"], model["visibility_network"]
    mat = s2.material(p, env, x, stream)
    normal_map = mat["normal_map"].detach()
    pe = positional_encoding(x.detach(), nets["pe_multires"])
    lights = env["num_lgt_sgs"]
    shadow_vis = shadow_visibility(p, config, pe, lights)
    normal_new = s2.unit(cesr_net(p, config, "normal_net", pe))
    shade_n = normal_new if new_normal else normal_map

    lobes, lambdas, mus = split_sgs(p["envmap_material_network.lgtSGs"])
    u_t, u_p = stream.uniform(lights, LIGHT_NSAMP), stream.uniform(lights, LIGHT_NSAMP)
    with torch.set_grad_enabled(use_rgb or prefit != "warmup"):
        swept = s2.diffuse_visibility(p, vis, x.detach(), shade_n.detach(), lobes,
                                      lambdas[:, 0], u_t, u_p).t()
    if prefit == "warmup":
        sup, light_vis, factor = torch.abs(swept.detach() - shadow_vis), swept, 0.1
    else:
        sup, light_vis = torch.abs(swept - shadow_vis), shadow_vis
        factor = 0.2 if prefit == "project" else 1.0
    rows_n = x.shape[0]
    spec = torch.abs(p["envmap_material_network.specular_reflectance"]).reshape(1, -1).expand(
        rows_n, 3)
    albedo = mat["diffuse_albedo"] / np.pi
    direct = [v[None].expand((rows_n,) + v.shape) for v in (lobes, lambdas, mus)]
    diffuse = s2.cos_integral(shade_n, direct[0], direct[1], direct[2] * light_vis[..., None])
    sg_rgb = diffuse * albedo + specular(p, vis, stream, x.detach(), shade_n, vd,
                                         mat["roughness"], spec, *direct, inv=False)
    indir = split_sgs(isgs[shaded])
    indir_rgb = (iint[shaded] * 2 * np.pi) * albedo + specular(
        p, vis, stream, x.detach(), shade_n, vd, mat["roughness"], spec, *indir, inv=True)

    w = live[:, None]
    rate = torch.sum(sup * w, 0) / torch.clamp(torch.sum(w), min=1.0)
    rho = 0.01
    sv = torch.mean(rho * torch.log(rho / (rate + 1e-4))
                    + (1 - rho) * torch.log((1 - rho) / (1 - rate + 1e-4))) * factor
    sv = sv + torch.sum(w * (normal_map - normal_new) ** 2) / torch.clamp(
        torch.sum(w) * 3, min=1.0)
    total = sv
    if use_rgb:
        def full(v):
            out = torch.ones((n, v.shape[1]), device=v.device)
            return out.index_put((shaded,), torch.where(live[:, None] > 0, v, 1.0))

        pred = s2.hdr2ldr(full(sg_rgb) + full(indir_rgb), s2.shift(p).reshape(1, 1))
        rgb_loss = torch.sum(torch.abs(pred - rgb) * surf[:, None]) / n
        smooth_w, kl_w = ((cesr["proj_smooth"], cesr["proj_kl"]) if prefit == "project"
                          else (cesr["explore_smooth"], cesr["explore_kl"]))
        latent = s2.chain(p, "envmap_material_network.spec_brdf_encoder_layer.encoder",
                          positional_encoding(points, env["multires"]), 5, s2.leaky)
        ws = surf.to(latent.dtype)[:, None]
        rho_hat = torch.sum(torch.sigmoid(latent) * ws, 0) / torch.clamp(ws.sum(), min=1.0)
        rho = 0.05
        kl = torch.mean(rho * torch.log(rho / (rho_hat + 1e-4))
                        + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat + 1e-4))
                        ) * lcfg["kl_weight"] * kl_w
        smooth = ((torch.sum(torch.abs(full(mat["diffuse_albedo"])
                                       - full(mat["xi_diffuse_albedo"]))) / (n * 3)
                   + torch.sum(torch.abs(full(mat["roughness"]) - full(mat["xi_roughness"]))) / n
                   * 0.2) * lcfg["latent_smooth_weight"] * smooth_w)
        total = total + lcfg["sg_rgb_weight"] * rgb_loss + kl + smooth
    return total, k


def train(config: dict, traffic: dict, scene, seed: int, n_steps: int, device,
          variant: str | None = None) -> dict:
    """``n_steps`` CESR steps from iteration ``traffic["start_iter"]``:
    ``losses``, ``first_grads`` and ``params`` of the trainable leaves,
    ``initial`` (their values before), ``rows`` (the surface rows a
    step)."""
    weights, grid = s2.setup(config, traffic, seed, device)
    weights.update(net_weights(config, seed, device))
    p = {k: v.clone() for k, v in weights.items()}
    names = [k for k in p if k.startswith(TRAINABLE)]
    initial = {k: p[k].clone() for k in names}
    for k in names:
        p[k].requires_grad_(True)
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    stream = s2.Stream(seed, device)
    lr = config["cesr"]["opt"]["lr"]
    start = traffic.get("start_iter", 0)
    losses, first, rows = [], None, []
    with matmul_precision(variant == "control"):
        for step, batch in enumerate(pbr.batches(config, traffic, scene, seed, device,
                                                 n_steps)):
            loss, r = loss_fn(p, config, grid, batch, stream, start + step,
                              variant == "half_batch")
            gs = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
            grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, gs)}
            losses.append(float(loss.detach()))
            rows.append(r)
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam(p, grads, m, v, lr, step + 1)
    return {"losses": losses, "first_grads": first, "initial": initial, "rows": rows,
            "params": {k: p[k].detach() for k in names}}

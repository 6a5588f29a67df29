"""Plain PyTorch reference of what the stage-2 steps share.

Frozen copies of RobIR's stage-2 arithmetic as the configuration states
it: the camera rays of a pixel batch, the cached-SDF grid baked from the
frozen NeuS (the trunk in fp32, stored in bf16) and sphere-traced through
it (march, bisection, one Newton step), the encodings, the sparse
autoencoders, the material, indirect-light and visibility nets (the last
at bf16 storage), the spherical-Gaussian shading and the scale-ACES tone
map. Random numbers come from ``Stream``, one device generator seeded as
the program's, asked in the program's order.
"""

from __future__ import annotations

import numpy as np
import torch

from .neus import positional_encoding, sdf_trunk
from ..weights import stage2_weights

TINY = 1e-6
MU_COS, LAMBDA_COS, ALPHA_COS = 32.7080, 0.0315, 31.7003


def f32(v: float) -> float:
    return float(np.float32(v))


class Stream:
    """The draws of a run, in the order they are asked for."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def uniform(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def normal(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device)


def sub(p: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


# -- data ---------------------------------------------------------------------


def pixel_batch(rng: np.random.Generator, scene, n: int, pose_scale: float) -> dict:
    """``n`` distinct pixels of one random view (the view, then the
    pixels, from ``rng``): origins, unit directions, object mask, linear
    radiance; the poses' translations divided by ``pose_scale``."""
    images = scene.images
    v = int(rng.integers(images.shape[0]))
    h, w = images.shape[1:3]
    sel = rng.choice(h * w, size=n, replace=False)
    pose = scene.camtoworlds[v].astype(np.float32).copy()
    pose[:3, 3] /= pose_scale
    f = np.float32(scene.focal)
    u, vv = (sel % w).astype(np.float32), (sel // w).astype(np.float32)
    x = (u - np.float32(w / 2)) / f
    y = (vv - np.float32(h / 2)) / f
    cam = np.stack([x, -y, -np.ones_like(x), np.ones_like(x)], -1)
    loc = pose[:3, 3]
    d = (pose @ cam.T).T[:, :3] - loc
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    img = images[v].reshape(-1, 4)[sel]
    return {"origins": np.broadcast_to(loc, d.shape).astype(np.float32),
            "dirs": d.astype(np.float32), "mask": img[:, 3] > 0.5,
            "rgb": np.power(img[:, :3], 2.2).astype(np.float32)}


# -- the grid tracer ----------------------------------------------------------


def frozen_sdf(p: dict, model: dict):
    """Stage-2 points -> the frozen NeuS's sdf: queried at ``coord_scale``
    x the point, halved."""
    s = model["coord_scale"]
    trunk = sub(p, "implicit_network")

    def sdf(x):
        with torch.no_grad():
            return sdf_trunk(trunk, model["neus"]["sdf"], x * s)[:, 0] / s
    return sdf


def bake(sdf, grid: dict, device, chunk: int = 262144) -> torch.Tensor:
    """The sdf at the R^3 nodes (x-major), stored in bf16."""
    r = grid["resolution"]
    axes = [torch.as_tensor(np.linspace(grid["bbox_min"][i], grid["bbox_max"][i], r,
                                        dtype=np.float32), device=device) for i in range(3)]
    out = torch.empty(r ** 3, device=device)
    for start in range(0, r ** 3, chunk):
        idx = torch.arange(start, min(start + chunk, r ** 3), device=device)
        pts = torch.stack([axes[0][idx // (r * r)], axes[1][(idx // r) % r], axes[2][idx % r]], -1)
        out[start:start + idx.numel()] = sdf(pts)
    return out.reshape(r, r, r).to(torch.bfloat16)


def setup(config: dict, traffic: dict, seed: int, device):
    """(weights, grid) that the reference's steps start from: the seeded
    stage-2 tree (its frozen NeuS of the mix's ``neus_seed`` where it names
    one) and the grid baked from its frozen NeuS."""
    weights = stage2_weights(config["model"], seed, device, traffic.get("neus_seed"))
    grid_cfg = config["model"]["grid"]
    return weights, Grid(bake(frozen_sdf(weights, config["model"]), grid_cfg, device), grid_cfg)


class Grid:
    def __init__(self, values: torch.Tensor, cfg: dict):
        self.v, self.cfg = values.reshape(-1), cfg
        self.r = cfg["resolution"]
        lo, hi = np.asarray(cfg["bbox_min"], np.float32), np.asarray(cfg["bbox_max"], np.float32)
        self.lo = torch.as_tensor(lo, device=values.device)
        self.span = torch.as_tensor(hi - lo, device=values.device)
        self.hi = torch.as_tensor(hi, device=values.device)
        cell = float(np.max((hi - lo) / self.r))
        self.eps_hit, self.min_step = f32(0.25 * cell), f32(0.5 * cell)
        self.max_dt, self.relax = f32(5.0 * cell), f32(cfg.get("relax", 0.9))
        self.start, self.eps, self.two_eps = f32(5e-3), f32(cell), f32(2 * cell)

    def sdf(self, x):
        r = self.r
        g = torch.clamp((x - self.lo) / self.span * (r - 1), 0.0, f32(r - 1 - 1e-6))
        i0 = torch.clamp(torch.floor(g), max=r - 2)
        f = g - i0
        i0 = i0.to(torch.int64)
        base = (i0[:, 0] * r + i0[:, 1]) * r + i0[:, 2]
        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        w = ((1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy)

        def blend(dz):
            c = [self.v[base + o + dz].float() for o in (0, r, r * r, r * r + r)]
            return c[0] * w[0] + c[1] * w[1] + c[2] * w[2] + c[3] * w[3]
        return blend(0) * (1 - fz) + blend(1) * fz

    def normal(self, x):
        g = []
        for i in range(3):
            xp, xm = x.clone(), x.clone()
            xp[:, i] = x[:, i] + self.eps
            xm[:, i] = x[:, i] - self.eps
            g.append((self.sdf(xp) - self.sdf(xm)) / self.two_eps)
        norm = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
        return torch.stack(g, -1) / torch.clamp(norm, min=1e-4)[:, None]

    def cast(self, o, d):
        """(t, hit) of each ray: sphere tracing at 0.9 of the sdf (at least
        half a cell a step), a hit below a quarter cell, then 8 bisections
        where the last step overshot and one Newton step."""
        with torch.no_grad():
            inv = 1.0 / torch.where(torch.abs(d) < f32(1e-9), f32(1e-9), d)
            t0, t1 = (self.lo - o) * inv, (self.hi - o) * inv
            tmin = torch.amax(torch.minimum(t0, t1), -1)
            t_far = torch.amin(torch.maximum(t0, t1), -1)
            near = torch.clamp(tmin, min=0.0)
            active = t_far > near
            t = near + self.start
            t_prev = t
            hit = torch.zeros_like(active)
            for _ in range(self.cfg["max_steps"]):
                if not bool(active.any()):
                    break
                s = self.sdf(o + t[:, None] * d)
                new_hit = active & (s < self.eps_hit)
                step = torch.clamp(self.relax * s, min=self.min_step)
                adv = active & ~new_hit
                t_next = torch.where(adv, t + step, t)
                active = active & ~new_hit & (t_next <= t_far)
                t_prev = torch.where(adv, t, t_prev)
                hit = hit | new_hit
                t = t_next
            lo, hi = t_prev, t
            bracketed = hit & (self.sdf(o + hi[:, None] * d) < 0.0)
            for _ in range(8):
                mid = 0.5 * (lo + hi)
                up = self.sdf(o + mid[:, None] * d) > 0.0
                lo = torch.where(bracketed & up, mid, lo)
                hi = torch.where(bracketed & ~up, mid, hi)
            t = torch.where(bracketed, 0.5 * (lo + hi), t)
            x = o + t[:, None] * d
            n = self.normal(x)
            s = self.sdf(x)
            speed = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]
            speed = torch.where(torch.abs(speed) < f32(1e-4), f32(1e-4), speed)
            t = torch.where(hit, t + torch.clamp(-s / speed, -self.max_dt, self.max_dt), t)
        return t, hit


# -- nets -------------------------------------------------------------------------


def linear(p, name, x, bf16=False):
    w, b = p[f"{name}.w"], p[f"{name}.b"]
    if bf16:
        return x.to(torch.bfloat16) @ w.to(torch.bfloat16) + b.to(torch.bfloat16)
    return x @ w + b


def chain(p, prefix, x, n, act, bf16=False):
    for i in range(n):
        x = linear(p, f"{prefix}.lin{i}", x, bf16)
        if i < n - 1:
            x = act(x)
    return x


def leaky(x):
    return torch.nn.functional.leaky_relu(x, 0.2)


def ae(p, prefix, x, noise, lc, out_sigmoid, smooth_on_latent, n_enc=5, n_dec=3):
    """A sparse autoencoder: (output, output of the perturbed pair)."""
    act = torch.sigmoid if lc == "sigmoid" else torch.nn.functional.softplus

    def enc(v):
        return act(chain(p, f"{prefix}.encoder", v, n_enc, leaky))

    def dec(z):
        return chain(p, f"{prefix}.decoder", z, n_dec, leaky)
    z = enc(x)
    out = dec(z)
    if noise is None:
        xi = out
    elif smooth_on_latent:
        xi = dec(z + 0.01 * noise)
    else:
        xi = dec(enc(x + 0.02 * noise))
    if out_sigmoid:
        out, xi = torch.sigmoid(out), torch.sigmoid(xi)
    return out, xi


def ipe(x, deg):
    scales = torch.tensor(2.0 ** np.arange(0, deg), dtype=x.dtype, device=x.device)
    shape = x.shape[:-1] + (deg * 3,)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    var = (torch.full_like(x, 1e-5)[..., None, :] * scales[:, None] ** 2).reshape(shape)
    a = torch.exp(-0.5 * var)
    return torch.cat([a * torch.sin(y), a * torch.cos(y)], -1)


def unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-4)


def material(p, env: dict, points, stream: Stream, train_spec=True):
    """The spec-BRDF and normal autoencoders at ``points`` (their
    perturbation draws ``spec_ae`` then ``normal_ae``)."""
    n = points.shape[0]
    spec_noise = stream.normal(n, env["latent_dim"])
    normal_noise = stream.normal(n, 6 * env["multires"])
    e = "envmap_material_network"
    brdf, xi = ae(p, f"{e}.spec_brdf_encoder_layer", positional_encoding(points, env["multires"]),
                  spec_noise, "sigmoid", True, True)
    if not train_spec:
        brdf, xi = brdf.detach(), xi.detach()
    nmap, nxi = ae(p, f"{e}.normal_decoder_layer", ipe(points, env["multires"]), normal_noise,
                   "sigmoid", False, False)
    return {"lgt_sgs": p[f"{e}.lgtSGs"], "specular_reflectance": p[f"{e}.specular_reflectance"],
            "roughness": brdf[:, 3:4] * 0.9 + 0.09, "diffuse_albedo": brdf[:, :3],
            "normal_map": unit(nmap), "xi_roughness": xi[:, 3:4] * 0.9 + 0.09,
            "xi_diffuse_albedo": xi[:, :3]}


def indirect(p, ind: dict, points, shift, stream: Stream):
    """(SG sets [N, L, 7], integral [N, 3]) of the indirect net (its draw
    ``indirect_ae``)."""
    x = torch.cat([positional_encoding(points, ind["multires"]), shift], -1)
    noise = stream.normal(points.shape[0], x.shape[-1])
    h = chain(p, "indirect_illum_network.lobe_layer", x, len(ind["dims"]) + 1, torch.relu)
    out = h.reshape(points.shape[0], ind["num_lgt_sgs"], 6)
    tp = torch.sigmoid(out[..., :2])
    theta, phi = tp[..., :1] * 2 * np.pi, tp[..., 1:2] * np.pi
    lobes = torch.cat([torch.cos(theta) * torch.sin(phi), torch.sin(theta) * torch.sin(phi),
                       torch.cos(phi)], -1)
    lam = torch.sigmoid(out[..., 2:3]) * 30 + 0.1
    _, integral = ae(p, "indirect_illum_network.integral_layer", x, noise, "softplus", False,
                     False)
    return torch.cat([lobes, lam, torch.relu(out[..., 3:])], -1), torch.abs(integral)


def vis_logits(p, vis: dict, points, dirs):
    h = torch.cat([positional_encoding(points, vis["points_multires"]),
                   positional_encoding(dirs, vis["dirs_multires"])], -1)
    return chain(p, "visibility_network", h, len(vis["dims"]) + 1, torch.relu, True).float()


def vis_logits_outer(p, vis: dict, points, dirs):
    """[N, 3] x [K, 3] -> [N, K, 2]; the first layer on the N + K rows."""
    bf = torch.bfloat16
    pe = positional_encoding(points, vis["points_multires"])
    de = positional_encoding(dirs, vis["dirs_multires"])
    w, b = p["visibility_network.lin0.w"], p["visibility_network.lin0.b"]
    k = pe.shape[-1]
    h = torch.relu((pe.to(bf) @ w[:k].to(bf))[:, None, :]
                   + (de.to(bf) @ w[k:].to(bf) + b.to(bf))[None])
    for i in range(1, len(vis["dims"]) + 1):
        h = linear(p, f"visibility_network.lin{i}", h, True)
        if i < len(vis["dims"]):
            h = torch.relu(h)
    return h.float()


# -- spherical Gaussians ----------------------------------------------------------


def norm_axis(x):
    return x / (torch.sqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12) + TINY)


def hemisphere_int(lam, cos_beta):
    lam = lam + TINY
    inv = 1.0 / lam
    t = torch.sqrt(lam) * (1.6988 + 10.8438 * inv) / (1.0 + 6.2201 * inv + 10.2415 * inv * inv)
    inv_a = torch.exp(-t)
    mask = (cos_beta >= 0).to(lam.dtype)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    d1 = 1.0 - inv_a + inv_b - inv_a * inv_b
    s1 = (1.0 - inv_a * inv_b) / torch.where(d1 < TINY, torch.full_like(d1, TINY), d1)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    d2 = (1.0 - inv_a) * (b + 1.0)
    s2 = (b - inv_a) / torch.where(d2 < TINY, torch.full_like(d2, TINY), d2)
    s = mask * s1 + (1.0 - mask) * s2
    a_b = 2.0 * np.pi / lam * (torch.exp(-lam) - torch.exp(-2.0 * lam))
    a_u = 2.0 * np.pi / lam * (1.0 - torch.exp(-lam))
    return a_b * (1.0 - s) + a_u * s


def lambda_trick(lobe1, lambda1, mu1, lobe2, lambda2, mu2):
    ratio = lambda1 / lambda2
    lobe1, lobe2 = norm_axis(lobe1), norm_axis(lobe2)
    dot = torch.sum(lobe1 * lobe2, -1, keepdim=True)
    tmp = torch.sqrt(torch.clamp(ratio * ratio + 1.0 + 2.0 * ratio * dot, min=1e-12))
    tmp = torch.minimum(tmp, ratio + 1.0)
    return ((ratio / tmp) * lobe1 + (1.0 / tmp) * lobe2, lambda2 * tmp,
            mu1 * mu2 * torch.exp(lambda2 * (tmp - ratio - 1.0)))


def cone_dirs(axis, sharpness, u_theta, u_phi, thr=1.0):
    z = torch.zeros_like(axis)
    z[..., 2] = 1.0
    x = torch.zeros_like(axis)
    x[..., 0] = 1.0
    up = torch.where(torch.abs(axis[..., 2:3]) > 0.99, x, z)
    u = norm_axis(torch.linalg.cross(up, axis, dim=-1))
    v = norm_axis(torch.linalg.cross(axis, u, dim=-1))
    rng = torch.clamp(torch.min(sharpness), max=thr)
    phi_range = torch.arccos(torch.clamp(-0.95 * rng / sharpness + 1.0, -1.0 + 1e-6, 1.0 - 1e-6))
    th, ph = u_theta * 2 * np.pi, u_phi * phi_range[:, None]
    return (u[:, None] * (torch.cos(th) * torch.sin(ph))[..., None]
            + v[:, None] * (torch.sin(th) * torch.sin(ph))[..., None]
            + axis[:, None] * torch.cos(ph)[..., None])


def diffuse_visibility(p, vis, points, normals, lobes, lambdas, u_theta, u_phi):
    """[M, N]: each light's SG-weighted mean visibility over its samples."""
    m, n, s = lobes.shape[0], points.shape[0], u_theta.shape[1]
    lobes = norm_axis(lobes)
    sd = cone_dirs(lobes, torch.clamp(lambdas, min=1e-4), u_theta, u_phi)
    dirs = sd.reshape(-1, 3)
    front = (normals @ dirs.t()) > TINY
    visible = torch.softmax(vis_logits_outer(p, vis, points, dirs), -1)[..., 1]
    v = torch.where(front, visible, 0.0).reshape(n, m, s).permute(1, 2, 0)
    w = torch.exp(lambdas[:, None, None] * (torch.sum(sd * lobes[:, None], -1, keepdim=True) - 1))
    return torch.sum(v * w, 1) / (torch.sum(w, 1) + TINY)


def specular_visibility(p, vis, points, normals, viewdirs, ref_lambdas, u_theta, u_phi, inv):
    n, s = points.shape[0], u_theta.shape[1]
    ndv = torch.clamp(torch.sum(normals * viewdirs, -1, keepdim=True), min=0.0)
    ref = norm_axis(-viewdirs + 2 * ndv * normals)
    sharp = torch.clamp(ref_lambdas, 0.1, 50.0)
    sd = cone_dirs(ref, sharp, u_theta, u_phi)
    front = torch.sum(normals[:, None] * sd, -1) > TINY
    logits = vis_logits(p, vis, points[:, None].expand(n, s, 3), sd)
    v = torch.where(front, torch.softmax(logits, -1)[..., 0 if inv else 1], 0.0)
    w = torch.exp(sharp[:, None] * (torch.sum(sd * ref[:, None], -1) - 1.0))
    return torch.sum(v * w, -1) / (torch.sum(w, -1) + TINY)


def specular_sg(normal, viewdirs, roughness, spec):
    inv_r4 = 2.0 / roughness ** 4
    mus = (inv_r4 / np.pi).expand(normal.shape)
    vdl = torch.clamp(torch.sum(normal * viewdirs, -1, keepdim=True), min=0.0)
    lobes = norm_axis(2 * vdl * normal - viewdirs)
    lambdas = inv_r4 / (4 * vdl + TINY)
    half = norm_axis(lobes + viewdirs)
    vdh = torch.clamp(torch.sum(viewdirs * half, -1, keepdim=True), min=0.0)
    fres = spec + (1.0 - spec) * torch.pow(2.0, -(5.55473 * vdh + 6.8316) * vdh)
    d1 = torch.clamp(torch.sum(lobes * normal, -1, keepdim=True), min=0.0)
    d2 = torch.clamp(torch.sum(viewdirs * normal, -1, keepdim=True), min=0.0)
    k = (roughness + 1.0) ** 2 / 8.0
    g1, g2 = d1 / (d1 * (1 - k) + k + TINY), d2 / (d2 * (1 - k) + k + TINY)
    return lobes, lambdas, mus * fres * g1 * g2 / (4 * d1 * d2 + TINY)


def cos_integral(normal, lobes, lambdas, mus):
    n = normal[:, None]
    lp, lamp, mup = lambda_trick(n, LAMBDA_COS, MU_COS, lobes, lambdas, mus)
    out = (mup * hemisphere_int(lamp, torch.sum(lp * n, -1, keepdim=True))
           - mus * ALPHA_COS * hemisphere_int(lambdas, torch.sum(lobes * n, -1, keepdim=True)))
    return torch.clamp(torch.sum(out, -2), min=0.0)


def sg_shade(p, vis, stream, points, normal, viewdirs, sgs, spec, rough, albedo,
             comp_vis, indir_integral=None, prefix=""):
    """One light set's colour (direct with the visibility sweep, or
    indirect), specular plus diffuse. Draws: ``lobe_theta``,
    ``lobe_phi`` (direct only), then the specular sweep's two."""
    n = points.shape[0]
    if sgs.dim() == 2:
        sgs = sgs[None].expand((n,) + sgs.shape)
    m = sgs.shape[1]
    lobes = sgs[..., :3] / (torch.linalg.norm(sgs[..., :3], dim=-1, keepdim=True) + TINY)
    lambdas, mus = torch.abs(sgs[..., 3:4]), torch.abs(sgs[..., -3:])
    spec = spec.reshape(1, -1).expand(n, 3)
    light_vis = None
    if comp_vis:
        u_t, u_p = stream.uniform(m, 32), stream.uniform(m, 32)
        light_vis = diffuse_visibility(p, vis, points, normal.detach(), lobes[0],
                                       lambdas[0, :, 0], u_t, u_p).t()[..., None].expand(n, m, 3)
    s_t, s_p = stream.uniform(n, 8), stream.uniform(n, 8)
    w_lobes, w_lambdas, w_mus = specular_sg(normal, viewdirs, rough, spec)
    brdf_vis = specular_visibility(p, vis, points, normal, viewdirs, w_lambdas[:, 0], s_t, s_p,
                                   inv=not comp_vis)
    final = lambda_trick(lobes, lambdas, mus * brdf_vis[:, None, None], w_lobes[:, None],
                         w_lambdas[:, None], w_mus[:, None])
    specular = cos_integral(normal, *final)
    diffuse_mus = (mus * light_vis if comp_vis else mus) * (albedo / np.pi)[:, None]
    diffuse = cos_integral(normal, lobes, lambdas, diffuse_mus)
    if indir_integral is not None:
        diffuse = indir_integral * albedo / np.pi
    return specular + diffuse


# -- tone map -----------------------------------------------------------------


def shift(p) -> torch.Tensor:
    return torch.clamp(torch.clamp(p["gamma.adapt_illum"] * 10 + 0.5, 0, 1), 1e-4, 1.0)


def aces(x):
    return x * (2.51 * x + 0.03) / (x * (2.43 * x + 0.59) + 0.14)


def hdr2ldr(x, t):
    return aces(x) / t ** 0.2

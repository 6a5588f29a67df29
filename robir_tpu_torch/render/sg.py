"""Spherical-Gaussian PBR shading (counterpart of ``robir_tpu/render/sg.py``,
the reference's ``model/sg_render.py``): dense [N, M] algebra, the
visibility sweeps over SG lobes, and the closed-form SG integrals.

The random directions of the sweeps come from U[0, 1) draws that are
arguments of the functions below; ``render_with_sg`` takes them from a
``Draws`` by name: ``lobe_theta``/``lobe_phi`` [M, S] for the diffuse sweep
and ``spec_theta``/``spec_phi`` [N, S] for the specular one, prefixed
``indir_`` for the indirect light set. ``compute_envmap`` renders the SG
lights into a lat-long image and ``render_envmap`` looks such an image up
along directions.

``render_with_sg(fun_spec=True)`` returns the specular term as a function
of roughness (differentiable in it), and ``viewdirs`` [V, N, 3] shades the
specular term once per view beside one shared diffuse term. The specular
draws are made once, where the inline render makes them, and shared by
every view and every call of the function, as the JAX package uses one
key for all of them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.draws import Draws
from ..core.mesh import DataMesh, batch_mean
from ..tools.profiler import span

TINY = 1e-6
MU_COS = 32.7080
LAMBDA_COS = 0.0315
ALPHA_COS = 31.7003

VisFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def norm_axis(x: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    return x / (norm + TINY)


def _unit_lobes(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + TINY)


def split_sgs(lgt_sgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., 7] raw SG parameters -> (unit lobes, |lambda|, |mu|)."""
    return (_unit_lobes(lgt_sgs[..., :3]), torch.abs(lgt_sgs[..., 3:4]),
            torch.abs(lgt_sgs[..., -3:]))


def render_envmap_sg(lgt_sgs: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """The SG mixture [M, 7] along ``viewdirs`` [..., 3] -> [..., 3]
    (sg_render.py:26-42): no epsilon in the lobes' norm, as the
    reference."""
    v = viewdirs[..., None, :]
    lobes = lgt_sgs[..., :3] / torch.linalg.norm(lgt_sgs[..., :3], dim=-1, keepdim=True)
    lambdas = torch.abs(lgt_sgs[..., 3:4])
    mus = torch.abs(lgt_sgs[..., -3:])
    rgb = mus * torch.exp(lambdas * (torch.sum(v * lobes, -1, keepdim=True) - 1.0))
    return torch.sum(rgb, dim=-2)


def envmap_dirs(H: int, W: int, upper_hemi: bool = False, device="cpu") -> torch.Tensor:
    """[H, W, 3] lat-long directions, blender convention (sg_render.py:9-19):
    the polar angle over rows from +z, the azimuth from +pi to -pi over
    columns."""
    phi = torch.linspace(0.0, np.pi / 2.0 if upper_hemi else np.pi, H, device=device)
    theta = torch.linspace(np.pi, -np.pi, W, device=device)
    phi, theta = torch.meshgrid(phi, theta, indexing="ij")
    return torch.stack([torch.cos(theta) * torch.sin(phi), torch.sin(theta) * torch.sin(phi),
                        torch.cos(phi)], -1)


def compute_envmap(lgt_sgs: torch.Tensor, H: int, W: int,
                   upper_hemi: bool = False) -> torch.Tensor:
    """The SG lights [M, 7] as an [H, W, 3] lat-long image."""
    return render_envmap_sg(lgt_sgs, envmap_dirs(H, W, upper_hemi, lgt_sgs.device))


def render_envmap(envmap: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of a lat-long [H, W, 3] image along [N, 3] unit
    directions (sg_render.py:45-59: grid_sample with align_corners=True,
    border texels clamped)."""
    H, W = envmap.shape[:2]
    phi = torch.arccos(torch.clamp(viewdirs[:, 2], -1.0, 1.0)) - TINY
    theta = torch.atan2(viewdirs[:, 1], viewdirs[:, 0])
    gy, gx = (phi / np.pi) * 2 - 1, -theta / np.pi  # grid_sample's [-1, 1]
    py, px = (gy + 1) * 0.5 * (H - 1), (gx + 1) * 0.5 * (W - 1)
    y0 = torch.clamp(torch.floor(py).long(), 0, H - 1)
    x0 = torch.clamp(torch.floor(px).long(), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = (py - y0)[:, None]
    wx = (px - x0)[:, None]
    return (envmap[y0, x0] * ((1 - wy) * (1 - wx)) + envmap[y0, x1] * ((1 - wy) * wx)
            + envmap[y1, x0] * (wy * (1 - wx)) + envmap[y1, x1] * (wy * wx))


def hemisphere_int(lambda_val: torch.Tensor, cos_beta: torch.Tensor) -> torch.Tensor:
    """Closed-form SG hemispherical integral (sg_render.py:62-81), with the
    JAX package's guarded denominators."""
    lambda_val = lambda_val + TINY
    inv_lambda = 1.0 / lambda_val
    t = torch.sqrt(lambda_val) * (1.6988 + 10.8438 * inv_lambda) / (
        1.0 + 6.2201 * inv_lambda + 10.2415 * inv_lambda * inv_lambda)
    inv_a = torch.exp(-t)
    mask = (cos_beta >= 0).to(lambda_val.dtype)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    d1 = 1.0 - inv_a + inv_b - inv_a * inv_b
    s1 = (1.0 - inv_a * inv_b) / torch.where(d1 < TINY, torch.full_like(d1, TINY), d1)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    d2 = (1.0 - inv_a) * (b + 1.0)
    s2 = (b - inv_a) / torch.where(d2 < TINY, torch.full_like(d2, TINY), d2)
    s = mask * s1 + (1.0 - mask) * s2
    a_b = 2.0 * np.pi / lambda_val * (torch.exp(-lambda_val) - torch.exp(-2.0 * lambda_val))
    a_u = 2.0 * np.pi / lambda_val * (1.0 - torch.exp(-lambda_val))
    return a_b * (1.0 - s) + a_u * s


def lambda_trick(lobe1, lambda1, mu1, lobe2, lambda2, mu2):
    """Product of two SGs as an SG (sg_render.py:84-104)."""
    ratio = lambda1 / lambda2
    lobe1 = norm_axis(lobe1)
    lobe2 = norm_axis(lobe2)
    dot = torch.sum(lobe1 * lobe2, dim=-1, keepdim=True)
    tmp = torch.sqrt(torch.clamp(ratio * ratio + 1.0 + 2.0 * ratio * dot, min=1e-12))
    tmp = torch.minimum(tmp, ratio + 1.0)
    lambda3 = lambda2 * tmp
    final_lobes = (ratio / tmp) * lobe1 + (1.0 / tmp) * lobe2
    final_mus = mu1 * mu2 * torch.exp(lambda2 * (tmp - ratio - 1.0))
    return final_lobes, lambda3, final_mus


def _lobe_frame(lobes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal (U, V) around unit ``lobes``, crossing with +z, or with +x
    for lobes within 0.99 of z."""
    z_axis = torch.zeros_like(lobes)
    z_axis[..., 2] = 1.0
    x_axis = torch.zeros_like(lobes)
    x_axis[..., 0] = 1.0
    up = torch.where(torch.abs(lobes[..., 2:3]) > 0.99, x_axis, z_axis)
    u = norm_axis(torch.linalg.cross(up, lobes, dim=-1))
    v = norm_axis(torch.linalg.cross(lobes, u, dim=-1))
    return u, v


def _cone_dirs(axis, sharpness, r_theta_u, r_phi_u, thr: float = 1.0):
    """Directions in a cone around each ``axis`` [R, 3]; cone angle set by
    the sharpest lobe; U[0,1) draws [R, S] -> [R, S, 3]."""
    u, v = _lobe_frame(axis)
    sg_range = torch.clamp(torch.min(sharpness), max=thr)
    r_phi_range = torch.arccos(torch.clamp((-0.95 * sg_range) / sharpness + 1.0,
                                           -1.0 + 1e-6, 1.0 - 1e-6))
    r_theta = r_theta_u * 2 * np.pi
    r_phi = r_phi_u * r_phi_range[:, None]
    return (u[:, None, :] * (torch.cos(r_theta) * torch.sin(r_phi))[..., None]
            + v[:, None, :] * (torch.sin(r_theta) * torch.sin(r_phi))[..., None]
            + axis[:, None, :] * torch.cos(r_phi)[..., None])


def sample_lobe_dirs(lobes: torch.Tensor, sharpness: torch.Tensor,
                     r_theta_u: torch.Tensor, r_phi_u: torch.Tensor,
                     thr: float = 1.0, sharp_min: float = 1e-4,
                     sharp_max: float | None = None) -> torch.Tensor:
    """Directions around each SG lobe (sg_render.py:129-146): lobes [L, 3],
    sharpness [L], U[0,1) draws [L, S] -> dirs [L, S, 3]."""
    sharpness = torch.clamp(sharpness, min=sharp_min, max=sharp_max)
    return _cone_dirs(lobes, sharpness, r_theta_u, r_phi_u, thr)


def _visible(logits: torch.Tensor, col: int, argmax: bool) -> torch.Tensor:
    if argmax:
        pick = torch.argmax(logits, -1) if col == 1 else torch.argmin(logits, -1)
        return pick.to(logits.dtype)
    return torch.softmax(logits, dim=-1)[..., col]


def get_diffuse_visibility(points: torch.Tensor, normals: torch.Tensor,
                           vis_fn: VisFn, lgt_lobes: torch.Tensor,
                           lgt_lambdas: torch.Tensor, r_theta_u: torch.Tensor,
                           r_phi_u: torch.Tensor, thr: float = 1.0,
                           argmax_vis: bool = False, chunk_lights: int = 0,
                           vis_outer_fn=None) -> torch.Tensor:
    """SG-weighted mean visibility toward each light lobe (sg_render.py:
    111-195), dense over every (point, sample) pair with back-facing
    samples masked to zero. points/normals [N, 3]; lgt_lobes [M, 3];
    lgt_lambdas [M]; draws [M, S] -> vis [M, N].

    With ``chunk_lights`` > 0 dividing M (and below it) the [N, M*S] sweep
    runs in groups of that many lights, one visibility-net call each, as
    the JAX package's ``lax.map``: the same values, a smaller peak of
    activations; otherwise in one pass."""
    M, N = lgt_lobes.shape[0], points.shape[0]
    nsamp = r_theta_u.shape[1]
    lobes = norm_axis(lgt_lobes)
    sample_dir = sample_lobe_dirs(lobes, lgt_lambdas, r_theta_u, r_phi_u, thr=thr)

    def sweep(sd: torch.Tensor) -> torch.Tensor:
        """sample directions [m, S, 3] -> visibility [N, m * S]."""
        dirs = sd.reshape(-1, 3)
        cos_term = (normals @ dirs.t()) > TINY
        if vis_outer_fn is not None:
            logits = vis_outer_fn(points, dirs)
        else:
            k = dirs.shape[0]
            logits = vis_fn(points[:, None, :].expand(N, k, 3), dirs[None].expand(N, k, 3))
        return torch.where(cos_term, _visible(logits, 1, argmax_vis), 0.0)

    if chunk_lights and M > chunk_lights and M % chunk_lights == 0:
        pred = torch.cat([sweep(g) for g in sample_dir.split(chunk_lights)], dim=1)
    else:
        pred = sweep(sample_dir)
    vis = pred.reshape(N, M, nsamp).permute(1, 2, 0)  # [M, S, N]
    w = torch.exp(lgt_lambdas[:, None, None]
                  * (torch.sum(sample_dir * lobes[:, None, :], -1, keepdim=True) - 1.0))
    return torch.sum(vis * w, dim=1) / (torch.sum(w, dim=1) + TINY)


def get_specular_visibility(points: torch.Tensor, normals: torch.Tensor,
                            viewdirs: torch.Tensor, vis_fn: VisFn,
                            ref_lambdas: torch.Tensor, r_theta_u: torch.Tensor,
                            r_phi_u: torch.Tensor, inv: bool = False,
                            argmax_vis: bool = False) -> torch.Tensor:
    """Visibility around the reflection direction per point (sg_render.py:
    198-301): [N, 3] inputs, ref_lambdas [N], draws [N, S] -> vis [N]."""
    N, nsamp = points.shape[0], r_theta_u.shape[1]
    n_dot_v = torch.clamp(torch.sum(normals * viewdirs, -1, keepdim=True), min=0.0)
    ref_dir = norm_axis(-viewdirs + 2 * n_dot_v * normals)
    sharpness = torch.clamp(ref_lambdas, 0.1, 50.0)
    sample_dir = _cone_dirs(ref_dir, sharpness, r_theta_u, r_phi_u)  # [N, S, 3]
    cos_term = torch.sum(normals[:, None, :] * sample_dir, -1) > TINY
    logits = vis_fn(points[:, None, :].expand(N, nsamp, 3), sample_dir)
    vis = torch.where(cos_term, _visible(logits, 0 if inv else 1, argmax_vis), 0.0)
    w = torch.exp(sharpness[:, None]
                  * (torch.sum(sample_dir * ref_dir[:, None, :], -1) - 1.0))
    return torch.sum(vis * w, -1) / (torch.sum(w, -1) + TINY)


def kl_divergence(x: torch.Tensor, mu: float = 0.05,
                  weight: Optional[torch.Tensor] = None,
                  lobe_weight: Optional[torch.Tensor] = None,
                  mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Bernoulli KL of the (weighted) batch-mean rate against ``mu``
    (reference ``utils/utils.py:14-17``); ``lobe_weight`` reweights the
    final mean over lobes, normalised to mean 1. Under a ``mesh`` the batch
    mean is over every rank's rows (``batch_mean``) and the KL is divided
    by the world size: the ranks' terms add up to the KL, and so do their
    gradients."""
    rho_hat = batch_mean(mesh, x, weight)
    rho = mu
    kl = (rho * torch.log(rho / (rho_hat + 1e-4))
          + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat + 1e-4)))
    world = 1 if mesh is None else mesh.world
    if lobe_weight is None:
        return torch.mean(kl) / world
    lw = lobe_weight / torch.clamp(torch.mean(lobe_weight), min=1e-9)
    return torch.mean(kl * lw) / world


def specular_sg(normal, viewdirs, roughness, specular_reflectance,
                metallic=None, diffuse_albedo=None):
    """Warped NDF-as-SG with Fresnel and geometry terms (sg_render.py:
    414-458) -> (warp_lobes [N,3], warp_lambdas [N,1], warp_mus [N,3])."""
    inv_r4 = 2.0 / (roughness ** 4)
    brdf_mus = (inv_r4 / np.pi).expand(normal.shape)
    v_dot_lobe = torch.clamp(torch.sum(normal * viewdirs, -1, keepdim=True), min=0.0)
    warp_lobes = norm_axis(2 * v_dot_lobe * normal - viewdirs)
    warp_lambdas = inv_r4 / (4 * v_dot_lobe + TINY)
    new_half = norm_axis(warp_lobes + viewdirs)
    v_dot_h = torch.clamp(torch.sum(viewdirs * new_half, -1, keepdim=True), min=0.0)
    spec_col = (specular_reflectance if metallic is None else
                (1.0 - metallic) * specular_reflectance + diffuse_albedo * metallic)
    fres = spec_col + (1.0 - spec_col) * torch.pow(
        2.0, -(5.55473 * v_dot_h + 6.8316) * v_dot_h)
    dot1 = torch.clamp(torch.sum(warp_lobes * normal, -1, keepdim=True), min=0.0)
    dot2 = torch.clamp(torch.sum(viewdirs * normal, -1, keepdim=True), min=0.0)
    k = (roughness + 1.0) ** 2 / 8.0
    g1 = dot1 / (dot1 * (1 - k) + k + TINY)
    g2 = dot2 / (dot2 * (1 - k) + k + TINY)
    moi = fres * g1 * g2 / (4 * dot1 * dot2 + TINY)
    return warp_lobes, warp_lambdas, brdf_mus * moi


def _sg_cos_integral(normal, lobes, lambdas, mus):
    """Hemisphere integral of SGs [N, M, .] times the clamped cosine,
    summed over the M lobes and clamped at 0."""
    n = normal[:, None, :]
    lobe_p, lambda_p, mu_p = lambda_trick(n, LAMBDA_COS, MU_COS, lobes, lambdas, mus)
    dot1 = torch.sum(lobe_p * n, -1, keepdim=True)
    dot2 = torch.sum(lobes * n, -1, keepdim=True)
    out = (mu_p * hemisphere_int(lambda_p, dot1)
           - mus * ALPHA_COS * hemisphere_int(lambdas, dot2))
    return torch.clamp(torch.sum(out, dim=-2), min=0.0)


def shade_with_sg_lights(normal, lgt_lobes, lgt_lambdas, lgt_mus,
                         warp_lobes, warp_lambdas, warp_mus):
    """Specular: (light SG x BRDF SG) x clamped cosine, integrated, summed
    over lights (sg_render.py:480-494)."""
    final = lambda_trick(lgt_lobes, lgt_lambdas, lgt_mus, warp_lobes[:, None, :],
                         warp_lambdas[:, None, :], warp_mus[:, None, :])
    return _sg_cos_integral(normal, *final)


def diffuse_sg_integral(normal, lgt_lobes, lgt_lambdas, final_mus):
    """Diffuse integral of the visibility-scaled light SGs (sg_render.py:
    512-530)."""
    return _sg_cos_integral(normal, lgt_lobes, lgt_lambdas, final_mus)


class SGRenderOutput(NamedTuple):
    sg_rgb: torch.Tensor
    sg_specular_rgb: torch.Tensor
    sg_diffuse_rgb: torch.Tensor
    vis_shadow: torch.Tensor
    supervise: torch.Tensor


def render_with_sg(draws: Draws, points, normal, viewdirs, lgt_sgs,
                   specular_reflectance, roughness, diffuse_albedo, *,
                   comp_vis: bool = True, vis_fn: Optional[VisFn] = None,
                   vis_outer_fn=None, lin_diff: bool = False,
                   indir_integral=None, metallic=None, diffuse_vis=None,
                   prefit: Optional[str] = None, argmax_vis: bool = False,
                   fun_spec: bool = False,
                   diffuse_nsamp: int = 32, diffuse_vis_nsamp: int = 8,
                   specular_nsamp: int = 8, diffuse_sweep_chunk: int = 0,
                   supervise_weight=None, supervise_rows: bool = False,
                   diffuse_vis_grad: bool = True, draw_prefix: str = "") -> SGRenderOutput:
    """Full SG shading for one light set (sg_render.py:343-565).

    points/normal [N, 3]; viewdirs [N, 3], or [V, N, 3] to shade the
    specular term per view (``sg_rgb`` [V, N, 3] = per-view specular +
    the shared diffuse); lgt_sgs [N, M, 7] or [M, 7]; roughness [N, 1];
    diffuse_albedo [N, 3]; diffuse_vis (CESR) [N, M].
    ``fun_spec=True`` returns ``sg_specular_rgb`` as ``fn(roughness)`` and
    ``sg_rgb`` with the diffuse term only.
    ``supervise_rows=True`` returns the supervision's per-row ingredient
    |gt - vis| [N, M] in place of its KL.
    ``diffuse_vis_grad=False`` runs the diffuse sweep without a graph, for
    callers whose loss does not reach its result (the CESR warmup step
    without the rgb term): that changes no gradient.
    ``diffuse_sweep_chunk`` is the sweep's ``chunk_lights``."""
    N = points.shape[0]
    if lgt_sgs.dim() == 2:
        lgt_sgs = lgt_sgs[None].expand((N,) + lgt_sgs.shape)
    M = lgt_sgs.shape[1]
    lgt_lobes, lgt_lambdas, origin_mus = split_sgs(lgt_sgs)
    spec_refl = specular_reflectance.reshape(1, -1).expand(N, 3)

    supervise = points.new_zeros(())
    vis_shadow = points.new_zeros((N, 3))
    light_vis = None
    if comp_vis:
        nsamp = diffuse_nsamp if diffuse_vis is None else diffuse_vis_nsamp
        with (torch.set_grad_enabled(torch.is_grad_enabled() and diffuse_vis_grad),
              span("sg.diffuse_sweep")):
            light_vis_gt = get_diffuse_visibility(
                points, normal.detach(), vis_fn, lgt_lobes[0], lgt_lambdas[0, :, 0],
                draws.uniform(draw_prefix + "lobe_theta", (M, nsamp)),
                draws.uniform(draw_prefix + "lobe_phi", (M, nsamp)),
                argmax_vis=argmax_vis, chunk_lights=diffuse_sweep_chunk,
                vis_outer_fn=vis_outer_fn)  # [M, N]
        light_vis_gt = light_vis_gt.t()[..., None].expand(N, M, 3)
        if diffuse_vis is not None:
            light_vis = diffuse_vis.reshape(N, M, 1).expand(N, M, 3)
            if prefit == "warmup":
                sup_x = torch.abs(light_vis_gt.detach() - light_vis)[..., 0]
                factor = 0.1
                light_vis = light_vis_gt
            else:
                sup_x = torch.abs(light_vis_gt - light_vis)[..., 0]
                factor = 0.2 if prefit == "project" else 1.0
            # per row, |gt - vis| [N, M]: the KL of the batch mean is taken
            # by the caller, outside a surface-pixel compaction
            supervise = sup_x if supervise_rows else kl_divergence(
                sup_x, 0.01, weight=supervise_weight) * factor
        else:
            light_vis = light_vis_gt
        vis_shadow = (torch.sum(light_vis * origin_mus, dim=1) / torch.clamp(
            torch.sum(origin_mus, dim=1), min=1e-4)).detach()

    spec_u = None
    if comp_vis or vis_fn is not None:
        spec_u = (draws.uniform(draw_prefix + "spec_theta", (N, specular_nsamp), rows=True),
                  draws.uniform(draw_prefix + "spec_phi", (N, specular_nsamp), rows=True))

    def one_view(vd, rough):
        warp_lobes, warp_lambdas, warp_mus = specular_sg(
            normal, vd, rough, spec_refl, metallic=metallic, diffuse_albedo=diffuse_albedo)
        lgt_mus_spec = origin_mus
        if spec_u is not None:
            brdf_vis = get_specular_visibility(points, normal, vd, vis_fn, warp_lambdas[:, 0],
                                               *spec_u, inv=not comp_vis,
                                               argmax_vis=argmax_vis)
            lgt_mus_spec = origin_mus * brdf_vis[:, None, None]
        return shade_with_sg_lights(normal, lgt_lobes, lgt_lambdas, lgt_mus_spec,
                                    warp_lobes, warp_lambdas, warp_mus)

    def spec_fn(rough: torch.Tensor) -> torch.Tensor:
        if viewdirs.dim() == 3:
            return torch.stack([one_view(vd, rough) for vd in viewdirs])
        return one_view(viewdirs, rough)

    lgt_mus_diff = origin_mus * light_vis if comp_vis else origin_mus
    diffuse = diffuse_albedo / np.pi
    final_mus = lgt_mus_diff if lin_diff else lgt_mus_diff * diffuse[:, None, :]
    diffuse_rgb = diffuse_sg_integral(normal, lgt_lobes, lgt_lambdas, final_mus)
    if indir_integral is not None:
        diffuse_rgb = indir_integral if lin_diff else indir_integral * diffuse
    if fun_spec:
        return SGRenderOutput(diffuse_rgb, spec_fn, diffuse_rgb, vis_shadow, supervise)
    specular_rgb = spec_fn(roughness)
    return SGRenderOutput(specular_rgb + diffuse_rgb, specular_rgb, diffuse_rgb,
                          vis_shadow, supervise)


class AllSGOutput(NamedTuple):
    sg_rgb: torch.Tensor
    sg_specular_rgb: torch.Tensor
    sg_diffuse_rgb: torch.Tensor
    vis_shadow: torch.Tensor
    supervise: torch.Tensor
    indir_rgb: torch.Tensor
    indir_diffuse_rgb: torch.Tensor
    indir_specular_rgb: torch.Tensor


def render_with_all_sg(draws: Draws, points, normal, viewdirs, lgt_sgs,
                       specular_reflectance, roughness, diffuse_albedo, *,
                       indir_integral=None, indir_lgt_sgs=None, vis_fn=None,
                       vis_outer_fn=None, lin_diff=False, metallic=None,
                       diffuse_vis=None, prefit=None, argmax_vis=False,
                       fun_spec: bool = False, diffuse_sweep_chunk: int = 0,
                       supervise_weight=None, supervise_rows: bool = False,
                       diffuse_vis_grad: bool = True) -> AllSGOutput:
    """Direct (visibility-attenuated) plus indirect SG shading
    (sg_render.py:304-337); with ``fun_spec`` both specular fields are
    functions of roughness, and ``viewdirs`` may be [V, N, 3] as for
    ``render_with_sg``. The per-row draws (the specular sweeps') have
    one row per point, so a compacted render draws them for its rows only;
    the JAX package keys them per chunk instead (``spec_key``)."""
    direct = render_with_sg(
        draws, points, normal, viewdirs, lgt_sgs, specular_reflectance,
        roughness, diffuse_albedo, comp_vis=True, vis_fn=vis_fn,
        vis_outer_fn=vis_outer_fn, lin_diff=lin_diff, metallic=metallic,
        diffuse_vis=diffuse_vis, prefit=prefit, argmax_vis=argmax_vis, fun_spec=fun_spec,
        diffuse_sweep_chunk=diffuse_sweep_chunk, supervise_weight=supervise_weight,
        supervise_rows=supervise_rows, diffuse_vis_grad=diffuse_vis_grad)
    if indir_lgt_sgs is not None:
        indirect = render_with_sg(
            draws, points, normal, viewdirs, indir_lgt_sgs, specular_reflectance,
            roughness, diffuse_albedo, comp_vis=False, vis_fn=vis_fn,
            lin_diff=lin_diff, indir_integral=indir_integral, metallic=metallic,
            argmax_vis=argmax_vis, fun_spec=fun_spec, draw_prefix="indir_")
        indir = (indirect.sg_rgb, indirect.sg_diffuse_rgb, indirect.sg_specular_rgb)
    else:
        z = torch.zeros_like(points)
        indir = (z, z, (lambda rough: z) if fun_spec else z)
    return AllSGOutput(direct.sg_rgb, direct.sg_specular_rgb, direct.sg_diffuse_rgb,
                       direct.vis_shadow, direct.supervise, *indir)

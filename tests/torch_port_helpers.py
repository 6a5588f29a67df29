"""Helpers shared by the tests that hold robir_tpu_torch to robir_tpu.

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs on the CPU as its own tests run it (Pallas kernels in interpret
mode), the port's side on CPU tensors, where its ops run their plain
versions. Whether a card is present is decided inside a test
(``cuda_or_skip``), never at import.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def to_t(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trunk_case(plan, seed: int, n_rows: int):
    """(x, weights, biases) as float32 numpy arrays for a trunk plan with
    ``layer_in_dim``/``layer_out_dim`` (either package's MLPPlan)."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for i in range(plan.n_layers):
        din, dout = plan.layer_in_dim(i), plan.layer_out_dim(i)
        ws.append((rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((0.1 * rng.standard_normal(dout)).astype(np.float32))
    x = rng.standard_normal((n_rows, plan.dims[0])).astype(np.float32)
    return x, ws, bs


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def jax_sg_draws(key, n_points: int, n_lights: int, diffuse_nsamp: int = 8,
                 spec_nsamp: int = 8, indirect: bool = True) -> dict:
    """The U[0,1) draws ``robir_tpu.render.sg.render_with_all_sg`` makes from
    ``key``, by the port's names (JAX imported here, so that the card-only
    tests, which import this module, need no JAX)."""
    import jax

    def pair(k, shape, prefix):
        ka, kb = jax.random.split(k)
        return {prefix + "theta": np.asarray(jax.random.uniform(ka, shape)),
                prefix + "phi": np.asarray(jax.random.uniform(kb, shape))}

    k1, k2 = jax.random.split(key)
    k_diff, rest = jax.random.split(k1)
    draws = pair(k_diff, (n_lights, diffuse_nsamp), "lobe_")
    draws.update(pair(jax.random.split(rest)[0], (n_points, spec_nsamp), "spec_"))
    if indirect:
        draws.update(pair(jax.random.split(k2)[0], (n_points, spec_nsamp), "indir_spec_"))
    return draws


def jax_stage2_draws(key, n_points: int, stage2_cfg, n_lights: int,
                     diffuse_nsamp: int = 8, spec_nsamp: int = 8, surface=None,
                     chunk: int = 0) -> dict:
    """Every draw of one ``robir_tpu.render.stage2.stage2_forward`` with an
    ``hdr_shift`` (the CESR step's; ``diffuse_nsamp=32`` for
    ``default_sg_render``) from its key, by the port's names: the indirect
    AE noise, the material heads' noise, then the SG render's directions.

    With ``chunk`` > 0 (the compacted render) and ``surface`` ([N] bool,
    the surface pixels), the per-row draws are those of JAX's compacted
    render, replayed: chunk c of the surface rows (in their order) keys
    its material draws by ``fold_in(k_sg, id of its first row)``, its
    specular sweep by ``fold_in(chunk_key, 2)`` and the indirect one by
    ``fold_in(that, 1)``, each drawn at [chunk, ...]. The port gets the
    surface rows' draws, [n_surface, ...] in row order; the per-light
    draws and the indirect AE noise are the dense render's."""
    import jax

    env = stage2_cfg.envmap
    k_ind, key = jax.random.split(key)
    k_sg, _ = jax.random.split(key)
    k_mat, k_render = jax.random.split(k_sg)

    def material(k, n):
        k_spec, k_norm = jax.random.split(k)
        return {"spec_ae": np.asarray(jax.random.normal(k_spec, (n, env.latent_dim))),
                "normal_ae": np.asarray(jax.random.normal(k_norm, (n, env.ipe.out_dim)))}

    def pair(k, shape, prefix):
        ka, kb = jax.random.split(k)
        return {prefix + "theta": np.asarray(jax.random.uniform(ka, shape)),
                prefix + "phi": np.asarray(jax.random.uniform(kb, shape))}

    draws = {"indirect_ae": np.asarray(jax.random.normal(
        k_ind, (n_points, stage2_cfg.indirect.in_dim)))}
    dense = jax_sg_draws(k_render, n_points, n_lights, diffuse_nsamp, spec_nsamp)
    if not chunk:
        draws.update(material(k_mat, n_points))
        draws.update(dense)
        return draws
    draws.update({k: v for k, v in dense.items() if k.startswith("lobe_")})
    rows = np.flatnonzero(surface)
    parts = []
    for c in range(0, len(rows), chunk):
        ck = jax.random.fold_in(k_sg, int(rows[c]))
        k_spec = jax.random.fold_in(ck, 2)
        part = material(ck, chunk)
        part.update(pair(k_spec, (chunk, spec_nsamp), "spec_"))
        part.update(pair(jax.random.fold_in(k_spec, 1), (chunk, spec_nsamp), "indir_spec_"))
        parts.append({k: v[:len(rows) - c] for k, v in part.items()})
    draws.update({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    return draws


def jax_vis_draws(key, n_points: int, nsamp: int, stage2_cfg) -> dict:
    """Every draw of one ``robir_tpu.stages.vis.make_vis_step`` step from its
    key, by the port's names. The step splits its key into the forward's
    and the trace's (``vis.py:56``); ``stage2_forward(trainstage="Illum")``
    draws the indirect AE noise, then the material heads' noise; then
    ``trace_radiance`` draws the fan's directions (``spherical_uniform``:
    the z coordinate, then the azimuth)."""
    import jax

    env = stage2_cfg.envmap
    k_fwd, k_trace = jax.random.split(key)
    k_ind, k = jax.random.split(k_fwd)
    k_spec, k_norm = jax.random.split(jax.random.split(k)[0])
    k_u, k_t = jax.random.split(jax.random.split(k_trace)[0])
    return {"indirect_ae": np.asarray(jax.random.normal(
                k_ind, (n_points, stage2_cfg.indirect.in_dim))),
            "spec_ae": np.asarray(jax.random.normal(k_spec, (n_points, env.latent_dim))),
            "normal_ae": np.asarray(jax.random.normal(k_norm, (n_points, env.ipe.out_dim))),
            "sphere_u": np.asarray(jax.random.uniform(k_u, (n_points, nsamp))),
            "sphere_t": np.asarray(jax.random.uniform(k_t, (n_points, nsamp)))}


def jax_energy_draws(key, n_steps: int, n_pixels: int, batch_px: int,
                     batch_shift: int) -> list:
    """The draws of ``robir_tpu.render.color.fit_energy``'s first
    ``n_steps`` steps from its key, one dict a step, by the port's names:
    each step splits a key off, then its shift batch and its pixel
    indices."""
    import jax

    out = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        k1, k2 = jax.random.split(k)
        out.append({"energy_shift": np.asarray(jax.random.uniform(k1, (batch_shift, 1))),
                    "energy_pixels": np.asarray(jax.random.randint(k2, (batch_px,), 0,
                                                                   n_pixels))})
    return out


# the two spheres of the shadow scene (``data/syn_dataset.py:shadow_scene``)
# in stage-2 coordinates: the scene's world coordinates / its pose scale 2
SHADOW_SPHERES = (((0.0, 0.0, 0.0), 0.25), ((0.185, 0.11, 0.305), 0.09))


def two_sphere_grid(grid_cfg):
    """The analytic sdf of the shadow scene's two spheres on the nodes of
    ``grid_cfg`` (either package's ``GridConfig``; the nodes are the same
    float32 linspace axes), as (JAX array, torch tensor) holding the same
    values in the config's storage dtype (bf16 rounded once, by JAX)."""
    import jax.numpy as jnp

    R = grid_cfg.resolution
    axes = [np.linspace(grid_cfg.bbox_min[i], grid_cfg.bbox_max[i], R, dtype=np.float32)
            for i in range(3)]
    p = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    sdf = np.min([np.linalg.norm(p - np.float32(c), axis=-1) - np.float32(r)
                  for c, r in SHADOW_SPHERES], axis=0).astype(np.float32)
    jgrid = jnp.asarray(sdf)
    if grid_cfg.storage_dtype == "bfloat16":
        jgrid = jgrid.astype(jnp.bfloat16)
    tgrid = torch.as_tensor(np.array(jgrid.astype(jnp.float32)))
    if grid_cfg.storage_dtype == "bfloat16":
        tgrid = tgrid.to(torch.bfloat16)
    return jgrid, tgrid


def grid_atlas(n_tris: int) -> np.ndarray:
    """A trivial UV atlas for ``n_tris`` triangles: triangle t in cell t of
    a square grid of cells, its corners inset at three corners of the cell
    (uv [3 n_tris, 2], corner-major as ``atlas_parameterize`` returns it).
    Written as a mesh cache's ``uv.npz``, it spares a test the atlas's
    packing, which takes seconds whatever the mesh."""
    side = int(np.ceil(np.sqrt(n_tris)))
    t = np.arange(n_tris)
    base = np.stack([t % side, t // side], -1).astype(np.float32)
    corners = np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9]], np.float32)
    return ((base[:, None, :] + corners[None]) / side).reshape(-1, 2)


def two_sphere_tex_sampler(root, resolution: int = 256, mesh_res: int = 48):
    """The port's ``TexSampler`` at ``resolution`` on a marching-tetrahedra
    mesh of the shadow scene's two spheres in stage-1 coordinates (x 2),
    written to ``root/mesh.ply`` with ``grid_atlas`` in its cache."""
    import os

    from robir_tpu_torch.texture import mesh as tmesh
    from robir_tpu_torch.texture import native as tnative
    from robir_tpu_torch.texture import pipeline as tpipe

    axes = [np.linspace(-1.2, 1.2, mesh_res, dtype=np.float32)] * 3
    p = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    sdf = np.min([np.linalg.norm(p - 2 * np.float32(c), axis=-1) - 2 * np.float32(r)
                  for c, r in SHADOW_SPHERES], axis=0).astype(np.float32)
    mesh = tmesh.Mesh(*tnative.marching_tetrahedra(sdf, (-1.2,) * 3, (1.2,) * 3))
    mesh.export_ply(os.path.join(root, "mesh.ply"))
    os.makedirs(os.path.join(root, "mesh.cache"), exist_ok=True)
    np.savez(os.path.join(root, "mesh.cache", "uv.npz"), uv=grid_atlas(len(mesh.tris)),
             idx=mesh.tris.reshape(-1).astype(np.int32))
    return tpipe.TexSampler(os.path.join(root, "mesh.ply"), resolution)


def jax_view_draws(jax_model, dataset, views, chunk: int, compact: int, key, stage2_cfg,
                   n_lights: int, diffuse_nsamp: int = 32) -> list:
    """The draws of each chunk of a JAX chunked view render (``render_view``
    or ``tools/relight.py:relight_views``) from its key, in chunk order
    over ``views``: each chunk of ``chunk`` rays (the last padded by
    repeating its last ray) splits a key off ``key`` and draws as one
    compacted ``stage2_forward`` (``jax_stage2_draws`` at ``compact``, its
    surface rows those ``jax_model``'s trace hits)."""
    import jax

    trace = jax.jit(jax_model.trace)
    out = []
    for v in views:
        dirs, cam_loc = dataset.camera_rays(v)
        for start in range(0, dirs.shape[0], chunk):
            d = dirs[start:start + chunk]
            d = np.concatenate([d, np.repeat(d[-1:], chunk - d.shape[0], 0)])
            hit = np.asarray(trace(np.broadcast_to(cam_loc, d.shape), d)[1])
            key, k = jax.random.split(key)
            out.append(jax_stage2_draws(k, chunk, stage2_cfg, n_lights,
                                        diffuse_nsamp=diffuse_nsamp, surface=hit,
                                        chunk=compact))
    return out


# the reference's Sequential (Linear, activation) stacks by the segment the
# parameter tree names them (robir_tpu_torch/core/import_ref.py:_SEQ2's inverse)
_REF_SEQ2 = {"encoder": "brdf_encoder_layer", "decoder": "brdf_decoder_layer",
             "lobe_layer": "lobe_layer", "energy": "mlp"}
_REF_SEQ1 = {"pts_lin": "pts_linears", "views_lin": "views_linears"}
_REF_RENAME = {"feature": "feature_linear", "alpha": "alpha_linear", "rgb": "rgb_linear"}


def reference_key(path: str):
    """The inverse of ``import_ref._map_key``: a '/'-joined path of the
    parameter tree -> (the reference's dotted state-dict key, the value's
    transform into the reference's layout: ``w``/``v`` transposed, ``g``
    as [out, 1]). Check code: it builds reference checkpoints from the
    port's trees, so that no reference checkpoint is needed."""
    import re

    parts = path.split("/")
    out = []
    i = 0
    while i < len(parts) - 1:
        p, nxt = parts[i], parts[i + 1]
        lin = re.fullmatch(r"lin(\d+)", nxt) if i + 1 < len(parts) - 1 else None
        seq1 = re.fullmatch(r"(pts_lin|views_lin)(\d+)", p)
        if lin and (p in _REF_SEQ2 or p == "visibility_network"):
            out += [p, "vis_layer"] if p == "visibility_network" else [_REF_SEQ2[p]]
            out.append(str(2 * int(lin.group(1))))
            i += 2
        elif seq1:
            out += [_REF_SEQ1[seq1.group(1)], seq1.group(2)]
            i += 1
        else:
            out.append(_REF_RENAME.get(p, p))
            i += 1
    if out[:1] == ["implicit_network"]:
        out.insert(1, "neus_model")
    leaf = parts[-1]
    if leaf == "adapt_illum" and parts[-2:-1] == ["gamma"]:
        out.append("hdr_shift")
    if leaf in ("w", "v"):
        return ".".join(out + ["weight" if leaf == "w" else "weight_v"]), \
            lambda a: np.ascontiguousarray(a.T)
    if leaf == "g":
        return ".".join(out + ["weight_g"]), lambda a: a.reshape(-1, 1)
    return ".".join(out + ["bias" if leaf == "b" else leaf]), lambda a: a


def reference_state_dict(tree) -> dict:
    """A parameter tree (nested dicts of arrays or tensors) as the
    reference's torch state dict (``reference_key`` of every leaf)."""
    from robir_tpu_torch.core.tree import flatten_with_paths

    sd = {}
    for path, leaf in flatten_with_paths(tree).items():
        key, xform = reference_key(path)
        sd[key] = torch.from_numpy(np.array(xform(to_np(leaf)), np.float32))
    return sd

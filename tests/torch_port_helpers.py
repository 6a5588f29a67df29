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


def write_llff_scene(root, n: int = 24, h: int = 120, w: int = 160, seed: int = 0,
                     focal: float = 100.0) -> str:
    """A forward-facing LLFF capture from ``seed`` under ``root``:
    ``images/NNN.png`` (smooth colour ramps with noise) and
    ``poses_bounds.npy`` (cameras near z = 0 looking along -z, in LLFF's raw
    [down, right, back] column layout with hwf appended, and per-view
    bounds). Returns ``root`` as a string."""
    import os

    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    rows = []
    for i in range(n):
        base = np.stack([xx, yy, 0.5 + 0.5 * np.sin(6 * xx + i)], -1)
        img = np.clip(base + 0.05 * rng.standard_normal((h, w, 3)), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i:03d}.png"))
        t = np.array([0.3 * (i - n / 2) / n, 0.02 * i, 0.1 * rng.random()])
        m = np.stack([[0, -1.0, 0], [1.0, 0, 0], [0, 0, 1.0]], 1)  # [down right back]
        pose = np.concatenate([m, t[:, None], np.array([[h], [w], [focal]])], 1)
        rows.append(np.concatenate([pose.ravel(), [2.0 + 0.1 * i, 12.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return str(root)


def write_multicam_scene(root, sizes=((16, 20), (24, 30)), n_train: int = 2,
                         n_test: int = 2, seed: int = 0) -> str:
    """A Multicam scene from ``seed`` under ``root``: ``metadata.json`` with
    per-image ``pix2cam``/``cam2world``/``width``/``height``/``lossmult``/
    ``near``/``far`` for the train and test splits, the images cycling
    through ``sizes`` ((h, w) each: ragged resolutions), as RGBA PNGs under
    ``imgs/``. Returns ``root`` as a string."""
    import json
    import os

    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    keys = ("file_path", "pix2cam", "cam2world", "width", "height", "lossmult", "near",
            "far")
    meta = {s: {k: [] for k in keys} for s in ("train", "test")}
    n = 0
    for split, count in (("train", n_train), ("test", n_test)):
        for i in range(count):
            h, w = sizes[i % len(sizes)]
            img = (rng.random((h, w, 4)) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "imgs", f"{n}.png"))
            focal = 0.5 * w
            pix2cam = np.linalg.inv(np.array([[focal, 0, w / 2], [0, focal, h / 2],
                                              [0, 0, 1.0]]))
            th = 2 * np.pi * n / (n_train + n_test)
            c2w = np.eye(4)[:3]
            c2w[:, 3] = [0.3 * np.cos(th), 0.3 * np.sin(th), 2.0 + 0.1 * n]
            c2w[:, :3] = np.diag([1.0, -1.0, -1.0])  # looking along -z
            m = meta[split]
            for k, v in zip(keys, (f"imgs/{n}.png", pix2cam.tolist(), c2w.tolist(), w, h,
                                   1.0, 1.0, 6.0)):
                m[k].append(v)
            n += 1
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return str(root)


def grab_grads():
    """An optax 'optimizer' that leaves the parameters and returns the
    gradients as its state, so a JAX train step hands them out exactly."""
    import jax
    import jax.numpy as jnp
    import optax
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def assert_grads_match(tparams, jgrads, rtol: float = 5e-4, scale_atol: float = 5e-4):
    """Every leaf gradient of the port's ``ParamTree`` against the JAX
    gradient tree at its path: rtol ``rtol`` and an atol of ``scale_atol``
    of the JAX tensor's largest entry; both trees have the same paths."""
    from robir_tpu_torch.core.tree import flatten_with_paths
    want = flatten_with_paths(jgrads)
    got = flatten_with_paths(tparams)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        w = np.asarray(want[path])
        g = np.zeros_like(w) if leaf.grad is None else to_np(leaf.grad)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=scale_atol * float(np.abs(w).max()),
                                   err_msg=path)


# -- data-parallel ranks ---------------------------------------------------
# The functions below run on spawned ranks (``core/mesh.py:spawn_ranks``),
# which import them by path: they import nothing of JAX, and their inputs
# and results are numpy arrays, floats and configs.

def each(mesh, *calls):
    """Run ``fn(mesh, *args)`` for each ``(fn, args)`` of ``calls`` on one
    rank, in order; returns their results (one spawn for several runs)."""
    return [fn(mesh, *args) for fn, args in calls]


def flat_params(tree) -> dict:
    from robir_tpu_torch.core.tree import flatten_with_paths
    return {k: v.detach().cpu().numpy().copy() for k, v in flatten_with_paths(tree).items()}


def flat_grads(tree) -> dict:
    """Each leaf's gradient (zeros where it has none), flat."""
    from robir_tpu_torch.core.tree import flatten_with_paths
    return {k: (np.zeros(tuple(v.shape), np.float32) if v.grad is None
                else v.grad.detach().cpu().numpy().copy())
            for k, v in flatten_with_paths(tree).items()}


def rank_train_step(mesh, params, model_cfg, render_cfg, train_cfg, batch, given, step=0):
    """One stage-1 ``train_step`` on this rank's rows of ``batch`` (a
    RayBatch of numpy arrays, the global batch) with the global draws
    ``given``; returns (metrics, the summed gradients, flat)."""
    from robir_tpu_torch.core.draws import Draws
    from robir_tpu_torch.core.mesh import batch_split
    from robir_tpu_torch.data.blender import RayBatch
    from robir_tpu_torch.fields.neus_model import NeuS
    from robir_tpu_torch.stages import neus_stage as tstage
    model = NeuS(params, model_cfg, mesh.device)
    opt, lr_fn = tstage.make_optimizer(model.parameters(), train_cfg)
    rows = mesh.local_slice(len(batch[0]))
    local = RayBatch(*[torch.as_tensor(np.asarray(x)[rows], device=mesh.device) for x in batch])
    draws = Draws(given={k: torch.as_tensor(v) for k, v in given.items()}, device=mesh.device,
                  split=batch_split(mesh, rows.stop - rows.start))
    metrics = tstage.train_step(model, opt, lr_fn, local, step, train_cfg, render_cfg, draws,
                                mesh=mesh)
    return {k: float(v) for k, v in metrics.items()}, flat_grads(model.params)


def rank_trainer_run(mesh, scene_kw, model_cfg, render_cfg, train_cfg, steps: int):
    """``NeusTrainer(mesh=mesh)`` on the in-memory sphere scene for
    ``steps`` steps; returns (its flat parameters, the last metrics)."""
    from robir_tpu_torch.core.mesh import check_replicas
    from robir_tpu_torch.data.synthetic import make_sphere_scene
    from robir_tpu_torch.stages.neus_stage import NeusTrainer
    trainer = NeusTrainer(make_sphere_scene("train", **scene_kw), model_cfg, render_cfg,
                          train_cfg, device="cpu", mesh=mesh)
    try:
        metrics = trainer.run(steps)
    finally:
        trainer.close()
    check_replicas(mesh, "the stage-1 parameters", trainer.model.parameters())
    return flat_params(trainer.model.params), metrics


def small_stage2_cfg(tracer: str = "grid"):
    """The stage-2 widths of ``test_torch_cesr.py`` (8 SG lights, 32-wide
    nets), with the grid tracer at configs/hotdog.json's settings at 32^3."""
    from robir_tpu_torch.fields import sdf as tsdf
    from robir_tpu_torch.fields.envmap_material import EnvmapMaterialConfig
    from robir_tpu_torch.fields.neus_model import NeuSConfig
    from robir_tpu_torch.fields.radiance import RenderingConfig
    from robir_tpu_torch.fields.visibility import IndirIllumConfig, VisNetConfig
    from robir_tpu_torch.render.color import ToneMapConfig
    from robir_tpu_torch.render.stage2 import Stage2Config
    from robir_tpu_torch.tracing.grid import GridConfig
    return Stage2Config(
        neus=NeuSConfig(sdf=tsdf.SDFConfig(d_out=33, d_hidden=32, n_layers=3, skip_in=(2,),
                                           multires=3),
                        color=RenderingConfig(d_feature=32, d_hidden=32, n_layers=2)),
        envmap=EnvmapMaterialConfig(multires=3, num_lgt_sgs=8, encoder_dims=(48, 48),
                                    decoder_dims=(24,), latent_dim=8),
        indirect=IndirIllumConfig(multires=3, dims=(32, 32), num_lgt_sgs=6),
        visnet=VisNetConfig(points_multires=3, dirs_multires=3, dims=(32, 32)),
        tonemap=ToneMapConfig(hdr_mode=0), tracer=tracer,
        grid=GridConfig(resolution=32, max_steps=64, storage_dtype="bfloat16", quad_rows=True))


def small_cesr_stage(**kw):
    """A CESR stage config with ``test_torch_cesr.py``'s narrow 3 x 96
    shadow and normal nets (PE 10 of the points, 63 inputs)."""
    import dataclasses

    from robir_tpu_torch.fields.sdf import SDFConfig
    from robir_tpu_torch.stages.cesr import CESRStageConfig

    net = dict(d_hidden=96, n_layers=3, skip_in=(2,), multires=0)

    @dataclasses.dataclass(frozen=True)
    class Small(CESRStageConfig):
        @property
        def shadow_cfg(self):
            return SDFConfig(d_in=63 + self.num_lights, d_out=2, **net)

        @property
        def normal_cfg(self):
            return SDFConfig(d_in=63, d_out=3, **net)

    return Small(**kw)


def rank_stage2_run(mesh, stage: str, stage_kw: dict, steps: int, tex_root=None,
                    seed: int = 0):
    """A stage-2 runner of ``stage`` ("pbr", "cesr", "vis" or "norm") at
    ``small_stage2_cfg`` on the shadow scene (4 views, 32 x 32) and the
    two-sphere grid, from seeded weights, for ``steps`` steps, one rank of
    ``mesh`` (None: one process); the Vis energy prologue 3 steps, the Norm
    sampler the texture of ``tex_root/mesh.ply`` at 64^2, which
    ``two_sphere_tex_sampler(tex_root, 64)`` wrote beforehand (the ranks
    read it). Returns (its flat parameters, each step's metrics as
    floats)."""
    import os

    from robir_tpu_torch.core.mesh import check_replicas
    from robir_tpu_torch.data.syn_dataset import shadow_scene
    from robir_tpu_torch.stages import cesr as tcesr
    from robir_tpu_torch.stages import norm as tnorm
    from robir_tpu_torch.stages import pbr as tpbr
    from robir_tpu_torch.stages import vis as tvis
    from robir_tpu_torch.stages.stage2_runner import StageOptConfig, init_stage2_params
    from robir_tpu_torch.core.params import to_numpy
    from robir_tpu_torch.texture.focus_sampler import TexSpaceSampler
    from robir_tpu_torch.texture.pipeline import TexSampler

    cfg = small_stage2_cfg()
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(seed), cfg))
    ds = shadow_scene(n_train=4, h=32, w=32)
    kw = dict(stage_kw, opt=StageOptConfig(lr=1e-3))
    if stage == "pbr":
        runner = tpbr.PBRRunner(cfg, params, ds, tpbr.PBRStageConfig(**kw), device="cpu",
                                mesh=mesh)
    elif stage == "cesr":
        runner = tcesr.CESRRunner(cfg, params, ds, small_cesr_stage(
            num_lights=8, warmup_iters=1, explore_iter=4, proj_iter=1, normal_switch_iter=2,
            dropout_iter=3, **kw), device="cpu", mesh=mesh)
    elif stage == "vis":
        runner = tvis.VisRunner(cfg, params, ds, tvis.VisStageConfig(**kw), device="cpu",
                                mesh=mesh)
        runner.fit_energy_prologue(3)
    else:
        sampler = TexSpaceSampler(TexSampler(os.path.join(tex_root, "mesh.ply"), 64), None,
                                  None, device="cpu")
        runner = tnorm.NormRunner(cfg, params, sampler, tnorm.NormStageConfig(**kw),
                                  device="cpu", mesh=mesh)
    runner.grid_values = two_sphere_grid(cfg.grid)[1]
    metrics = [{k: float(v) for k, v in runner.run(1).items()} for _ in range(steps)]
    check_replicas(mesh, f"the {stage} parameters", runner.params.parameters())
    return flat_params(runner.params), metrics


def rank_pbr_step(mesh, cfg, params, dataset_kw, batch, given, stage_kw, grid):
    """One dense ``PBRRunner.step`` on this rank's rows of ``batch`` (numpy,
    global) with the global draws ``given`` on ``grid``; returns (metrics,
    the summed gradients, flat)."""
    from robir_tpu_torch.core.draws import Draws
    from robir_tpu_torch.core.mesh import batch_split
    from robir_tpu_torch.data.syn_dataset import shadow_scene
    from robir_tpu_torch.stages import pbr as tpbr
    runner = tpbr.PBRRunner(cfg, params, shadow_scene(**dataset_kw),
                            tpbr.PBRStageConfig(**stage_kw), device="cpu", mesh=mesh)
    runner.grid_values = torch.as_tensor(grid)
    rows = mesh.local_slice(stage_kw["num_pixels"])
    local = {k: torch.as_tensor(np.asarray(v)[rows]) for k, v in batch.items()}
    draws = Draws(given={k: torch.as_tensor(v) for k, v in given.items()},
                  split=batch_split(mesh, rows.stop - rows.start))
    metrics = runner.step(local, draws)
    return {k: float(v) for k, v in metrics.items()}, flat_grads(runner.params)


def rank_ae_kl(mesh, latent):
    """``ae_kl_divergence`` on this rank's rows of the global ``latent`` (numpy)
    under ``mesh``: (its value, its gradient on those rows)."""
    from robir_tpu_torch.fields.sparse_ae import ae_kl_divergence
    x = torch.as_tensor(np.asarray(latent)[mesh.local_slice(len(latent))]).requires_grad_(True)
    value = ae_kl_divergence(x, 0.05, mesh)
    value.backward()
    return float(value), x.grad.numpy().copy()


def rank_inv_losses(mesh, g, sdf, net, obj, nmap):
    """InvLoss's eikonal, mask and normal-consistency terms on this rank's
    rows of the global numpy inputs under ``mesh`` (None: all of them):
    their values."""
    from robir_tpu_torch.stages import losses
    rows = slice(None) if mesh is None else mesh.local_slice(len(g))
    g, sdf, net, obj, nmap = (torch.as_tensor(np.asarray(a)[rows])
                              for a in (g, sdf, net, obj, nmap))
    return (float(losses.eikonal_loss(g, mesh)),
            float(losses.mask_loss(losses.InvLossConfig(), sdf, net, obj, mesh)),
            float(losses.normal_consistency_loss(nmap, g, obj, mesh)))


def rank_neus_surface(mesh, points, view_dirs, normals):
    """``get_neus_surface``'s gradient error on this rank's rows of the
    global ``points``, ``view_dirs`` and ``normals`` (numpy) under ``mesh``
    (None: all of them), on a seeded NeuS at ``small_stage2_cfg``."""
    from robir_tpu_torch.core.params import to_numpy
    from robir_tpu_torch.render.stage2 import Stage2Model
    from robir_tpu_torch.stages.norm import get_neus_surface
    from robir_tpu_torch.stages.stage2_runner import init_stage2_params
    cfg = small_stage2_cfg()
    model = Stage2Model(to_numpy(init_stage2_params(torch.Generator().manual_seed(0), cfg)),
                        cfg, "cpu")
    rows = slice(None) if mesh is None else mesh.local_slice(len(points))
    x, d, n = (torch.as_tensor(np.asarray(a)[rows]) for a in (points, view_dirs, normals))
    with torch.no_grad():
        return float(get_neus_surface(model, x, d, n, mesh=mesh)[2])


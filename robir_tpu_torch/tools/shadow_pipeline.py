"""The shadow-removal pipeline end to end on the procedural two-sphere scene,
scored against its analytic ground truth (the port's counterpart of the
repository's ``tools/shadow_pipeline.py``, with the same configuration,
steps, metrics and quality gates):

- NeuS: the test PSNR and the mesh's distance to the two analytic spheres;
- Vis: the mean predicted visibility at analytically lit and at occluded
  front-facing directions;
- PBR and CESR: the albedo's shadow/lit ratio across the cast-shadow
  boundary (1.0: the shadow is gone from the reflectance), its chroma
  cosine and its scale-invariant PSNR against the true albedo; the baked
  albedo map's PSNR;
- relighting: the mean relit PSNR against the test split's relit ground
  truth under an SG stand-in for the alternate light.

Every stage runs through ``robir_tpu_torch.cli.main`` on ``--device``
(``cuda`` unless ``cpu`` is given; it raises without a card). Writes
``<out>/pipeline_metrics.json``, prints it, and exits 1 when a gate fails
(unless ``--no_gates``).

    python -m robir_tpu_torch.tools.shadow_pipeline [--out D] [--fast] [--plain]
        [--no_gates] [--seed N] [--vis_iters N] [--pbr_iters N] [--cesr_iters N]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# the scene's constants (data/synthetic.py:render_two_sphere_gt's defaults)
CENTERS = [np.array([0.0, 0.0, 0.0]), np.array([0.37, 0.22, 0.61])]
RADII = [0.5, 0.18]
ALBEDO0 = np.array([0.8, 0.3, 0.2])
LIGHT = np.array([0.5, 0.3, 0.8]) / np.linalg.norm([0.5, 0.3, 0.8])


def analytic_hit(o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Whether each ray (o, d) meets either sphere ahead of it."""
    hit = np.zeros(o.shape[0], bool)
    for c, r in zip(CENTERS, RADII):
        oc = o - c
        b = 2 * np.sum(oc * d, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = b * b - 4 * cc
        t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
        t2 = (-b + np.sqrt(np.maximum(disc, 0))) / 2
        hit |= (disc > 0) & ((t > 1e-3) | (t2 > 1e-3))
    return hit


def surface_samples(n: int, seed: int = 3):
    """``n`` world points on the main sphere and their normals."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    return p * RADII[0], p


def conf_dict(fast: bool) -> dict:
    """The pipeline's configuration: the full schedule, or ``fast``'s
    narrow widths and short schedule."""
    neus = {
        "sdf": {"d_out": 129, "d_hidden": 128, "n_layers": 4, "skip_in": [2],
                "multires": 6, "bias": 0.5, "storage_dtype": "bfloat16"},
        "color": {"d_feature": 128, "d_hidden": 128, "n_layers": 3,
                  "storage_dtype": "bfloat16"},
        "radius": 2.0,
    }
    d = {
        "dataset": {"pose_scale": 2.0, "batch_size": 512, "near": 2.0, "far": 6.0,
                    "white_bkgd": True, "alpha_as_mask": True},
        "model": {
            "neus": neus,
            "envmap_material_network": {"multires": 6, "num_lgt_sgs": 32,
                                        "encoder_dims": [128, 128], "decoder_dims": [64],
                                        "latent_dim": 16},
            "indirect_illum_network": {"multires": 6, "dims": [128, 128], "num_lgt_sgs": 12},
            "visibility_network": {"points_multires": 6, "dirs_multires": 4,
                                   "dims": [256, 256, 256, 256],
                                   "storage_dtype": "bfloat16"},
            "tonemap": {"hdr_mode": 0, "gamma": 1.0},
            "grid": {"resolution": 224, "bbox_min": [-0.45] * 3, "bbox_max": [0.45] * 3,
                     "quad_rows": True},
        },
        "render": {"n_samples": 64, "n_importance": 64, "up_sample_steps": 4,
                   "white_bkgd": True},
        "train": {"batch_size": 512, "max_steps": 4000, "lr_init": 5e-4,
                  "lr_delay_steps": 500, "anneal_end": 1000, "eval_chunk": 4608,
                  "eval_every": 0, "ckpt_every": 1_000_000, "eikonal_weight": 0.1,
                  "silhouette_weight": 1.0},
        "texture_resolution": 512,
        "norm": {"num_pixels": 512, "max_iters": 500, "smooth_after": 100,
                 "opt": {"lr": 5e-4}},
        "vis": {"num_pixels": 256, "nsamp": 512, "opt": {"lr": 5e-4}},
        "pbr": {"num_pixels": 1024, "opt": {"lr": 5e-4}},
        "cesr": {"num_pixels": 1024, "opt": {"lr": 5e-4}, "explore_iter": 100,
                 "proj_iter": 50, "warmup_iters": 100, "normal_switch_iter": 200,
                 "dropout_iter": 150},
    }
    if fast:
        d["model"]["neus"]["sdf"].update(d_out=33, d_hidden=32, n_layers=3, skip_in=[],
                                         multires=3)
        d["model"]["neus"]["color"].update(d_feature=32, d_hidden=32, n_layers=2)
        d["model"]["envmap_material_network"].update(
            num_lgt_sgs=16, encoder_dims=[64, 64], decoder_dims=[32], latent_dim=8,
            multires=4)
        d["model"]["indirect_illum_network"].update(dims=[32, 32], num_lgt_sgs=8, multires=4)
        d["model"]["visibility_network"].update(dims=[64, 64])
        d["model"]["grid"].update(resolution=96)
        d["train"].update(max_steps=300, batch_size=128)
        d["dataset"]["batch_size"] = 128
        d["render"].update(n_samples=24, n_importance=24, up_sample_steps=2)
        d["norm"].update(max_iters=40, num_pixels=128)
        d["vis"].update(nsamp=64, num_pixels=64)
        d["pbr"].update(num_pixels=128)
        d["cesr"].update(num_pixels=128, explore_iter=10, proj_iter=5, warmup_iters=5,
                         normal_switch_iter=8, dropout_iter=12)
    return d


def make_relight_envmap(env_dir: str) -> str:
    """The analytic 'envmap6' (the relit ground truth's light): a sharp lobe
    about the alternate light direction carrying the 0.8 directional term
    and a broad one carrying the 0.2 ambient floor, written as
    ``<env_dir>/envmap6/sg_128.npy`` and ``<env_dir>/envmap6.exr``;
    returns ``<env_dir>/envmap6``."""
    from ..data.synthetic import RELIT_LIGHT_DIRS
    from ..render.sg import compute_envmap
    from ..utils.exr import write_exr

    ld = np.asarray(RELIT_LIGHT_DIRS["envmap6"], np.float32)
    ld = ld / np.linalg.norm(ld)
    sgs = np.zeros((2, 7), np.float32)
    sgs[0, :3] = ld
    sgs[0, 3] = 40.0
    sgs[0, 4:] = 0.8 * 40.0 / (2 * np.pi * (1 - np.exp(-2 * 40.0)))  # about its flux
    sgs[1, :3] = [0, 0, 1]
    sgs[1, 3] = 0.01
    sgs[1, 4:] = 0.2 / np.pi
    path = os.path.join(env_dir, "envmap6")
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "sg_128.npy"), sgs)
    with torch.no_grad():
        img = compute_envmap(torch.as_tensor(sgs), 64, 128).numpy()
    write_exr(path + ".exr", img.astype(np.float32))
    return path


# The quality gates, as the JAX pipeline states them. Full schedule: set
# on that pipeline's measured full-schedule runs; fast: loose sanity floors
# for a short smoke run.
GATES_FULL = {
    "vis_mean_at_lit_front": (">=", 0.95),
    "albedo_shadow_lit_ratio_cesr": ("range", (0.90, 1.21)),
    "relit_psnr_masked": (">=", 16.0),
    "albedo_psnr_cesr": (">=", 19.0),
    "mesh_err_median": ("<=", 0.03),
}
# the textured scene is harder for CESR (texture and shadow to tell apart)
GATES_FULL_TEXTURED_OVERRIDES = {
    "albedo_shadow_lit_ratio_cesr": ("range", (0.90, 1.25)),
    "relit_psnr_masked": (">=", 17.5),
    "albedo_psnr_cesr": (">=", 15.0),
}
GATES_FAST = {
    "vis_mean_at_lit_front": (">=", 0.10),
    "albedo_shadow_lit_ratio_cesr": ("range", (0.6, 1.8)),
    "relit_psnr_masked": (">=", 8.0),
    "albedo_psnr_cesr": (">=", 14.0),
    "mesh_err_median": ("<=", 0.085),
}


def check_gates(metrics: dict, fast: bool) -> list[str]:
    """The failed gates' descriptions (empty: every gate passed). Also adds
    to ``metrics["warnings"]`` a notice where a full textured run's CESR
    ratio passes its textured gate but exceeds the plain scene's bound."""
    gates = GATES_FAST if fast else GATES_FULL
    warnings = metrics.setdefault("warnings", [])
    if not fast and metrics.get("textured"):
        ratio = metrics.get("albedo_shadow_lit_ratio_cesr")
        plain_hi = GATES_FULL["albedo_shadow_lit_ratio_cesr"][1][1]
        if ratio is not None and ratio > plain_hi:
            warnings.append(
                f"albedo_shadow_lit_ratio_cesr {ratio:.4g} exceeds the "
                f"plain-scene bound {plain_hi} (textured gate is looser; "
                f"watch the cross-round drift 1.02 -> 1.11 -> 1.187)")
        gates = {**gates, **GATES_FULL_TEXTURED_OVERRIDES}
    vals = dict(metrics)
    rel = metrics.get("relight") or {}
    if "mean_relit_psnr_masked" in rel:
        vals["relit_psnr_masked"] = rel["mean_relit_psnr_masked"]
    failures = []
    for key, (op, bound) in gates.items():
        v = vals.get(key)
        if v is None:
            failures.append(f"{key}: missing")
            continue
        ok = (v >= bound if op == ">=" else
              v <= bound if op == "<=" else
              bound[0] <= v <= bound[1])
        if not ok:
            failures.append(f"{key}: {v:.4g} violates {op} {bound}")
    return failures


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="shadow_pipeline_out")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="constant albedo; the default is the textured_albedo main sphere")
    ap.add_argument("--no_gates", action="store_true",
                    help="emit metrics without asserting the quality gates")
    ap.add_argument("--seed", type=int, default=0, help="training seed passed to every stage")
    ap.add_argument("--vis_iters", type=int, default=None)
    ap.add_argument("--pbr_iters", type=int, default=None)
    ap.add_argument("--cesr_iters", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from .. import cli, resolve_device
    from ..core import checkpoint as ckpt_lib
    from ..core.config import build_stage2_config
    from ..core.params import from_jax
    from ..data.synthetic import make_shadow_dataset, textured_albedo
    from ..fields.neus_model import NeuS
    from ..fields.sdf import frozen_sdf
    from ..fields.visibility import visnet_apply
    from ..render.stage2 import Stage2Model
    from ..stages.stage2_runner import init_stage2_params
    from ..texture.mesh import extract_mesh
    from ..texture.pipeline import TexSampler, bilinear_sample
    from .tex_extract import extract_textures

    device = resolve_device(args.device)
    t_start = time.time()
    os.makedirs(args.out, exist_ok=True)
    scene = os.path.join(args.out, "scene")
    logs = os.path.join(args.out, "logs")
    textured = not args.plain
    if not os.path.exists(os.path.join(scene, "transforms_train.json")):
        sz = 64 if args.fast else 96
        make_shadow_dataset(scene, n_train=16, n_test=2, h=sz, w=sz, textured=textured)

    conf = conf_dict(args.fast)
    conf_path = os.path.join(args.out, "conf.json")
    with open(conf_path, "w") as fp:
        json.dump(conf, fp, indent=1)

    metrics = {"fast": args.fast, "textured": textured}

    def stage(name, argv):
        t0 = time.time()
        print(f"=== {name}: {' '.join(argv)}", flush=True)
        cli.main(argv)
        if device.type == "cuda":
            torch.cuda.synchronize()
        metrics[f"{name}_seconds"] = round(time.time() - t0, 1)

    common = ["--conf", conf_path, "--data", scene, "--log_dir", logs, "--seed", str(args.seed),
              "--device", args.device]
    metrics["seed"] = args.seed
    n_iters = {"neus": conf["train"]["max_steps"], "norm": conf["norm"]["max_iters"],
               "vis": args.vis_iters or (60 if args.fast else 800),
               "pbr": args.pbr_iters or (120 if args.fast else 2000),
               "cesr": args.cesr_iters or (80 if args.fast else 600)}

    stage("neus", ["neus", *common, "--n_iters", str(n_iters["neus"])])
    desc = os.path.join(logs, "NeuS", "neus", "description.json")
    if os.path.exists(desc):
        with open(desc) as f:
            metrics["neus_test"] = json.load(f)

    # the mesh in stage-1 (world) coordinates: TexSampler scales by 0.5
    # into stage 2's itself
    t0 = time.time()
    s1_cfg = cli._stage1_configs(conf)[0]
    loaded = ckpt_lib.load(ckpt_lib.latest_path(os.path.join(logs, "NeuS")))[0]
    s1_model = NeuS(loaded["params"], s1_cfg, device)
    world_mesh = extract_mesh(frozen_sdf(s1_model.params["sdf_network"], s1_cfg.sdf, out_cols=1),
                              bbox_min=(-0.95,) * 3, bbox_max=(0.95,) * 3,
                              resolution=128 if args.fast else 256, device=device)
    scale = conf["dataset"]["pose_scale"]
    mesh_path = os.path.join(args.out, "mesh.ply")
    world_mesh.export_ply(mesh_path)
    metrics["mesh_seconds"] = round(time.time() - t0, 1)

    # the mesh's distance to the analytic spheres (world coordinates)
    v = np.asarray(world_mesh.verts)
    d_an = np.minimum(np.abs(np.linalg.norm(v - CENTERS[0], axis=-1) - RADII[0]),
                      np.abs(np.linalg.norm(v - CENTERS[1], axis=-1) - RADII[1]))
    metrics["mesh_err_median"] = float(np.median(d_an))
    metrics["mesh_err_p90"] = float(np.percentile(d_an, 90))

    stage("norm", ["norm", *common, "--mesh", mesh_path, "--n_iters", str(n_iters["norm"])])
    stage("vis", ["vis", *common, "--n_iters", str(n_iters["vis"])])
    stage("pbr", ["pbr", *common, "--n_iters", str(n_iters["pbr"])])

    # -- the Vis net's confidence against analytic occlusion -------------
    cfg2 = build_stage2_config(conf["model"])

    def stage2_params(ckpt_path):
        return ckpt_lib.restore_into(init_stage2_params(torch.Generator().manual_seed(0), cfg2),
                                     ckpt_path, ignore_unknown=True)[0]

    params2 = stage2_params(os.path.join(logs, "Vis", "checkpoints", "latest.npz"))
    n, S = 400, 128
    pts_w, normals = surface_samples(n)
    rng = np.random.default_rng(5)
    dirs = rng.standard_normal((n, S, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    front = np.einsum("nd,nsd->ns", normals, dirs) > 0.05
    occ = analytic_hit(np.repeat(pts_w + 0.01 * normals, S, 0),
                       dirs.reshape(-1, 3)).reshape(n, S)
    with torch.no_grad():
        logits = visnet_apply(
            from_jax(params2["visibility_network"], device), cfg2.visnet,
            torch.as_tensor(np.repeat(pts_w / scale, S, 0), dtype=torch.float32, device=device),
            torch.as_tensor(dirs.reshape(-1, 3), dtype=torch.float32, device=device))
        pv = torch.softmax(logits.float(), -1)[:, 1].cpu().numpy().reshape(n, S)
    metrics["vis_mean_at_lit_front"] = float(pv[front & ~occ].mean())
    metrics["vis_mean_at_occluded_front"] = float(pv[front & occ].mean())

    # -- the albedo's shadow/lit ratio (PBR, then CESR) ---------------------
    def gt_albedo(pts_world):
        if textured:
            return textured_albedo(pts_world)
        return np.broadcast_to(ALBEDO0, pts_world.shape).astype(np.float32)

    def diffuse_albedo(p, pts_s2):
        with torch.no_grad():
            mat = Stage2Model(p, cfg2, device).material(
                torch.as_tensor(pts_s2, dtype=torch.float32, device=device), None)
            return mat.diffuse_albedo.cpu().numpy()

    def albedo_metrics(ckpt_path):
        """(shadow/lit ratio, chroma cosine, scale-invariant albedo PSNR).
        The ratio divides out the true pattern first (prediction / truth
        per point), so it isolates the shadow baked into the albedo on
        either scene; the PSNR fits one global scale (reflectance is
        recovered up to the light's intensity)."""
        p = stage2_params(ckpt_path)
        pts_all, nrm_all = surface_samples(4096, seed=11)
        # the analytic cast shadow toward the training light
        shadow = analytic_hit(pts_all + 1e-3 * nrm_all,
                              np.broadcast_to(LIGHT, pts_all.shape).copy())
        lit_side = nrm_all @ LIGHT > 0.2
        sel_shadow = shadow & lit_side
        sel_lit = ~shadow & lit_side
        alb = diffuse_albedo(p, pts_all / scale)
        gt = gt_albedo(pts_all)
        mean_lit = alb[sel_lit].mean(0)
        gt_lit = gt[sel_lit].mean(0)
        chroma = float(mean_lit @ gt_lit / (np.linalg.norm(mean_lit) * np.linalg.norm(gt_lit)
                                            + 1e-9))
        rel = alb / np.clip(gt, 1e-3, None)
        sscale = float((alb * gt).sum() / np.clip((alb * alb).sum(), 1e-9, None))
        mse = float(np.mean((sscale * alb - gt) ** 2))
        psnr = -10 * np.log10(mse + 1e-12)
        if sel_shadow.sum() < 10 or sel_lit.sum() < 10:
            return None, chroma, psnr
        ratio = float(rel[sel_shadow].mean() / (rel[sel_lit].mean() + 1e-9))
        return ratio, chroma, psnr

    r, c, ps = albedo_metrics(os.path.join(logs, "PBR", "checkpoints", "latest.npz"))
    metrics["albedo_shadow_lit_ratio_pbr"] = r
    metrics["albedo_chroma_cos_pbr"] = c
    metrics["albedo_psnr_pbr"] = ps

    stage("cesr", ["cesr", *common, "--n_iters", str(n_iters["cesr"])])
    cesr_ckpt = os.path.join(logs, "CESR", "checkpoints", "latest.npz")
    r, c, ps = albedo_metrics(cesr_ckpt)
    metrics["albedo_shadow_lit_ratio_cesr"] = r
    metrics["albedo_chroma_cos_cesr"] = c
    metrics["albedo_psnr_cesr"] = ps

    # -- the baked albedo map against the true pattern at its texels -------
    t0 = time.time()
    p_cesr = stage2_params(cesr_ckpt)
    tex_res = 128 if args.fast else 256
    extract_textures(p_cesr, cfg2, mesh_path, os.path.join(args.out, "textures"),
                     resolution=tex_res, chunk=16384, device=device)
    sampler = TexSampler(mesh_path, tex_res)
    uu, vv = np.meshgrid(np.linspace(0, 1, tex_res, dtype=np.float32),
                         np.linspace(0, 1, tex_res, dtype=np.float32), indexing="xy")
    uv = np.stack([uu, vv], -1).reshape(-1, 2)
    tex_s2 = bilinear_sample(sampler.vert, uv) * sampler.coord_scale
    tex_mask = bilinear_sample(sampler.maskf, uv)[:, 0] > 0.5
    # the main sphere's texels only (the true pattern lives there)
    tex_world = tex_s2 * scale
    on_main = (np.abs(np.linalg.norm(tex_world - CENTERS[0], axis=-1) - RADII[0]) < 0.1) \
        & tex_mask
    alb_map = diffuse_albedo(p_cesr, tex_s2[on_main])
    gt_map = gt_albedo(tex_world[on_main])
    sm = float((alb_map * gt_map).sum() / np.clip((alb_map * alb_map).sum(), 1e-9, None))
    metrics["albedo_map_psnr_cesr"] = float(
        -10 * np.log10(np.mean((sm * alb_map - gt_map) ** 2) + 1e-12))
    metrics["albedo_map_texels"] = int(on_main.sum())
    metrics["tex_extract_seconds"] = round(time.time() - t0, 1)

    # -- relighting against the test split's relit ground truth -------------
    env_path = make_relight_envmap(os.path.join(args.out, "envmaps"))
    # white background: the scene's relit ground truth is rendered on white
    stage("relight", ["relight", *common, "--envmap", env_path, "--n_views", "2",
                      "--background", "white"])
    rmet = os.path.join(logs, "relight", "envmap6", "metrics.json")
    if os.path.exists(rmet):
        with open(rmet) as f:
            metrics["relight"] = json.load(f)
        metrics["relight"].pop("relit_psnr", None)

    metrics["total_seconds"] = round(time.time() - t_start, 1)
    failures = [] if args.no_gates else check_gates(metrics, args.fast)
    metrics["gates"] = {"checked": not args.no_gates, "mode": "fast" if args.fast else "full",
                        "failures": failures}
    with open(os.path.join(args.out, "pipeline_metrics.json"), "w") as fp:
        json.dump(metrics, fp, indent=1)
    print("\n=== pipeline metrics ===")
    print(json.dumps(metrics, indent=1), flush=True)
    for w in metrics.get("warnings", []):
        print("WARNING: " + w, flush=True)
    if failures:
        print("\n=== QUALITY GATES FAILED ===")
        for f in failures:
            print("  " + f)
        sys.exit(1)
    return metrics


if __name__ == "__main__":
    main()

"""The port's diagnostic plots: ``tools/plots.py`` writes the JAX
package's images, byte for byte, from the same arrays; and each stage's
``*_plot_to_disk`` renders one view of the shadow scene on the CPU (the
stages' runners at configs/sphere_smoke.json's widths, a 32^3 grid baked
from the seeded NeuS) into one grid of the right size, from finite
buffers, that is not one flat colour.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from robir_tpu.tools import plots as jplots
from robir_tpu_torch.core.config import build_stage2_config, build_stage_config, load_config
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.stages import cesr, norm, pbr, vis
from robir_tpu_torch.stages.stage2_runner import init_stage2_params
from robir_tpu_torch.tools import plots

H, W = 20, 24


def _outputs(rng) -> dict:
    n = H * W
    return {"normals": rng.uniform(-1, 1, (n, 3)), "normal_neus": rng.uniform(-1, 1, (n, 3)),
            "pred_vis": rng.random(n), "gt_vis": rng.random(n),
            "pred_rgb": rng.random((n, 3)) * 1.2, "diffuse_albedo": rng.random((n, 3)),
            "roughness": rng.random((n, 3)), "indir_rgb": rng.random((n, 3)),
            "vis_shadow": rng.random((n, 3)), "normal_map": rng.uniform(-1, 1, (n, 3)),
            "sg_specular_rgb": rng.random((n, 3))}


@pytest.mark.parametrize("name,extra", [("plot_norm", ()), ("plot_illum", ()),
                                        ("plot_mat", (3,)), ("plot_cesr", (1,))])
def test_plots_match_jax(tmp_path, name, extra):
    rng = np.random.default_rng(0)
    out, gt = _outputs(rng), rng.random((H * W, 3)).astype(np.float32)
    a = getattr(plots, name)(out, gt, str(tmp_path / "port"), 7, (H, W), *extra)
    b = getattr(jplots, name)(out, gt, str(tmp_path / "jax"), 7, (H, W), *extra)
    assert a.replace("port", "jax") == b
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    x = rng.uniform(-0.5, 1.5, (5, 3))
    np.testing.assert_array_equal(plots.tonemap(x), jplots.tonemap(x))


@pytest.fixture(scope="module")
def setup():
    raw = load_config("configs/sphere_smoke.json")
    cfg = build_stage2_config(raw["model"])
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, resolution=32))
    params = init_stage2_params(torch.Generator().manual_seed(0), cfg)
    return raw, cfg, params, shadow_scene(n_train=2, h=H, w=W)


STAGES = {"norm": (norm.NormRunner, norm.NormStageConfig, norm.norm_plot_to_disk),
          "vis": (vis.VisRunner, vis.VisStageConfig, vis.vis_plot_to_disk),
          "pbr": (pbr.PBRRunner, pbr.PBRStageConfig, pbr.pbr_plot_to_disk),
          "cesr": (cesr.CESRRunner, cesr.CESRStageConfig, cesr.cesr_plot_to_disk)}


def _runner(setup, stage, tmp_path):
    raw, cfg, params, ds = setup
    runner_t, stage_t, _ = STAGES[stage]
    data = None if stage == "norm" else ds  # the Norm runner takes a texture sampler
    r = runner_t(cfg, params, data, build_stage_config(stage_t, raw[stage]), device="cpu",
                 log_dir=str(tmp_path))
    r.bake_grid()
    return r


@pytest.mark.parametrize("stage,plot,rows,cols", [
    ("norm", "plot_norm", 1, 3), ("vis", "plot_illum", 1, 3),
    ("pbr", "plot_mat", 2, 3), ("cesr", "plot_cesr", 2, 3)])
def test_stage_plot_to_disk(setup, tmp_path, monkeypatch, stage, plot, rows, cols):
    ds = setup[3]
    runner = _runner(setup, stage, tmp_path)
    seen = {}
    real = getattr(plots, plot)

    def spy(outputs, rgb_gt, plots_dir, it, img_res, *rest):
        seen.update(outputs)
        return real(outputs, rgb_gt, plots_dir, it, img_res, *rest)

    monkeypatch.setattr(plots, plot, spy)
    path = STAGES[stage][2](runner, ds, chunk=256)
    assert path.startswith(str(tmp_path / runner.stage_name / "plots"))
    assert seen and all(np.isfinite(v).all() for v in seen.values())
    assert all(v.shape[0] == H * W for v in seen.values())
    img = np.asarray(Image.open(path))
    assert img.shape == (rows * H, cols * W, 3)
    assert img.reshape(-1, 3).std(0).max() > 0
    # some pixels hit the surface (the rest are ones)
    surface = seen["mask"] if "mask" in seen else (
        np.any(seen["normals"] != 1, -1) if stage == "norm" else seen["pred_vis"] != 1)
    assert 0 < surface.sum() < H * W

"""The port's relighting (``tools/relight.py``, ``fields/envmap_material.py``'s
``load_light`` and ``get_light``) against the JAX package's, on the
fixture of ``tests/test_relight.py``: a 24 x 24 sphere scene's test split,
narrow widths, a 32^3 grid baked by JAX from seeded weights (both packages
march it), and a prefit envmap of 16 SGs named after the split's relit
ground truth. ``relight_views`` under the swapped light on the envmap
background, and under the training light on white: every frame's buffers,
the hits, the relit PSNRs and the PNGs, with JAX's per-chunk keys replayed
(``torch_port_helpers.jax_view_draws``).

Tolerances: the buffers and PSNRs 1e-5 (relative and absolute; fp32 in
another summation order, the unit normals from K3's plain version against
JAX's autodiff); the hits, the envmap and SGs read, and ``_display_psnr``
exact; the PNGs (8-bit) within one level.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from robir_tpu.core.config import build_stage2_config as jbuild_stage2_config
from robir_tpu.data.syn_dataset import SynDataset as JSynDataset
from robir_tpu.data.syn_dataset import SynDatasetConfig as JSynDatasetConfig
from robir_tpu.fields import envmap_material as jenv
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.tools import relight as jrelight
from robir_tpu.tracing.grid import build_sdf_grid as jbuild_sdf_grid
from robir_tpu_torch.core.config import build_stage2_config
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import SynDataset, SynDatasetConfig
from robir_tpu_torch.data.synthetic import make_sphere_dataset
from robir_tpu_torch.fields import envmap_material as tenv
from robir_tpu_torch.stages.stage2_runner import init_stage2_params
from robir_tpu_torch.tools import relight as trelight
from robir_tpu_torch.utils.exr import write_exr
from torch_port_helpers import jax_view_draws, to_t

MODEL = {
    "neus": {"sdf": {"d_out": 33, "d_hidden": 32, "n_layers": 3, "skip_in": [],
                     "multires": 3, "bias": 0.5},
             "color": {"d_feature": 32, "d_hidden": 32, "n_layers": 2}},
    "envmap_material_network": {"multires": 4, "num_lgt_sgs": 16, "encoder_dims": [64, 64],
                                "decoder_dims": [32]},
    "indirect_illum_network": {"multires": 4, "dims": [32, 32], "num_lgt_sgs": 8},
    "visibility_network": {"points_multires": 4, "dirs_multires": 4, "dims": [32, 32]},
    "tonemap": {"hdr_mode": 0, "gamma": 1.0},
    "grid": {"resolution": 32, "bbox_min": [-0.55] * 3, "bbox_max": [0.55] * 3},
}
RES, N_SG = 24, 16
CHUNK, COMPACT = RES * RES, 512  # one chunk a view, compacted as relight_views does


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    scene = str(tmp_path_factory.mktemp("syn"))
    make_sphere_dataset(scene, n_train=4, n_test=2, h=RES, w=RES, radius=0.5)
    jcfg, tcfg = jbuild_stage2_config(MODEL), build_stage2_config(MODEL)
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(0), tcfg))
    jgrid = jbuild_sdf_grid(JStage2Model(params, jcfg).sdf, jcfg.grid)
    env_path = os.path.join(str(tmp_path_factory.mktemp("env")), "envmap6")
    os.makedirs(env_path)
    rng = np.random.default_rng(0)
    sgs = np.concatenate([rng.standard_normal((N_SG, 3)).astype(np.float32),
                          np.full((N_SG, 1), 30.0, np.float32),
                          np.full((N_SG, 3), 0.5, np.float32)], -1)
    np.save(os.path.join(env_path, "sg_128.npy"), sgs)
    env = 0.2 + 0.6 * rng.random((8, 16, 3)).astype(np.float32)
    write_exr(env_path + ".exr", env)
    return dict(scene=scene, jcfg=jcfg, tcfg=tcfg, params=params, jgrid=jgrid,
                env_path=env_path, sgs=sgs, env=env)


@pytest.mark.parametrize("light_origin,background", [(False, "envmap"), (True, "white")])
def test_relight_views_matches_jax(setup, tmp_path, light_origin, background):
    s = setup
    jds = JSynDataset(JSynDatasetConfig(instance_dir=s["scene"], split="test"))
    tds = SynDataset(SynDatasetConfig(instance_dir=s["scene"], split="test"))
    views = [0, 1]
    kw = dict(view_indices=views, chunk=CHUNK, light_origin=light_origin,
              background=background)
    want, wmet = jrelight.relight_views(s["params"], s["jcfg"], s["jgrid"], jds, s["env_path"],
                                        str(tmp_path / "jax"), **kw)
    draws = jax_view_draws(JStage2Model(s["params"], s["jcfg"], s["jgrid"]), jds, views, CHUNK,
                           COMPACT, jax.random.PRNGKey(0), s["jcfg"], N_SG)
    got, gmet = trelight.relight_views(
        s["params"], s["tcfg"], torch.as_tensor(np.array(s["jgrid"])), tds, s["env_path"],
        str(tmp_path / "port"), draws=lambda c: Draws(given={k: to_t(v) for k, v in
                                                            draws[c].items()}),
        device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["mask"], w["mask"])
        assert 0 < g["mask"].sum() < RES * RES
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert gmet.keys() == wmet.keys() and len(gmet["relit_psnr"]) == 2
    for k in ("relit_psnr", "mean_relit_psnr", "relit_psnr_masked", "mean_relit_psnr_masked"):
        np.testing.assert_allclose(gmet[k], wmet[k], rtol=1e-5, err_msg=k)
    assert os.path.basename(gmet["video"]) == os.path.basename(wmet["video"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        if name.endswith(".png"):
            a, b = (np.asarray(Image.open(tmp_path / d / name), np.int16) for d in ("port", "jax"))
            assert np.abs(a - b).max() <= 1, name


def test_load_light_and_get_light_match_jax(setup):
    s = setup
    base = {"lgtSGs": torch.zeros(3, 7), "specular_reflectance": torch.ones(1, 1)}
    got, genv = tenv.load_light(base, s["env_path"])
    want, wenv = jenv.load_light({k: v.numpy() for k, v in base.items()}, s["env_path"])
    np.testing.assert_array_equal(got["lgtSGs"].numpy(), np.asarray(want["lgtSGs"]))
    np.testing.assert_array_equal(genv, wenv)
    np.testing.assert_array_equal(genv, s["env"])
    assert base["lgtSGs"].shape == (3, 7)  # the input is left as it was
    for upper in (False, True):
        tcfg = tenv.EnvmapMaterialConfig(upper_hemi=upper)
        jcfg = jenv.EnvmapMaterialConfig(upper_hemi=upper)
        lgt = got["lgtSGs"].clone().requires_grad_()
        out = tenv.get_light({"lgtSGs": lgt}, tcfg)
        assert not out.requires_grad
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jenv.get_light({"lgtSGs": np.asarray(want["lgtSGs"])},
                                                   jcfg)))


def test_display_psnr_matches_jax():
    rng = np.random.default_rng(4)
    pred, gt = rng.random((50, 3)) * 1.2 - 0.1, rng.random((50, 3))
    assert trelight._display_psnr(pred, gt) == jrelight._display_psnr(pred, gt)
    assert trelight._display_psnr(gt, gt) == jrelight._display_psnr(gt, gt) == 120.0

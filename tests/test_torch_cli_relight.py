"""The port's ``relight`` command against the JAX CLI's on the same inputs,
at ``configs/sphere_smoke.json`` with ``--device cpu``: a small textured
shadow scene's two test views, a seeded stage-2 checkpoint, and the shadow
pipeline's analytic envmap6 on a white background. Each package's command
bakes its own grid: the port's is held to JAX's within 1e-5, then both
render on JAX's grid, the port with JAX's per-chunk keys replayed
(``torch_port_helpers.jax_view_draws``).

Tolerances: the PNGs within one 8-bit level; the relit PSNRs 1e-5
relative.
"""

import json
import os

import jax
import numpy as np
import torch

from robir_tpu import cli as jcli
from robir_tpu.core.config import build_stage2_config as jbuild_stage2_config
from robir_tpu.data.syn_dataset import SynDataset as JSynDataset
from robir_tpu.data.syn_dataset import SynDatasetConfig as JSynDatasetConfig
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.tracing import grid as jgrid_mod
from robir_tpu_torch import cli
from robir_tpu_torch.core.config import load_config
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.tools import relight as trelight
from robir_tpu_torch.tracing import grid as tgrid_mod
from test_torch_cli_post import CONF, _pngs_close, run  # noqa: F401 (run: the fixture)
from torch_port_helpers import jax_view_draws, to_t


def test_relight_matches_jax_cli(run, monkeypatch):
    grids = {}
    real_bake = jgrid_mod.build_sdf_grid

    def jax_bake(*a, **k):
        grids["jax"] = real_bake(*a, **k)
        return grids["jax"]

    monkeypatch.setattr(jgrid_mod, "build_sdf_grid", jax_bake)
    jout = str(run["root"] / "relight_jax")
    jcli.main(["relight", *run["common"], "--envmap", run["env"], "--n_views", "2",
               "--background", "white", "--out", jout])

    # the port's own bake, against JAX's; then the render on JAX's grid
    jgrid = np.array(grids["jax"])
    real_tbake = tgrid_mod.build_sdf_grid
    baked = {}

    def port_bake(*a, **k):
        baked["port"] = real_tbake(*a, **k)
        return torch.as_tensor(jgrid)

    jcfg = jbuild_stage2_config(load_config(CONF)["model"])
    jds = JSynDataset(JSynDatasetConfig(instance_dir=run["scene"], split="test",
                                        pose_scale=2.0))
    n_sg = np.load(os.path.join(run["env"], "sg_128.npy")).shape[0]
    draws = jax_view_draws(JStage2Model(run["params"], jcfg, grids["jax"]), jds, [0, 1], 8000,
                           512, jax.random.PRNGKey(0), jcfg, n_sg)
    real_relight = trelight.relight_views
    monkeypatch.setattr(tgrid_mod, "build_sdf_grid", port_bake)
    monkeypatch.setattr(trelight, "relight_views", lambda *a, **k: real_relight(
        *a, draws=lambda c: Draws(given={n: to_t(v) for n, v in draws[c].items()}), **k))
    tout = str(run["root"] / "relight_port")
    views, metrics, grid = cli.main(["relight", *run["common"], "--envmap", run["env"],
                                     "--n_views", "2", "--background", "white", "--out", tout,
                                     "--device", "cpu"])
    np.testing.assert_allclose(baked["port"].numpy(), jgrid, rtol=0, atol=1e-5)
    assert len(views) == 2 and torch.equal(grid, torch.as_tensor(jgrid))
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names and "metrics.json" in names
    _pngs_close(tout, jout, [n for n in names if n.endswith(".png")])
    with open(os.path.join(jout, "metrics.json")) as f:
        want = json.load(f)
    with open(os.path.join(tout, "metrics.json")) as f:
        got = json.load(f)
    assert got.keys() == want.keys() == metrics.keys()
    for k in ("relit_psnr", "mean_relit_psnr", "relit_psnr_masked", "mean_relit_psnr_masked"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)

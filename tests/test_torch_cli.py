"""The port's command line (``robir_tpu_torch/cli.py``) against the JAX
package's: the parser, the ``--set`` overrides, the dataset-key filter, the
plot schedule of ``_run_stage``, the Norm decoder that ``vis`` restores,
the stage-1 alternates and IDR mode against the JAX command line, the
whole chain neus -> mesh -> norm -> vis -> pbr
-> cesr on the CPU in one log dir, and ``mesh`` on a JAX trainer's
checkpoint (vertices within 1e-5 of the JAX command's PLY, triangles
equal: the two grids differ by fp32 rounding, far below a cell).
"""

import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch

from robir_tpu import cli as jcli
from robir_tpu.core.config import apply_overrides as japply_overrides
from robir_tpu.data import blender as jblender
from robir_tpu.data.synthetic import make_sphere_dataset
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.fields.sdf import SDFConfig as JSDFConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch import cli
from robir_tpu_torch.core import checkpoint as ckpt_lib
from robir_tpu_torch.core.config import apply_overrides, build_stage2_config, load_config
from robir_tpu_torch.core.tree import flatten_with_paths, unflatten_paths
from robir_tpu_torch.stages import vis as vis_mod
from robir_tpu_torch.stages.stage2_runner import init_stage2_params
from robir_tpu_torch.texture.mesh import Mesh
from torch_port_helpers import grid_atlas

# stage 1 at the widths of configs/sphere_smoke.json's NeuS (model.neus),
# which stage 2 then loads
STAGE1 = ["--set", "train.batch_size=64", "--set", "render.n_samples=16",
          "--set", "render.n_importance=16", "--set", "render.up_sample_steps=2",
          "--set", "train.mesh_resolution=24", "--set", "train.eval_chunk=256",
          "--set", "train.eval_every=2", "--set", "train.ckpt_every=2"]


def test_parser_help_and_missing_subcommand():
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    with pytest.raises(SystemExit):
        cli.main([])


def test_apply_overrides_matches_jax():
    overrides = ["model.grid.resolution=128", "train.lr_init=1e-3", "a.b.c=[1, 2, 3]",
                 "flag=true", "none=null", "name=hotdog", "s=\"quoted\"", "x.y={\"k\": 1}",
                 "model.neus.sdf.skip_in=[]", "bad=1e"]
    base = load_config("configs/hotdog.json")
    got = apply_overrides(json.loads(json.dumps(base)), overrides)
    want = japply_overrides(json.loads(json.dumps(base)), overrides)
    assert got == want
    assert got["model"]["grid"]["resolution"] == 128 and got["bad"] == "1e"


def test_config_to_dict_matches_jax():
    from robir_tpu.core.config import config_to_dict as jconfig_to_dict
    from robir_tpu.stages.neus_stage import NeusTrainConfig as JNeusTrainConfig
    from robir_tpu.tracing.grid import GridConfig as JGridConfig
    from robir_tpu_torch.core.config import config_to_dict
    from robir_tpu_torch.stages.neus_stage import NeusTrainConfig
    from robir_tpu_torch.tracing.grid import GridConfig
    raw = load_config("configs/hotdog.json")["model"]["grid"]
    grid = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()}
    for got, want in ((GridConfig(**grid), JGridConfig(**grid)),
                      (NeusTrainConfig(eval_every=7), JNeusTrainConfig(eval_every=7))):
        assert config_to_dict(got) == jconfig_to_dict(want)


def test_filter_fields_rejects_unknown_keys():
    from robir_tpu_torch.data.syn_dataset import SynDatasetConfig
    d = {"frame_skip": 2, "pose_scale": 2.0, "llffhold": 8, "white_bkgd": True, "near": 2.0}
    assert cli._filter_fields(SynDatasetConfig, d) == {"frame_skip": 2, "pose_scale": 2.0}
    assert cli._known_dataset_keys() == jcli._known_dataset_keys()
    with pytest.raises(KeyError, match="frame_skp"):
        cli._filter_fields(SynDatasetConfig, {"frame_skp": 2})


def test_run_stage_plot_scheduling(monkeypatch, tmp_path):
    """--plot_freq N plots every N iters and at the end; the default plots
    once at the end; --no_plot never."""
    calls = []

    class FakeRunner:
        grid_values = object()
        log_dir = str(tmp_path)
        stage_name = "Vis"
        cur_iter = 0

        def run(self, n, log_every=0, log_fn=None):
            self.cur_iter += n
            return {}

        def save(self):
            return "ckpt"

        def restore_latest(self):
            return False

    monkeypatch.setattr(cli, "_plot_stage", lambda runner, dataset, name: calls.append(
        runner.cur_iter))

    def args(**kw):
        return argparse.Namespace(**{**dict(is_continue=False, n_iters=None, plot_freq=0,
                                            no_plot=False), **kw})

    cli._run_stage(FakeRunner(), args(plot_freq=4), 10, "Vis", dataset=object())
    assert calls == [4, 8, 10]
    calls.clear()
    cli._run_stage(FakeRunner(), args(), 7, "Vis", dataset=object())
    assert calls == [7]
    calls.clear()
    cli._run_stage(FakeRunner(), args(no_plot=True, plot_freq=3), 7, "Vis", dataset=object())
    assert calls == []


def test_cmd_vis_restores_the_norm_decoder(tmp_path, monkeypatch):
    """vis restores the Norm stage's normal decoder, and nothing else of the
    Norm checkpoint, into the parameters it builds its runner on."""
    from robir_tpu_torch.data.synthetic import make_sphere_dataset as tmake
    scene = tmake(str(tmp_path / "scene"), n_train=2, n_test=1, h=24, w=24)
    log_dir = str(tmp_path / "logs")
    cfg = build_stage2_config(load_config("configs/sphere_smoke.json")["model"])
    marked = {k: v + 0.125 for k, v in flatten_with_paths(
        init_stage2_params(torch.Generator().manual_seed(9), cfg)).items()}
    ckpt_lib.save(os.path.join(log_dir, "Norm", "checkpoints", "latest.npz"),
                  unflatten_paths(marked), step=1)
    captured = {}

    class SpyRunner:
        def __init__(self, cfg, params, *args, **kw):
            captured["params"] = params
            raise RuntimeError("stop-after-capture")

    monkeypatch.setattr(vis_mod, "VisRunner", SpyRunner)
    with pytest.raises(RuntimeError, match="stop-after-capture"):
        cli.main(["vis", "--conf", "configs/sphere_smoke.json", "--data", scene,
                  "--log_dir", log_dir, "--n_iters", "1", "--device", "cpu"])
    got = {k: np.asarray(v) for k, v in flatten_with_paths(captured["params"]).items()}
    decoder = [k for k in marked if "normal_decoder_layer" in k]
    assert decoder and all(np.array_equal(got[k], marked[k].numpy()) for k in decoder)
    others = [k for k in marked if k not in decoder]
    assert not any(np.array_equal(got[k], marked[k].numpy()) for k in others)


def _layout(path: str) -> dict:
    """{path: shape} of a checkpoint file, and its step."""
    tree, meta = ckpt_lib.load(path)
    return {k: np.shape(v) for k, v in flatten_with_paths(tree).items()}, meta.get("step")


def _conf(tmp_path, conf: dict) -> str:
    path = str(tmp_path / "conf.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


SMALL_TRAIN = {"batch_size": 16, "max_steps": 4, "eval_chunk": 128, "ckpt_every": 100,
               "eval_every": 0}
SMALL_VNERF = {"type": "vnerf", "width": 16, "depth": 2, "skips": [], "multires": 3,
               "multires_view": 2}
SMALL_HASH = {"type": "hash", "hash_sdf": {"width": 16, "depth": 2, "d_out": 9,
                                           "grid": {"n_levels": 4, "log2_hashmap_size": 10}},
              "color": {"d_feature": 8, "d_hidden": 16, "n_layers": 2}}
ALTERNATES = {
    "llff": ({"model": SMALL_VNERF, "render": {"type": "mip", "num_samples": 8},
              "dataset": {"type": "llff", "llffhold": 4}}, "llff"),
    "multicam": ({"model": dict(SMALL_VNERF, use_ipe=True, ipe_max_deg=4),
                  "render": {"type": "mip", "num_samples": 8}, "dataset": {"type": "multicam"}},
                 "multicam"),
    "hash": ({"model": SMALL_HASH, "render": {"n_samples": 8, "n_importance": 8,
                                              "up_sample_steps": 2}}, "sphere"),
    "vnerf_mip": ({"model": SMALL_VNERF, "render": {"type": "mip", "num_samples": 8,
                                                    "mode": "sim"},
                   "train": {"similarity_weight": 0.1}}, "sphere"),
}


@pytest.mark.parametrize("case", [*ALTERNATES, "pbr_idr"])
def test_alternates_match_the_jax_cli(tmp_path, case, monkeypatch):
    """What the port refused until ROADMAP.md A.6 and A.9 were ported, run
    by both command lines on the CPU at small widths: ``neus`` on an LLFF
    and a Multicam scene (VNeRF and MipNeRF under the mip renderer), with
    the hash-grid NeuS, and with VNeRF under the 'sim' compositor; ``pbr``
    in IDR mode (``model.use_neus=false``) from one Vis checkpoint. Each
    package's checkpoint has the same paths, shapes and step, and its test
    metrics are finite; the IDR PBR checkpoints hold the Vis file's
    indirect and visibility nets bit for bit."""
    from robir_tpu_torch.data.synthetic import make_sphere_dataset as tmake
    from torch_port_helpers import write_llff_scene, write_multicam_scene
    if case == "pbr_idr":
        from robir_tpu_torch.data.synthetic import make_shadow_dataset
        scene = make_shadow_dataset(str(tmp_path / "scene"), n_train=3, n_test=1, h=16, w=16)
        idr = ["--conf", "configs/sphere_smoke.json", "--data", scene, "--set",
               "model.use_neus=false", "--set", "model.neus.sdf.bias=0.3"]
        orig = vis_mod.VisRunner.fit_energy_prologue
        monkeypatch.setattr(vis_mod.VisRunner, "fit_energy_prologue",
                            lambda self, n_steps=1000: orig(self, 3))
        L = str(tmp_path / "vis")
        cli.main(["vis", *idr, "--log_dir", L, "--n_iters", "1", "--no_plot", "--device", "cpu"])
        vis_file = os.path.join(L, "Vis", "checkpoints", "latest.npz")
        got = {}
        for pkg, main in (("port", cli.main), ("jax", jcli.main)):
            os.makedirs(os.path.join(tmp_path, pkg, "Vis", "checkpoints"))
            import shutil
            shutil.copy(vis_file, os.path.join(tmp_path, pkg, "Vis", "checkpoints"))
            extra = ["--device", "cpu"] if pkg == "port" else []
            main(["pbr", *idr, "--log_dir", str(tmp_path / pkg), "--n_iters", "1", "--no_plot",
                  *extra])
            got[pkg] = os.path.join(tmp_path, pkg, "PBR", "checkpoints", "latest.npz")
        assert _layout(got["port"]) == _layout(got["jax"])
        vis = flatten_with_paths(ckpt_lib.load(vis_file)[0])
        kept = [k for k in vis if k.startswith(("indirect_illum_network", "visibility_network"))]
        for pkg in ("port", "jax"):
            leaves = flatten_with_paths(ckpt_lib.load(got[pkg])[0])
            assert "rendering_network/lin0/v" in leaves
            assert kept and all(np.array_equal(leaves[k], vis[k]) for k in kept)
        return
    conf, kind = ALTERNATES[case]
    conf = {**conf, "train": {**SMALL_TRAIN, **conf.get("train", {})}}
    data = str(tmp_path / "scene")
    if kind == "llff":
        write_llff_scene(data, n=8, h=12, w=16)
    elif kind == "multicam":
        write_multicam_scene(data)
    else:
        tmake(data, n_train=2, n_test=1, h=12, w=12)
    args = ["neus", "--conf", _conf(tmp_path, conf), "--data", data, "--n_iters", "2"]
    cli.main([*args, "--log_dir", str(tmp_path / "port"), "--device", "cpu"])
    jcli.main([*args, "--log_dir", str(tmp_path / "jax")])
    files = {pkg: os.path.join(tmp_path, pkg, "NeuS", "ckpt_000002.npz")
             for pkg in ("port", "jax")}
    assert _layout(files["port"]) == _layout(files["jax"])
    for pkg in ("port", "jax"):
        with open(os.path.join(tmp_path, pkg, "NeuS", "neus", "description.json")) as f:
            desc = json.load(f)
        assert np.isfinite(desc["mean_psnr"]) and desc["rays_per_sec"] > 0, (pkg, desc)


def test_norm_refuses_idr_mode_with_the_jax_error(tmp_path):
    """``norm`` with ``model.use_neus=false`` raises the JAX package's
    ValueError, the error of its ``get_neus_surface`` on an IDR model (the
    Norm stage's surface integration needs the NeuS's deviation network;
    the JAX command line meets it in its plot, which it prints)."""
    import dataclasses

    import jax.numpy as jnp

    from robir_tpu.core.config import build_stage2_config as jbuild
    from robir_tpu.render.stage2 import Stage2Model as JStage2Model
    from robir_tpu.stages import norm as jnorm
    from robir_tpu.fields.sdf import init_sdf as jinit_sdf
    import jax
    from robir_tpu_torch.data.synthetic import make_shadow_dataset
    scene = make_shadow_dataset(str(tmp_path / "scene"), n_train=2, n_test=1, h=8, w=8)
    cfg = dataclasses.replace(jbuild(load_config("configs/sphere_smoke.json")["model"]),
                              use_neus=False)
    x = jnp.full((2, 3), 0.3)
    with pytest.raises(ValueError) as jax_error:
        # the IDR tree's implicit_network: all the surface integration reads
        params = {"implicit_network": jinit_sdf(jax.random.PRNGKey(0), cfg.neus.sdf)}
        jnorm.get_neus_surface(JStage2Model(params, cfg), x, x, x)
    with pytest.raises(ValueError) as port_error:
        cli.main(["norm", "--conf", "configs/sphere_smoke.json", "--data", scene, "--mesh",
                  str(tmp_path / "mesh.ply"), "--log_dir", str(tmp_path / "logs"),
                  "--set", "model.use_neus=false", "--device", "cpu"])
    assert str(port_error.value) == str(jax_error.value)


def test_stage2_refuses_a_neus_of_other_widths(tmp_path):
    """A stage-1 checkpoint whose NeuS does not fit ``model.neus`` (here PE
    multires 2 against sphere_smoke.json's 3) raises, naming the fix."""
    import dataclasses

    from robir_tpu_torch.data.synthetic import make_sphere_dataset as tmake
    from robir_tpu_torch.fields.neus_model import init_neus
    scene = tmake(str(tmp_path / "scene"), n_train=2, n_test=1, h=8, w=8)
    neus = build_stage2_config(load_config("configs/sphere_smoke.json")["model"]).neus
    other = dataclasses.replace(neus, sdf=dataclasses.replace(neus.sdf, multires=2))
    ckpt_lib.save(str(tmp_path / "logs" / "NeuS" / "ckpt_000001.npz"),
                  {"params": init_neus(torch.Generator().manual_seed(0), other)}, step=1)
    with pytest.raises(ValueError, match="sdf_network/lin0/v.*multires"):
        cli.main(["norm", "--conf", "configs/sphere_smoke.json", "--data", scene, "--mesh",
                  "unused.ply", "--log_dir", str(tmp_path / "logs"), "--device", "cpu"])


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from robir_tpu_torch.data.synthetic import make_sphere_dataset as tmake
    scene = tmake(str(tmp_path / "scene"), n_train=2, n_test=1, h=8, w=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["neus", "--conf", "configs/sphere_smoke.json", "--data", scene,
                  "--log_dir", str(tmp_path / "logs"), "--n_iters", "1", *STAGE1])


def test_the_chain_on_the_cpu(tmp_path, monkeypatch):
    """neus (with a resume) -> mesh -> norm -> vis -> pbr -> cesr in one log
    dir, at configs/sphere_smoke.json's widths on its sphere scene: every
    stage's checkpoints and plots, the NeuS run directory's files, and the
    Vis checkpoint's decoder the Norm checkpoint's. The mesh's texture
    cache gets a trivial atlas (the atlas's packing takes a minute here);
    the Vis prologue takes 3 steps."""
    from robir_tpu_torch.data.synthetic import make_sphere_dataset as tmake
    scene = tmake(str(tmp_path / "scene"), n_train=4, n_test=2, h=24, w=24)
    L = str(tmp_path / "logs")
    common = ["--conf", "configs/sphere_smoke.json", "--data", scene, "--log_dir", L,
              "--device", "cpu"]
    trainer = cli.main(["neus", *common, "--n_iters", "4", *STAGE1])
    assert trainer.step == 4
    trainer = cli.main(["neus", *common, "--n_iters", "2", "--is_continue", *STAGE1])
    assert trainer.step == 6
    run_dir = os.path.join(L, "NeuS", "neus")
    assert [os.path.basename(p) for p in sorted(glob.glob(os.path.join(L, "NeuS", "*.npz")))] \
        == ["ckpt_000002.npz", "ckpt_000004.npz", "ckpt_000006.npz"]
    assert sorted(os.listdir(os.path.join(run_dir, "meshes"))) == [
        f"mesh_{s:06d}.ply" for s in (2, 4, 6)]
    with open(os.path.join(run_dir, "description.json")) as f:
        assert json.load(f)["rays_per_sec"] > 0

    mesh_path = os.path.join(L, "mesh.ply")
    mesh = cli.main(["mesh", *common, "--ckpt", os.path.join(L, "NeuS", "ckpt_000006.npz"),
                     "--out", mesh_path, "--set", "mesh.resolution=32"])
    assert len(mesh.tris) > 0 and np.array_equal(Mesh.load_ply(mesh_path).tris, mesh.tris)
    os.makedirs(os.path.join(L, "mesh.cache"))
    np.savez(os.path.join(L, "mesh.cache", "uv.npz"), uv=grid_atlas(len(mesh.tris)),
             idx=mesh.tris.reshape(-1).astype(np.int32))

    cli.main(["norm", *common, "--mesh", mesh_path, "--n_iters", "4", "--plot_freq", "2"])
    orig = vis_mod.VisRunner.fit_energy_prologue
    monkeypatch.setattr(vis_mod.VisRunner, "fit_energy_prologue",
                        lambda self, n_steps=1000: orig(self, 3))
    for stage in ("vis", "pbr", "cesr"):
        cli.main([stage, *common, "--n_iters", "2", "--plot_freq", "1"])
    plots = {"Norm": ["norm_2.png", "norm_4.png"], "Vis": ["illum_1.png", "illum_2.png"],
             "PBR": ["envmap_1.png", "envmap_2.png", "mat_1_0.png", "mat_2_0.png"],
             "CESR": ["cesr_1_0.png", "cesr_2_0.png", "envmap_1.png", "envmap_2.png"]}
    for stage, names in plots.items():
        assert sorted(os.listdir(os.path.join(L, stage, "plots"))) == names
        step = 4 if stage == "Norm" else 2
        meta = ckpt_lib.load(os.path.join(L, stage, "checkpoints", "latest.npz"))[1]
        assert meta["step"] == step
    norm = flatten_with_paths(ckpt_lib.load(os.path.join(L, "Norm", "checkpoints",
                                                         "latest.npz"))[0])
    vis = flatten_with_paths(ckpt_lib.load(os.path.join(L, "Vis", "checkpoints",
                                                        "latest.npz"))[0])
    decoder = [k for k in norm if "normal_decoder_layer" in k]
    assert decoder and all(np.array_equal(vis[k], norm[k]) for k in decoder)


def test_mesh_of_a_jax_checkpoint_matches_jax_cmd_mesh(tmp_path):
    conf = {"model": {"sdf": {"d_out": 17, "d_hidden": 32, "n_layers": 3, "skip_in": [2],
                              "multires": 2, "bias": 0.5},
                      "color": {"d_feature": 16, "d_hidden": 32, "n_layers": 2}},
            "mesh": {"resolution": 256}}
    conf_path = str(tmp_path / "conf.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    scene = make_sphere_dataset(str(tmp_path / "scene"), n_train=2, n_test=1, h=16, w=16)
    jt = jstage.NeusTrainer(
        jblender.BlenderScene(jblender.BlenderConfig(dataset_dir=scene), "train"),
        jnm.NeuSConfig(sdf=JSDFConfig(d_out=17, d_hidden=32, n_layers=3, skip_in=(2,),
                                      multires=2, bias=0.5),
                       color=JRenderingConfig(d_feature=16, d_hidden=32, n_layers=2)),
        jneus.NeusRenderConfig(n_samples=16, n_importance=16, up_sample_steps=2),
        jstage.NeusTrainConfig(batch_size=64, lr_init=1e-2, lr_delay_steps=0),
        log_dir=str(tmp_path / "NeuS"))
    jt.run(3)
    ckpt = jt.save()
    args = ["mesh", "--conf", conf_path, "--ckpt", ckpt, "--set", "mesh.resolution=32"]
    jcli.main([*args, "--out", str(tmp_path / "jax.ply")])
    cli.main([*args, "--out", str(tmp_path / "port.ply"), "--device", "cpu"])
    want = Mesh.load_ply(str(tmp_path / "jax.ply"))
    got = Mesh.load_ply(str(tmp_path / "port.ply"))
    assert len(want.tris) > 0
    np.testing.assert_array_equal(got.tris, want.tris)
    np.testing.assert_allclose(got.verts, want.verts, atol=1e-5)

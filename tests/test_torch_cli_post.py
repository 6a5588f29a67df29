"""The port's commands after training (``textures``, ``sgfit``,
``import-ref``; ``relight`` in ``test_torch_cli_relight.py``) against the
JAX CLI's files on the same inputs, at
``configs/sphere_smoke.json`` with ``--device cpu`` on a small textured
shadow scene, from one seeded stage-2 checkpoint; both parsers' options;
and the port's shadow pipeline (``robir_tpu_torch/tools/shadow_pipeline.py``)
against the repository's ``tools/shadow_pipeline.py``: its configurations,
quality gates, ``check_gates`` and relighting envmap; and that the new
commands and the pipeline raise on ``cuda`` without a card.

``sgfit`` starts both packages from JAX's init. Tolerances: the texture
maps within one 8-bit level; the SGs of 5 Adam steps 1e-4 and the fitted
image 1e-4 of its largest value; the OBJ, MTL and imported checkpoints
exact; the gates and configurations equal; the relighting envmap's image
1e-5 (``compute_envmap`` in fp32 in another order).
"""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from robir_tpu import cli as jcli
from robir_tpu.core import checkpoint as jckpt
from robir_tpu.stages import sg_fit as jfit
from robir_tpu_torch import cli
from robir_tpu_torch.core import checkpoint as ckpt_lib
from robir_tpu_torch.core.config import build_stage2_config, load_config
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.data.synthetic import make_shadow_dataset
from robir_tpu_torch.render.sg import compute_envmap
from robir_tpu_torch.stages import sg_fit as tfit
from robir_tpu_torch.stages.stage2_runner import init_stage2_params
from robir_tpu_torch.tools import shadow_pipeline as tpipe
from robir_tpu_torch.utils.exr import read_exr, write_exr
from torch_port_helpers import reference_state_dict, two_sphere_tex_sampler

CONF = "configs/sphere_smoke.json"
RES = 24


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 24 x 24 textured shadow scene; a log dir with a seeded NeuS and a
    seeded CESR checkpoint; the shadow pipeline's envmap6."""
    root = tmp_path_factory.mktemp("post")
    scene = make_shadow_dataset(str(root / "scene"), n_train=3, n_test=2, h=RES, w=RES,
                                textured=True)
    L = str(root / "logs")
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(6),
                                         build_stage2_config(load_config(CONF)["model"])))
    ckpt_lib.save(os.path.join(L, "NeuS", "ckpt_000007.npz"),
                  {"params": params["implicit_network"]}, step=7)
    ckpt_lib.save(os.path.join(L, "CESR", "checkpoints", "latest.npz"), params, step=3)
    env = tpipe.make_relight_envmap(str(root / "envmaps"))
    return dict(root=root, scene=scene, L=L, params=params, env=env,
                common=["--conf", CONF, "--data", scene, "--log_dir", L])


def _pngs_close(a_dir, b_dir, names):
    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(d, name)), np.int16) for d in (a_dir, b_dir))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


def test_textures_matches_jax_cli(run):
    two_sphere_tex_sampler(str(run["root"]), 64)  # the mesh, its atlas and maps in the cache
    mesh = str(run["root"] / "mesh.ply")
    args = ["textures", *run["common"], "--mesh", mesh, "--resolution", "64"]
    jcli.main([*args, "--out", str(run["root"] / "tex_jax")])
    maps = cli.main([*args, "--out", str(run["root"] / "tex_port"), "--device", "cpu"])
    assert sorted(maps) == ["albedo", "metallic", "normal", "roughness"]
    names = sorted(os.listdir(run["root"] / "tex_jax"))
    assert sorted(os.listdir(run["root"] / "tex_port")) == names
    _pngs_close(run["root"] / "tex_port", run["root"] / "tex_jax",
                [n for n in names if n.endswith(".png")])
    for name in ("mesh.obj", "mesh.mtl"):
        with open(run["root"] / "tex_port" / name, "rb") as a, \
                open(run["root"] / "tex_jax" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_sgfit_matches_jax_cli(run, monkeypatch):
    """5 steps at 8 SGs from JAX's init (PRNGKey(0)) on a 64 x 128 EXR,
    enlarged to 256 x 512 by the area rule."""
    rng = np.random.default_rng(3)
    sgs = rng.standard_normal((4, 7)).astype(np.float32)
    sgs[:, 3], sgs[:, 4:] = 15.0, np.abs(sgs[:, 4:])
    with torch.no_grad():
        write_exr(str(run["root"] / "env.exr"), compute_envmap(torch.as_tensor(sgs), 64,
                                                                128).numpy())
    init = np.asarray(jfit.init_lgt_sgs(jax.random.PRNGKey(0), 8))
    monkeypatch.setattr(tfit, "init_lgt_sgs", lambda gen, n: torch.tensor(init))
    args = ["sgfit", "--envmap_path", str(run["root"] / "env.exr"), "--num_sg", "8",
            "--n_iters", "5"]
    jcli.main([*args, "--out_dir", str(run["root"] / "fit_jax")])
    got, logged = cli.main([*args, "--out_dir", str(run["root"] / "fit_port"), "--device",
                            "cpu"])
    for d in ("fit_jax", "fit_port"):
        assert sorted(os.listdir(run["root"] / d)) == ["fit_8.exr", "sg_8.npy"]
    want = np.load(run["root"] / "fit_jax" / "sg_8.npy")
    np.testing.assert_allclose(np.load(run["root"] / "fit_port" / "sg_8.npy"), want, atol=1e-4)
    np.testing.assert_array_equal(got, np.load(run["root"] / "fit_port" / "sg_8.npy"))
    a, b = (read_exr(str(run["root"] / d / "fit_8.exr")) for d in ("fit_port", "fit_jax"))
    assert a.shape == b.shape == (256, 512, 3)
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    assert logged[-1][0] == 4 and logged[-1][1] < logged[0][1]


def test_import_ref_matches_jax_cli(run, tmp_path):
    """A reference tar of the NeuS and a pth of the CESR checkpoint, each
    imported by both packages' commands into a fresh log dir: the files
    equal, every leaf the source's."""
    neus = ckpt_lib.load(os.path.join(run["L"], "NeuS", "ckpt_000007.npz"))[0]["params"]
    tar, pth = str(tmp_path / "000007.tar"), str(tmp_path / "latest.pth")
    torch.save({"global_step": 7, "model": reference_state_dict(neus)}, tar)
    torch.save({"model_state_dict": reference_state_dict(run["params"]), "epoch": 3}, pth)
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        main(["import-ref", "--conf", CONF, "--data", run["scene"], "--log_dir",
              str(tmp_path / pkg), "--stage1_tar", tar, "--stage2_pth", pth, "--filter", "all"]
             + (["--device", "cpu"] if pkg == "port" else []))
    for rel, src in ((os.path.join("NeuS", "ckpt_000007.npz"), {"params": neus}),
                     (os.path.join("CESR", "checkpoints", "latest.npz"), run["params"])):
        got, gmeta = ckpt_lib.load(str(tmp_path / "port" / rel))
        want, wmeta = jckpt.load(str(tmp_path / "jax" / rel))
        g, w, s = (flatten_with_paths(t) for t in (got, want, src))
        assert g.keys() == w.keys() == s.keys()
        assert all(np.array_equal(g[k], w[k]) and np.array_equal(g[k], s[k]) for k in s)
        assert gmeta == wmeta


def _options(main, name, capsys) -> set:
    with pytest.raises(SystemExit):
        main([name, "--help"])
    return set(re.findall(r"(--\w+)", capsys.readouterr().out))


@pytest.mark.parametrize("name", ["neus", "mesh", "norm", "vis", "pbr", "cesr", "relight",
                                  "textures", "import-ref", "sgfit"])
def test_every_subcommand_takes_the_jax_options(name, capsys):
    """Each of the JAX CLI's ten subcommands, with its options and
    ``--device``."""
    want = _options(jcli.main, name, capsys)
    assert _options(cli.main, name, capsys) == want | {"--device"}


def _jax_pipeline():
    spec = importlib.util.spec_from_file_location("jax_shadow_pipeline",
                                                  "tools/shadow_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pipeline_configs_and_gates_match_jax():
    jp = _jax_pipeline()
    for fast in (False, True):
        assert tpipe.conf_dict(fast) == jp.conf_dict(fast)
    for name in ("GATES_FULL", "GATES_FULL_TEXTURED_OVERRIDES", "GATES_FAST", "CENTERS",
                 "RADII", "ALBEDO0", "LIGHT"):
        a, b = getattr(tpipe, name), getattr(jp, name)
        assert (a == b if isinstance(a, dict) else np.array_equal(np.asarray(a), np.asarray(b)))


def _passing(fast: bool, textured: bool) -> dict:
    """Metrics that pass every gate of the mode."""
    return {"fast": fast, "textured": textured, "vis_mean_at_lit_front": 0.97,
            "albedo_shadow_lit_ratio_cesr": 1.05, "albedo_psnr_cesr": 20.0,
            "mesh_err_median": 0.02, "relight": {"mean_relit_psnr_masked": 18.0}}


# each case: fast, textured, the metrics changed from passing ones, whether
# a gate fails, whether the textured warning is given
GATE_CASES = [
    (False, False, {}, False, False), (True, False, {}, False, False),
    (False, True, {}, False, False), (True, True, {}, False, False),
    (False, False, {"vis_mean_at_lit_front": 0.9}, True, False),
    (False, False, {"albedo_shadow_lit_ratio_cesr": 1.22}, True, False),
    (False, True, {"albedo_shadow_lit_ratio_cesr": 1.22}, False, True),
    (False, True, {"albedo_shadow_lit_ratio_cesr": 1.3}, True, True),
    (False, False, {"albedo_psnr_cesr": 18.0}, True, False),
    (False, True, {"albedo_psnr_cesr": 14.0}, True, False),
    (False, False, {"mesh_err_median": 0.04}, True, False),
    (False, False, {"relight": {"mean_relit_psnr_masked": 15.0}}, True, False),
    (False, True, {"relight": {"mean_relit_psnr_masked": 17.0}}, True, False),
    (False, False, {"relight": None}, True, False),
    (True, False, {"vis_mean_at_lit_front": 0.05}, True, False),
    (True, False, {"albedo_shadow_lit_ratio_cesr": 0.5}, True, False),
    (True, False, {"albedo_psnr_cesr": 13.0}, True, False),
    (True, False, {"mesh_err_median": 0.09}, True, False),
    (True, False, {"relight": {"mean_relit_psnr_masked": 7.0}}, True, False),
    (True, False, {"albedo_shadow_lit_ratio_cesr": None}, True, False),
]


@pytest.mark.parametrize("fast,textured,change,fails,warns", GATE_CASES)
def test_check_gates_matches_jax(fast, textured, change, fails, warns):
    jp = _jax_pipeline()
    got, want = ({**_passing(fast, textured), **change} for _ in range(2))
    failures = tpipe.check_gates(got, fast)
    assert failures == jp.check_gates(want, fast)
    assert got["warnings"] == want["warnings"]
    assert bool(failures) == fails and bool(got["warnings"]) == warns


def test_relight_envmap_matches_jax(tmp_path):
    jp = _jax_pipeline()
    got = tpipe.make_relight_envmap(str(tmp_path / "port"))
    want = jp.make_relight_envmap(str(tmp_path / "jax"))
    np.testing.assert_array_equal(np.load(os.path.join(got, "sg_128.npy")),
                                  np.load(os.path.join(want, "sg_128.npy")))
    a, b = read_exr(got + ".exr"), read_exr(want + ".exr")
    assert a.shape == b.shape == (64, 128, 3)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("what", ["relight", "textures", "sgfit", "shadow_pipeline"])
def test_cuda_without_a_card_raises(run, tmp_path, what):
    """The commands run on ``cuda`` unless given ``--device cpu``, and raise
    without a card; none continues on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = str(tmp_path / "env.exr")
    write_exr(env, np.full((8, 16, 3), 0.5, np.float32))
    argv = {"relight": ["relight", *run["common"], "--envmap", run["env"], "--out",
                        str(tmp_path / "relit")],
            "textures": ["textures", *run["common"], "--mesh", str(tmp_path / "none.ply"),
                         "--out", str(tmp_path / "tex")],
            "sgfit": ["sgfit", "--envmap_path", env, "--n_iters", "1"]}
    with pytest.raises(RuntimeError, match="CUDA"):
        if what == "shadow_pipeline":
            tpipe.main(["--out", str(tmp_path / "pipeline")])
        else:
            cli.main(argv[what])
    assert not os.path.exists(tmp_path / "pipeline" / "scene")

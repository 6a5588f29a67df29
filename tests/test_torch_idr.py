"""The port's stage 2 in IDR mode (``model.use_neus=false``: the plain IDR
SDF tree as ``implicit_network`` and a top-level ``rendering_network``, no
coordinate scale) against the JAX package, at the setting of
``tests/test_stage2_model.py:idr_model`` (a 64 x 4 trunk, the sphere
tracer) on the small heads of ``test_torch_cesr.py``: the IDR pair's
queries (``sdf``, ``sdf_full``, ``sdf_gradient``, ``color``,
``borrow_color`` at the surface point), the sphere-traced primary rays
and ``stage2_forward`` with the default SG render; the fresh IDR tree's
layout; and the Norm stage's refusal. (The CESR step and the hand-over:
``test_torch_idr_cesr.py``.)

Tolerance: forward values 1e-5 (the SG colours 1e-4 relative, as
``test_torch_stage2_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.fields import sdf as jsdf
from robir_tpu.fields.radiance import RenderingConfig as JRender
from robir_tpu.render.stage2 import Stage2Model as JStage2Model
from robir_tpu.render.stage2 import stage2_forward as jstage2_forward
from robir_tpu.tracing.sphere import SphereTracerConfig as JSphere
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.data.syn_dataset import shadow_scene
from robir_tpu_torch.fields import sdf as tsdf
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.render.stage2 import Stage2Model, stage2_forward
from robir_tpu_torch.stages import norm as tnorm
from robir_tpu_torch.stages import stage2_runner as trunner
from robir_tpu_torch.tracing.sphere import SphereTracerConfig
from test_torch_cesr import JCFG, N_LIGHTS, STAGE_KW, TCFG, TSmallCESR
from torch_port_helpers import assert_close, jax_stage2_draws, to_t

FWD = dict(rtol=1e-5, atol=1e-5)
# idr_model's trunk, its sphere at radius 0.3 (inside the shadow scene's
# views, so that some pixels miss it)
IDR_SDF = dict(d_out=33, d_hidden=64, n_layers=4, skip_in=(), multires=3, bias=0.3)
IDR_COLOR = dict(d_feature=32, d_hidden=32, n_layers=2)
TRACER = dict(object_bounding_sphere=1.0, n_steps=64)

JIDR = dataclasses.replace(JCFG, use_neus=False, sphere_tracer=JSphere(**TRACER),
                           neus=dataclasses.replace(JCFG.neus, sdf=jsdf.SDFConfig(**IDR_SDF),
                                                    color=JRender(**IDR_COLOR)))
TIDR = dataclasses.replace(TCFG, use_neus=False, sphere_tracer=SphereTracerConfig(**TRACER),
                           neus=dataclasses.replace(TCFG.neus, sdf=tsdf.SDFConfig(**IDR_SDF),
                                                    color=RenderingConfig(**IDR_COLOR)))


def idr_params(seed: int = 0) -> dict:
    """The port's IDR-mode init plus the two CESR nets, as numpy."""
    gen = torch.Generator().manual_seed(seed)
    tree = trunner.init_stage2_params(gen, TIDR)
    stage = TSmallCESR(**STAGE_KW)
    tree["shadow_net"] = tsdf.init_sdf(gen, stage.shadow_cfg)
    tree["normal_net"] = tsdf.init_sdf(gen, stage.normal_cfg)
    return to_numpy(tree)


@pytest.fixture(scope="module")
def case():
    ds = shadow_scene(n_train=3, h=40, w=40)
    return idr_params(), ds, ds.sample_pixels(np.random.default_rng(2), 1, 48)


def test_idr_tree_matches_jax_layout():
    """The fresh IDR tree: the SDF tree itself under implicit_network and a
    top-level rendering_network, with the paths and shapes of the JAX
    package's ``init_sdf`` and ``init_rendering``; the other subtrees are
    those of the NeuS-mode tree."""
    from robir_tpu.fields.radiance import init_rendering as jinit_rendering
    got = {k: tuple(v.shape) for k, v in ttree.flatten_with_paths(
        trunner.init_stage2_params(torch.Generator().manual_seed(0), TIDR)).items()}
    neus_mode = {k: tuple(v.shape) for k, v in ttree.flatten_with_paths(
        trunner.init_stage2_params(torch.Generator().manual_seed(0), TCFG)).items()}
    k1, k5 = jax.random.split(jax.random.PRNGKey(0))
    want = {k: v for k, v in neus_mode.items() if not k.startswith("implicit_network")}
    for name, tree in (("implicit_network",
                        jax.eval_shape(lambda: jsdf.init_sdf(k1, JIDR.neus.sdf))),
                       ("rendering_network",
                        jax.eval_shape(lambda: jinit_rendering(k5, JIDR.neus.color)))):
        want.update({f"{name}/{k}": tuple(v.shape)
                     for k, v in ttree.flatten_with_paths(tree).items()})
    assert got == want
    assert "implicit_network/lin0/v" in got and "rendering_network/lin0/v" in got


def test_idr_queries_and_trace_match_jax(case):
    params, _, batch = case
    jm, tm = JStage2Model(params, JIDR), Stage2Model(params, TIDR, "cpu")
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((17, 3))).astype(np.float32)
    d = rng.standard_normal((17, 3)).astype(np.float32)
    feat = rng.standard_normal((17, 32)).astype(np.float32)
    tx = to_t(x)
    want = jax.jit(lambda x, d, f: (jm.sdf(x), jm.sdf_full(x), jm.sdf_gradient(x),
                                    jm.color(x, x, d, f), jm.borrow_color(x, d)))(x, d, feat)
    got = (tm.sdf(tx), tm.sdf_full(tx), tm.sdf_gradient(tx),
           tm.color(tx, tx, to_t(d), to_t(feat)), tm.borrow_color(tx, to_t(d)))
    for name, a, b in zip(("sdf", "sdf_full", "sdf_gradient", "color", "borrow_color"),
                          got, want):
        assert_close(a, b, **FWD, what=name)
    assert_close(tm.borrow_color(tx, to_t(d), chunk=5), want[-1], **FWD)
    want = jax.jit(jm.trace)(jnp.asarray(batch["points"]), jnp.asarray(batch["dirs"]))
    got = tm.trace(to_t(batch["points"]), to_t(batch["dirs"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < int(got[1].sum()) < 48
    assert_close(got[0], want[0], **FWD)
    assert_close(got[2], want[2], **FWD)
    with pytest.raises(ValueError, match="deviation network"):
        tm.inv_s()


def test_idr_forward_matches_jax(case):
    """``stage2_forward`` with the default SG render on JAX's draws: every
    output JAX's forward gives but ``sdf_output``, which the port does not
    compute (as ``test_torch_stage2_model.py``)."""
    params, _, batch = case
    key = jax.random.PRNGKey(7)
    shift = np.full((48, 1), 0.45, np.float32)
    inp = {"points": batch["points"], "dirs": batch["dirs"],
           "object_mask": batch["object_mask"], "hdr_shift": shift}
    want = jax.jit(lambda p, k, i: jstage2_forward(JStage2Model(p, JIDR), k, i,
                                                   train_spec=True))(
        params, key, {k: jnp.asarray(v) for k, v in inp.items()})
    draws = Draws(given={k: to_t(v) for k, v in jax_stage2_draws(
        key, 48, JIDR, N_LIGHTS, diffuse_nsamp=32).items()})
    got = stage2_forward(Stage2Model(params, TIDR, "cpu"), draws,
                         {k: torch.as_tensor(v) for k, v in inp.items()}, train_spec=True)
    assert 0 < int(got["network_object_mask"].sum()) < 48
    shared = sorted(set(got) & set(want))
    assert set(want) - set(got) == {"sdf_output"}
    for k in shared:
        rtol = 1e-4 if "rgb" in k else 1e-5  # the SG cosine integrals (test_torch_sg.py)
        assert_close(got[k].detach(), want[k], rtol=rtol, atol=1e-5, what=k)


def test_norm_refuses_idr(case):
    """``get_neus_surface`` raises the JAX package's ValueError in IDR mode
    (its message is held to the JAX CLI's ``norm`` in
    ``test_torch_cli.py``)."""
    params, _, _ = case
    x = to_t(0.3 * np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="undefined with model.use_neus=false"):
        tnorm.get_neus_surface(Stage2Model(params, TIDR, "cpu"), x, x, x)

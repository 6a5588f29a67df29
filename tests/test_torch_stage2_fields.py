"""The port's stage-2 fields against the JAX package on bridged weights and
shared draws: IPE, the sparse autoencoder, the envmap/material heads, the
visibility net (plain and factorised), the indirect field, tone mapping,
path filtering, the config loader and the weights bridge on a whole
stage-2 tree.

Tolerances: 1e-5 on forward values (fp32, other summation order); rtol
5e-4 on gradients; bf16-storage paths to bf16 rounding (2e-2 of the
largest entry). The N(0,1) and U[0,1) draws are made from the keys the
JAX code uses and handed to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.core import config as jconfig
from robir_tpu.core import tree as jtree
from robir_tpu.fields import encoding as jenc
from robir_tpu.fields import envmap_material as jenv
from robir_tpu.fields import sparse_ae as jae
from robir_tpu.fields import visibility as jvis
from robir_tpu.render import color as jcolor
from robir_tpu.render.stage2 import Stage2Config as JStage2Config
from robir_tpu.stages import cesr as jcesr
from robir_tpu.stages import stage2_runner as jrunner
from robir_tpu_torch.core import config as tconfig
from robir_tpu_torch.core import tree as ttree
from robir_tpu_torch.core.params import ParamTree, freeze, from_jax, to_numpy
from robir_tpu_torch.fields import encoding as tenc
from robir_tpu_torch.fields import envmap_material as tenv
from robir_tpu_torch.fields import sparse_ae as tae
from robir_tpu_torch.fields import visibility as tvis
from robir_tpu_torch.render import color as tcolor
from robir_tpu_torch.stages import cesr as tcesr
from robir_tpu_torch.stages import stage2_runner as trunner
from torch_port_helpers import assert_close, to_t

SMALL_AE = dict(encoder_dims=(48, 48), decoder_dims=(24,), latent_dim=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pts(seed, n=19, scale=0.6):
    return (scale * np.random.default_rng(seed).standard_normal((n, 3))).astype(np.float32)


def test_integrated_pos_enc_matches_jax():
    jc, tc = jenc.IPEConfig(max_deg=5), tenc.IPEConfig(max_deg=5)
    x, var = _pts(0), np.abs(_pts(1, scale=0.01))
    want = jenc.integrated_pos_enc(jnp.asarray(x), jnp.asarray(var), jc)
    got = tenc.integrated_pos_enc(to_t(x), to_t(var), tc)
    assert got.shape == (19, tc.out_dim) == want.shape
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smooth_on_latent,lc_act,out_act,use_var", [
    (True, "sigmoid", "sigmoid", True), (False, "softplus", None, False),
    (True, "softplus", None, False)])
def test_sparse_ae_matches_jax(smooth_on_latent, lc_act, out_act, use_var):
    """Encode/decode with leaky ReLU, both latent activations, the dropout
    mask, and the smoothness pair from the same N(0,1) draw; then the
    gradient of a loss on both outputs."""
    jc = jae.SparseAEConfig(in_dim=11, out_dim=5, smooth_on_latent=smooth_on_latent,
                            lc_act=lc_act, out_act=out_act, **SMALL_AE)
    tc = tae.SparseAEConfig(**dataclasses.asdict(jc))
    params = jae.init_sparse_ae(jax.random.PRNGKey(1), jc)
    x = np.random.default_rng(2).standard_normal((13, 11)).astype(np.float32)
    var = (np.arange(8) % 3 == 0).astype(np.float32) if use_var else None
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, tc.noise_shape(13))
    w = np.random.default_rng(4).standard_normal((13, 5)).astype(np.float32)

    def jloss(p):
        out, xi = jae.sparse_ae_apply(p, jc, jnp.asarray(x), key,
                                      var=None if var is None else jnp.asarray(var))
        return jnp.sum(out * w) + jnp.sum(xi * xi), (out, xi)

    (_, (jout, jxi)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tp = from_jax(_np(params))
    out, xi = tae.sparse_ae_apply(tp, tc, to_t(x), to_t(noise),
                                  var=None if var is None else to_t(var))
    assert_close(out, jout, rtol=1e-5, atol=1e-5)
    assert_close(xi, jxi, rtol=1e-5, atol=1e-5)
    (torch.sum(out * to_t(w)) + torch.sum(xi * xi)).backward()
    for path, leaf in ttree.flatten_with_paths(tp).items():
        assert_close(leaf.grad, jtree.flatten_with_paths(jg)[path], rtol=5e-4,
                     atol=1e-6, what=path)


def _small_env(**kw):
    return dict(multires=3, num_lgt_sgs=8, **SMALL_AE, **kw)


def test_lgt_sgs_init_structure():
    """Fibonacci lobes duplicated across the halves, lambda >= 10, gray mu,
    energy normalised to 2 pi * 0.8 (the generators differ, so the numbers
    are compared through these invariants)."""
    np.testing.assert_allclose(tenv.fibonacci_sphere(16), jenv.fibonacci_sphere(16))
    tc = tenv.EnvmapMaterialConfig(**_small_env())
    sgs = tenv.init_lgt_sgs(torch.Generator().manual_seed(0), tc).numpy()
    jsgs = np.asarray(jenv.init_lgt_sgs(jax.random.PRNGKey(0), jenv.EnvmapMaterialConfig(
        **_small_env())))
    for a in (sgs, jsgs):
        assert a.shape == (8, 7) and a.dtype == np.float32
        np.testing.assert_allclose(a[:4, :3], tenv.fibonacci_sphere(4), atol=1e-6)
        np.testing.assert_array_equal(a[:4, :3], a[4:, :3])
        assert (a[:, 3] >= 10).all()
        np.testing.assert_array_equal(a[:, 4], a[:, 5])
        np.testing.assert_allclose(tenv.compute_energy(a).sum(0), 2 * np.pi * 0.8,
                                   rtol=1e-4)


@pytest.mark.parametrize("train_spec,upper_hemi,with_noise", [
    (True, False, True), (False, True, False)])
def test_envmap_material_apply_matches_jax(train_spec, upper_hemi, with_noise):
    jc = jenv.EnvmapMaterialConfig(**_small_env(upper_hemi=upper_hemi))
    tc = tenv.EnvmapMaterialConfig(**_small_env(upper_hemi=upper_hemi))
    params = jenv.init_envmap_material(jax.random.PRNGKey(5), jc)
    x = _pts(6)
    spec_var = (np.arange(8) % 4 == 1).astype(np.float32)
    key = jax.random.PRNGKey(7) if with_noise else None
    want = jenv.envmap_material_apply(params, jc, jnp.asarray(x), key=key,
                                      train_spec=train_spec,
                                      spec_var=jnp.asarray(spec_var))
    spec_noise = normal_noise = None
    if with_noise:
        k_spec, k_norm = jax.random.split(key)
        spec_noise = to_t(jax.random.normal(k_spec, tc.spec_brdf_ae.noise_shape(19)))
        normal_noise = to_t(jax.random.normal(k_norm, tc.normal_ae.noise_shape(19)))
    tp = from_jax(_np(params))
    got = tenv.envmap_material_apply(tp, tc, to_t(x), spec_noise, normal_noise,
                                     train_spec=train_spec, spec_var=to_t(spec_var))
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert_close(a, b, rtol=1e-5, atol=1e-5, what=name)


def _vis_case(storage):
    jc = jvis.VisNetConfig(points_multires=3, dirs_multires=2, dims=(40, 40, 40),
                           storage_dtype=storage)
    tc = tvis.VisNetConfig(**dataclasses.asdict(jc))
    params = jvis.init_visnet(jax.random.PRNGKey(8), jc)
    return jc, tc, params, from_jax(_np(params))


@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_visnet_and_outer_product_match_jax(storage):
    """The dense net on [N, K] pairs and the factorised outer-product sweep,
    fp32 and in bf16 storage; in fp32 also the gradient w.r.t. the
    directions (the diffuse sweep's only differentiated input)."""
    jc, tc, params, tp = _vis_case(storage)
    x, d = _pts(9, n=7), _pts(10, n=5)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    want = jvis.visnet_outer_apply(params, jc, jnp.asarray(x), jnp.asarray(d))
    got = tvis.visnet_outer_apply(tp, tc, to_t(x), to_t(d))
    pb = np.broadcast_to(x[:, None], (7, 5, 3))
    db = np.broadcast_to(d[None], (7, 5, 3))
    dense = tvis.visnet_apply(tp, tc, to_t(pb), to_t(db))
    jdense = jvis.visnet_apply(params, jc, jnp.asarray(pb), jnp.asarray(db))
    assert got.shape == (7, 5, 2) and got.dtype == torch.float32
    if storage is None:
        assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert_close(dense, jdense, rtol=1e-5, atol=1e-5)
        w = np.random.default_rng(11).standard_normal((7, 5, 2)).astype(np.float32)
        jgd = jax.grad(lambda dd: jnp.sum(jvis.visnet_outer_apply(
            params, jc, jnp.asarray(x), dd) * w))(jnp.asarray(d))
        td = to_t(d).requires_grad_()
        torch.sum(tvis.visnet_outer_apply(tp, tc, to_t(x), td) * to_t(w)).backward()
        assert_close(td.grad, jgd, rtol=5e-4, atol=1e-6)
    else:
        scale = float(np.abs(np.asarray(want)).max())
        assert_close(got, want, rtol=0, atol=2e-2 * scale)
        assert_close(dense, jdense, rtol=0, atol=2e-2 * scale)


def test_indirect_apply_matches_jax():
    jc = jvis.IndirIllumConfig(multires=3, dims=(40, 40), num_lgt_sgs=6)
    tc = tvis.IndirIllumConfig(**dataclasses.asdict(jc))
    params = jvis.init_indirect(jax.random.PRNGKey(12), jc)
    x = _pts(13)
    shift = np.full((19, 1), 0.4, np.float32)
    key = jax.random.PRNGKey(14)
    want_sgs, want_int = jvis.indirect_apply(params, jc, jnp.asarray(x),
                                             jnp.asarray(shift), key=key)
    noise = to_t(jax.random.normal(key, tc.integral_ae.noise_shape(19)))
    sgs, integral = tvis.indirect_apply(from_jax(_np(params)), tc, to_t(x),
                                        to_t(shift), noise)
    assert sgs.shape == (19, 6, 7)
    assert_close(sgs, want_sgs, rtol=1e-5, atol=1e-5)
    assert_close(integral, want_int, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hdr_mode", [0, 1, 2, 3])
def test_tone_mapping_matches_jax(hdr_mode):
    jc, tc = jcolor.ToneMapConfig(hdr_mode=hdr_mode), tcolor.ToneMapConfig(hdr_mode=hdr_mode)
    jp = jcolor.init_tonemap(jc)
    jp = dict(jp, adapt_illum=jnp.float32(-0.013))
    tp = from_jax(_np(jp))
    x = np.random.default_rng(15).uniform(0.02, 0.9, (9, 3)).astype(np.float32)
    shift = np.random.default_rng(16).uniform(0.05, 0.95, (9, 1)).astype(np.float32)
    assert_close(tcolor.as_input(tp), jcolor.as_input(jp), rtol=1e-6, atol=1e-7)
    for raw in (None, shift):
        for fn, jfn in ((tcolor.hdr2ldr, jcolor.hdr2ldr), (tcolor.ldr2hdr, jcolor.ldr2hdr)):
            got = fn(tp, tc, to_t(x), None if raw is None else to_t(raw))
            want = jfn(jp, jc, jnp.asarray(x), None if raw is None else jnp.asarray(raw))
            assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert_close(tcolor.gamma_forward(tp, to_t(x)), jcolor.gamma_forward(jp, jnp.asarray(x)),
                 rtol=1e-6, atol=1e-7)


def test_tree_filtering_matches_jax():
    tree = {"a": {"x": np.ones(2), "y": {"z": np.zeros(1)}}, "b": np.ones(3),
            "ab": {"q": np.ones(1)}}
    for fn, jfn in ((ttree.keep_prefixes, jtree.keep_prefixes),
                    (ttree.drop_prefixes, jtree.drop_prefixes)):
        for prefixes in (("a",), ("a/y", "b"), ("ab",)):
            got, want = fn(tree, prefixes), jfn(tree, prefixes)
            assert ttree.flatten_with_paths(got).keys() == jtree.flatten_with_paths(want).keys()


def _small_stage2(jax_side: bool):
    from robir_tpu.fields.neus_model import NeuSConfig as JN
    from robir_tpu.fields.radiance import RenderingConfig as JR
    from robir_tpu.fields.sdf import SDFConfig as JS
    from robir_tpu_torch.fields.neus_model import NeuSConfig as TN
    from robir_tpu_torch.fields.radiance import RenderingConfig as TR
    from robir_tpu_torch.fields.sdf import SDFConfig as TS
    from robir_tpu_torch.render.stage2 import Stage2Config as TStage2Config
    N, R, S, C, V, I, E, T = ((JN, JR, JS, JStage2Config, jvis.VisNetConfig,
                               jvis.IndirIllumConfig, jenv.EnvmapMaterialConfig,
                               jcolor.ToneMapConfig) if jax_side else
                              (TN, TR, TS, TStage2Config, tvis.VisNetConfig,
                               tvis.IndirIllumConfig, tenv.EnvmapMaterialConfig,
                               tcolor.ToneMapConfig))
    return C(neus=N(sdf=S(d_out=33, d_hidden=32, n_layers=3, skip_in=(), multires=3),
                    color=R(d_feature=32, d_hidden=32, n_layers=2)),
             envmap=E(**_small_env()), indirect=I(multires=3, dims=(32, 32), num_lgt_sgs=6),
             visnet=V(points_multires=3, dirs_multires=3, dims=(32, 32)),
             tonemap=T(hdr_mode=2), tracer="sphere")


def test_bridge_round_trips_a_stage2_tree():
    """from_jax/to_numpy carry a whole init_stage2_params tree, mixed nodes
    (lgtSGs beside the autoencoders, the tone-map scalars beside the
    energy net) included; freeze leaves only the named subtrees trainable."""
    params = jrunner.init_stage2_params(jax.random.PRNGKey(0), _small_stage2(True))
    params["normal_net"] = {"lin0": {"v": np.ones((2, 3)), "g": np.ones(3), "b": np.ones(3)}}
    tree = from_jax(_np(params))
    assert isinstance(tree["envmap_material_network"], ParamTree)
    assert tree["envmap_material_network"]["lgtSGs"].shape == (8, 7)
    back = to_numpy(tree)
    flat_a = jtree.flatten_with_paths(_np(params))
    flat_b = jtree.flatten_with_paths(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k], np.float32), flat_b[k], err_msg=k)
    port = trunner.init_stage2_params(torch.Generator().manual_seed(0), _small_stage2(False))
    flat_p = ttree.flatten_with_paths(port)
    assert flat_p.keys() == flat_a.keys() - {"normal_net/lin0/v", "normal_net/lin0/g",
                                             "normal_net/lin0/b"}
    for k, v in flat_p.items():
        assert tuple(v.shape) == np.shape(flat_a[k]), k
    trainable = freeze(tree, jcesr.CESRRunner.TRAINABLE[:2])
    names = {n.split(".")[0] for n, p in tree.named_parameters() if p.requires_grad}
    assert names == {"gamma", "envmap_material_network"}
    assert len(trainable) == sum(p.requires_grad for p in tree.parameters())
    with pytest.raises(KeyError):
        freeze(tree, ("no_such_net",))


def test_hotdog_config_matches_jax():
    raw = jconfig.load_config("configs/hotdog.json")
    want = jconfig.build_stage2_config(raw["model"])
    got = tconfig.build_stage2_config(raw["model"])
    for section in ("envmap", "indirect", "visnet", "tonemap", "grid", "sphere_tracer"):
        a, b = dataclasses.asdict(getattr(got, section)), dataclasses.asdict(getattr(want, section))
        assert a == {k: v for k, v in b.items() if k in a}, section
    assert dataclasses.asdict(got.neus.sdf) == dataclasses.asdict(want.neus.sdf)
    assert got.coord_scale == want.coord_scale == 2.0
    assert got.tracer == want.tracer == "grid"
    jstage = jconfig.build_stage_config(jcesr.CESRStageConfig, raw["cesr"])
    tstage = tconfig.build_stage_config(tcesr.CESRStageConfig, raw["cesr"])
    # the same keys and values, the compaction defaults included
    assert dataclasses.asdict(tstage) == dataclasses.asdict(jstage)
    assert tstage.compact_chunk == 128
    with pytest.raises(KeyError):
        tconfig.build_stage2_config({**raw["model"], "no_such_key": 1})
    with pytest.raises(KeyError):
        tconfig.build_stage_config(tcesr.CESRStageConfig, {"no_such_key": 1})
    # bgr and vis_compute_dtype: read as JAX reads them, off by default
    assert (got.bgr, got.vis_compute_dtype) == (want.bgr, want.vis_compute_dtype) == (False, None)
    opts = {**raw["model"], "bgr": True, "vis_compute_dtype": "bfloat16"}
    t_opts, j_opts = tconfig.build_stage2_config(opts), jconfig.build_stage2_config(opts)
    assert (t_opts.bgr, t_opts.vis_compute_dtype) == (j_opts.bgr, j_opts.vis_compute_dtype) \
        == (True, "bfloat16")
    # the light-chunked diffuse sweep: read as JAX reads it, 0 by default
    assert got.sweep_light_chunk == want.sweep_light_chunk == 0
    chunked = {**raw["model"], "sweep_light_chunk": 32}
    assert (tconfig.build_stage2_config(chunked).sweep_light_chunk
            == jconfig.build_stage2_config(chunked).sweep_light_chunk == 32)

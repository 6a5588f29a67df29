"""The port's hash-grid encoding, hash SDF and hash-grid NeuS against the
JAX package: the spatial hash on corner coordinates up to the finest
default level's resolution (``floor(16 * 1.5^15)`` = 7,006), the encoding
and the SDF head (values and every gradient, the tables' too), the NeuS
interface's value and spatial gradient with a loss on that gradient
reaching the tables (JAX's per-point ``vmap(grad)``, the port's
``autograd.grad(create_graph=True)``), one stage-1 train step under the
NeuS renderer on JAX's draws, the mesh of a hash checkpoint from both
packages' ``mesh`` commands, and stage-1 checkpoints read across both
packages.

Tolerances: forward values 1e-5; gradients rtol 5e-4 with an atol of 5e-4
of each tensor's largest entry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu import cli as jcli
from robir_tpu.data import blender as jblender
from robir_tpu.data.synthetic import make_sphere_dataset
from robir_tpu.fields import hashgrid as jhash
from robir_tpu.fields import neus_model as jnm
from robir_tpu.fields.radiance import RenderingConfig as JRenderingConfig
from robir_tpu.render import neus as jneus
from robir_tpu.stages import neus_stage as jstage
from robir_tpu_torch import cli
from robir_tpu_torch.core import checkpoint as ckpt_lib
from robir_tpu_torch.core.draws import Draws
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.data.blender import BlenderConfig, BlenderScene, RayBatch
from robir_tpu_torch.fields import hashgrid as thash
from robir_tpu_torch.fields import neus_model as tnm
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.render import neus as tneus
from robir_tpu_torch.stages import neus_stage as tstage
from robir_tpu_torch.texture.mesh import Mesh
from torch_port_helpers import assert_close, assert_grads_match, grab_grads, to_t

FWD = dict(rtol=1e-5, atol=1e-5)
GRID_KW = dict(n_levels=4, n_features=2, log2_hashmap_size=10, base_resolution=4)
HASH_KW = dict(d_out=9, width=16, depth=2)
COLOR_KW = dict(d_feature=8, d_hidden=16, n_layers=2)
RENDER_KW = dict(n_samples=8, n_importance=8, up_sample_steps=2)


def _cfgs():
    t = tnm.HashNeuSConfig(hash_sdf=thash.HashSDFConfig(grid=thash.HashGridConfig(**GRID_KW),
                                                         **HASH_KW),
                           color=RenderingConfig(**COLOR_KW))
    j = jnm.HashNeuSConfig(hash_sdf=jhash.HashSDFConfig(grid=jhash.HashGridConfig(**GRID_KW),
                                                        **HASH_KW),
                           color=JRenderingConfig(**COLOR_KW))
    return t, j


def _params(cfg, table_scale=1.0):
    """The port's init as numpy, the tables scaled (a larger field than the
    init's +-1e-4, so that the gradients are not all fp32 noise)."""
    p = to_numpy(tnm.init_hash_neus(torch.Generator().manual_seed(0), cfg))
    p["sdf_network"]["hash"]["tables"] *= table_scale
    return p


def test_hash_matches_jax_up_to_the_finest_level():
    cfg = jhash.HashGridConfig()
    top = cfg.resolution(cfg.n_levels - 1)
    assert top == 7006
    rng = np.random.default_rng(0)
    coords = np.concatenate([rng.integers(0, top + 2, (4096, 3)),
                             np.array([[0, 0, 0], [top, top, top], [top + 1, 0, top + 1],
                                       [1, top + 1, 2]])]).astype(np.int32)
    want = np.asarray(jhash._hash(jnp.asarray(coords))).astype(np.int64)
    got = thash.spatial_hash(torch.as_tensor(coords, dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() > 2 ** 31  # the wraparound's top bit is exercised


def test_encoding_and_sdf_match_jax():
    tcfg, jcfg = _cfgs()
    params = _params(tcfg, 1e3)["sdf_network"]
    x = np.random.default_rng(1).uniform(-1.1, 1.1, (64, 3)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((64, 9)).astype(np.float32)
    enc = thash.hashgrid_encode(from_jax(params["hash"]), tcfg.hash_sdf.grid, to_t(x))
    assert_close(enc, jhash.hashgrid_encode(params["hash"], jcfg.hash_sdf.grid, x), **FWD)

    def jf(p):
        out = jhash.hash_sdf_apply(p, jcfg.hash_sdf, x)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(params)
    tp = from_jax(params)
    out = thash.hash_sdf_apply(tp, tcfg.hash_sdf, to_t(x))
    assert_close(out, jout, **FWD)
    torch.sum(out * to_t(w)).backward()
    assert_grads_match(tp, jg)


def test_full_with_grad_and_its_second_order_match_jax():
    """Value and d sdf / dx; then a loss on the gradient (the eikonal form)
    differentiated to the parameters, tables included."""
    tcfg, jcfg = _cfgs()
    params = _params(tcfg, 1e3)
    x = np.random.default_rng(3).uniform(-0.9, 0.9, (48, 3)).astype(np.float32)

    def jf(p):
        full, g = jnm.HashNeuS(p, jcfg).full_with_grad(jnp.asarray(x))
        return jnp.sum((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2) + jnp.sum(full), (full, g)

    (_, (jfull, jgrad)), jg = jax.value_and_grad(jf, has_aux=True)(params)
    model = tnm.HashNeuS(params, tcfg, "cpu")
    full, g = model.full_with_grad(to_t(x))
    assert_close(full, jfull, **FWD)
    assert_close(g, jgrad, **FWD)
    (torch.sum((torch.linalg.norm(g, dim=-1) - 1.0) ** 2) + torch.sum(full)).backward()
    assert_grads_match({"sdf_network": model.params["sdf_network"]},
                       {"sdf_network": jg["sdf_network"]})
    with torch.no_grad():
        full2, g2 = model.full_with_grad(to_t(x))
    assert not full2.requires_grad and torch.equal(g2, g.detach())


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_sphere_dataset(str(tmp_path_factory.mktemp("scene")), n_train=2, n_test=1,
                               h=16, w=16)


def test_train_step_matches_jax(scene_dir):
    """One hash-NeuS step: the loss, every metric and every gradient."""
    tcfg, jcfg = _cfgs()
    params = _params(tcfg, 1e3)
    batch = BlenderScene(BlenderConfig(dataset_dir=scene_dir), "train").sample(
        np.random.default_rng(4), 32)
    train_kw = dict(batch_size=32, lr_delay_steps=0, max_steps=100, anneal_end=10)
    jrender = jneus.NeusRenderConfig(**RENDER_KW)
    _, jrender_fn, _ = jstage.make_stage1_bindings("hash", "neus", jcfg, jrender)
    step = jstage.make_train_step(jcfg, jrender, jstage.NeusTrainConfig(**train_kw),
                                  grab_grads(), render_fn=jrender_fn)
    key = jax.random.PRNGKey(5)
    _, jg, jm = step(jax.tree_util.tree_map(jnp.asarray, params), None,
                     jblender.RayBatch(*map(jnp.asarray, batch)), jnp.asarray(3, jnp.int32), key)
    bindings = tstage.make_stage1_bindings("hash", "neus", tcfg,
                                           tneus.NeusRenderConfig(**RENDER_KW))
    model = bindings.model(params, "cpu")
    rays, pixels = tstage.batch_to_rays(RayBatch(*map(to_t, batch)))
    draws = Draws(given={"t_rand": to_t(jax.random.uniform(jax.random.split(key)[1], (32, 1)))})
    out = bindings.render(draws, rays, model, tstage.cos_anneal_ratio(3, 10))
    loss, metrics = tstage.neus_loss(out, rays.lossmult, pixels,
                                     tstage.NeusTrainConfig(**train_kw))
    for k in jm:
        assert_close(metrics[k].detach(), jm[k], rtol=1e-5, atol=1e-7, what=k)
    loss.backward()
    assert_grads_match(model.params, jg)


def _hash_conf(path):
    conf = {"model": {"type": "hash", "hash_sdf": dict(HASH_KW, grid=GRID_KW),
                      "color": COLOR_KW},
            "render": RENDER_KW, "mesh": {"resolution": 24}}
    with open(path, "w") as f:
        json.dump(conf, f)
    return str(path)


def test_mesh_of_a_hash_checkpoint_matches_jax_cmd_mesh(tmp_path):
    """Both packages' ``mesh`` on one hash checkpoint (tables scaled, the
    sdf's bias moved to its median over the box: a field with a surface):
    vertices within 1e-5, triangles equal."""
    tcfg, _ = _cfgs()
    params = _params(tcfg, 3e3)
    x = torch.as_tensor(np.random.default_rng(6).uniform(-1.2, 1.2, (4096, 3)),
                        dtype=torch.float32)
    with torch.no_grad():
        median = float(tnm.HashNeuS(params, tcfg, "cpu").sdf(x).median())
    params["sdf_network"]["mlp"][f"lin{HASH_KW['depth']}"]["b"][0] -= median
    ckpt = str(tmp_path / "ckpt_000001.npz")
    ckpt_lib.save(ckpt, {"params": params}, step=1)
    args = ["mesh", "--conf", _hash_conf(tmp_path / "conf.json"), "--ckpt", ckpt]
    jcli.main([*args, "--out", str(tmp_path / "jax.ply")])
    cli.main([*args, "--out", str(tmp_path / "port.ply"), "--device", "cpu"])
    want, got = Mesh.load_ply(str(tmp_path / "jax.ply")), Mesh.load_ply(str(tmp_path / "port.ply"))
    assert len(want.tris) > 0
    np.testing.assert_array_equal(got.tris, want.tris)
    np.testing.assert_allclose(got.verts, want.verts, atol=1e-5)


def test_checkpoints_cross_both_packages(tmp_path, scene_dir):
    """A hash stage-1 checkpoint of the port's trainer (after a step: Adam
    moments set) resumes a JAX trainer, and a JAX trainer's resumes the
    port's: parameters, moments and step bit-equal."""
    from robir_tpu.core.tree import flatten_with_paths as jflat
    from robir_tpu.core.tree import to_plain
    tcfg, jcfg = _cfgs()
    train_kw = dict(batch_size=16, lr_delay_steps=0, max_steps=100)
    trender = tneus.NeusRenderConfig(**RENDER_KW)
    tt = tstage.NeusTrainer(BlenderScene(BlenderConfig(dataset_dir=scene_dir), "train"), tcfg,
                            trender, tstage.NeusTrainConfig(**train_kw), device="cpu",
                            log_dir=str(tmp_path / "port"),
                            bindings=tstage.make_stage1_bindings("hash", "neus", tcfg, trender))
    try:
        tt.run(1)
        port_file = tt.save()
    finally:
        tt.close()
    jrender = jneus.NeusRenderConfig(**RENDER_KW)
    jt = jstage.NeusTrainer(jblender.BlenderScene(jblender.BlenderConfig(dataset_dir=scene_dir),
                                                  "train"),
                            jcfg, jrender, jstage.NeusTrainConfig(**train_kw),
                            log_dir=str(tmp_path / "jax"), seed=3,
                            bindings=jstage.make_stage1_bindings("hash", "neus", jcfg, jrender))
    jax_file = jt.save()
    jt.restore(port_file)
    saved = flatten_with_paths(ckpt_lib.load(port_file)[0])
    got = jflat(to_plain({"params": jt.params, "opt_state": jt.opt_state}))
    assert sorted(got) == sorted(saved) and jt.step == 1
    assert all(np.array_equal(np.asarray(got[k]), saved[k]) for k in saved)
    tt.restore(jax_file)
    want = flatten_with_paths(ckpt_lib.load(jax_file)[0])
    state = tt.state()
    assert sorted(state) == sorted(want) and tt.step == 0
    assert all(np.array_equal(state[k], want[k]) for k in want)

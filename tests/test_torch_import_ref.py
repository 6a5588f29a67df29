"""The port's reference-checkpoint import (``core/import_ref.py``) against the
JAX package's: the key map on keys that exercise every rule, the files
``import_stage1`` and ``import_stage2`` write (each filter), and
``graft``'s refusals. The reference checkpoints are built in memory from
seeded parameter trees through ``torch_port_helpers.reference_state_dict``
(the inverse of the key map), so no reference checkpoint is needed.

Tolerance: none; the imported leaves are bit-equal across the packages and
to their source.
"""

import numpy as np
import pytest
import torch

from robir_tpu.core import checkpoint as jckpt
from robir_tpu.core import import_ref as jimport
from robir_tpu_torch.core import checkpoint as tckpt
from robir_tpu_torch.core import import_ref as timport
from robir_tpu_torch.core.config import build_stage2_config, load_config
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.core.tree import flatten_with_paths
from robir_tpu_torch.fields.neus_model import init_neus
from robir_tpu_torch.fields.sdf import init_sdf
from robir_tpu_torch.stages.cesr import CESRStageConfig
from robir_tpu_torch.stages.stage2_runner import init_stage2_params
from torch_port_helpers import reference_key, reference_state_dict

CFG = build_stage2_config(load_config("configs/sphere_smoke.json")["model"])

# keys through every rule of the map: weight, weight_v, weight_g, bias; both
# Sequential tables; the stage-2 bridge's implicit_network.neus_model
# prefix; hdr_shift; the renames; bare parameters; a table's name not
# followed by an index
KEYS = [
    "sdf_network.lin0.weight_v", "sdf_network.lin0.weight_g", "sdf_network.lin3.bias",
    "implicit_network.neus_model.sdf_network.lin2.weight_v",
    "implicit_network.neus_model.color_network.lin0.weight_g",
    "implicit_network.neus_model.deviation_network.variance",
    "visibility_network.vis_layer.0.weight", "visibility_network.vis_layer.4.bias",
    "envmap_material_network.spec_brdf_encoder_layer.brdf_encoder_layer.2.weight",
    "envmap_material_network.normal_decoder_layer.brdf_decoder_layer.0.bias",
    "indirect_illum_network.lobe_layer.4.weight", "gamma.mlp.6.weight", "gamma.mlp.bias",
    "nerf_outside.pts_linears.7.weight", "nerf_outside.views_linears.0.bias",
    "nerf_outside.feature_linear.weight", "nerf_outside.alpha_linear.bias",
    "nerf_outside.rgb_linear.weight", "gamma.hdr_shift.adapt_illum", "gamma.gamma",
    "envmap_material_network.lgtSGs", "envmap_material_network.specular_reflectance",
]


@pytest.mark.parametrize("key", KEYS)
def test_map_key_matches_jax(key):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    if key.endswith("weight_g"):
        a = a[:, :1]
    path, xform = timport._map_key(key)
    jpath, jxform = jimport._map_key(key)
    assert path == jpath
    np.testing.assert_array_equal(xform(a), jxform(a))


def _stage2_tree(seed: int, cesr: bool = False) -> dict:
    tree = to_numpy(init_stage2_params(torch.Generator().manual_seed(seed), CFG))
    if cesr:
        gen = torch.Generator().manual_seed(seed + 1)
        tree["shadow_net"] = to_numpy(init_sdf(gen, CESRStageConfig().shadow_cfg))
    return tree


def test_reference_key_inverts_the_map():
    """The helper's reference keys map back to every path of a stage-2 tree
    with CESR's nets and of a stage-1 NeuS, and the converted state dict
    holds the tree's leaves bit for bit."""
    for tree in (_stage2_tree(0, cesr=True),
                 to_numpy(init_neus(torch.Generator().manual_seed(0), CFG.neus))):
        flat = flatten_with_paths(tree)
        assert all(timport._map_key(reference_key(k)[0])[0] == k for k in flat)
        back = flatten_with_paths(timport.convert_state_dict(reference_state_dict(tree)))
        assert back.keys() == flat.keys()
        assert all(np.array_equal(back[k], flat[k]) for k in flat)


def _files_equal(got_path, want_path):
    got, gmeta = tckpt.load(got_path)
    want, wmeta = jckpt.load(want_path)
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert gmeta == wmeta
    return g


def test_import_stage1_matches_jax(tmp_path):
    neus = to_numpy(init_neus(torch.Generator().manual_seed(3), CFG.neus))
    tar = str(tmp_path / "001234.tar")
    torch.save({"global_step": 1234, "resume_time": 1.0,
                "model": reference_state_dict(neus)}, tar)
    got = timport.import_stage1(tar, str(tmp_path / "port"))
    want = jimport.import_stage1(tar, str(tmp_path / "jax"))
    assert got.endswith("ckpt_001234.npz") and want.endswith("ckpt_001234.npz")
    flat = _files_equal(got, want)
    src = flatten_with_paths(neus)
    assert all(np.array_equal(flat["params/" + k], v) for k, v in src.items())


@pytest.mark.parametrize("filter_name", ["all", "pbr_resume", "norm_only", "illum"])
def test_import_stage2_matches_jax(tmp_path, filter_name):
    """A CESR-era pth (its shadow_net dropped by ``ignore_unknown``) grafted
    onto another seed's init through each filter: both packages' files
    equal; each leaf the filter keeps is the source's, every other the
    base's."""
    base, src = _stage2_tree(0), _stage2_tree(7, cesr=True)
    pth = str(tmp_path / "latest.pth")
    torch.save({"model_state_dict": reference_state_dict(src), "epoch": 9}, pth)
    got = timport.import_stage2(pth, base, str(tmp_path / "port.npz"), filter_name,
                                ignore_unknown=True)
    want = jimport.import_stage2(pth, base, str(tmp_path / "jax.npz"), filter_name,
                                 ignore_unknown=True)
    flat = _files_equal(got, want)
    keep = timport.FILTERS[filter_name] or (lambda p: True)
    b, s = flatten_with_paths(base), flatten_with_paths(src)
    assert flat.keys() == b.keys()
    assert all(np.array_equal(flat[k], s[k] if keep(k) else b[k]) for k in b)
    assert tckpt.load(got)[1]["step"] == 9


def test_graft_refuses_unknown_paths_and_shapes():
    base = _stage2_tree(0)
    extra = {"shadow_net": {"lin0": {"b": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="shadow_net/lin0/b"):
        timport.graft(base, extra)
    with pytest.raises(KeyError):
        jimport.graft(base, extra)
    kept = timport.graft(base, extra, ignore_unknown=True)
    assert "shadow_net" not in kept
    wrong = {"envmap_material_network": {"lgtSGs": np.zeros((3, 7), np.float32)}}
    with pytest.raises(ValueError, match="lgtSGs"):
        timport.graft(base, wrong)
    with pytest.raises(ValueError):
        jimport.graft(base, wrong)

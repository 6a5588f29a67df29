"""The port's texture extraction (``tools/tex_extract.py``) against the JAX
package's: ``extract_textures`` on a marching-tetrahedra mesh of the
shadow scene's two spheres whose cache holds ``torch_port_helpers.grid_atlas``
and the port's rasterised maps (so that no atlas runs and both packages
read one set of maps); the four maps, the PNGs, and the OBJ and MTL
bytes; ``mutual_information`` on random maps.

Tolerances: the maps 1e-5 (the same material net in fp32 in another
summation order); the PNGs within one 8-bit level; the OBJ, the MTL and
the mutual information exact (the same host code).
"""

import os

import numpy as np
import torch
from PIL import Image

from robir_tpu.tools import tex_extract as jtex
from robir_tpu_torch.core.config import build_stage2_config, load_config
from robir_tpu_torch.core.params import to_numpy
from robir_tpu_torch.stages.stage2_runner import init_stage2_params
from robir_tpu_torch.tools import tex_extract as ttex
from torch_port_helpers import two_sphere_tex_sampler

RES = 64


def test_extract_textures_matches_jax(tmp_path):
    from robir_tpu.core.config import build_stage2_config as jbuild_stage2_config
    raw = load_config("configs/sphere_smoke.json")["model"]
    params = to_numpy(init_stage2_params(torch.Generator().manual_seed(4),
                                         build_stage2_config(raw)))
    two_sphere_tex_sampler(str(tmp_path), RES)  # writes the mesh and fills its cache
    mesh = str(tmp_path / "mesh.ply")
    got = ttex.extract_textures(params, build_stage2_config(raw), mesh, str(tmp_path / "port"),
                                resolution=RES, chunk=1000, device="cpu")
    want = jtex.extract_textures(params, jbuild_stage2_config(raw), mesh, str(tmp_path / "jax"),
                                 resolution=RES, chunk=1000)
    assert got.keys() == want.keys() == {"albedo", "roughness", "metallic", "normal"}
    for k in want:
        assert got[k].shape == (RES, RES, 3)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert 0.05 < float((got["normal"].sum(-1) > 0).mean()) < 0.95
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a, b = (str(tmp_path / d / name) for d in ("port", "jax"))
        if name.endswith(".png"):
            diff = np.abs(np.asarray(Image.open(a), np.int16) - np.asarray(Image.open(b), np.int16))
            assert diff.max() <= 1, name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_mutual_information_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 50, 3)).astype(np.float32)
    b = 0.5 * a + 0.5 * rng.random((40, 50, 3)).astype(np.float32)
    for x, y in ((a, b), (a[..., 0], b[..., 0]), (a, a)):
        assert ttex.mutual_information(x, y) == jtex.mutual_information(x, y)
    assert ttex.mutual_information(a, a) > ttex.mutual_information(a, b) > 0

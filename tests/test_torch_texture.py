"""The port's texture pipeline (``texture/pipeline.py``, ``utils/exr.py``)
against the JAX package's: ``erode_map``, EXR files in ZIP and PIZ written
by either package and read by the other, ``TexSampler``'s maps at 256 on a
sphere mesh, the cache directory read across the packages, and
``TexSampler.sample`` on one numpy seed; one arm of the atlas in both
builds of the native library.

Tolerances: erode and EXR exact (the same numpy arithmetic, files
byte-equal); the atlas's UVs, the maps and the samples within 1e-6 (the
atlas and the rasteriser are two builds of one C++ source, which may be
compiled with different flags).
"""

import os
import shutil

import numpy as np
import pytest

from robir_tpu.texture import native as jnative
from robir_tpu.texture import pipeline as jpipe
from robir_tpu.utils import exr as jexr
from robir_tpu_torch.texture import mesh as tmesh
from robir_tpu_torch.texture import native as tnative
from robir_tpu_torch.texture import pipeline as tpipe
from robir_tpu_torch.utils import exr as texr

TEX_RES = 256


def sphere_mesh(res: int = 40, radius: float = 0.5):
    axes = [np.linspace(-1.2, 1.2, res, dtype=np.float32)] * 3
    p = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    grid = (np.linalg.norm(p, axis=-1) - radius).astype(np.float32)
    verts, tris = tnative.marching_tetrahedra(grid, (-1.2,) * 3, (1.2,) * 3)
    return tmesh.Mesh(verts, tris)


@pytest.fixture(scope="module")
def atlas():
    """A sphere mesh and one arm of each package's atlas on it (the
    portfolio's eight arms take a few seconds each)."""
    mesh = sphere_mesh()
    return mesh, {"port": tnative.atlas_parameterize(mesh.verts, mesh.tris, 0.6),
                  "jax": jnative.atlas_parameterize(mesh.verts, mesh.tris, 0.6)}


@pytest.fixture(scope="module")
def samplers(tmp_path_factory, atlas):
    """Each package's TexSampler on its own copy of the mesh, whose cache
    holds only the shared atlas (``uv.npz``, as TextureCache writes it), so
    that each rasterises, writes, reads and erodes its own maps; then each
    package's on the other's filled cache.

    Both rasterise through the port's build of the native library: the
    JAX package's build may contract products into fused multiply-adds
    (``-march=native``), which moves the rasterised mask by an ulp from
    1.0, and ``erode_map`` takes a texel as masked only at exactly 1
    (``test_rasterizers_agree`` holds the two builds to each other)."""
    root = tmp_path_factory.mktemp("tex")
    mesh, arms = atlas
    uv, idx, _ = arms["port"]
    for kind in ("jax", "port"):
        os.makedirs(root / kind / "mesh.cache")
        mesh.export_ply(str(root / kind / "mesh.ply"))
        np.savez(root / kind / "mesh.cache" / "uv.npz", uv=uv, idx=idx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "rasterize_attributes", tnative.rasterize_attributes)
        out = {"jax": jpipe.TexSampler(str(root / "jax" / "mesh.ply"), TEX_RES)}
    out["port"] = tpipe.TexSampler(str(root / "port" / "mesh.ply"), TEX_RES)
    out["port_on_jax_cache"] = tpipe.TexSampler(str(root / "jax" / "mesh.ply"), TEX_RES)
    out["jax_on_port_cache"] = jpipe.TexSampler(str(root / "port" / "mesh.ply"), TEX_RES)
    return root, out


def test_atlas_matches_jax(atlas):
    """One arm of the atlas in both builds: the same charts and corners,
    UVs within 1e-6."""
    mesh, arms = atlas
    (uv, idx, nc), (juv, jidx, jnc) = arms["port"], arms["jax"]
    assert nc == jnc > 1 and uv.shape == (len(mesh.tris) * 3, 2)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(uv, juv, rtol=0, atol=1e-6)
    assert 0 <= uv.min() and uv.max() <= 1


def test_rasterizers_agree(atlas):
    """The two builds' rasterisations of the vertex positions and of ones
    over the shared atlas: the same coverage, values within 1e-6."""
    mesh, arms = atlas
    uv, idx, _ = arms["port"]
    tris = np.arange(len(uv), dtype=np.int32).reshape(-1, 3)
    for attr in (mesh.verts[idx], np.ones((len(uv), 3), np.float32)):
        got = tnative.rasterize_attributes(uv, tris, attr, TEX_RES, TEX_RES)
        want = jnative.rasterize_attributes(uv, tris, attr, TEX_RES, TEX_RES)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert 0.3 < got[1].mean() < 0.95


def test_erode_map_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((33, 29, 3)).astype(np.float32)
    mask = np.repeat((rng.random((33, 29, 1)) > 0.6).astype(np.float32), 3, -1)
    got, want = tpipe.erode_map(img, mask), jpipe.erode_map(img, mask, 2)
    np.testing.assert_array_equal(got, want)
    filled = (mask.mean(-1) < 1)
    assert not np.array_equal(got[filled], img[filled])
    np.testing.assert_array_equal(got[~filled], img[~filled])


@pytest.mark.parametrize("compression", ["zip", "piz", "none"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_exr_across_packages(tmp_path, compression, channels):
    """A file written by either package is byte-equal to the other's and
    reads the same in both: exact in FLOAT, HALF-rounded in PIZ."""
    rng = np.random.default_rng(channels)
    img = (rng.standard_normal((45, 37, channels)) * 4).astype(np.float32)
    img[:16] = 0.25  # a compressible band
    texr.write_exr(str(tmp_path / "port.exr"), img, compression)
    jexr.write_exr(str(tmp_path / "jax.exr"), img, compression)
    assert (tmp_path / "port.exr").read_bytes() == (tmp_path / "jax.exr").read_bytes()
    want = img if compression != "piz" else img.astype(np.float16).astype(np.float32)
    for name in ("port.exr", "jax.exr"):
        for read in (texr.read_exr, jexr.read_exr):
            np.testing.assert_array_equal(read(str(tmp_path / name)), want)


def test_texture_maps_match_jax(samplers):
    """The eroded vertex and normal maps and the mask of the two packages'
    TexSamplers on one mesh."""
    _, s = samplers
    port, ref = s["port"], s["jax"]
    assert port.vert.shape == (TEX_RES, TEX_RES, 3) and port.mask.dtype == bool
    np.testing.assert_array_equal(port.mask, ref.mask)
    assert 0.3 < port.mask.mean() < 0.95
    np.testing.assert_allclose(port.vert, ref.vert, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.norm, ref.norm, rtol=0, atol=1e-6)
    # texels on the sphere (the erosion's ring averages across the charts'
    # gutters, which the atlas sizes for a 2,048 texture)
    r = np.linalg.norm(port.vert[port.mask], axis=-1)
    assert np.median(np.abs(r - 0.5)) < 0.005


def test_caches_read_across_packages(samplers):
    """The cache beside each mesh has the JAX layout and file names, and
    either package's TexSampler on the other's cache reads its maps."""
    root, s = samplers
    for kind in ("jax", "port"):
        names = sorted(os.listdir(root / kind / "mesh.cache"))
        assert names == sorted(["uv.npz"] + [f"{t}x{TEX_RES}.exr"
                                             for t in ("vert", "norm", "mask")])
    for reader, writer in (("port_on_jax_cache", "jax"), ("jax_on_port_cache", "port")):
        for attr in ("vert", "norm", "mask"):
            np.testing.assert_array_equal(getattr(s[reader], attr), getattr(s[writer], attr))
    port_cache = tpipe.TextureCache(str(root / "jax" / "mesh.ply"))
    jax_cache = jpipe.TextureCache(str(root / "jax" / "mesh.ply"))
    np.testing.assert_array_equal(port_cache.uv, jax_cache.uv)
    for a, b in zip(port_cache.load_basics(TEX_RES), jax_cache.load_basics(TEX_RES)):
        np.testing.assert_array_equal(a, b)


def test_render_basics_is_rasterize_basics(samplers, tmp_path):
    """The cache's EXRs hold rasterize_basics' images."""
    root, _ = samplers
    shutil.copy(root / "port" / "mesh.ply", tmp_path / "m.ply")
    os.makedirs(tmp_path / "m.cache")
    shutil.copy(root / "port" / "mesh.cache" / "uv.npz", tmp_path / "m.cache" / "uv.npz")
    cache = tpipe.TextureCache(str(tmp_path / "m.ply"))
    imgs = cache.rasterize_basics(64)
    cache.render_basics(64)
    for tag, got in zip(("vert", "norm", "mask"), cache.load_basics(64)):
        np.testing.assert_array_equal(got, imgs[tag])
    assert imgs["mask"].max() == 1.0


def test_sample_matches_jax(samplers):
    """TexSampler.sample on one numpy seed: every output equal, the points
    in stage-2 coordinates (x 0.5)."""
    _, s = samplers
    got = s["port"].sample(np.random.default_rng(5), 500)
    want = s["jax"].sample(np.random.default_rng(5), 500)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    m = got["object_mask"]
    assert m.mean() > 0.3
    r = np.linalg.norm(got["x"][m], axis=-1)
    assert np.median(np.abs(r - 0.25)) < 0.0025


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((9, 13, 2)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.bilinear_sample(img, uv), jpipe.bilinear_sample(img, uv))

"""The port's mesh export (``texture/mesh.py``, ``texture/native.py``,
``NeusTrainer.extract_mesh``) against the JAX package's, on a small
seeded NeuS (3 layers, width 48) at resolution 40: the SDF grid that each
package's ``extract_mesh`` meshes, the two marching-tetrahedra copies on
one grid, PLY and OBJ files across the packages, the OBJ loader on quads
and the vertex normals. Also: the port builds its own native library
under ``robir_tpu_torch/build/``, never under ``native/``.

Tolerances: the two SDF grids to 1e-5 (fp32, another summation order);
on one shared grid, identical triangles and vertices within 1e-6 (the two
libraries may be compiled with different flags); files and normals exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robir_tpu.fields import sdf as jsdf
from robir_tpu.fields.neus_model import NeuS as JNeuS
from robir_tpu.fields.neus_model import NeuSConfig as JNeuSConfig
from robir_tpu.fields.radiance import RenderingConfig as JRender
from robir_tpu.texture import mesh as jmesh
from robir_tpu.texture import native as jnative
from robir_tpu.texture import pipeline as jpipe
from robir_tpu_torch.core.params import from_jax, to_numpy
from robir_tpu_torch.data.synthetic import make_sphere_scene
from robir_tpu_torch.fields import sdf as tsdf
from robir_tpu_torch.fields.neus_model import NeuSConfig, init_neus
from robir_tpu_torch.fields.radiance import RenderingConfig
from robir_tpu_torch.render.neus import NeusRenderConfig
from robir_tpu_torch.stages.neus_stage import NeusTrainConfig, NeusTrainer
from robir_tpu_torch.texture import mesh as tmesh
from robir_tpu_torch.texture import native as tnative
from robir_tpu_torch.texture import pipeline as tpipe

RES = 40
SDF = dict(d_out=17, d_hidden=48, n_layers=3, skip_in=(2,), multires=3, bias=0.5)
COLOR = dict(d_feature=16, d_hidden=16, n_layers=2)
BOX = ((-1.2,) * 3, (1.2,) * 3)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh_case(monkeypatch_module):
    """A seeded NeuS's SDF grid as each package's extract_mesh meshes it
    (the grid handed to marching tetrahedra, caught on its way), and both
    meshes."""
    tcfg = NeuSConfig(sdf=tsdf.SDFConfig(**SDF), color=RenderingConfig(**COLOR))
    jcfg = JNeuSConfig(sdf=jsdf.SDFConfig(**SDF), color=JRender(**COLOR))
    params = to_numpy(init_neus(torch.Generator().manual_seed(3), tcfg))
    grids = {}

    def catch(which, real):
        def mt(grid, *args):
            grids[which] = np.array(grid)
            return real(grid, *args)
        return mt

    monkeypatch_module.setattr(jnative, "marching_tetrahedra",
                               catch("jax", jnative.marching_tetrahedra))
    jax_mesh = jmesh.extract_mesh(JNeuS(params, jcfg).sdf, *BOX, resolution=RES)
    monkeypatch_module.setattr(tmesh, "marching_tetrahedra",
                               catch("port", tmesh.marching_tetrahedra))
    sdf = tsdf.frozen_sdf(from_jax(params)["sdf_network"], tcfg.sdf, out_cols=1)
    port_mesh = tmesh.extract_mesh(sdf, *BOX, resolution=RES, device="cpu")
    return params, tcfg, grids, jax_mesh, port_mesh


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_sdf_grid_matches_jax(mesh_case):
    """The grid each package meshes: the same nodes (numpy's float32 axes),
    the last chunk padded; values within 1e-5; a surface inside."""
    _, _, grids, _, _ = mesh_case
    assert grids["port"].shape == grids["jax"].shape == (RES,) * 3
    np.testing.assert_allclose(grids["port"], grids["jax"], rtol=0, atol=1e-5)
    assert grids["jax"].min() < 0 < grids["jax"].max()


def test_sdf_grid_nodes_and_padding():
    """sdf_grid evaluates numpy's float32 linspace nodes in x-major order,
    in chunks of 65,536 points, the last padded with zero points."""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x[:, 1]

    lo, hi = (-1.0, -0.5, 0.0), (1.0, 0.5, 2.0)
    R = 41  # 68,921 nodes: two chunks, the second padded
    grid = tmesh.sdf_grid(fn, lo, hi, R, device="cpu")
    # JAX's axes: float32 endpoints, float32 linspace
    lo32, hi32 = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    axes = [np.linspace(lo32[i], hi32[i], R, dtype=np.float32) for i in range(3)]
    p = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    np.testing.assert_array_equal(grid, p[..., 1])
    assert [x.shape[0] for x in seen] == [tmesh.MESH_CHUNK] * 2
    pts = torch.cat(seen).numpy()
    np.testing.assert_array_equal(pts[:R ** 3], p.reshape(-1, 3))
    assert not pts[R ** 3:].any()


def test_both_marching_tetrahedra_on_one_grid(mesh_case):
    """JAX's grid through both libraries: identical triangles, vertices
    within 1e-6; and each package's mesh is its own grid's."""
    _, _, grids, jax_mesh, port_mesh = mesh_case
    jv, jt = jnative.marching_tetrahedra(grids["jax"], *BOX)
    tv, tt = tnative.marching_tetrahedra(grids["jax"], *BOX)
    assert len(jt) > 100
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(jax_mesh.tris, jt)
    pv, pt = tnative.marching_tetrahedra(grids["port"], *BOX)
    np.testing.assert_array_equal(port_mesh.tris, pt)
    np.testing.assert_array_equal(port_mesh.verts, pv)


def test_vertex_normals_and_bounds_match_jax(mesh_case):
    _, _, _, jax_mesh, _ = mesh_case
    port = tmesh.Mesh(jax_mesh.verts, jax_mesh.tris)
    np.testing.assert_array_equal(port.vertex_normals(), jax_mesh.vertex_normals())
    for a, b in zip(port.bounds(), jax_mesh.bounds()):
        np.testing.assert_array_equal(a, b)


def test_ply_and_obj_across_packages(mesh_case, tmp_path):
    """A PLY written by either package loads in the other unchanged; an
    OBJ (with and without UVs) reads the same through both loaders."""
    _, _, _, jax_mesh, port_mesh = mesh_case
    port_mesh.export_ply(str(tmp_path / "port.ply"))
    jax_mesh.export_ply(str(tmp_path / "jax.ply"))
    tmesh.Mesh(jax_mesh.verts, jax_mesh.tris).export_ply(str(tmp_path / "same.ply"))
    assert (tmp_path / "same.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for path, src in (("port.ply", port_mesh), ("jax.ply", jax_mesh)):
        for loader in (jmesh.Mesh.load_ply, tmesh.Mesh.load_ply):
            m = loader(str(tmp_path / path))
            np.testing.assert_array_equal(m.verts, src.verts)
            np.testing.assert_array_equal(m.tris, src.tris)
    uv = np.random.default_rng(0).random((len(port_mesh.tris) * 3, 2)).astype(np.float32)
    port_mesh.export_obj(str(tmp_path / "port.obj"), uv=uv, mtl_name="m")
    jmesh.Mesh(port_mesh.verts, port_mesh.tris).export_obj(str(tmp_path / "jax.obj"), uv=uv,
                                                           mtl_name="m")
    assert (tmp_path / "port.obj").read_text() == (tmp_path / "jax.obj").read_text()
    port_mesh.export_obj(str(tmp_path / "plain.obj"))
    for name in ("port.obj", "plain.obj"):
        a = tpipe._load_obj_mesh(str(tmp_path / name))
        b = jpipe._load_obj_mesh(str(tmp_path / name))
        np.testing.assert_array_equal(a.tris, b.tris)
        np.testing.assert_array_equal(a.verts, b.verts)
        np.testing.assert_array_equal(a.tris, port_mesh.tris)
        # six decimals in the file, then a float32 parse: 5e-7 + half an ulp
        np.testing.assert_allclose(a.verts, port_mesh.verts, rtol=0, atol=6e-7)


def test_obj_loader_fan_triangulates_quads(tmp_path):
    path = tmp_path / "quads.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                    "f 1/1 2/2 3/3 4/4\nf 1 2 5\nf 2//1 3//1 4//1 5//1 1//1\n")
    got, want = tpipe._load_obj_mesh(str(path)), jpipe._load_obj_mesh(str(path))
    np.testing.assert_array_equal(got.tris, [[0, 1, 2], [0, 2, 3], [0, 1, 4],
                                             [1, 2, 3], [1, 3, 4], [1, 4, 0]])
    np.testing.assert_array_equal(got.tris, want.tris)
    np.testing.assert_array_equal(got.verts, want.verts)


def test_trainer_extract_mesh(mesh_case):
    """NeusTrainer.extract_mesh meshes the trainer's SDF over
    [-mesh_bbox, mesh_bbox]^3 at its resolution: the same mesh as
    extract_mesh of that SDF."""
    params, tcfg, _, _, _ = mesh_case
    scene = make_sphere_scene("train", h=8, w=8, seed=0)
    trainer = NeusTrainer(scene, tcfg, NeusRenderConfig(n_samples=8, n_importance=8),
                          NeusTrainConfig(mesh_resolution=24, mesh_bbox=1.1), seed=3,
                          device="cpu")
    got = trainer.extract_mesh()
    sdf = tsdf.frozen_sdf(from_jax(params)["sdf_network"], tcfg.sdf, out_cols=1)
    want = tmesh.extract_mesh(sdf, (-1.1,) * 3, (1.1,) * 3, resolution=24, device="cpu")
    np.testing.assert_array_equal(got.tris, want.tris)
    np.testing.assert_array_equal(got.verts, want.verts)
    assert len(got.tris) > 0 and np.abs(got.verts).max() <= 1.1
    assert len(trainer.extract_mesh(16).tris) < len(got.tris)


def test_native_library_builds_in_the_port():
    """The port's library is its own build under robir_tpu_torch/build/,
    named by a hash of the source and flags; nothing under native/."""
    path = tnative.build()
    assert path == tnative.library_path() and path.exists()
    assert path.parent == tnative.BUILD_DIR
    assert os.path.relpath(path, REPO_ROOT).split(os.sep)[:2] == ["robir_tpu_torch", "build"]
    assert tnative.SOURCE.read_bytes().endswith(
        open(os.path.join(REPO_ROOT, "native", "robir_native.cpp"), "rb").read())
    assert os.path.realpath(tnative._load()._name) == os.path.realpath(path)

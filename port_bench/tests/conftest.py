"""Shared fixtures of the benchmark's own tests: cells at tiny widths on
the CPU, written beside copies of the metric readers and layer lists."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from port_bench import manifest  # noqa: E402

LIMITS = {"loss": 1e-3, "loss_step1": 1e-3, "first_grad": 3e-4, "change": 4e-3}


def tiny_neus(config: dict) -> dict:
    m = config["model"]
    m["sdf"].update(d_hidden=32, n_layers=4, skip_in=[2], d_out=33, multires=4)
    m["color"].update(d_feature=32, d_hidden=32, n_layers=2)
    config["render"].update(n_samples=8, n_importance=8, up_sample_steps=2)
    return config


def tiny_hotdog(config: dict) -> dict:
    m = config["model"]
    m["neus"]["sdf"].update(d_hidden=32, n_layers=4, skip_in=[2], d_out=33, multires=4)
    m["neus"]["color"].update(d_feature=32, d_hidden=32, n_layers=2)
    m["envmap_material_network"].update(num_lgt_sgs=8, multires=4)
    m["indirect_illum_network"].update(dims=[32, 32], num_lgt_sgs=4, multires=4)
    m["visibility_network"].update(dims=[32, 32], points_multires=4, dirs_multires=4)
    m["grid"].update(resolution=32, max_steps=64)
    # compacted at this batch, as the full batch is at the published chunk
    config["pbr"]["compact_chunk"] = 16
    return config


def _traffic(name: str, **changes) -> dict:
    with open(os.path.join(manifest.ROOT, "traffic", f"{name}.json")) as fp:
        t = json.load(fp)
    t.update(warmup_steps=1, trace_skip_steps=1, trace_steps=3, **changes)
    return t


@pytest.fixture
def tiny_root(tmp_path):
    """A cell root with ``tiny.train`` (stage 1) and ``tinyhd.pbr``."""
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    for sub in ("metrics", "layers"):
        shutil.copytree(os.path.join(manifest.ROOT, sub), tmp_path / sub)
    with open(os.path.join(manifest.ROOT, "configs", "neus_blender.json")) as fp:
        neus = tiny_neus(json.load(fp))
    with open(os.path.join(manifest.ROOT, "configs", "hotdog.json")) as fp:
        hotdog = tiny_hotdog(json.load(fp))
    files = {
        "configs/tiny.json": neus, "configs/tinyhd.json": hotdog,
        "traffic/train.json": _traffic("train_2k", batch=32, scene={
            "kind": "sphere", "views": 4, "size": 16, "camera_angle_x": 0.6911112070083618}),
        # a frozen NeuS whose tiny trunk reaches the surface in this scene
        "traffic/pbr.json": _traffic("pbr_8k", batch=64, neus_seed=2 ** 31 + 11, scene={
            "kind": "two_spheres", "views": 4, "size": 16, "camera_angle_x": 0.45}),
        "limits/tiny.train.json": LIMITS, "limits/tinyhd.pbr.json": LIMITS}
    for rel, obj in files.items():
        (tmp_path / rel).write_text(json.dumps(obj))
    return str(tmp_path)

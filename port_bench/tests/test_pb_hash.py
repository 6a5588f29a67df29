"""The hash-grid NeuS cell at a tiny size: a whole run agrees with the plain
reference, each fault planted in the timed path makes ``correct`` false, a
traced run reads the hash metrics (on the CPU all but the roofline and the
scans, which need the card's kernel time: their readers are held on
hand-made traces, and on a card by a traced run), and
``neus_blender.train_512`` resolves to the ``neus`` stage."""

import json
import os
import shutil

import pytest
import torch

from port_bench import flops_hash, manifest, run
from port_bench.tests.conftest import LIMITS
from port_bench.tests.test_pb_run import _half_batch, _unchanged
from port_bench.trace import STEP, Trace

SEED = str(2 ** 31 + 11)
CELL = "tinyhash.hash"


def tiny_hash() -> dict:
    """``configs/neus_hash.json`` at 3 levels of 2^10 entries, a 16-wide
    head, 8 + 4 x 2 samples."""
    with open(os.path.join(manifest.ROOT, "configs", "neus_hash.json")) as fp:
        config = json.load(fp)
    hs = config["model"]["hash_sdf"]
    hs["grid"].update(n_levels=3, log2_hashmap_size=10)
    hs["width"] = 16
    config["render"].update(n_samples=8, n_importance=8, up_sample_steps=4)
    return config


@pytest.fixture
def hash_root(tmp_path):
    """A cell root with ``tinyhash.hash``: 8 rays of 4 16 x 16 views."""
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    for sub in ("metrics", "layers"):
        shutil.copytree(os.path.join(manifest.ROOT, sub), tmp_path / sub)
    with open(os.path.join(manifest.ROOT, "traffic", "hash_512.json")) as fp:
        mix = json.load(fp)
    mix.update(batch=8, warmup_steps=1, trace_skip_steps=1, trace_steps=3, scene={
        "kind": "sphere", "views": 4, "size": 16, "camera_angle_x": 0.6911112070083618})
    files = {"configs/tinyhash.json": tiny_hash(), "traffic/hash.json": mix,
             "limits/tinyhash.hash.json": LIMITS}
    for rel, obj in files.items():
        (tmp_path / rel).write_text(json.dumps(obj))
    return str(tmp_path)


def run_cell(root, capsys, trace=0, device=torch.device("cpu")):
    rc = run.main(["--workload", CELL, "--seed", SEED, "--seconds", "0.5",
                   "--trace", str(trace)], device=device, root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_program_agrees_with_the_reference(hash_root, capsys):
    out = run_cell(hash_root, capsys)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"train_rays_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(hash_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(hash_root, capsys)
    assert not out["correct"], out["compared"]


def test_a_traced_run_reads_the_hash_metrics(hash_root, capsys):
    """5 encodings a step of 8 rays x (8 + 3 x 2 queried + 16 shaded)
    points; no device on the CPU: no kernel time, so no roofline."""
    out = run_cell(hash_root, capsys, trace=1)
    assert out["correct"]
    m = out["metrics"]
    assert {"hash_idle_ms_per_step", "hash_points_per_step", "mfu_pct"} <= set(m)
    assert "hash_encode_roofline" not in m and "trunk_roofline" not in m
    assert "hash_scan_ms_per_step" not in m
    assert m["hash_points_per_step"]["value"] == 240
    assert m["hash_idle_ms_per_step"]["value"] >= 0.0
    assert 0 < m["mfu_pct"]["value"]


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_the_roofline_reader_on_a_hand_made_trace():
    """Two steps; of the device time, the listed kernels' 350 us in the
    window count (the last kernel's half outside it does not), the trunk's
    does not: the least time of ``hash_bytes`` at 3.35 TB/s over 175 us a
    step."""
    kernels = manifest.layer_kernels("hash_encoding")
    trace = Trace([ev("user_annotation", STEP, 0, 1000), ev("user_annotation", STEP, 1000, 1000),
                   ev("kernel", f"void {kernels[0]}<long>", 100, 200, tid=7),
                   ev("kernel", f"void {kernels[-1]}<float>", 1500, 100, tid=7),
                   ev("kernel", f"void {kernels[-1]}<float>", 1950, 100, tid=7),
                   ev("kernel", "vg_fwd_kernel<64>", 300, 400, tid=7)])
    ctx = run.Context(trace, {"hash_bytes": 335_000_000}, 1.0, manifest.ROOT)
    metric = manifest.metric_module("hash_encode_roofline")
    assert metric.read(ctx) == pytest.approx(100.0 * 1e-4 / 175e-6)
    assert metric.read(run.Context(trace, {}, 1.0, manifest.ROOT)) is None


def test_the_scan_reader_on_a_hand_made_trace():
    """Two steps; the listed scans' 300 us in the window count, the
    gather's and the trunk's do not: 0.15 ms a step; nothing without the
    hash encoding's work or without a scan."""
    scans = manifest.layer_kernels("hash_scans")
    gather = manifest.layer_kernels("hash_encoding")[0]
    trace = Trace([ev("user_annotation", STEP, 0, 1000), ev("user_annotation", STEP, 1000, 1000),
                   ev("kernel", f"void at::native::{scans[0]}<float, std::multiplies<float> >",
                      100, 200, tid=7),
                   ev("kernel", f"void at_cuda_detail::cub::{scans[-1]}<long>", 1500, 100, tid=7),
                   ev("kernel", f"void {gather}<long>", 1700, 100, tid=7),
                   ev("kernel", "vg_fwd_kernel<64>", 300, 400, tid=7)])
    metric = manifest.metric_module("hash_scan_ms_per_step")
    assert metric.read(run.Context(trace, {"hash_bytes": 1}, 1.0, manifest.ROOT)) == \
        pytest.approx(0.15)
    assert metric.read(run.Context(trace, {}, 1.0, manifest.ROOT)) is None
    bare = Trace([ev("user_annotation", STEP, 0, 1000), ev("kernel", "vg_fwd_kernel<64>", 1, 9)])
    assert metric.read(run.Context(bare, {"hash_bytes": 1}, 1.0, manifest.ROOT)) is None


def test_the_step_counts_at_the_published_sizes():
    """512 rays: 64 + 3 x 16 queried and 128 shaded samples a ray; the
    head 32 -> 128 x 4 -> 257; 16 levels x 8 corners of 8 bytes."""
    with open(os.path.join(manifest.ROOT, "configs", "neus_hash.json")) as fp:
        config = json.load(fp)
    work = flops_hash.hash_step_work(config["model"], config["render"], 512)
    assert work["rows"] == {"queried": 57_344, "shaded": 65_536, "points": 122_880}
    nw = 32 * 128 + 3 * 128 * 128 + 128 * 257
    ns = 32 * 128 + 3 * 128 * 128 + 128
    assert work["flops"]["fp32"] == 57_344 * 2 * ns + 65_536 * (6 * nw + 6 * ns)
    assert work["hash_bytes"] == 122_880 * (128 * 8 + 12 + 128) + 65_536 * 128 * 8


def test_train_512_resolves_to_the_neus_stage():
    cell = manifest.load_cell("neus_blender.train_512")
    assert cell["stage"] == "neus" and cell["traffic"]["batch"] == 512
    assert manifest.stage_module(cell["stage"]).__name__ == "port_bench.stages.neus"
    hashed = manifest.load_cell("neus_hash.hash_512")
    assert manifest.stage_module(hashed["stage"]).__name__ == "port_bench.stages.neus_hash"
    assert hashed["traffic"]["batch"] == 512


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_roofline(hash_root, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = run_cell(hash_root, capsys, trace=1, device=torch.device("cuda"))
    assert out["correct"], out["compared"]
    m = out["metrics"]
    assert 0 < m["hash_encode_roofline"]["value"] <= 100
    assert m["hash_scan_ms_per_step"]["value"] > 0
    assert m["hash_points_per_step"]["value"] == 240

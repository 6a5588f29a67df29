"""The CESR cell at tiny widths on the CPU: a whole run agrees with the plain
reference, each fault planted in the timed path makes ``correct`` false,
a traced run reads the CESR metrics, and the stage module's nets are the
runner's."""

import json
import os
import shutil

import pytest
import torch

from port_bench import flops_cesr, manifest, run
from port_bench.reference import cesr as reference
from port_bench.tests.conftest import LIMITS, tiny_hotdog
from port_bench.tests.test_pb_run import _half_batch, _unchanged

SEED = str(2 ** 31 + 11)
CELL = "tinycesr.cesr"


def tiny_cesr() -> dict:
    """``configs/hotdog_cesr.json`` at ``tiny_hotdog``'s widths (8 lights),
    its two nets at their published 8 x 512, compacted at 16."""
    with open(os.path.join(manifest.ROOT, "configs", "hotdog_cesr.json")) as fp:
        config = json.load(fp)
    config = tiny_hotdog({**config, "pbr": {}})
    del config["pbr"]
    config["cesr"]["compact_chunk"] = 16
    return config


@pytest.fixture
def cesr_root(tmp_path):
    """A cell root with ``tinycesr.cesr``: 64 pixels of a 16 x 16 two-sphere
    view from iteration 1,001."""
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    for sub in ("metrics", "layers"):
        shutil.copytree(os.path.join(manifest.ROOT, sub), tmp_path / sub)
    with open(os.path.join(manifest.ROOT, "traffic", "cesr_4k.json")) as fp:
        mix = json.load(fp)
    # a frozen NeuS whose tiny trunk reaches the surface in this scene
    mix.update(batch=64, neus_seed=2 ** 31 + 11, warmup_steps=1, trace_skip_steps=1,
               trace_steps=3, scene={"kind": "two_spheres", "views": 4, "size": 16,
                                     "camera_angle_x": 0.45})
    files = {"configs/tinycesr.json": tiny_cesr(), "traffic/cesr.json": mix,
             "limits/tinycesr.cesr.json": LIMITS}
    for rel, obj in files.items():
        (tmp_path / rel).write_text(json.dumps(obj))
    return str(tmp_path)


def run_cell(root, capsys, trace=0):
    rc = run.main(["--workload", CELL, "--seed", SEED, "--seconds", "0.5",
                   "--trace", str(trace)], device=torch.device("cpu"), root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_program_agrees_with_the_reference(cesr_root, capsys):
    out = run_cell(cesr_root, capsys)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"train_rays_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(cesr_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(cesr_root, capsys)
    assert not out["correct"], out["compared"]


def test_a_traced_run_reads_the_cesr_metrics(cesr_root, capsys):
    """The counter gives the compacted rows of the traced steps x 8
    lights; no device on the CPU: no kernel time, so no roofline."""
    out = run_cell(cesr_root, capsys, trace=1)
    assert out["correct"]
    m = out["metrics"]
    assert {"light_rows_per_step", "shadow_idle_ms_per_step", "mfu_pct",
            "surface_rows_per_step"} <= set(m)
    assert "normal_net_roofline" not in m and "trunk_roofline" not in m
    assert m["light_rows_per_step"]["value"] == 8 * m["surface_rows_per_step"]["value"]
    assert m["shadow_idle_ms_per_step"]["value"] >= 0.0


def test_the_cell_hands_the_runner_its_own_nets():
    """``net_weights`` makes, from the seed, the nets ``CESRRunner`` makes
    itself, bit for bit."""
    from robir_tpu_torch.core.config import build_stage2_config, build_stage_config
    from robir_tpu_torch.stages.cesr import CESRRunner, CESRStageConfig
    from robir_tpu_torch.stages.stage2_runner import init_stage2_params

    config = tiny_cesr()
    cfg = build_stage2_config(config["model"])
    runner = CESRRunner(cfg, init_stage2_params(torch.Generator().manual_seed(0), cfg), None,
                        build_stage_config(CESRStageConfig, config["cesr"]), seed=int(SEED),
                        device="cpu")
    leaves = dict(runner.params.named_parameters())
    made = reference.net_weights(config, int(SEED), "cpu")
    assert sorted(made) == sorted(k for k in leaves if k.startswith(("shadow_net.",
                                                                      "normal_net.")))
    for k, v in made.items():
        assert torch.equal(leaves[k].detach(), v), k


def test_the_nets_counts_at_the_published_widths():
    """The normal net a row: the forward 2 x 1,836,544 weights (K1's
    3,673,088 FLOPs a row at this net, PERF.md section 6), dW as much, the
    hidden inputs' gradient without the 63-wide encoded input of the first
    and the skip layer; the shadow net's forward a row: the encoded input's
    products of those two layers once, the hidden ones for each light."""
    with open(os.path.join(manifest.ROOT, "configs", "hotdog_cesr.json")) as fp:
        config = json.load(fp)
    nw = 63 * 512 + 5 * 512 * 512 + 512 * 449 + 512 * 512 + 512 * 3
    assert 2 * nw == 3_673_088
    assert flops_cesr.normal_net_row_flops(config) == 2 * (2 * nw + nw - 2 * 63 * 512)
    hidden = 5 * 512 * 512 + 512 * 321 + 321 * 512 + 512 * 2
    assert flops_cesr.shadow_net_row_flops(config) == 2 * (2 * 63 * 512 + 128 * hidden)

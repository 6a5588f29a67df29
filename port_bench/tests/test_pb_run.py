"""Whole runs of tiny cells on the CPU: the program agrees with the plain
reference, and each fault a training cell can have, planted in the timed
path, makes ``correct`` come out false."""

import json

import pytest
import torch

from port_bench import run

SEED = str(2 ** 31 + 11)
CELLS = ["tiny.train", "tinyhd.pbr"]


def run_cell(root, cell, capsys, trace=0):
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.5",
                   "--trace", str(trace)], device=torch.device("cpu"), root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(tiny_root, capsys, cell):
    out = run_cell(tiny_root, cell, capsys)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"train_rays_per_s", "step_ms_p95", "setup_s"}
    assert list(out)[-1] == "compared"


def test_a_traced_run_reads_the_per_layer_metrics(tiny_root, capsys):
    out = run_cell(tiny_root, "tiny.train", capsys, trace=1)
    assert out["correct"]
    # no device on the CPU: idle throughout, no kernel time to read
    assert out["metrics"]["device_idle_pct"]["value"] == 100.0
    assert "trunk_roofline" not in out["metrics"]
    assert {"host_ms_per_step", "mfu_pct"} <= set(out["metrics"])
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from robir_tpu_torch.stages.neus_stage import NeusTrainer
    from robir_tpu_torch.stages.stage2_runner import MaterialRunner

    put, batch = NeusTrainer._put, MaterialRunner._batch

    def half_put(self, b):
        out = put(self, b)
        return type(out)(*[x[:x.shape[0] // 2] for x in out])

    def halved(fn):
        return lambda self: {k: v[:v.shape[0] // 2] for k, v in fn(self).items()}

    monkeypatch.setattr(NeusTrainer, "_put", half_put)
    monkeypatch.setattr(MaterialRunner, "_batch", halved(batch))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_cell(tiny_root, cell, capsys)
    assert not out["correct"], out["compared"]

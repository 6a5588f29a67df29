"""The port's hash-grid NeuS against the benchmark's plain reference
(``port_bench/reference/neus_hash.py``: plain torch, nothing of the port;
its d sdf/dx analytic, not autograd), on the CPU at a tiny size: 3 levels,
T = 2^10, a 16-wide head, 8 rays of 8 + 4 x 2 samples, seeded weights.

Held: the encoding; d sdf/dx (the program's ``autograd.grad(create_graph=
True)`` against the reference's analytic sum over corners), with the
second-order gradients of a loss on it; three ``NeusTrainer`` steps
through the benchmark's stage module (each loss, the first gradient of
every leaf, the change of each); one step's ``hash.encode`` spans and
``hash.points`` counts.

Tolerances: values to 1e-6 of the largest entry (fp32 sums of 8 corners
and 16-wide products in other orders; the readings are 0 and 2.3e-7 for
d sdf/dx); gradients to 1e-5 of each tensor's largest entry (the
second-order pass sums each table row's scatters in another order; the
readings are up to 3.0e-7, the tables'). A step's loss to 2e-6 relative, each leaf's first-gradient
norm to 1e-4 of the larger of its own and the median leaf's, the change
over three steps to 2e-3 of the same (the tolerances of the CESR step's
plain test, whose reasons hold here: Adam's first updates are about the
learning rate for any entry that is not zero); the readings are 1.4e-7,
6.4e-7 and 4.2e-8. The half batch reads 4.9e-1 on the loss.
"""

import json
import os

import numpy as np
import pytest
import torch

from port_bench import manifest
from port_bench.reference import neus_hash as reference
from port_bench.stages import neus_hash as hash_stage
from port_bench.tests.test_pb_hash import tiny_hash
from robir_tpu_torch.core.config import stage1_dispatch
from robir_tpu_torch.fields import hashgrid
from robir_tpu_torch.stages.neus_stage import make_stage1_bindings
from robir_tpu_torch.tools import profiler

SEED = 2 ** 31 + 11


def traffic(steps: int = 3) -> dict:
    with open(os.path.join(manifest.ROOT, "traffic", "hash_512.json")) as fp:
        t = json.load(fp)
    t.update(batch=8, compared_steps=steps, warmup_steps=0, scene={
        "kind": "sphere", "views": 4, "size": 16, "camera_angle_x": 0.6911112070083618})
    return t


def model_and_weights(table_scale: float):
    """The program's hash NeuS (``cli neus``'s bindings) holding the
    reference's seeded weights, the finer levels' tables scaled up to the
    coarsest's sphere (so that every level counts in the encoding and its
    gradient, not the sphere alone)."""
    c = tiny_hash()
    mt, rt, model_cfg, render_cfg = stage1_dispatch(c)
    b = make_stage1_bindings(mt, rt, model_cfg, render_cfg)
    model = b.model(b.init(torch.Generator().manual_seed(0)), "cpu")
    w = reference.weights(c["model"], SEED, "cpu")
    w["sdf_network.hash.tables"][1:] *= table_scale
    params = dict(model.params.named_parameters())
    assert sorted(params) == sorted(w)
    with torch.no_grad():
        for k, v in w.items():
            params[k].copy_(v)
    return model, params, c["model"]["hash_sdf"]


def points(n: int = 200) -> torch.Tensor:
    """Points over [-1.3, 1.3]^3: some outside the box, clamped."""
    return (torch.rand((n, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1) * 1.3


def close(got, want, rel):
    got, want = got.detach(), want.detach()
    torch.testing.assert_close(got, want, rtol=0, atol=rel * float(want.abs().max()))


def test_the_encoding_follows_the_plain_reference():
    model, params, hs = model_and_weights(1e4)
    x = points()
    got = hashgrid.hashgrid_encode(model.params["sdf_network"]["hash"], model.cfg.hash_sdf.grid,
                                   x)
    with torch.no_grad():
        want, _ = reference.encode(params["sdf_network.hash.tables"], hs["grid"], x, False)
    assert got.shape == want.shape == (200, 6)
    close(got, want, 1e-6)
    assert float(want.abs().max()) > 0.1


def test_the_spatial_gradient_is_the_analytic_one():
    """Value and d sdf/dx, then the second-order gradients of a loss on
    both (the eikonal term's shape) reaching the tables and the head."""
    model, params, hs = model_and_weights(1e4)
    x = points()
    full, grad = model.full_with_grad(x)
    ref_full, ref_grad = reference.field(params, hs, x, with_grad=True)
    close(full, ref_full, 1e-6)
    close(grad, ref_grad, 1e-6)
    # the clamped axes of points outside the box have no gradient
    outside = x.abs() > 1.0
    assert outside.any() and not grad[outside].any() and not ref_grad[outside].any()
    assert float(ref_grad.detach().norm(dim=-1).mean()) > 0.1

    def loss(f, g):
        return ((g.norm(dim=-1) - 1.0) ** 2).sum() + f[:, :4].sum()

    names = ["sdf_network.hash.tables", "sdf_network.mlp.lin0.w", "sdf_network.mlp.lin3.w",
             "sdf_network.mlp.lin4.w"]
    got = torch.autograd.grad(loss(full, grad), [params[k] for k in names])
    want = torch.autograd.grad(loss(ref_full, ref_grad), [params[k] for k in names])
    for k, g, w in zip(names, got, want):
        assert float(w.abs().max()) > 0, k
        close(g, w, 1e-5)


@pytest.fixture(scope="module")
def cell():
    c = hash_stage.build(tiny_hash(), traffic(), SEED, torch.device("cpu"))
    c.release()
    return c


def test_three_trainer_steps_follow_the_plain_reference(cell):
    got = cell.compare()
    assert got["loss"][0] < 2e-6, got
    assert got["first_grad"][0] < 1e-4, got
    assert got["change"][0] < 2e-3, got
    # the eikonal term's second-order pass reaches the tables
    assert float(cell.first_grads["sdf_network.hash.tables"].norm()) > 0


def test_the_half_batch_is_told_apart(cell):
    assert cell.compare("half_batch")["loss"][0] > 1e-2


def test_a_step_opens_the_encoding_five_times(tmp_path):
    """One step under a profiler: ``hash.encode`` at the coarse query, the
    3 up-sampling queries and the shaded call; ``hash.points`` sums to
    8 rays x (8 + 3 x 2 queried + 16 shaded samples)."""
    c = hash_stage.build(tiny_hash(), traffic(steps=0), SEED, torch.device("cpu"))
    before = len(profiler.count_log("hash.points"))
    with profiler.trace(str(tmp_path), device="cpu"):
        assert np.isfinite(c.step())
    counts = [n for _, n in profiler.count_log("hash.points")[before:]]
    assert counts == [64, 16, 16, 16, 128]
    assert sum(counts) == 8 * (8 + 3 * 2 + 16) == 240
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fp:
        events = json.load(fp)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    encodes = [(s, e) for s, e, n in spans if n == "hash.encode"]
    assert len(encodes) == 5
    (sample,) = [(s, e) for s, e, n in spans if n == "neus.sample"]
    (shade,) = [(s, e) for s, e, n in spans if n == "neus.shade"]
    assert all(sample[0] <= s and e <= sample[1] for s, e in encodes[:4])
    assert shade[0] <= encodes[4][0] and encodes[4][1] <= shade[1]

"""The port's CESR step against the benchmark's plain reference
(``port_bench/reference/cesr.py``: plain torch, nothing of the port), on
the CPU at small widths with seeded weights: three steps of
``CESRRunner.run(1)`` through the benchmark's stage module (the seeded stage-2
tree, the runner's own nets, a baked 32^3 grid) from iteration 1,001
(explore, the refined normal) in row mode and dense, and from 0 (warmup,
the AE normal): each loss, the first gradient of every trainable leaf and
the change of each after the three steps. Also: one step's spans and
``cesr.light_rows`` counter; the factorised ``shadow_net_vis`` against
the reference's net on the concatenated input.

Tolerances: the losses to 2e-6 relative (fp32 sums in other orders; the
readings are up to 4.4e-7); each leaf's first-gradient norm to 1e-4 of
the larger of its own and the median leaf's (readings up to 1.1e-5, the
shadow net's first layer and the normal net, whose n / |n| is
ill-conditioned); the change over three steps to 2e-3 of the same (Adam's
first updates are about the learning rate for any gradient entry that is
not zero, so a rounding of a tiny entry moves a weight by that much;
readings up to 1.0e-4). A step on the half batch reads 3.5e-2 on its loss.
"""

import json
import os

import numpy as np
import pytest
import torch

from port_bench import manifest
from port_bench.reference import cesr as reference
from port_bench.reference.neus import positional_encoding
from port_bench.stages import cesr as cesr_stage
from port_bench.tests.conftest import tiny_hotdog
from port_bench.weights import nest
from robir_tpu_torch.stages import cesr as tcesr
from robir_tpu_torch.tools import profiler

SEED = 2 ** 31 + 11


def config(lights: int = 8, chunk: int = 16) -> dict:
    with open(os.path.join(manifest.ROOT, "configs", "hotdog_cesr.json")) as fp:
        c = json.load(fp)
    c = tiny_hotdog({**c, "pbr": {}})
    del c["pbr"]
    c["model"]["envmap_material_network"]["num_lgt_sgs"] = lights
    c["cesr"]["compact_chunk"] = chunk
    return c


def traffic(start: int, steps: int = 3) -> dict:
    with open(os.path.join(manifest.ROOT, "traffic", "cesr_4k.json")) as fp:
        t = json.load(fp)
    # a frozen NeuS whose tiny trunk reaches the surface in this scene
    t.update(batch=64, neus_seed=SEED, start_iter=start, compared_steps=steps,
             warmup_steps=0, scene={"kind": "two_spheres", "views": 4, "size": 16,
                                    "camera_angle_x": 0.45})
    return t


@pytest.mark.parametrize("start,chunk", [(1001, 16), (1001, 0), (0, 16)],
                         ids=["explore_rows", "explore_dense", "warmup_rows"])
def test_the_step_follows_the_plain_reference(start, chunk):
    cell = cesr_stage.build(config(chunk=chunk), traffic(start), SEED, torch.device("cpu"))
    assert cell.program.cur_iter == start + 3
    cell.release()
    got = cell.compare()
    assert got["loss"][0] < 2e-6, got
    assert got["first_grad"][0] < 1e-4, got
    assert got["change"][0] < 2e-3, got
    # the shadow and normal nets learn in every phase
    assert any(k.startswith("shadow_net.") for k in cell.first_grads)
    assert all(float(cell.first_grads[f"{net}.lin0.v"].norm()) > 0
               for net in ("shadow_net", "normal_net"))


def test_the_half_batch_is_told_apart():
    cell = cesr_stage.build(config(), traffic(1001, steps=1), SEED, torch.device("cpu"))
    cell.release()
    assert cell.compare("half_batch")["loss"][0] > 1e-2


def annotations(tmp_path) -> list[tuple[str, float, float]]:
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fp:
        events = json.load(fp)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda x: x[1])


def test_a_step_counts_its_light_rows_and_names_both_nets(tmp_path):
    """One compacted step at 128 lights under a profiler: ``cesr.shadow_net``
    then ``cesr.normal_net``, once each, inside ``stage2.shade``; one
    ``cesr.light_rows`` count of the step's surface rows (its
    ``compact.rows``) x 128."""
    cell = cesr_stage.build(config(lights=128), traffic(1001, steps=1), SEED, torch.device("cpu"))
    before = {k: len(profiler.count_log(k)) for k in ("cesr.light_rows", "compact.rows")}
    with profiler.trace(str(tmp_path), device="cpu"):
        assert np.isfinite(cell.step())
    (rows,) = [n for _, n in profiler.count_log("compact.rows")[before["compact.rows"]:]]
    assert rows > 0
    assert [n for _, n in profiler.count_log("cesr.light_rows")[before["cesr.light_rows"]:]
            ] == [rows * 128]
    got = annotations(tmp_path)
    names = [n for n, _, _ in got]
    assert names.count("cesr.shadow_net") == names.count("cesr.normal_net") == 1
    spans = {n: (s, e) for n, s, e in got}
    shade, shadow, normal = spans["stage2.shade"], spans["cesr.shadow_net"], spans[
        "cesr.normal_net"]
    assert shade[0] <= shadow[0] and shadow[1] <= normal[0] and normal[1] <= shade[1]


def test_the_factorised_shadow_net_is_the_unfactorised_one():
    """``shadow_net_vis`` (the PE and one-hot projections split, the one-hot
    one a row of the weight) against the reference's net on the [rows x
    128, PE10 (+) one-hot] input at the published 8 x 512: the same to fp32
    rounding (8 layers of up to 512-term sums in another order,
    visibilities in (0, 1): 2e-6; the reading is 3.6e-7, each 4e-7 from
    the fp64 net)."""
    c = config(lights=128)
    flat = reference.net_weights(c, SEED, "cpu")
    # at its init every light reads 0.5 +- 1e-4: draw the last layer afresh
    # so that the lights' visibilities spread over (0, 1)
    flat["shadow_net.lin8.v"] = torch.randn(flat["shadow_net.lin8.v"].shape,
                                            generator=torch.Generator().manual_seed(6))
    points = torch.rand((20, 3), generator=torch.Generator().manual_seed(5)) * 2 - 1
    got = tcesr.shadow_net_vis(nest(flat)["shadow_net"], tcesr.CESRStageConfig(num_lights=128),
                               points, 128)
    with torch.no_grad():
        want = reference.shadow_visibility(flat, c, positional_encoding(points, 10), 128)
    assert got.shape == want.shape == (20, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    # and not by chance: the nets' visibilities spread over the lights
    assert float(want.std()) > 0.03

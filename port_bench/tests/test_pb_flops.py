"""The benchmark's FLOP arithmetic, against per-row counts worked out by
hand from the 8 x 256 trunk's layers."""

import json
import os

import pytest

from port_bench import flops, manifest


def config(name):
    with open(os.path.join(manifest.ROOT, "configs", f"{name}.json")) as fp:
        return json.load(fp)


# multires 10: 63 -> 256, two of 256 -> 256, 256 -> 193 (the skip's
# concat makes 256), four of 256 -> 256, 256 -> 257; multires 6 (39 in,
# 217 before the skip) weighs the same; the SDF column alone: 256 -> 1
NW = 63 * 256 + 2 * 256 * 256 + 256 * 193 + 4 * 256 * 256 + 256 * 257
NS = NW - 256 * 256


@pytest.mark.parametrize("sdf", [config("neus_blender")["model"]["sdf"],
                                 config("hotdog")["model"]["neus"]["sdf"]])
def test_trunk_rows_count_the_work_the_function_needs(sdf):
    assert (NW, NS) == (524_544, 459_008)
    assert flops.trunk_row_flops(sdf) == {
        "K1": 2 * NW, "K1_sdf": 2 * NS, "K3": 2 * NW + 2 * NS, "K3_sdf": 4 * NS,
        "K4": 4 * NW + 4 * NS}


def test_stage1_step_at_2048_rays():
    c = config("neus_blender")
    w = flops.neus_step_work(c["model"], c["render"], 2048)
    assert w["rows"] == {"K1": 2048 * 112, "K3": 2048 * 128, "K4": 2048 * 128}
    assert w["trunk_flops"] == 2048 * (112 * 2 * NS + 128 * (6 * NW + 6 * NS))
    # the bf16 colour net: 289 -> 256 x 4 -> 3, forward and backward
    assert w["flops"]["bf16"] == 2048 * 128 * 3 * 2 * (289 * 256 + 3 * 256 * 256 + 256 * 3)


def test_pbr_step_grows_with_surface_rows():
    m = config("hotdog")["model"]
    a, b = flops.pbr_step_work(m, 8192, 1000.0), flops.pbr_step_work(m, 8192, 2000.0)
    sweep = 2 * 1000 * (128 * 32 + 16) * 2 * (3 * 256 * 256 + 256 * 2)
    assert a["flops"]["bf16"] == sweep
    assert b["flops"]["bf16"] == 2 * sweep
    assert b["flops"]["fp32"] > a["flops"]["fp32"]


def test_least_seconds_at_the_published_peaks():
    assert flops.least_seconds({"fp32": 67e12, "bf16": 989e12}) == pytest.approx(2.0)

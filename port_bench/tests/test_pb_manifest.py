"""The manifest finds a cell's parts, metrics and layers by name, and a new
file of each kind is found without an edit."""

import json
import os

import pytest

from port_bench import manifest


def test_committed_cells_are_found_by_name():
    repo = os.path.dirname(manifest.ROOT)
    with open(os.path.join(repo, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for cell in bench["workloads"]:
        found = manifest.load_cell(cell["name"])
        with open(os.path.join(repo, files[cell["config"]])) as fp:
            assert found["config"] == json.load(fp)
        assert manifest.stage_module(found["stage"]).build
    names = manifest.metric_names()
    for metric in bench["per_layer"]:
        assert metric["name"] in names
        m = manifest.metric_module(metric["name"])
        assert (m.UNIT, m.LAYER, m.SOURCE, m.MOVES) == (
            metric["unit"], metric["layer"], metric["source"], metric["moves"])


def test_layer_kernels():
    assert "vg_bwd_rows_kernel" in manifest.layer_kernels("trunk")
    assert "wgrad_kernel" in manifest.layer_kernels("trunk")
    assert manifest.layer_kernels("tracer") == ["grid_march_kernel"]


def test_new_files_are_picked_up_without_edits(tiny_root):
    root = tiny_root
    with open(os.path.join(root, "traffic", "train.json")) as fp:
        mix = json.load(fp)
    mix["batch"] = 48
    with open(os.path.join(root, "traffic", "wider.json"), "w") as fp:
        json.dump(mix, fp)
    with open(os.path.join(root, "limits", "tiny.wider.json"), "w") as fp:
        json.dump({"loss": 1.0}, fp)
    cell = manifest.load_cell("tiny.wider", root)
    assert cell["traffic"]["batch"] == 48 and cell["stage"] == "neus"
    with open(os.path.join(root, "metrics", "steps_seen.py"), "w") as fp:
        fp.write('UNIT, LAYER, SOURCE, MOVES = "n", "device", "device_trace", '
                 '"train_rays_per_s"\n\ndef read(ctx):\n    return len(ctx.step_s)\n')
    assert "steps_seen" in manifest.metric_names(root)
    assert manifest.metric_module("steps_seen", root).read(
        type("C", (), {"step_s": [1, 2]})()) == 2
    os.makedirs(os.path.join(root, "layers", "trunk"), exist_ok=True)
    with open(os.path.join(root, "layers", "trunk", "k5.txt"), "w") as fp:
        fp.write("# a later kernel\nk5_kernel\n")
    assert "k5_kernel" in manifest.layer_kernels("trunk", root)


@pytest.mark.parametrize("name", ["neus_blender", "neus_blender.", ".train_2k",
                                  "neus_blender.no_such_mix", "no_such.train_2k"])
def test_unknown_cells_are_refused(name):
    with pytest.raises(KeyError):
        manifest.load_cell(name)

"""The top-level-name import check, and the reference's independence of
the program."""

import ast
import os

import pytest

from port_bench import imports, manifest


@pytest.mark.parametrize("names", [["robir_tpu_torch", "robir_tpu_torch.stages.pbr"],
                                   ["torch", "numpy", "port_bench.run"], ["robir_tpu_tools"],
                                   ["benchmarks"]])
def test_the_port_and_others_pass(names):
    assert imports.forbidden(names) == []


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax",
                                  "robir_tpu", "robir_tpu.fields.sdf", "bench", "chip_smoke",
                                  "kernel_times"])
def test_jax_and_the_jax_package_fail(name):
    assert imports.forbidden(["torch", name]) == [name]


def _imported(path: str) -> set[str]:
    with open(path) as fp:
        tree = ast.parse(fp.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(folder):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(manifest.ROOT, "reference")):
        assert _imported(path) <= {"__future__", "contextlib", "math", "numpy", "torch"}, path


def test_the_harness_imports_no_jax():
    for path in _sources(manifest.ROOT):
        if os.sep + "tests" + os.sep in path:
            continue
        assert not imports.forbidden(_imported(path)), path

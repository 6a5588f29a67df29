"""On the card, at each cell's own size: a sound run of the program passes
every limit and the control (the reference in the precision below the
configuration's, in the program's place) fails one.

    python -m pytest port_bench/tests/test_pb_cuda.py -q

skips without a card."""

import pytest
import torch

from port_bench import control, manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["neus_blender.train_2k", "hotdog.pbr_8k"])
def test_the_program_passes_and_the_control_fails(card, cell):
    limits = manifest.load_cell(cell)["limits"]
    got = {r["judged"]: r for r in control.readings(cell, [2 ** 31 + 101],
                                                    ["program", "control"], card)}
    assert all(got["program"][k] <= v for k, v in limits.items()), got["program"]
    assert any(got["control"][k] > v for k, v in limits.items()), got["control"]

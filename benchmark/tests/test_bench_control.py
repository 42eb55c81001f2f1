"""The control at each cell's own size on the card: the plain reference
with its pyramid in bfloat16, in the program's place on the steps a run
checks, must come out as not correct, while the program on the same
steps is correct.  Needs the card; skips without one.

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests
"""

import pytest
import torch

from benchmark import control
from benchmark.reference import check

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["traffic_vga_500.farm",
                                  "traffic_vga_500.live"])
def test_control_refused_at_cell_size(card, cell):
    for seed in SEEDS:
        r = control.readings(cell, seed, 1.0)
        assert check.passed(r["program"]), r
        assert not check.passed(r["control"]), r

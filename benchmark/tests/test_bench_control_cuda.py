"""The check's control on the card, at each cell's own size: the program
with its bf16 path switched on (`RenderConfig(precision="bf16")`, the
trainer's render_precision) must come out not correct against the
float32 reference, and the float32 program correct on the same seed."""
from __future__ import annotations

import pytest

from benchmark import run as R

SPEC = R.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    seed = 4_100_000_017
    ctl = R.run(cell, seed, 8.0, False, control="bf16", log=lambda *a: None)
    assert not ctl["correct"], ctl["checks"]
    ok = R.run(cell, seed, 8.0, False, log=lambda *a: None)
    assert ok["correct"], ok["checks"]

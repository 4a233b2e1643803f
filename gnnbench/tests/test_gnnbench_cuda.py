"""On the card (marker ``cuda``; skipped without one), at each cell's own
size: the program's first steps pass every limit of ``correct``, and the
control (the plain reference in float32 with TF32 GEMMs, put in the
program's place) fails one.  The limits hold at the timed sizes only:
smaller graphs read higher.

    python -m pytest -q -m cuda gnnbench/tests/test_gnnbench_cuda.py
"""

import pytest
import torch

from gnnbench import calibrate, compare, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from msha_gnn_torch.ops.cuda import _build

    _build.BUILD_DIR = harness.BUILD / "msha_gnn_torch"
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 2**31 + 7, 4_000_000_003])
@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.benchmark()["workloads"]])
def test_program_passes_and_control_fails(card, workload, seed):
    limits = harness.cell(workload)[1]["limits"]
    nums, _ = calibrate.readings(workload, seed, card,
                                 variants=("program", "control"))
    assert compare.verdict(nums["program"], limits), nums["program"]
    assert not compare.verdict(nums["control"], limits), nums["control"]

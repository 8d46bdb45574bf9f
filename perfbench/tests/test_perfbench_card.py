"""On the card, at each cell's own size: the control (the reference in
TF32 in the program's place) fails at least one of the cell's limits.
Run on a machine with the card:

    python3 -m pytest perfbench/tests/test_perfbench_card.py -m cuda
"""
import pytest
import torch

from perfbench import control, harness

SECONDS = {"pwn_odom.live": 3.0, "pwn_odom.offline": 1.0, "se2_schur.victoria": 1.0, "se2_dense.victoria": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_control_fails_a_limit_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    harness.env_for_caches()
    values, _ = control.readings(workload, 2**31 + 4242, SECONDS[workload], "tf32")
    limits = harness.limits(workload)
    assert any(values[k] > v for k, v in limits.items()), values

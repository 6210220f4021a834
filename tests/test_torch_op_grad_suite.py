"""The JAX package's finite-difference gradient suite replayed against
the port.

Every case of tests/test_op_grad_suite.py (`GRAD_CASES`) that reaches
the core op corpus (see tests/test_torch_op_suite.py, which does the
same for tests/test_op_suite.py) runs through both packages on the same
inputs, in the JAX table's order, none dropped: the port's forward
against the JAX forward, and torch's gradient against the JAX tape's
for a fixed random cotangent at float64 inputs, at the tolerances
tests/torch_replay.py states (float32 1e-5 relative, float64 1e-10,
integer and index outputs exact).
"""
import pytest
import torch

import test_op_grad_suite as grad_suite
import paddle_tpu_torch
from torch_replay import reaches_slice, replay


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device():
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    place._default = prev


GRAD = [(i, c) for i, c in enumerate(grad_suite.GRAD_CASES)
        if reaches_slice(c)]


@pytest.mark.parametrize("case", [c for _, c in GRAD],
                         ids=[f"{i}:{c.name}" for i, c in GRAD])
def test_op_grad_suite_case(case):
    replay(case)

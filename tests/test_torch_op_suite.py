"""The JAX package's declarative op suite replayed against the port.

Every case of tests/test_op_suite.py (`ALL_CASES`) that reaches the
core op corpus (its api is a function of ops/{creation, math, logic,
manipulation, linalg, search, array_ops, random_ops}.py, or a lambda
over ops those modules register) runs through both packages on the
same inputs, in the JAX tables' order, none dropped: the port's forward
against the JAX forward, and torch's gradient against the JAX tape's
for a fixed random cotangent, at the tolerances tests/torch_replay.py
states (float32 1e-5 relative, float64 1e-10, integer and index outputs
exact, decompositions up to sign or basis at 1e-4). The port also runs
each case through its own harness (paddle_tpu_torch.testing), against
the case's numpy oracle and float64 finite differences.
tests/test_torch_op_grad_suite.py does the same for
tests/test_op_grad_suite.py (`GRAD_CASES`); the two are separate files
to keep each well inside the per-file test-time budget.
"""
import numpy as np
import pytest
import torch

import test_op_grad_suite as grad_suite
import test_op_suite as suite
import paddle_tpu_torch
from paddle_tpu_torch.testing import OpTestCase, run_case
from torch_replay import port_api, reaches_slice, replay


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


SUITE = [(i, c) for i, c in enumerate(suite.ALL_CASES) if reaches_slice(c)]
GRAD = [(i, c) for i, c in enumerate(grad_suite.GRAD_CASES)
        if reaches_slice(c)]


def test_replay_covers_the_slice():
    """The filter keeps the slice's cases: every op type of the slice
    that the two JAX suites exercise is replayed (here and in
    tests/test_torch_op_grad_suite.py)."""
    from torch_replay import slice_op_types
    ops = slice_op_types()
    want = {t for c in suite.ALL_CASES + grad_suite.GRAD_CASES
            for t in c.op_types if t in ops}
    got = {t for _, c in SUITE + GRAD for t in c.op_types}
    assert want <= got, sorted(want - got)
    assert len(SUITE) >= 150 and len(GRAD) >= 50, (len(SUITE), len(GRAD))


@pytest.mark.parametrize("case", [c for _, c in SUITE],
                         ids=[f"{i}:{c.name}" for i, c in SUITE])
def test_op_suite_case(case):
    replay(case)


@pytest.mark.parametrize("case", [c for _, c in SUITE],
                         ids=[f"{i}:{c.name}" for i, c in SUITE])
def test_port_harness_case(case):
    """The port's op_test harness on the case's own oracle and finite
    differences (the JAX suite's check, run on the port)."""
    run_case(OpTestCase(port_api(case.api), case.args, case.kwargs,
                        case.ref, case.grad, case.out_sel, case.op_types,
                        case.atol, case.rtol, case.grad_atol,
                        case.grad_rtol, name=case.name))


def test_harness_catches_a_wrong_gradient():
    """numeric_grad and check_grad reject a function whose autograd
    gradient is wrong (the harness is not vacuous)."""
    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * x

        @staticmethod
        def backward(ctx, g):
            return g  # d(x*x)/dx is 2x, not 1

    case = OpTestCase(lambda x: Wrong.apply(x),
                      (np.linspace(0.5, 1.5, 6, dtype=np.float32),),
                      grad=(0,), name="wrong")
    with pytest.raises(AssertionError, match="grad mismatch"):
        run_case(case)


def test_committed_case_table_matches_the_tables():
    """paddle_tpu_torch/testing/op_cases.{json,npz}, which chip_smoke.py
    and tests/test_torch_cuda.py replay on CUDA without JAX, are the
    cases replayed here and in the grad and tail files, inputs included
    (`python tests/torch_replay.py` writes them again)."""
    import json
    from torch_replay import CASE_FILE, case_spec
    specs, arrays = case_spec()
    assert json.loads(CASE_FILE.with_suffix(".json").read_text()) == \
        json.loads(json.dumps(specs))
    with np.load(CASE_FILE.with_suffix(".npz")) as z:
        assert sorted(z.files) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
            assert z[k].dtype == v.dtype, k


def test_case_table_replays_on_the_port_without_jax():
    """The loaded table rebuilds every case over the port, and each one
    runs on the CPU as the replay above ran it."""
    from paddle_tpu_torch.testing import op_cases
    cases = op_cases.load_cases()
    import test_torch_op_tail as tail
    assert len(cases) == len(SUITE) + len(GRAD) + len(tail.CASES)
    for case in cases[:len(SUITE)]:
        got, grads, devices = op_cases.run(case, "cpu")
        assert devices == {"cpu"}, case.name
        again = op_cases.run(case, "cpu")
        assert op_cases.compare(got, again[0], case) is None, case.name

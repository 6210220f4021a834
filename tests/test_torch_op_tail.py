"""The JAX package's function-style op tests replayed against the port.

The cases of tests/test_ops.py, tests/test_op_tail.py and
tests/test_op_tail3.py that reach the core op corpus (math, logic,
search, manipulation, creation, linalg and array ops), in those files'
order: each test's calls, written once as `fn(paddle, *tensors)`, run
through the JAX package and through the port on the same inputs, and
the port is held to the JAX package's outputs and gradients at the
tolerances tests/torch_replay.py states (float32 1e-5 relative, float64
1e-10, integer and index outputs exact). The random draws of those
tests (test_ops.py's uniform/randint/randperm and test_op_tail.py's
random ops) are held in distribution in tests/test_torch_random_ops.py;
test_op_tail3.py's LoD conversions wait for core/lod.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from torch_replay import replay_call

rng = np.random.RandomState(3)


def r(*shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, size=shape).astype("float32")


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


def C(name, fn, *args, grad=(), out_sel=0):
    """A case: fn(paddle, *tensors) -> outputs; grad: the args whose
    gradients of output out_sel are compared."""
    return pytest.param(fn, args, grad, out_sel, id=name)


a234 = np.arange(24, dtype="float32").reshape(2, 3, 4)
x45 = np.arange(12, dtype="float32").reshape(4, 3)
spd = (lambda a: a @ a.T + 4 * np.eye(4, dtype="float32"))(r(4, 4))

CASES = [
    # ------------------------------------------- tests/test_ops.py
    *[C(f"test_ops:unary_output[{n}]", lambda P, x, n=n: getattr(P, n)(x),
        r(2, 3, lo=lo, hi=hi))
      for n, lo, hi in [("exp", -1, 1), ("log", .5, 2), ("sqrt", .5, 2),
                        ("tanh", -2, 2), ("sin", -2, 2), ("cos", -2, 2),
                        ("square", -2, 2), ("abs", .5, 2),
                        ("rsqrt", .5, 2), ("log1p", .1, 2), ("erf", -1, 1),
                        ("floor", -2, 2), ("reciprocal", .5, 2)]],
    *[C(f"test_ops:unary_grad_vs_numeric[{n}]",
        lambda P, x, n=n: getattr(P, n)(x), r(2, 3, lo=.5, hi=1.5),
        grad=(0,))
      for n in ("exp", "tanh", "sqrt", "log", "square")],
    C("test_ops:binary_broadcast_grads", lambda P, a, b: a * b,
      r(3, 1, 4), r(2, 4), grad=(0, 1)),
    C("test_ops:reductions", lambda P, t: [
        P.sum(t, axis=1), P.mean(t, axis=[0, 2]),
        P.max(t, axis=-1, keepdim=True), P.prod(t, axis=0),
        P.logsumexp(t, axis=1)], r(3, 4, 5), grad=(0,)),
    C("test_ops:matmul_variants", lambda P, a, b, bt, m, v: [
        P.matmul(a, b), P.matmul(a, bt, transpose_y=True), P.bmm(a, b),
        P.mv(m, v)], r(2, 3, 4), r(2, 4, 5), r(2, 5, 4), r(3, 4), r(4),
      grad=(0, 1)),
    C("test_ops:manipulation_roundtrips", lambda P, t: [
        P.reshape(t, [4, 6]), P.reshape(t, [0, -1]),
        P.transpose(t, [2, 0, 1]), P.flatten(t, 1, 2),
        P.unsqueeze(t, [0, -1]), P.squeeze(P.ones([1, 2, 1, 3]), axis=0),
        *P.split(t, [1, 2], axis=1), P.stack([t, t], axis=0),
        P.tile(P.ones([2]), [3, 2]), P.expand(P.ones([1, 3]), [4, 3]),
        P.flip(t, [0]), P.roll(t, 1, axis=0)], a234, grad=(0,)),
    C("test_ops:gather_scatter", lambda P, x, i, up, nd: [
        P.gather(x, i), P.scatter(x, i, up), P.gather_nd(x, nd)],
      x45, np.array([0, 2]), np.ones((2, 3), np.float32),
      np.array([[0, 1], [2, 2]]), grad=(0, 2)),
    C("test_ops:where_topk_sort", lambda P, t: [
        *P.topk(t, 2, axis=1), P.sort(t, axis=1), P.argsort(t, axis=1),
        P.where(t > 0, t, t * 0), P.argmax(t)], r(3, 5), grad=(0,)),
    C("test_ops:creation_ops", lambda P: [
        P.zeros([2, 3]), P.ones([2, 3], dtype="int64"), P.full([2], 7.0),
        P.arange(1, 7, 2), P.linspace(0, 1, 5), P.eye(3),
        P.tril(P.ones([3, 3]))]),
    C("test_ops:linalg_extras", lambda P, a, s: [
        P.cholesky(s), P.inverse(s), P.ops.linalg.det(s),
        P.ops.linalg.norm(a), P.einsum("ij,jk->ik", a, a)],
      r(4, 4), spd, grad=(0, 1)),
    C("test_ops:logic_ops", lambda P, a, b: [
        a == b, a > b, P.allclose(P.ones([2]), P.ones([2])),
        P.ops.logic.equal_all(a, a), P.ops.logic.equal_all(a, b)],
      np.array([1, 2, 3]), np.array([1, 0, 3])),
    C("test_ops:cast_and_dtypes", lambda P, x: [
        x.astype("int64"), x.astype("bfloat16").astype("float32")],
      np.ones(2, np.float32)),
    C("test_ops:cumsum_clip_lerp", lambda P, t: [
        P.cumsum(t, axis=1), P.clip(t, -0.5, 0.5),
        P.ops.math.lerp(P.zeros([3]), P.ones([3]), 0.3)], r(3, 4),
      grad=(0,)),
    # --------------------------------------- tests/test_op_tail.py
    C("test_op_tail:shape_size_rank_unbind_meshgrid", lambda P, x, u, v: [
        P.shape(x), P.numel(x), P.rank(x), *P.unbind(x, axis=1),
        *P.meshgrid(u, v)], np.ones((2, 3, 4), np.float32),
      np.array([1., 2.], np.float32), np.array([3., 4., 5.], np.float32)),
    C("test_op_tail:unique_and_consecutive", lambda P, x, y: [
        P.unique(x), *P.unique(x, return_counts=True),
        P.ops.array_ops.unique_consecutive(y)],
      np.array([2, 1, 2, 3, 1]), np.array([1, 1, 2, 2, 3, 1])),
    C("test_op_tail:tensor_array_roundtrip", lambda P: (lambda arr: [
        P.ops.array_ops.array_length(arr),
        P.ops.array_ops.array_read(arr, 0),
        P.ops.array_ops.array_read(arr, 1)])(
        P.ops.array_ops.array_write(
            P.zeros([2]), 1, P.ops.array_ops.array_write(
                P.ones([2]), 0, P.ops.array_ops.create_array())))),
    C("test_op_tail:broadcast_tensors_and_crop", lambda P, x: [
        *P.broadcast_tensors([P.ones([1, 3]), P.zeros([4, 1])]),
        P.crop(x, shape=[2, 3], offsets=[1, 2])],
      np.arange(24, dtype="float32").reshape(4, 6), grad=(0,), out_sel=2),
    C("test_op_tail:math_tail", lambda P, x, p, v: [
        P.ops.math.complex(P.to_tensor(np.float32(1)),
                           P.to_tensor(np.float32(2))),
        P.ops.math.diff(x), P.ops.math.trapezoid(x), P.ops.math.logit(p),
        P.ops.math.vander(v, 3),
        P.ops.math.take(x, P.to_tensor(np.array([0, 6, -1]))),
        P.ops.math.nan_to_num(P.to_tensor(np.array([np.nan, np.inf],
                                                   np.float32)))],
      r(3, 5), np.array([0.2, 0.5, 0.8], np.float32),
      np.array([1., 2., 3.], np.float32), grad=(0,), out_sel=1),
    # -------------------------------------- tests/test_op_tail3.py
    C("test_op_tail3:diag_embed", lambda P, x: P.ops.creation.diag_embed(x),
      r(2, 3), grad=(0,)),
    C("test_op_tail3:tensor_array_to_tensor", lambda P, a, b: list(
        P.ops.array_ops.tensor_array_to_tensor([a, b], axis=0)),
      r(2, 2), r(3, 2), grad=(0, 1)),
]


@pytest.mark.parametrize("fn,args,grad,out_sel", CASES)
def test_op_tail_case(fn, args, grad, out_sel):
    replay_call("case", fn, args, grad=grad, out_sel=out_sel)

"""Two faults of the port repaired against the JAX package, on the CPU.

1. Results of operations on a parameter. The port's parameters had
   torch's disabled `__torch_function__`, so `p * 2`, `p.clone()` and
   the like came back as plain torch.Tensors without Paddle's methods
   (`(p * 2).scale_(2.0)` raised AttributeError, `(p * 2).numpy()`
   torch's "requires grad" error, `(p + 1).stop_gradient`
   AttributeError). In the JAX package each returns a Tensor. Each
   expression of EXPRESSIONS runs on a parameter of both packages (the
   same values) and is followed by a Paddle-only method; values are
   held to 1e-6 relative (float32 on both sides; a reduction may sum in
   another order), flags exactly. The repair keeps the port's own code
   free of per-op Python: the `__torch_function__` entries counted over
   one tiny-GPT jit.TrainStep step and over two serving engine steps
   are 0.
2. `F.interpolate` / `F.upsample` / `nn.Upsample(align_mode=1)` and
   `nn.BatchNorm(trainable_statistics=True)` raised NotImplementedError
   in the port; the JAX package accepts both and ignores them. Outputs
   are held to the JAX package's at 1e-5 (the resize tests' float32
   limit) and bitwise to align_mode=0's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle

import paddle_tpu_torch as paddle
from paddle_tpu_torch import jit
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.tensor import EagerParamBase, Tensor
from paddle_tpu_torch.inference.serving import EngineConfig, LLMEngine
from paddle_tpu_torch.inference.serving.scheduler import SamplingParams
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    prev_threads, prev_dev = torch.get_num_threads(), place._default
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    torch.set_num_threads(prev_threads)
    place._default = prev_dev


def _linear_pair():
    """nn.Linear(3, 2) in both packages, the port holding the JAX
    weights."""
    jpaddle.seed(3)
    jl = jpaddle.nn.Linear(3, 2)
    tl = paddle.nn.Linear(3, 2)
    tl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})
    return jl.weight, tl.weight


# (name, expression on (package, parameter)); every expression is
# written the same way in both packages
EXPRESSIONS = {
    "clone": lambda P, p: p.clone(),
    "mul": lambda P, p: p * 2,
    "rmul": lambda P, p: 2.0 * p,
    "add": lambda P, p: p + 1,
    "sub_param": lambda P, p: p - p,
    "neg": lambda P, p: -p,
    "pow": lambda P, p: p ** 2,
    "div": lambda P, p: p / 4,
    "detach": lambda P, p: p.detach(),
    "index": lambda P, p: p[0],
    "slice": lambda P, p: p[1:, :1],
    "T": lambda P, p: p.T,
    "matmul": lambda P, p: P.matmul(p, p, transpose_y=True),
    "exp": lambda P, p: P.exp(p),
    "sum": lambda P, p: P.sum(p, axis=0),
    "reshape": lambda P, p: P.reshape(p, [2, 3]),
    "concat": lambda P, p: P.concat([p, p], axis=0),
    "method_abs": lambda P, p: p.abs(),
    "method_mean": lambda P, p: p.mean(),
}


# views of the parameter: torch refuses an in-place write to a view of
# a leaf that requires grad (the JAX package's arrays are immutable, so
# its scale_ rebinds); these take the out-of-place scale
VIEWS = {"T", "index", "slice", "reshape"}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_operation_on_parameter_returns_tensor(name):
    jp, tp = _linear_pair()
    assert isinstance(tp, EagerParamBase)
    expr = EXPRESSIONS[name]
    got, want = expr(paddle, tp), expr(jpaddle, jp)
    assert type(got) is Tensor, type(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=0)
    assert got.stop_gradient == want.stop_gradient
    # a Paddle-only method on the result
    method = "scale" if name in VIEWS else "scale_"
    np.testing.assert_allclose(
        getattr(expr(paddle, tp), method)(2.0).numpy(),
        np.asarray(getattr(expr(jpaddle, jp), method)(2.0).numpy()),
        rtol=1e-6, atol=0)


def test_queue_examples_from_the_fault():
    jp, tp = _linear_pair()
    np.testing.assert_array_equal(tp.clone().scale_(2.0).numpy(),
                                  np.asarray(jp.clone().scale_(2.0).numpy()))
    np.testing.assert_array_equal((tp * 2).scale_(2.0).numpy(),
                                  np.asarray((jp * 2).scale_(2.0).numpy()))
    np.testing.assert_array_equal((tp * 2).numpy(),
                                  np.asarray((jp * 2).numpy()))
    assert (tp + 1).stop_gradient is (jp + 1).stop_gradient is False
    # the gradient flows from a result back to the parameter
    (tp * 2).sum().backward()
    np.testing.assert_array_equal(tp.grad.numpy(), np.full((3, 2), 2.0))


def _count_torch_function(monkeypatch):
    """Count every entry into the port's `__torch_function__` (Tensor's,
    which parameters inherit, and any a subclass defines itself)."""
    calls = [0]
    for cls in (Tensor, EagerParamBase):
        impl = cls.__dict__.get("__torch_function__")
        if impl is None:
            continue
        inner = getattr(impl, "__func__", impl)

        def counting(c, func, types, args=(), kwargs=None, _inner=inner):
            calls[0] += 1
            return _inner(c, func, types, args, kwargs)
        if inner is torch._C._disabled_torch_function_impl:
            continue
        monkeypatch.setattr(cls, "__torch_function__",
                            classmethod(counting))
    return calls


def test_count_probe_sees_user_level_operations(monkeypatch):
    _, tp = _linear_pair()
    calls = _count_torch_function(monkeypatch)
    tp * 2
    assert calls[0] == 1


TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=16)


def test_train_step_and_engine_step_enter_no_torch_function(monkeypatch):
    """The repair keeps the port's own code off __torch_function__: one
    TrainStep step (forward, backward, clip, AdamW) and two engine steps
    (a prefill and a decode chunk) enter it 0 times."""
    model = GPT(GPTConfig(**TINY), device="cpu", seed=0)
    step = jit.TrainStep(model, gpt_loss_fn,
                         AdamW(1e-3, parameters=model.parameters()))
    rng = np.random.RandomState(0)
    x = rng.randint(0, 61, (2, 16))
    y = rng.randint(0, 61, (2, 16))
    step(x, y)  # warm: builds the optimizer state
    eng = LLMEngine.from_model(model, EngineConfig(
        block_size=4, num_blocks=16, max_num_seqs=2), device="cpu")
    eng.add_request(rng.randint(0, 61, (5,)).astype(np.int32),
                    SamplingParams(max_tokens=4), request_id="r0")
    calls = _count_torch_function(monkeypatch)
    loss = step(x, y)
    assert calls[0] == 0, calls[0]
    eng.step()
    eng.step()
    assert calls[0] == 0, calls[0]
    assert np.isfinite(float(loss))


# --------------------------------------------------------------- fault 2
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
def test_interpolate_align_mode_is_accepted_and_ignored(mode):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 5, 7).astype(np.float32)
    want = np.asarray(jpaddle.nn.functional.interpolate(
        jpaddle.to_tensor(x), size=[9, 4], mode=mode,
        align_mode=1).numpy())
    got = F.interpolate(paddle.to_tensor(x), size=[9, 4], mode=mode,
                        align_mode=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), F.interpolate(paddle.to_tensor(x), size=[9, 4],
                                   mode=mode, align_mode=0).numpy())
    up = F.upsample(paddle.to_tensor(x), scale_factor=2, mode=mode,
                    align_mode=1)
    jup = jpaddle.nn.functional.upsample(jpaddle.to_tensor(x),
                                         scale_factor=2, mode=mode,
                                         align_mode=1)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup.numpy()),
                               rtol=1e-5, atol=1e-5)
    layer = paddle.nn.Upsample(size=[8, 8], mode=mode, align_mode=1)
    jlayer = jpaddle.nn.Upsample(size=[8, 8], mode=mode, align_mode=1)
    np.testing.assert_allclose(
        layer(paddle.to_tensor(x)).numpy(),
        np.asarray(jlayer(jpaddle.to_tensor(x)).numpy()), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_trainable_statistics_is_accepted_and_ignored(training):
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    jbn = jpaddle.nn.BatchNorm(3, trainable_statistics=True)
    bn = paddle.nn.BatchNorm(3, trainable_statistics=True)
    bn.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jbn.state_dict().items()})
    if not training:
        jbn.eval()
        bn.eval()
    want = np.asarray(jbn(jpaddle.to_tensor(x)).numpy())
    got = bn(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn._mean.numpy(),
                               np.asarray(jbn._mean.numpy()), atol=1e-6)

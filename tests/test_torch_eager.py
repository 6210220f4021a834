"""The port's eager training surface against the JAX package's, on the
CPU: the LR schedulers, the optimizers' eager API (step, clear_grad,
minimize, state_dict), GradScaler, auto_cast O1's cast decisions, the
f32 eager loop on a tiny GPT, jit.TrainStep's trainable set (ROADMAP
Queue 3 item 2) and the float16 attention route.

Both packages get the same weights (GPT.load_jax_params) and inputs;
results are held to 1e-5 (float32) unless a case says otherwise.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.models.generation as jgen
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import tensor as jtensor
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as j_loss_fn

import paddle_tpu_torch
from paddle_tpu_torch.core import dispatch as tdispatch
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.core import tensor as ttensor
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn.functional import attention as A
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.ops.kernels import packed_flash as k2

PKGS = (paddle_tpu, paddle_tpu_torch)
# the auto_cast modules (the packages' amp.auto_cast is the function)
jauto = importlib.import_module("paddle_tpu.amp.auto_cast")
tauto = importlib.import_module("paddle_tpu_torch.amp.auto_cast")


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    _place._default = prev


def _aligned(build_jax, build_port):
    """Build a JAX and a port object with both packages' tensor-name
    counters started at the same value, so their parameters get the same
    generated names (counters only ever advance)."""
    n = max(jtensor._tensor_name_counter[0], ttensor._tensor_name_counter[0])
    jtensor._tensor_name_counter[0] = n
    j = build_jax()
    ttensor._tensor_name_counter[0] = n
    t = build_port()
    n = max(jtensor._tensor_name_counter[0], ttensor._tensor_name_counter[0])
    jtensor._tensor_name_counter[0] = ttensor._tensor_name_counter[0] = n
    return j, t


def _gpt_pair(cfg_kw):
    def jbuild():
        paddle_tpu.seed(0)
        return JGPT(JGPTConfig(**cfg_kw))

    def tbuild():
        return GPT(GPTConfig(**cfg_kw), device="cpu")
    jm, tm = _aligned(jbuild, tbuild)
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(torch.from_numpy(params[k]))
    return jm, tm


def _batch(vocab, b, t, seed=1):
    tok = np.random.RandomState(seed).randint(0, vocab, (b, t + 1))
    return tok[:, :-1].astype(np.int64), tok[:, 1:].astype(np.int64)


# ------------------------------------------------------------ schedulers
def _schedulers(lr):
    return {
        "NoamDecay": lambda: lr.NoamDecay(64, 10),
        "PiecewiseDecay": lambda: lr.PiecewiseDecay([10, 20],
                                                    [0.1, 0.05, 0.01]),
        "NaturalExpDecay": lambda: lr.NaturalExpDecay(0.1, 0.1),
        "InverseTimeDecay": lambda: lr.InverseTimeDecay(0.1, 0.1),
        "PolynomialDecay": lambda: lr.PolynomialDecay(0.1, 20, 0.001, 2.0,
                                                      cycle=True),
        "LinearWarmup": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(0.1, T_max=30), 5, 0.0, 0.1),
        "ExponentialDecay": lambda: lr.ExponentialDecay(0.1, 0.95),
        "MultiStepDecay": lambda: lr.MultiStepDecay(0.1, [10, 30], 0.5),
        "StepDecay": lambda: lr.StepDecay(0.1, 7, 0.5),
        "LambdaDecay": lambda: lr.LambdaDecay(0.1, lambda e: 0.9 ** e),
        "MultiplicativeDecay": lambda: lr.MultiplicativeDecay(
            0.1, lambda e: 0.95),
        "CosineAnnealingDecay": lambda: lr.CosineAnnealingDecay(
            0.1, 20, 0.001),
        "ReduceOnPlateau": lambda: lr.ReduceOnPlateau(0.1, patience=2,
                                                      cooldown=1),
        "CyclicLR": lambda: lr.CyclicLR(0.01, 0.1, 5, mode="triangular2"),
        "OneCycleLR": lambda: lr.OneCycleLR(0.1, 60, three_phase=True),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(paddle_tpu_torch
                                                    .optimizer.lr)))
def test_scheduler_lr_over_50_steps_equals_jax(name):
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.98] * 9
    runs = []
    for paddle in PKGS:
        s = _schedulers(paddle.optimizer.lr)[name]()
        lrs = []
        for i in range(50):
            lrs.append(s())
            if name == "ReduceOnPlateau":
                s.step(metrics[i])
            else:
                s.step()
        runs.append(lrs)
    assert runs[1] == runs[0]
    assert len(set(runs[1])) > 1


def test_scheduler_drives_the_optimizer():
    """The eager step reads the scheduler each time: three Momentum steps
    under StepDecay move a Linear as in the JAX package; set_lr refuses
    a scheduler and a float learning rate is settable."""
    x = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    got = []
    for paddle in PKGS:
        paddle.seed(0)
        lin = paddle.nn.Linear(3, 2)
        lin.set_state_dict({"weight": np.full((3, 2), 0.3, np.float32),
                            "bias": np.zeros(2, np.float32)})
        sched = paddle.optimizer.lr.StepDecay(0.1, 1, 0.5)
        opt = paddle.optimizer.Momentum(sched, parameters=lin.parameters())
        lrs = []
        for _ in range(3):
            loss = (lin(paddle.to_tensor(x)) ** 2).mean()
            loss.backward()
            lrs.append(opt.get_lr())
            opt.step()
            opt.clear_grad()
            sched.step()
        with pytest.raises(RuntimeError):
            opt.set_lr(0.5)
        got.append((lrs, lin.weight.numpy(), lin.bias.numpy()))
        assert all(p.grad is None for p in lin.parameters())
    assert got[1][0] == got[0][0] == [0.1, 0.05, 0.025]
    for g, w in zip(got[1][1:], got[0][1:]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    o = paddle_tpu_torch.optimizer.Adam(0.1, parameters=[])
    o.set_lr(0.02)
    assert o.get_lr() == 0.02


# ------------------------------------------------------- state dicts
def _adamw_pair_steps(n_steps, state=None):
    """Two AdamW steps (or n_steps) on a tiny MLP in both packages;
    the port can start from a state dict."""
    cfg = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
               max_seq_len=8)
    jm, tm = _gpt_pair(cfg)
    x, y = _batch(64, 2, 8, seed=4)
    out = []
    for paddle, m, lf in ((paddle_tpu, jm, j_loss_fn),
                          (paddle_tpu_torch, tm, gpt_loss_fn)):
        opt = paddle.optimizer.AdamW(
            paddle.optimizer.lr.ExponentialDecay(0.01, 0.9),
            parameters=m.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        for _ in range(n_steps):
            loss = lf(m, paddle.to_tensor(x), paddle.to_tensor(y))
            opt.minimize(loss)
            opt.clear_grad()
            opt._learning_rate.step()
        out.append((m, opt))
    return out


def test_optimizer_state_dict_round_trip_keys_equal_jax():
    (jm, jo), (tm, to) = _adamw_pair_steps(2)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert sorted(tsd) == sorted(jsd)
    assert any(k.endswith("_moment1") for k in tsd)
    assert tsd["global_step"] == jsd["global_step"] == 2
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k in jsd:
        if k not in ("global_step", "LR_Scheduler"):
            np.testing.assert_allclose(tsd[k].numpy(), jsd[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    def fresh_from(sd):
        o = paddle_tpu_torch.optimizer.AdamW(
            paddle_tpu_torch.optimizer.lr.ExponentialDecay(0.01, 0.9),
            parameters=tm.parameters(),
            grad_clip=paddle_tpu_torch.nn.ClipGradByGlobalNorm(1.0))
        o.set_state_dict({k: (v.numpy() if hasattr(v, "numpy") else v)
                          for k, v in sd.items()})
        return o
    # the JAX package's state dict loads every accumulator of the port's
    from_jax = fresh_from(jsd)
    assert len(from_jax._accumulators) == len(tm.parameters())
    assert from_jax.get_lr() == to.get_lr() and from_jax._global_step == 2
    # a fresh optimizer loaded from the port's state dict (through
    # numpy) takes the same third step as the one that made it
    fresh = fresh_from(tsd)
    saved = {k: p.detach().clone() for k, p in tm.named_parameters()}
    x, y = _batch(64, 2, 8, seed=5)
    results = []
    for opt in (to, fresh):
        with torch.no_grad():
            for k, p in tm.named_parameters():
                p.copy_(saved[k])
        loss = gpt_loss_fn(tm, paddle_tpu_torch.to_tensor(x),
                           paddle_tpu_torch.to_tensor(y))
        opt.minimize(loss)
        opt.clear_grad()
        results.append([p.detach().clone() for p in tm.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -------------------------------------------------------- GradScaler
def test_grad_scaler_skips_on_inf_and_rescales_as_jax():
    x = np.ones((2, 3), np.float32)
    got = []
    for paddle in PKGS:
        paddle.seed(0)
        lin = paddle.nn.Linear(3, 1)
        lin.set_state_dict({"weight": np.full((3, 1), 0.5, np.float32),
                            "bias": np.zeros(1, np.float32)})
        opt = paddle.optimizer.Adam(0.1, parameters=lin.parameters())
        scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0,
                                       incr_every_n_steps=2)
        trace = []
        for bad in (False, True, False, False):
            loss = lin(paddle.to_tensor(x)).sum()
            scaled = scaler.scale(loss)
            scaled.backward()
            if bad:
                g = lin.weight.grad
                if paddle is paddle_tpu:
                    g._value = g._value.at[0, 0].set(float("inf"))
                else:
                    g[0, 0] = float("inf")
            before = lin.weight.numpy().copy()
            scaler.minimize(opt, scaled)
            opt.clear_grad()
            moved = not np.array_equal(before, lin.weight.numpy())
            trace.append((moved, scaler.get_init_loss_scaling()))
        got.append((trace, lin.weight.numpy(),
                    scaler.state_dict()["good_steps"]))
    assert got[1][0] == got[0][0]
    assert got[1][0] == [(True, 1024.0), (False, 512.0), (True, 512.0),
                         (True, 1024.0)]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-6)
    assert got[1][2] == got[0][2]


def test_grad_scaler_reads_the_host_once_a_step():
    lin = paddle_tpu_torch.nn.Linear(3, 2)
    opt = paddle_tpu_torch.optimizer.Adam(0.1, parameters=lin.parameters())
    scaler = paddle_tpu_torch.amp.GradScaler()
    for _ in range(3):
        scaled = scaler.scale(lin(paddle_tpu_torch.ones([2, 3])).sum())
        scaled.backward()
        scaler.minimize(opt, scaled)
        opt.clear_grad()
    assert scaler.host_syncs == 3 and scaler.skipped_steps == 0


def test_registered_op_types_are_the_jax_packages():
    """Every op type the port registers is one the JAX package registers
    (so the AMP lists, written in those names, apply alike), and the
    functionals the train steps run are among them."""
    port = set(tdispatch.registered_ops())
    assert port <= set(jdispatch.registered_ops()), \
        sorted(port - set(jdispatch.registered_ops()))
    assert {"linear", "matmul_v2", "bmm", "lookup_table_v2", "dropout",
            "layer_norm", "softmax", "softmax_with_cross_entropy", "conv2d",
            "batch_norm_train", "batch_norm_infer", "fused_bn_add_act_train",
            "gelu", "scaled_dot_product_attention", "reduce_sum",
            "reduce_mean"} <= port
    assert tdispatch.get_op("linear").op_type == "linear"


# ------------------------------------------------------ auto_cast O1
_DECIDED = (tauto.WHITE_LIST | tauto.BLACK_LIST
            | {"scaled_dot_product_attention"})


def _name(d):
    return str(d).replace("torch.", "")


def test_o1_cast_decisions_equal_jax_on_a_tiny_gpt():
    """The ops whose arguments auto_cast O1 decides (white and black
    lists) and attention, in call order, with their argument dtypes
    before and after the hook, on one loss of a tiny GPT."""
    jm, tm = _gpt_pair(dict(GPTConfig.tiny().__dict__))
    assert tauto.WHITE_LIST == jauto.WHITE_LIST
    assert tauto.BLACK_LIST == jauto.BLACK_LIST
    x, y = _batch(256, 2, 16)
    logs = [], []
    orig = jdispatch._amp_cast_hook

    def jhook(op, ts):
        r = orig(op, ts)
        if op in _DECIDED:
            logs[0].append((op, tuple(_name(t._value.dtype) for t in ts),
                            tuple(_name(t._value.dtype)
                                  for t in (r if r is not None else ts))))
        return r
    jdispatch.register_amp_hook(jhook)
    try:
        with paddle_tpu.amp.auto_cast(level="O1", dtype="bfloat16"):
            jl = j_loss_fn(jm, paddle_tpu.to_tensor(x),
                           paddle_tpu.to_tensor(y))
    finally:
        jdispatch.register_amp_hook(orig)

    def tlog(hook):
        def h(op, args, kwargs):
            a2, k2 = hook(op, args, kwargs)
            if op in _DECIDED:
                def dts(a):
                    return tuple(_name(t.dtype) for t in a
                                 if torch.is_tensor(t))
                logs[1].append((op, dts(args), dts(a2)))
            return a2, k2
        return h
    with paddle_tpu_torch.amp.auto_cast(level="O1", dtype="bfloat16"):
        tdispatch._State.amp = tlog(tdispatch._State.amp)
        tl = gpt_loss_fn(tm, paddle_tpu_torch.to_tensor(x),
                         paddle_tpu_torch.to_tensor(y))
    assert tdispatch._State.amp is None
    assert logs[1] == logs[0]
    assert ("linear", ("float32",) * 3, ("bfloat16",) * 3) in logs[1]
    assert logs[1][-1][2] == ("float32", "int64")
    assert tl.dtype == paddle_tpu_torch.float32
    # bf16 rounding in different orders of summation: 2e-2 relative
    assert abs(float(tl) - float(jl)) <= 2e-2 * abs(float(jl))


# -------------------------------------------------- the f32 eager loop
def test_f32_eager_loop_matches_jax_tape():
    """Five steps of backward -> step -> clear_grad -> sched.step with
    AdamW over LinearWarmup(CosineAnnealingDecay) and global-norm clip,
    on a tiny GPT: losses and every parameter within 1e-5 of the JAX
    package's eager tape. AdamW's epsilon is 1e-6, not 1e-8: the key
    projection's bias has a zero gradient in exact arithmetic (softmax
    ignores a constant added to a row's logits), so each package hands
    Adam its own rounding noise there (~1e-10), which epsilon 1e-8
    would turn into steps of +-lr in either direction."""
    jm, tm = _gpt_pair(dict(GPTConfig.tiny().__dict__))
    x, y = _batch(256, 2, 32)
    runs = []
    for paddle, m, lf in ((paddle_tpu, jm, j_loss_fn),
                          (paddle_tpu_torch, tm, gpt_loss_fn)):
        lr = paddle.optimizer.lr
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, T_max=10),
                                warmup_steps=2, start_lr=1e-3, end_lr=1e-2)
        opt = paddle.optimizer.AdamW(
            sched, epsilon=1e-6, parameters=m.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
        losses = []
        for _ in range(5):
            loss = lf(m, xt, yt)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.numpy()))
        runs.append((losses, {k: p.numpy() for k, p in
                              m.named_parameters()}))
    (jl, jp), (tl, tp) = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# --------------------------------- Queue 3 item 2: frozen parameters
@pytest.mark.parametrize("when", ["before", "after"])
def test_train_step_leaves_frozen_parameters_alone(when):
    """Freezing before step 1 (stop_gradient), or after it (trainable
    False, then invalidate()): the frozen parameter stays where it was,
    and the parameters and optimizer state equal the JAX package's."""
    x = np.random.RandomState(6).randn(4, 3).astype(np.float32)
    y = np.random.RandomState(7).randn(4, 2).astype(np.float32)
    runs = []
    for paddle in PKGS:
        paddle.seed(0)
        lin = paddle.nn.Linear(3, 2)
        lin.set_state_dict({"weight": np.full((3, 2), 0.2, np.float32),
                            "bias": np.full(2, 0.1, np.float32)})
        opt = paddle.optimizer.Adam(0.1, parameters=lin.parameters())
        step = paddle.jit.TrainStep(
            lin, lambda m, a, b: ((m(a) - b) ** 2).mean(), opt)
        xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
        if when == "before":
            lin.weight.stop_gradient = True
        else:
            step(xt, yt)
            lin.bias.trainable = False
            step.invalidate()
        frozen = (lin.weight if when == "before" else lin.bias).numpy()
        for _ in range(2):
            step(xt, yt)
        still = (lin.weight if when == "before" else lin.bias).numpy()
        np.testing.assert_array_equal(still, frozen)
        state = {k: {s: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
                     for s, v in st.items()}
                 for k, st in step._opt_state.items()}
        runs.append((lin.weight.numpy(), lin.bias.numpy(), state))
    (jw, jb, js), (tw, tb, ts) = runs
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-7)
    assert sorted(ts) == sorted(js) == (["bias"] if when == "before"
                                         else ["weight"])
    for k in js:
        for s in js[k]:
            np.testing.assert_allclose(ts[k][s], js[k][s], rtol=1e-5,
                                       atol=1e-7)


# ---------------------------------------------- float16 attention route
@pytest.fixture
def min_seq_128():
    jprev, prev = (jflags.flag("flash_attention_min_seq"),
                   flags.flag("flash_attention_min_seq"))
    paddle_tpu.set_flags({"FLAGS_flash_attention_min_seq": 128})
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    paddle_tpu.set_flags({"FLAGS_flash_attention_min_seq": jprev})
    flags.set_flags({"FLAGS_flash_attention_min_seq": prev})


@pytest.mark.parametrize("heads", [1, 2])
def test_float16_routes_to_the_kernels(heads, min_seq_128):
    """Under auto_cast(dtype="float16") a tiny GPT step at K1's (1 head
    of 128) or K2's (2 heads of 64) shape takes the flash route, as in
    float32 and bfloat16: K1 and K2 have float16 instances (on the CPU
    the wrappers run their plain versions, so nothing launches)."""
    m = GPT(GPTConfig(vocab_size=64, hidden_size=128, num_layers=1,
                      num_heads=heads, max_seq_len=128), device="cpu")
    x, y = _batch(64, 1, 128)
    xt, yt = paddle_tpu_torch.to_tensor(x), paddle_tpu_torch.to_tensor(y)
    fns = (k1.flash_attention_fwd, k1.flash_attention_bwd,
           k2.packed_flash_fwd, k2.packed_flash_bwd)
    before = [f.launches for f in fns]
    routes = {}
    for dtype in ("float16", "bfloat16"):
        with paddle_tpu_torch.amp.auto_cast(level="O1", dtype=dtype):
            loss = gpt_loss_fn(m, xt, yt)
        routes[dtype] = (A.LAST_PATH, str(A.LAST_DTYPE))
        loss.backward()
        assert math.isfinite(float(loss.numpy()))
        m.clear_gradients()
    gpt_loss_fn(m, xt, yt)
    routes["float32"] = (A.LAST_PATH, str(A.LAST_DTYPE))
    assert routes == {"float16": ("flash", "torch.float16"),
                      "bfloat16": ("flash", "torch.bfloat16"),
                      "float32": ("flash", "torch.float32")}
    assert [f.launches for f in fns] == before
    assert k2.route_gate(64, 2, 128, 128)

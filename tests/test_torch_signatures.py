"""The port's public signatures against the JAX package's, on the CPU.

A ported function or class keeps the reference's positional parameter
order (ROADMAP.md, Signatures), so that a call written against
paddle_tpu binds to the same parameters in paddle_tpu_torch. A
parameter whose feature is not ported yet stays in its place and takes
only its default (any other value raises NotImplementedError).

`test_positional_order_matches_reference` walks every module of the
port, pairs each public function, class and public method with the
object of the same name in the corresponding module of the JAX package
(`ops/kernels/X` with `ops/pallas/X`, and K4's wrapper with
tools/fused_conv_proto.py), and holds the positional parameter names
of the two to their common prefix. A port's positional parameters past
the reference's own must be listed in PORT_ONLY_TRAILING with a reason.

The behavioural tests each make a reference-style positional call that
lands on another parameter, quietly, unless the order matches, and
compare its result with the JAX package's (float32; the tolerance of
each says why). AdamW's weight_decay follows the reference's rule: the
value when it is a float, 0.01 otherwise.
"""
import importlib
import importlib.util
import inspect
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

import paddle_tpu_torch
import paddle_tpu_torch.models.generation as gen
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import (ColumnParallelLinear,
                                          RowParallelLinear)
from paddle_tpu_torch.inference.serving import (EngineConfig, LLMEngine,
                                                PagedKVCache, Scheduler,
                                                SchedulerConfig)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum

_ROOT = Path(__file__).resolve().parents[1]

# port modules with no counterpart in the JAX package: helpers of the
# port itself, and tools whose JAX counterparts live in bench.py or
# tools/ under other names
NO_COUNTERPART = {
    "paddle_tpu_torch.core.unported",
    "paddle_tpu_torch.ops.kernels",
    "paddle_tpu_torch.ops.kernels._build",
    "paddle_tpu_torch.tools",
    "paddle_tpu_torch.tools.fused_conv_proto",
    "paddle_tpu_torch.tools.engine_bench",
    "paddle_tpu_torch.tools.k3_sweep",
    "paddle_tpu_torch.tools.measure",
    "paddle_tpu_torch.tools.profile_serving",
    "paddle_tpu_torch.tools.serving_traffic",
    "paddle_tpu_torch.tools.train_bench",
}

# positional parameters of the port past the reference's last one; a
# reference-style call never reaches them
PORT_ONLY_TRAILING = {
    # the device the model is built on (the port's entry points default
    # to CUDA) and the seed of its random weights (the JAX models draw
    # from paddle.seed)
    "models.gpt.GPT": ["device", "seed"],
    "models.bert.Bert": ["device", "seed"],
    "models.bert.BertForPretraining": ["device", "seed"],
    "vision.models.resnet.ResNet": ["device", "seed"],
    "vision.models.lenet.LeNet": ["device", "seed"],
    # the attention route ("ragged" K3 or "bucketed"): the JAX function
    # picks it from a module-level switch
    "inference.serving.attention.paged_decode_step": ["kernel"],
}

# the callables whose order was repaired; the walk must find each
REPAIRED = {
    "nn.functional.loss.softmax_with_cross_entropy",
    "nn.functional.loss.cross_entropy", "nn.functional.common.dropout",
    "nn.functional.pooling.max_pool2d", "nn.layer.common.Linear",
    "nn.layer.conv.Conv2D", "nn.layer.pooling.MaxPool2D",
    "distributed.tp_layers.ColumnParallelLinear",
    "distributed.tp_layers.RowParallelLinear",
    "optimizer.optimizers.Momentum", "optimizer.optimizers.Adam",
    "optimizer.optimizers.AdamW", "models.generation.generate",
    "inference.serving.engine.EngineConfig",
    "inference.serving.scheduler.SchedulerConfig",
    "inference.serving.paged_cache.PagedKVCache",
    "inference.serving.engine.LLMEngine",
    "inference.serving.engine.LLMEngine.from_model",
}


def _reference_module(name):
    if name == "paddle_tpu_torch.ops.kernels.fused_conv":
        path = _ROOT / "tools" / "fused_conv_proto.py"
        spec = importlib.util.spec_from_file_location("fused_conv_proto",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    ref = name.replace("paddle_tpu_torch", "paddle_tpu", 1)
    return importlib.import_module(
        ref.replace(".ops.kernels.", ".ops.pallas."))


def _positional(obj):
    params = list(inspect.signature(obj).parameters.values())
    names = [p.name for p in params
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return names[1:] if names[:1] in (["self"], ["cls"]) else names


def _pairs():
    """{case: (port object, [reference objects])} over every public
    function, class and public method of the port that the JAX package
    also has; one case per port object, named after where it is
    defined."""
    cases, missing = {}, set()

    def add(case, obj, ref):
        cases.setdefault(case, (obj, []))
        if all(r is not ref for r in cases[case][1]):
            cases[case][1].append(ref)

    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        mod = importlib.import_module(info.name)
        if info.name in NO_COUNTERPART:
            continue
        try:
            ref_mod = _reference_module(info.name)
        except ModuleNotFoundError:
            missing.add(info.name)
            continue
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or not (inspect.isfunction(obj)
                                            or inspect.isclass(obj)):
                continue
            if not obj.__module__.startswith("paddle_tpu_torch."):
                continue
            ref = getattr(ref_mod, attr, None)
            if ref is None or not callable(ref):
                continue
            case = f"{obj.__module__[len('paddle_tpu_torch.'):]}." \
                   f"{obj.__qualname__}"
            add(case, obj, ref)
            if not inspect.isclass(obj) or not inspect.isclass(ref):
                continue
            for meth, fn in vars(obj).items():
                ref_fn = getattr(ref, meth, None)
                if meth.startswith("_") or ref_fn is None:
                    continue
                fn = getattr(obj, meth)
                if callable(fn) and callable(ref_fn) and not \
                        isinstance(inspect.getattr_static(obj, meth),
                                   property):
                    add(f"{case}.{meth}", fn, ref_fn)
    return cases, missing


CASES, MISSING = _pairs()


def test_walk_covers_the_port():
    assert not MISSING, f"port modules with no JAX counterpart: {MISSING}"
    assert REPAIRED <= set(CASES), sorted(REPAIRED - set(CASES))
    assert len(CASES) >= 60


@pytest.mark.parametrize("case", sorted(CASES))
def test_positional_order_matches_reference(case):
    obj, refs = CASES[case]
    port = _positional(obj)
    for ref in refs:
        want = _positional(ref)
        n = min(len(port), len(want))
        assert port[:n] == want[:n], (case, port, want)
        assert port[len(want):] == PORT_ONLY_TRAILING.get(case, []), \
            (case, port, want)


# ------------------------------------------------ reference-style calls
def test_softmax_with_cross_entropy_third_positional_is_soft_label():
    """The third argument is soft_label: False keeps hard labels, and a
    row labelled 0 gets its loss (ignore_index stays -100)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 5).astype(np.float32)
    label = np.array([[0], [1], [0], [4], [2], [0]], np.int64)
    got = F.softmax_with_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(label), False)
    want = JF.softmax_with_cross_entropy(paddle.to_tensor(logits),
                                         paddle.to_tensor(label), False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert bool(torch.all(got[label[:, 0] == 0] > 0))


def test_momentum_seventh_positional_is_multi_precision():
    """Momentum(lr, mom, params, nesterov, wd, clip, False): the seventh
    argument is multi_precision, so rescale_grad stays 1 and the
    parameters move as in the JAX package (float32, one rounding per
    op: 1e-7)."""
    rng = np.random.RandomState(1)
    p = {"w": rng.randn(4, 3).astype(np.float32)}
    grads = [{"w": rng.randn(4, 3).astype(np.float32)} for _ in range(2)]
    args = (0.1, 0.9, None, False, None, None, False)
    jo, to = jopt.Momentum(*args), Momentum(*args)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jo.init_opt_state(jp), to.init_opt_state(tp)
    for g in grads:
        jp, js = jo.apply_updates(jp, {k: jnp.asarray(v)
                                       for k, v in g.items()}, js)
        tp, ts = to.apply_updates(tp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, ts)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-7)
    assert not np.allclose(tp["w"].numpy(), p["w"])


def test_dropout_third_positional_is_axis():
    """dropout(x, p, None): the third argument is axis, so training stays
    True and elements are dropped, in both packages (the random streams
    differ, so each is checked for Paddle's upscale_in_train form)."""
    x = np.random.RandomState(2).rand(64, 64).astype(np.float32) + 1.0
    paddle.seed(0)
    torch.manual_seed(0)
    for out in (F.dropout(torch.from_numpy(x), 0.5, None).numpy(),
                JF.dropout(paddle.to_tensor(x), 0.5, None).numpy()):
        kept = out != 0
        assert 0.4 < kept.mean() < 0.6
        np.testing.assert_allclose(out[kept], x[kept] / 0.5, rtol=1e-6)


@pytest.fixture(scope="module")
def gpt_pair():
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=24)
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**kw), params, device="cpu")


def test_generate_positional_temperature_then_eos(gpt_pair):
    """generate(model, ids, n, 0.0, None, None, eos): temperature,
    top_k and top_p come before eos_token_id; greedy tokens equal the
    JAX package's exactly."""
    jm, tm = gpt_pair
    ids = np.random.RandomState(4).randint(0, 97, (3, 4)).astype(np.int32)
    plain = np.asarray(jgen.generate(jm, jnp.asarray(ids), 12, 0.0))
    np.testing.assert_array_equal(gen.generate(tm, ids, 12, 0.0), plain)
    row = list(plain[0, 4:])
    eos = next(int(t) for i, t in enumerate(row)
               if i >= 2 and t not in row[:i])
    want = np.asarray(jgen.generate(jm, jnp.asarray(ids), 12, 0.0, None,
                                    None, eos))
    got = gen.generate(tm, ids, 12, 0.0, None, None, eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 4:] == eos).sum() > 1


@pytest.mark.parametrize("weight_decay", [None, 0, 0.05])
def test_adamw_weight_decay_rule_matches_jax(weight_decay):
    """The coefficient is weight_decay when it is a float and 0.01
    otherwise (None and the int 0 decay at 0.01). Three steps at lr 0.1
    on float32, held to 1e-6 as the other AdamW parity test is."""
    rng = np.random.RandomState(3)
    p = {"w": rng.randn(5, 4).astype(np.float32)}
    grads = [{"w": rng.randn(5, 4).astype(np.float32)} for _ in range(3)]
    jo = jopt.AdamW(0.1, weight_decay=weight_decay)
    to = AdamW(0.1, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jo.init_opt_state(jp), to.init_opt_state(tp)
    for g in grads:
        jp, js = jo.apply_updates(jp, {k: jnp.asarray(v)
                                       for k, v in g.items()}, js)
        tp, ts = to.apply_updates(tp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, ts)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)


def test_adam_weight_decay_is_l2_as_in_jax():
    """Adam's sixth parameter is weight_decay (a float: L2Decay on the
    gradient), as in the JAX package."""
    rng = np.random.RandomState(5)
    p = {"w": rng.randn(3, 3).astype(np.float32)}
    g = {"w": rng.randn(3, 3).astype(np.float32)}
    args = (0.1, 0.9, 0.999, 1e-8, None, 0.5)
    jo, to = jopt.Adam(*args), Adam(*args)
    jp, js = jo.apply_updates({"w": jnp.asarray(p["w"])},
                              {"w": jnp.asarray(g["w"])},
                              jo.init_opt_state({"w": jnp.asarray(p["w"])}))
    tw = {"w": torch.from_numpy(p["w"].copy())}
    tp, _ = to.apply_updates(tw, {"w": torch.from_numpy(g["w"])},
                             to.init_opt_state(tw))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["Momentum", "Adam", "AdamW"])
def test_multi_precision_is_accepted_and_ignored_as_in_jax(name):
    """multi_precision=True is taken and ignored by both packages (master
    weights come from amp.decorate(level="O2")): no masters, and two
    steps at lr 0.1 on float32 move the parameters as in the JAX
    package, held to 1e-6 as the AdamW parity test is."""
    rng = np.random.RandomState(7)
    p = {"w": rng.randn(4, 3).astype(np.float32)}
    grads = [{"w": rng.randn(4, 3).astype(np.float32)} for _ in range(2)]
    jo = getattr(jopt, name)(learning_rate=0.1, multi_precision=True)
    to = {"Momentum": Momentum, "Adam": Adam, "AdamW": AdamW}[name](
        learning_rate=0.1, multi_precision=True)
    assert jo._multi_precision is False and to._multi_precision is False
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jo.init_opt_state(jp), to.init_opt_state(tp)
    for g in grads:
        jp, js = jo.apply_updates(jp, {k: jnp.asarray(v)
                                       for k, v in g.items()}, js)
        tp, ts = to.apply_updates(tp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, ts)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)


def test_parallel_linear_third_positional_is_weight_attr():
    """ColumnParallelLinear(in, out, None, False): weight_attr, then
    has_bias=False."""
    for cls in (ColumnParallelLinear, RowParallelLinear):
        layer = cls(8, 4, None, False)
        assert layer.bias is None and tuple(layer.weight.shape) == (8, 4)
    assert tnn.Linear(8, 4, None, False).bias is None
    assert tnn.Linear(8, 4).bias is not None


def test_softmax_with_cross_entropy_return_softmax():
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 7).astype(np.float32)
    label = rng.randint(0, 7, (4, 1)).astype(np.int64)
    loss, sm = F.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label),
        return_softmax=True)
    jloss, jsm = JF.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        return_softmax=True)
    np.testing.assert_allclose(loss.numpy(), jloss.numpy(), atol=1e-6)
    np.testing.assert_allclose(sm.numpy(), jsm.numpy(), atol=1e-6)


def _cache(**kw):
    return PagedKVCache(1, 1, 4, 4, 2, device="cpu", **kw)


UNPORTED = {
    "Linear.weight_attr": lambda: tnn.Linear(4, 4, weight_attr=object()),
    "Conv2D.padding_mode": lambda: tnn.Conv2D(3, 4, 3,
                                              padding_mode="reflect"),
    "MaxPool2D.return_mask": lambda: tnn.MaxPool2D(3, return_mask=True),
    "max_pool2d.return_mask": lambda: F.max_pool2d(
        torch.zeros(1, 1, 4, 4), 2, return_mask=True),
    "dropout.axis": lambda: F.dropout(torch.ones(4, 4), 0.5, 1),
    "Dropout.mode": lambda: tnn.Dropout(0.5, mode="downscale_in_infer"),
    "cross_entropy.weight": lambda: F.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
        torch.ones(3)),
    "cross_entropy.soft_label": lambda: F.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, 3), soft_label=True),
    "cross_entropy.axis": lambda: F.cross_entropy(
        torch.zeros(2, 3), torch.zeros(2, dtype=torch.long), axis=0),
    "softmax_with_cross_entropy.soft_label": lambda:
        F.softmax_with_cross_entropy(torch.zeros(2, 3), torch.zeros(2, 3),
                                     True),
    "Adam.lazy_mode": lambda: Adam(0.1, lazy_mode=True),
    "AdamW.lr_ratio": lambda: AdamW(0.1, lr_ratio=lambda p: 1.0),
    "AdamW.apply_decay_param_fun": lambda: AdamW(
        0.1, apply_decay_param_fun=lambda n: True),
    "generate.temperature": "gpt",
    "PagedKVCache.promote_timeout_s": lambda: _cache(promote_timeout_s=1.0),
    "SchedulerConfig.tenants": lambda: Scheduler(
        SchedulerConfig(tenants=object()), _cache()),
    "SchedulerConfig.cache_high_watermark": lambda: Scheduler(
        SchedulerConfig(cache_high_watermark=0.9), _cache()),
    "EngineConfig.step_timeout_s": "engine",
    "EngineConfig.obs_label": "engine",
    "EngineConfig.revision": "engine",
    "LLMEngine.faults": "engine",
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_parameter_takes_only_its_default(case, gpt_pair):
    """Each reference parameter kept in place without its feature
    raises NotImplementedError for any value but its default."""
    call = UNPORTED[case]
    _, tm = gpt_pair
    if call == "gpt":
        def call():
            gen.generate(tm, np.zeros((1, 2), np.int32), 2, 0.7)
    elif call == "engine":
        field = case.split(".")[1]
        value = {"step_timeout_s": 1.0, "obs_label": "x",
                 "revision": "r1", "faults": object()}[field]

        def call():
            if field == "faults":
                return LLMEngine.from_model(tm, EngineConfig(block_size=8),
                                            value, device="cpu")
            return LLMEngine.from_model(
                tm, EngineConfig(block_size=8, **{field: value}),
                device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        call()

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

@pytest.fixture(autouse=True)
def _cpu_device():
    """Port layers built bare (outside a model given device="cpu") make
    their parameters on the default device, CUDA unless set_device says
    otherwise: these tests ask for the CPU, and restore the default."""
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle_tpu_torch.set_device("cpu")
    yield
    place._default = prev


# port modules with no counterpart in the JAX package: helpers of the
# port itself, and tools whose JAX counterparts live in bench.py or
# tools/ under other names
NO_COUNTERPART = {
    "paddle_tpu_torch.core.unported",
    # the op corpus's replayed cases for runs with no JAX (chip_smoke.py's
    # phase 31, tests/test_torch_cuda.py)
    "paddle_tpu_torch.testing.op_cases",
    "paddle_tpu_torch.ops.kernels",
    "paddle_tpu_torch.ops.kernels._build",
    "paddle_tpu_torch.tools",
    "paddle_tpu_torch.tools.chaos_serve",
    "paddle_tpu_torch.tools.fused_conv_proto",
    "paddle_tpu_torch.tools.engine_bench",
    "paddle_tpu_torch.tools.fit_bench",
    # the supervised worker (the JAX package's is tests/ft_worker.py)
    "paddle_tpu_torch.tools.ft_worker",
    "paddle_tpu_torch.tools.k3_sweep",
    "paddle_tpu_torch.tools.measure",
    "paddle_tpu_torch.tools.profile_serving",
    "paddle_tpu_torch.tools.seq2seq_bench",
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
    "vision.models.mobilenet.MobileNetV1": ["device", "seed"],
    "vision.models.mobilenet.MobileNetV2": ["device", "seed"],
    "vision.models.vgg.VGG": ["device", "seed"],
    # the attention route ("ragged" K3 or "bucketed"): the JAX function
    # picks it from a module-level switch
    "inference.serving.attention.paged_decode_step": ["kernel"],
    "parallel.pipeline.PipelinedGPT": ["device", "seed"],
    # the torch Module's train(mode); the JAX containers' take none
    "parallel.pipeline.PipelineLayer.train": ["mode"],
    "parallel.pipeline.PipelinedGPT.train": ["mode"],
    # the card the hot rows live on (the JAX cache places them on the
    # default device or a mesh)
    "distributed.ps.device_cache.DeviceEmbeddingCache": ["device"],
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


def _has_signature(obj) -> bool:
    """False for callables with no Python signature to hold (exception
    classes over builtin types, as core/errors.py has in both
    packages)."""
    try:
        inspect.signature(obj)
    except ValueError:
        return False
    return True


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
            if ref is None or not callable(ref) or not _has_signature(obj):
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


def _named(obj, method: bool):
    """Every parameter name a call may bind: positional and keyword-only
    (*args/**kwargs aside, and a method's bound first parameter, which
    the JAX package's Tensor methods name x)."""
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.KEYWORD_ONLY)
    params = list(inspect.signature(obj).parameters.values())
    if method or params[:1] and params[0].name in ("self", "cls"):
        params = params[1:]
    return [p.name for p in params if p.kind in kinds]


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_reference_parameter_exists(case):
    """A reference call by keyword binds in the port: every parameter of
    the JAX package's callable, positional or keyword-only, exists in
    the port's (a feature not ported yet keeps the parameter and takes
    only its default)."""
    obj, refs = CASES[case]
    method = inspect.isfunction(obj) and "." in obj.__qualname__
    port = set(_named(obj, method))
    for ref in refs:
        missing = [n for n in _named(ref, method) if n not in port]
        assert not missing, (case, missing)


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
    "Adam.lazy_mode": lambda: Adam(0.1, lazy_mode=True),
    "Embedding.sparse": lambda: tnn.Embedding(10, 4, sparse=True),
    "embedding.sparse": lambda: F.embedding(
        torch.zeros(2, dtype=torch.long), torch.zeros(10, 4), sparse=True),
    "ragged_decode_attention.interpret": lambda: _k3(interpret=True),
    "fused_scale_relu_matmul.bm": lambda: _k4(bm=256),
    "define_flag.public": lambda: paddle_tpu_torch.core.flags.define_flag(
        "unported_probe", 1, public=False),
    "DeviceEmbeddingCache.mesh": lambda: paddle_tpu_torch.distributed.ps.
    DeviceEmbeddingCache(None, 0, 1, 1, mesh=object(), axis="dp",
                         device="cpu"),
}


def _k3(**kw):
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_decode_attention)
    return ragged_decode_attention(
        torch.zeros(1, 1, 8), torch.zeros(2, 4, 1, 8), torch.zeros(2, 4, 1, 8),
        torch.zeros(1, 2, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), **kw)


def _k4(**kw):
    from paddle_tpu_torch.ops.kernels.fused_conv import (
        fused_scale_relu_matmul)
    x = torch.zeros(16, 16, dtype=torch.bfloat16)
    return fused_scale_relu_matmul(x, None, x, torch.ones(16),
                                   torch.zeros(16), **kw)


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_parameter_takes_only_its_default(case, gpt_pair):
    """Each reference parameter kept in place without its feature
    raises NotImplementedError for any value but its default."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        UNPORTED[case]()


# ---------------------------- parameters ported with slice 5b
def _two_requests(tenants=(None, None), lens=(4, 4)):
    from paddle_tpu_torch.inference.serving import Request, SamplingParams
    return [Request(f"r{i}", np.arange(1, n + 1, dtype=np.int32),
                    SamplingParams(max_tokens=2,
                                   tenant=t or "default"))
            for i, (t, n) in enumerate(zip(tenants, lens))]


def _ported_scheduler_tenants():
    """A registry turns on WFQ: the latency tenant's later request is
    admitted ahead of the batch tenant's earlier one."""
    from paddle_tpu_torch.inference.serving import (TenantConfig,
                                                    TenantRegistry)
    reg = TenantRegistry([TenantConfig("bulk", priority="batch"),
                          TenantConfig("fast", priority="latency")])
    sch = Scheduler(SchedulerConfig(max_num_seqs=1, tenants=reg),
                    PagedKVCache(1, 1, 4, 16, 2, device="cpu"))
    bulk, fast = _two_requests(("bulk", "fast"), (6, 6))
    sch.add(bulk)
    sch.add(fast)
    assert [r.request_id for r in sch.schedule().prefill] == ["r1"]


def _ported_scheduler_cost_model():
    """A cost model prices admissions in its FLOPs: two 4-token prompts
    fit the flat 8-token budget, but not cost(8) when the base cost
    dominates."""
    from paddle_tpu_torch.analysis.jaxplan import PrefillCostModel
    admitted = []
    for model in (None, PrefillCostModel(1000.0, 1.0, 0.0)):
        sch = Scheduler(SchedulerConfig(max_prefill_tokens=8,
                                        prefill_cost_model=model),
                        PagedKVCache(1, 1, 4, 16, 2, device="cpu"))
        for r in _two_requests():
            sch.add(r)
        admitted.append(len(sch.schedule().prefill))
    assert admitted == [2, 1]


def _ported_engine(gpt_pair, **kw):
    _, tm = gpt_pair
    return LLMEngine.from_model(tm, EngineConfig(block_size=8, **kw),
                                device="cpu")


def _ported_engine_cost_model(gpt_pair):
    """"auto" resolves to the committed plan's model, as in the JAX
    package."""
    from paddle_tpu.analysis import jaxplan as jplan
    eng = _ported_engine(gpt_pair, prefill_cost_model="auto")
    got = eng.scheduler.config.prefill_cost_model
    assert got is not None
    assert got.as_dict() == jplan.default_admission_model().as_dict()


def _ported_engine_tenants(gpt_pair):
    """A registry's quota refuses the second request of a spent
    tenant."""
    from paddle_tpu_torch.inference.serving import (
        SamplingParams, TenantConfig, TenantQuotaExceeded, TenantRegistry)
    reg = TenantRegistry([TenantConfig("q", quota_tokens=10)])
    eng = _ported_engine(gpt_pair, tenants=reg)
    sp = SamplingParams(max_tokens=4, tenant="q")
    eng.add_request(np.arange(1, 5, dtype=np.int32), sp)
    with pytest.raises(TenantQuotaExceeded):
        eng.add_request(np.arange(1, 5, dtype=np.int32), sp)


def _ported_engine_obs_label(gpt_pair):
    """The label prefixes the engine's series in the obs registry."""
    from paddle_tpu_torch import obs
    eng = _ported_engine(gpt_pair, obs_label="sig-label")
    assert eng.stats.label.startswith("sig-label-")
    eng.stats.steps += 1
    assert obs.REGISTRY.get("serving_events_total").get(
        engine=eng.stats.label, event="steps").value == 1


# ---------------------------- parameters ported with slice 7
def _engine_pair(gpt_pair, **kw):
    """The port's and the JAX package's engine over the same weights."""
    from paddle_tpu.inference.serving import (EngineConfig as JEC,
                                              LLMEngine as JLE)
    jm, _ = gpt_pair
    return _ported_engine(gpt_pair, **kw), \
        JLE.from_model(jm, JEC(block_size=8, **kw))


def _sp_pair(**kw):
    from paddle_tpu.inference.serving import SamplingParams as JSP
    from paddle_tpu_torch.inference.serving import SamplingParams as TSP
    return TSP(**kw), JSP(**kw)


def _drained(eng, rid):
    while eng.has_unfinished():
        eng.step()
    return [int(t) for t in eng.get_request(rid).output_ids]


def _ported_engine_model_revision(gpt_pair, field):
    """A non-default (model, revision) key rides on every exported
    payload and stamps the engine's first_token / finish events, as in
    the JAX package; a differently keyed engine refuses the payload."""
    from paddle_tpu import obs as jobs
    from paddle_tpu_torch import obs
    kw = {field: {"model": "m1", "revision": "r1"}[field]}
    key = {"model": "default", "revision": "r0", **kw}
    snaps = []
    for eng, sp, ob in zip(_engine_pair(gpt_pair, **kw), _sp_pair(
            max_tokens=4), (obs, jobs)):
        ob.reqtrace.enable()
        rid = eng.add_request(np.arange(1, 6, dtype=np.int32), sp)
        eng.step()
        snap = eng.export_request(rid)
        snaps.append((snap["model"], snap["revision"]))
        _drained(eng, rid)
        tags = [{k: e.attrs.get(k) for k in ("model", "revision")}
                for e in ob.reqtrace.events(trace_id=eng.get_request(
                    rid).tid) if e.kind in ("first_token", "finish")]
        assert tags == [key, key]
    assert snaps[0] == snaps[1] == (key["model"], key["revision"])
    other = _ported_engine(gpt_pair)
    with pytest.raises(ValueError, match="cross-revision"):
        other.admit_migrated(dict(snap, model=key["model"],
                                  revision=key["revision"]))


def _ported_add_request_arrival_time(gpt_pair):
    """A re-admitted request keeps its original arrival stamp: its
    deadline counts from it, so one that already blew it times out."""
    got = []
    for eng, sp in zip(_engine_pair(gpt_pair), _sp_pair(
            max_tokens=4, deadline_s=0.5)):
        rid = eng.add_request(np.arange(1, 5, dtype=np.int32), sp,
                              arrival_time=1.0)
        assert eng.get_request(rid).arrival_time == 1.0
        eng.step()
        got.append(eng.get_request(rid).state)
    assert got == ["finished_timeout"] * 2


def _ported_add_request_arrival(gpt_pair):
    """The FCFS ticket is the one given, and a readmitted request with
    an earlier ticket goes ahead of a waiting later one."""
    orders = []
    for eng, sp in zip(_engine_pair(gpt_pair, max_num_seqs=1),
                       _sp_pair(max_tokens=2)):
        eng.add_request(np.arange(1, 5, dtype=np.int32), sp,
                        request_id="late", arrival=10 ** 9)
        rid = eng.add_request(np.arange(2, 6, dtype=np.int32), sp,
                              request_id="early", arrival=5, readmit=True)
        assert eng.get_request(rid).arrival == 5
        orders.append([r.request_id for r in eng.scheduler.waiting])
    assert orders == [["early", "late"]] * 2


def _ported_add_request_resume_tokens(gpt_pair):
    """Resumed tokens seed the output log, and the re-prefill continues
    the greedy stream where it stopped: the tail equals the whole run's,
    as in the JAX engine."""
    full, tails = [], []
    for eng, sp in zip(_engine_pair(gpt_pair), _sp_pair(max_tokens=6)):
        p = np.arange(1, 6, dtype=np.int32)
        full.append(_drained(eng, eng.add_request(p, sp)))
        rid = eng.add_request(p, sp, resume_tokens=full[-1][:3])
        tails.append(_drained(eng, rid))
    assert full[0] == full[1] == tails[0] == tails[1]


def _ported_add_request_readmit(gpt_pair):
    """readmit bypasses max_waiting (a new arrival is refused) and
    charges no tenant quota."""
    from paddle_tpu_torch.inference.serving import (
        EngineOverloaded, SamplingParams, TenantConfig, TenantRegistry)
    reg = TenantRegistry([TenantConfig("q", quota_tokens=10)])
    eng = _ported_engine(gpt_pair, max_waiting=1, tenants=reg)
    sp = SamplingParams(max_tokens=4, tenant="q")
    eng.add_request(np.arange(1, 5, dtype=np.int32), sp)
    with pytest.raises(EngineOverloaded):
        eng.add_request(np.arange(1, 3, dtype=np.int32),
                        SamplingParams(max_tokens=1, tenant="q"))
    eng.add_request(np.arange(1, 5, dtype=np.int32), sp, readmit=True)
    eng.add_request(np.arange(1, 5, dtype=np.int32), sp, readmit=True)
    assert eng.scheduler.num_waiting() == 3


def _ported_add_request_trace_id(gpt_pair):
    """The given trace id names the request's timeline."""
    from paddle_tpu_torch import obs
    obs.reqtrace.enable()
    eng = _ported_engine(gpt_pair)
    rid = eng.add_request(np.arange(1, 5, dtype=np.int32),
                          trace_id="tr-sig-7")
    _drained(eng, rid)
    kinds = [e.kind for e in obs.reqtrace.events(trace_id="tr-sig-7")]
    assert kinds[0] == "engine_admit" and kinds.count("finish") == 1


def _ported_linear_weight_attr():
    """A ParamAttr names the weight, gives its initializer, learning-rate
    multiplier and trainable flag, as the JAX package's does."""
    jw = paddle.nn.Linear(4, 3, weight_attr=paddle.ParamAttr(
        name="sig_w", initializer=paddle.nn.initializer.Constant(0.5),
        learning_rate=0.1, trainable=False)).weight
    tw = tnn.Linear(4, 3, weight_attr=paddle_tpu_torch.ParamAttr(
        name="sig_w", initializer=tnn.initializer.Constant(0.5),
        learning_rate=0.1, trainable=False)).weight
    np.testing.assert_array_equal(tw.detach().numpy(), jw.numpy())
    assert (tw.name, tw.stop_gradient, tw.trainable, tw.optimize_attr) == \
        (jw.name, jw.stop_gradient, jw.trainable, jw.optimize_attr)


def _adamw_pair(**kw):
    """Three functional AdamW steps at lr 0.1 over {"w", "b"} in both
    packages (float32; held to 1e-6 as the other AdamW tests are)."""
    rng = np.random.RandomState(8)
    p = {k: rng.randn(4, 3).astype(np.float32) for k in ("w", "b")}
    grads = [{k: rng.randn(4, 3).astype(np.float32) for k in p}
             for _ in range(3)]
    jo, to = jopt.AdamW(0.1, **kw), AdamW(0.1, **kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jo.init_opt_state(jp), to.init_opt_state(tp)
    for g in grads:
        jp, js = jo.apply_updates(jp, {k: jnp.asarray(v)
                                       for k, v in g.items()}, js)
        tp, ts = to.apply_updates(tp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, ts)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
    return tp


def _ported_adamw_apply_decay_param_fun():
    """Only the parameters the function admits decay (here "w"): both
    packages agree, and "b" moves as under weight_decay 0."""
    tp = _adamw_pair(weight_decay=0.5,
                     apply_decay_param_fun=lambda n: n == "w")
    no_decay = _adamw_pair(weight_decay=0.0)
    np.testing.assert_array_equal(tp["b"].numpy(), no_decay["b"].numpy())
    assert not np.allclose(tp["w"].numpy(), no_decay["w"].numpy())


def _ported_adamw_lr_ratio():
    """lr_ratio is accepted and ignored, as in the JAX package: the same
    steps as without it."""
    tp = _adamw_pair(lr_ratio=lambda p: 0.5)
    plain_run = _adamw_pair()
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), plain_run[k].numpy())


def _train_step_pair(x, **kw):
    """A Linear(3, 2) TrainStep with SGD(0.1) on the same weights in both
    packages, each given keywords `kw` (the JAX step's `anomaly_guard`
    is its own package's guard), one call on x and y = 1; returns
    (port result, JAX result, port layer, JAX layer, port guard, JAX
    guard)."""
    from paddle_tpu.core.anomaly import AnomalyGuard as JGuard
    from paddle_tpu_torch.core.anomaly import AnomalyGuard
    paddle.seed(3)
    jl = paddle.nn.Linear(3, 2)
    tl = tnn.Linear(3, 2)
    tl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})
    tkw, jkw = dict(kw), dict(kw)
    guards = (None, None)
    if "anomaly_guard" in kw:
        guards = (AnomalyGuard(kw["anomaly_guard"]),
                  JGuard(kw["anomaly_guard"]))
        tkw["anomaly_guard"], jkw["anomaly_guard"] = guards

    def loss(m, a, b):
        out = m(a)
        return ((out - b) ** 2).mean(), out

    y = np.ones((x.shape[0], 2), np.float32)
    t = paddle_tpu_torch.jit.TrainStep(
        tl, loss, paddle_tpu_torch.optimizer.SGD(
            0.1, parameters=tl.parameters()), **tkw)
    j = paddle.jit.TrainStep(jl, loss, jopt.SGD(
        0.1, parameters=jl.parameters()), **jkw)
    return (t(torch.from_numpy(x), torch.from_numpy(y)),
            j(paddle.to_tensor(x), paddle.to_tensor(y)), tl, jl) + guards


def _ported_train_step_return_outputs():
    """return_outputs=True gives (loss, loss_fn's outputs) as the JAX
    step does: the same loss and predictions (float32, 1e-6), and the
    same updated weights."""
    x = np.random.RandomState(4).randn(5, 3).astype(np.float32)
    (tloss, tout), (jloss, jout), tl, jl, _, _ = _train_step_pair(
        x, return_outputs=True)
    assert len(tout) == len(jout) == 2
    np.testing.assert_allclose(tloss.numpy(), jloss.numpy(), atol=1e-6)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(
        jout[1].numpy()), atol=1e-6)
    np.testing.assert_allclose(tl.weight.numpy(), jl.weight.numpy(),
                               atol=1e-6)


def _ported_train_step_anomaly_guard():
    """anomaly_guard reaches the step: under skip_step a NaN batch
    leaves the weights bitwise as they were and counts one skipped step
    in both packages."""
    x = np.random.RandomState(4).randn(5, 3).astype(np.float32)
    x[2, 1] = np.nan
    w0 = None
    _, _, tl, jl, tg, jg = _train_step_pair(x, anomaly_guard="skip_step")
    paddle.seed(3)
    w0 = paddle.nn.Linear(3, 2).weight.numpy()
    np.testing.assert_array_equal(tl.weight.numpy(), w0)
    np.testing.assert_array_equal(np.asarray(jl.weight.numpy()), w0)
    assert tg.state_dict() == jg.state_dict()
    assert tg.skipped_steps == 1


def _ce_pair(port_kw, jax_kw=None, soft=False, axis=-1, probs=False):
    """cross_entropy in both packages on the same logits [3, 5, 4] (or
    their softmax with probs): values and input gradients in float32
    within 1e-6."""
    rng = np.random.RandomState(11)
    x = rng.randn(3, 5, 4).astype(np.float32)
    if probs:
        x = np.exp(x) / np.exp(x).sum(axis=axis, keepdims=True)
    c = x.shape[axis]
    if soft:
        lab = rng.rand(*x.shape).astype(np.float32)
        lab /= lab.sum(axis=axis, keepdims=True)
    else:
        shape = list(x.shape)
        shape[axis] = 1
        lab = rng.randint(0, c, size=shape).astype(np.int64)
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in port_kw.items()}
    jkw = {k: (paddle.to_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in (jax_kw or port_kw).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = F.cross_entropy(tx, torch.from_numpy(lab), **kw)
    got.backward()
    jx = paddle.to_tensor(x, stop_gradient=False)
    want = JF.cross_entropy(jx, paddle.to_tensor(lab), **jkw)
    want.backward()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def _ported_ce_weight():
    _ce_pair({"weight": np.array([0.5, 1.0, 2.0, 0.25], np.float32)})


def _ported_ce_soft_label():
    _ce_pair({"soft_label": True}, soft=True)


def _ported_ce_axis():
    _ce_pair({"axis": 1}, axis=1)


def _ported_ce_use_softmax():
    _ce_pair({"use_softmax": False}, probs=True)


def _ported_swce(soft=False, axis=-1):
    rng = np.random.RandomState(12)
    x = rng.randn(4, 6, 3).astype(np.float32)
    if soft:
        lab = rng.rand(*x.shape).astype(np.float32)
        lab /= lab.sum(axis=axis, keepdims=True)
    else:
        shape = list(x.shape)
        shape[axis] = 1
        lab = rng.randint(0, x.shape[axis], size=shape).astype(np.int64)
    got = F.softmax_with_cross_entropy(torch.from_numpy(x),
                                       torch.from_numpy(lab), soft,
                                       axis=axis)
    want = JF.softmax_with_cross_entropy(paddle.to_tensor(x),
                                         paddle.to_tensor(lab), soft,
                                         axis=axis)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _ported_dropout_axis():
    """A mask shared along the axes not listed: whole columns of x are
    kept (scaled by 2) or dropped, as in the JAX package."""
    paddle_tpu_torch.seed(3)
    out = F.dropout(torch.ones(64, 32), 0.5, 1).numpy()
    assert set(np.unique(out)) <= {0.0, 2.0}
    assert (out == out[:1]).all() and 0 < out[0].mean() < 2


def _dropout_modes(layer_kw):
    x = np.random.RandomState(5).rand(16, 8).astype(np.float32) + 0.5
    tl = tnn.Dropout(0.25, **layer_kw)
    jl = paddle.nn.Dropout(0.25, **layer_kw)
    tl.eval(), jl.eval()
    np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                               jl(paddle.to_tensor(x)).numpy(), rtol=1e-7)
    tl.train()
    out = tl(torch.from_numpy(x)).numpy()
    return x, out


def _ported_dropout_mode():
    """downscale_in_infer: kept values unscaled in training, x * (1 - p)
    in eval, as in the JAX package."""
    x, out = _dropout_modes({"mode": "downscale_in_infer"})
    assert np.all((out == 0) | (out == x)) and (out == 0).any()


def _ported_dropout_layer_axis():
    x, out = _dropout_modes({"axis": 0})
    kept = out != 0
    assert (kept == kept[:, :1]).all()
    np.testing.assert_allclose(out[kept], x[kept] / 0.75, rtol=1e-6)


def _ported_conv_padding_mode():
    """Conv2D(padding_mode="reflect") reflects the input by `padding`
    before a convolution with none, as Paddle does; the JAX package
    stores the mode nowhere, so its conv2d on the reflected input is the
    reference (float32, 1e-5: the same sums in another order)."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 7, 6).astype(np.float32)
    tl = tnn.Conv2D(3, 4, 3, padding=[1, 2], padding_mode="reflect")
    w, b = tl.weight.detach().numpy(), tl.bias.detach().numpy()
    xr = np.pad(x, [(0, 0), (0, 0), (1, 1), (2, 2)], mode="reflect")
    want = JF.conv2d(paddle.to_tensor(xr), paddle.to_tensor(w),
                     paddle.to_tensor(b)).numpy()
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-5)


def _check_mask(x, out, mask, want):
    """out equals the JAX max pool; mask holds the flat index of each
    maximum inside its (N, C) input plane."""
    np.testing.assert_array_equal(out.numpy(), want)
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    picked = np.take_along_axis(flat, mask.numpy().reshape(
        mask.shape[0], mask.shape[1], -1), axis=2)
    np.testing.assert_array_equal(picked.reshape(out.shape), out.numpy())


def _ported_max_pool2d_return_mask():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 3, 9, 7).astype(np.float32)
    out, mask = F.max_pool2d(torch.from_numpy(x), 3, 2, 1,
                             return_mask=True, ceil_mode=True)
    want = JF.max_pool2d(paddle.to_tensor(x), 3, 2, 1,
                         ceil_mode=True).numpy()
    _check_mask(x, out, mask, want)


def _ported_max_pool2d_layer_return_mask():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    out, mask = tnn.MaxPool2D(2, return_mask=True)(torch.from_numpy(x))
    want = paddle.nn.MaxPool2D(2)(paddle.to_tensor(x)).numpy()
    _check_mask(x, out, mask, want)


PORTED = {
    "Conv2D.padding_mode": _ported_conv_padding_mode,
    "MaxPool2D.return_mask": _ported_max_pool2d_layer_return_mask,
    "max_pool2d.return_mask": _ported_max_pool2d_return_mask,
    "dropout.axis": _ported_dropout_axis,
    "Dropout.mode": _ported_dropout_mode,
    "Dropout.axis": _ported_dropout_layer_axis,
    "cross_entropy.weight": _ported_ce_weight,
    "cross_entropy.soft_label": _ported_ce_soft_label,
    "cross_entropy.axis": _ported_ce_axis,
    "cross_entropy.use_softmax": _ported_ce_use_softmax,
    "softmax_with_cross_entropy.soft_label":
        lambda: _ported_swce(soft=True),
    "softmax_with_cross_entropy.axis": lambda: _ported_swce(axis=1),
    "Linear.weight_attr": _ported_linear_weight_attr,
    "AdamW.apply_decay_param_fun": _ported_adamw_apply_decay_param_fun,
    "AdamW.lr_ratio": _ported_adamw_lr_ratio,
    "SchedulerConfig.tenants": _ported_scheduler_tenants,
    "SchedulerConfig.prefill_cost_model": _ported_scheduler_cost_model,
    "EngineConfig.prefill_cost_model": _ported_engine_cost_model,
    "EngineConfig.tenants": _ported_engine_tenants,
    "EngineConfig.obs_label": _ported_engine_obs_label,
    "EngineConfig.model": lambda pair: _ported_engine_model_revision(
        pair, "model"),
    "EngineConfig.revision": lambda pair: _ported_engine_model_revision(
        pair, "revision"),
    "LLMEngine.add_request.arrival_time": _ported_add_request_arrival_time,
    "LLMEngine.add_request.arrival": _ported_add_request_arrival,
    "LLMEngine.add_request.resume_tokens": _ported_add_request_resume_tokens,
    "LLMEngine.add_request.readmit": _ported_add_request_readmit,
    "LLMEngine.add_request.trace_id": _ported_add_request_trace_id,
    "TrainStep.return_outputs": _ported_train_step_return_outputs,
    "TrainStep.anomaly_guard": _ported_train_step_anomaly_guard,
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_parameter_reaches_its_feature(case, gpt_pair):
    """Each parameter that took only its default until slice 5b (the
    engine's and scheduler's), slice 6a (Linear's weight_attr, AdamW's
    apply_decay_param_fun and lr_ratio), slice 6b (dropout's axis and
    mode, the cross-entropies' weight, soft_label, axis and
    use_softmax), slice 6c (Conv2D's padding_mode, the max pools'
    return_mask), slice 7 (EngineConfig's model and revision,
    add_request's failover keywords) or slice 8a (TrainStep's
    return_outputs and anomaly_guard) now takes a value and reaches its
    feature, computing as the JAX package does (or, where it drops the
    argument, as Paddle does, against the JAX package on the equivalent
    input)."""
    fn = PORTED[case]
    if case.startswith(("EngineConfig", "LLMEngine")):
        fn(gpt_pair)
    else:
        fn()


# ------------------------------------------- slice 6b: every public name
SLICE_6B = ("nn.functional.activation", "nn.layer.activation",
            "nn.functional.common", "nn.layer.common", "nn.functional.loss",
            "nn.layer.loss", "nn.layer.container", "nn.initializer",
            "nn.clip", "nn.utils", "nn.layer.transformer", "nn.layer.rnn",
            "nn.decode", "optimizer.optimizers", "framework_io")


def _reference_names(module):
    ref = importlib.import_module(f"paddle_tpu.{module}")
    return {n for n, o in vars(ref).items()
            if not n.startswith("_") and callable(o)
            and getattr(o, "__module__", "") == f"paddle_tpu.{module}"}


@pytest.mark.parametrize("module", SLICE_6B)
def test_slice_6b_module_has_every_reference_name(module):
    """Every public function and class the JAX module defines (aliases
    included) has a counterpart of the same name in the port's module
    (the vision-side names of nn.functional.common and nn.layer.common
    joined with slice 6c); the walk above holds their positional
    order."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = _reference_names(module)
    assert names, module
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, (module, missing)


# ------------------------------------------- slice 6c: every public name
SLICE_6C = ("nn.functional.pooling", "nn.functional.conv",
            "nn.functional.norm", "nn.functional.common",
            "nn.functional.extension", "nn.layer.conv", "nn.layer.pooling",
            "nn.layer.norm", "nn.layer.common", "vision.models.resnet",
            "vision.models.mobilenet", "vision.models.vgg",
            "optimizer.wrappers", "incubate.optimizer", "ops.vision_ops")
# what nn.functional takes from ops.vision_ops; its detection ops wait
# for slice 10 (ROADMAP Queue 1 item 10)
VISION_OPS_F = {"grid_sample", "affine_grid", "temporal_shift",
                "pixel_unshuffle", "fold"}
# the names nn.functional takes from other ops modules
OPS_F = {"ops.manipulation": {"pad"}, "ops.extra_ops": {"sigmoid_focal_loss"},
         "ops.creation": {"diag_embed"}}


@pytest.mark.parametrize("module", SLICE_6C)
def test_slice_6c_module_has_every_reference_name(module):
    """Every public function and class of the 15 JAX modules of slice 6c
    (and what its package re-exports) has a counterpart of the same name
    in the port, but ops/vision_ops.py's detection ops (slice 10); the
    walk above holds their positional order."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    # the re-exporting modules (extension, incubate.optimizer): by the
    # names they bind to an object of the JAX package
    ref = importlib.import_module(f"paddle_tpu.{module}")
    names = _reference_names(module) or {
        n for n, o in vars(ref).items() if not n.startswith("_")
        and getattr(o, "__module__", "").startswith("paddle_tpu.")}
    if module == "ops.vision_ops":
        names &= VISION_OPS_F
    assert names, module
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, (module, missing)
    for mod, want in OPS_F.items():
        assert all(hasattr(importlib.import_module(
            f"paddle_tpu_torch.{mod}"), n) for n in want), mod


@pytest.mark.parametrize("package", ["nn", "nn.functional", "optimizer",
                                     "incubate", "vision.models", "vision"])
def test_slice_6c_packages_export_every_reference_name(package):
    """The packages' public names: every one the JAX package exports,
    but those waiting for slices 8 (vision data), 9 (SyncBatchNorm is
    present and raises) and 10 (detection), and modules and helpers
    the JAX package's namespace leaks (numpy, jax, functools...); the
    vision data modules came with slice 8a."""
    ref = importlib.import_module(f"paddle_tpu.{package}")
    port = importlib.import_module(f"paddle_tpu_torch.{package}")
    leaked = {"np", "jnp", "jax", "functools", "annotations", "op",
              "to_tensor", "Tensor", "convert_dtype", "weight_norm_hook",
              "layer", "clip", "decode"}
    waits = {"incubate": {"LayerHelper", "load_op_library", "reader"},
             "vision": {"ops"}}.get(package, set())
    names = {n for n in dir(ref) if not n.startswith("_")}
    missing = sorted(names - leaked - waits - set(dir(port)))
    assert not missing, (package, missing)


# -------------------------------------------- slice 7: every public name
SLICE_7 = ("inference.serving.replica", "inference.serving.migration",
           "inference.serving.router", "inference.serving.autoscaler",
           "inference.serving.deploy")


def _reference_order(module):
    """Public functions, classes and constants of the JAX module, in the
    order its source defines them."""
    ref = importlib.import_module(f"paddle_tpu.{module}")
    names = [n for n in vars(ref) if not n.startswith("_")
             and (callable(vars(ref)[n])
                  and getattr(vars(ref)[n], "__module__", "")
                  == f"paddle_tpu.{module}"
                  or n.isupper())]
    return names


@pytest.mark.parametrize("module", SLICE_7)
def test_slice_7_module_has_every_reference_name(module):
    """Every public function, class and constant of the five fleet
    modules of the JAX package (replica, migration, router, autoscaler,
    deploy) has a counterpart of the same name in the port's module,
    defined in the same order, and every public method of each class
    exists with the reference's positional order (the walk above holds
    the parameters); the package exports every name of the JAX
    package's `__all__`."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = _reference_order(module)
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)
    for name in names:
        ref = getattr(importlib.import_module(f"paddle_tpu.{module}"), name)
        if not inspect.isclass(ref):
            continue
        obj = getattr(port, name)
        for meth, fn in vars(ref).items():
            if meth.startswith("_") or not callable(fn):
                continue
            assert callable(getattr(obj, meth, None)), (name, meth)
            assert _positional(getattr(obj, meth)) == _positional(
                getattr(ref, meth)), (name, meth)
    import paddle_tpu.inference.serving as jserving
    import paddle_tpu_torch.inference.serving as tserving
    assert not set(jserving.__all__) - set(tserving.__all__)


# ------------------------------------------- slice 8a: every public name
SLICE_8A = ("io.dataset", "io.sampler", "io.dataloader", "io.device_loader",
            "vision.image", "vision.transforms.functional",
            "vision.transforms.transforms", "vision.datasets.folder",
            "vision.datasets.mnist", "vision.datasets.cifar",
            "vision.datasets.flowers", "vision.datasets.voc2012",
            "metric.metrics", "core.anomaly", "core.monitor",
            "incubate.checkpoint", "hapi.callbacks", "hapi.model_summary",
            "hapi.model")


@pytest.mark.parametrize("module", SLICE_8A)
def test_slice_8a_module_has_every_reference_name(module):
    """Every public function, class and constant of the training
    runtime's JAX modules (io, vision data, metric, anomaly, monitor,
    checkpoint, hapi) has a counterpart of the same name in the port's
    module, defined in the reference's order; the walk above holds each
    callable's positional order, and jit.TrainStep's return_outputs and
    anomaly_guard are held by test_ported_parameter_reaches_its_feature."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = _reference_order(module)
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)


@pytest.mark.parametrize("package", ["io", "vision.transforms",
                                     "vision.datasets", "metric", "hapi"])
def test_slice_8a_packages_export_every_reference_name(package):
    """The packages export every public name of the JAX package (io's
    InMemoryDataset and QueueDataset raise NotImplementedError until the
    native datafeed is ported) and the top level has Model, summary,
    flops, callbacks, io and metric."""
    ref = importlib.import_module(f"paddle_tpu.{package}")
    port = importlib.import_module(f"paddle_tpu_torch.{package}")
    names = {n for n in dir(ref) if not n.startswith("_")} - {
        "dataset_native", "annotations"}
    missing = sorted(names - set(dir(port)))
    assert not missing, (package, missing)
    for name in ("Model", "summary", "flops", "callbacks", "io", "metric"):
        assert hasattr(paddle_tpu_torch, name), name


# ------------------------------------------- slice 8b: every public name
SLICE_8B = ("ops.math", "ops.logic", "ops.search", "ops.manipulation",
            "ops.creation", "ops.linalg", "ops.random_ops", "ops.array_ops")
# the two names of ops/array_ops.py that wait for core/lod.py (ROADMAP
# Queue 1, the long tail)
SLICE_8B_WAITS = {"array_to_lod_tensor", "lod_tensor_to_array"}


@pytest.mark.parametrize("module", SLICE_8B)
def test_slice_8b_module_has_every_reference_name(module):
    """Every public function and class of the core op corpus's eight JAX
    modules has a counterpart of the same name in the port's module,
    defined in the reference's order, but array_ops' two LoD functions;
    the walk above holds each callable's positional order."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = [n for n in _reference_order(module) if n not in SLICE_8B_WAITS]
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)


# ------------------------------------------- slice 8c: every public name
SLICE_8C = ("distributed.fleet.utils", "distributed.elastic",
            "text.datasets", "reader", "batch") + tuple(
    f"dataset.{m}" for m in ("common", "image", "mnist", "cifar", "imdb",
                             "imikolov", "uci_housing", "movielens",
                             "conll05", "flowers", "voc2012", "wmt14",
                             "wmt16"))


@pytest.mark.parametrize("module", SLICE_8C)
def test_slice_8c_module_has_every_reference_name(module):
    """Every public function, class and constant of slice 8c's JAX
    modules (recompute and the file-system helpers, the elastic
    supervisor, the text datasets, the reader decorators, batch and the
    fluid-era dataset generators) has a counterpart of the same name in
    the port's module, defined in the reference's order; the walk above
    holds each callable's positional order. recompute keeps
    preserve_rng_state (keyword-only after *args, as the reference pops
    it from its kwargs) and the supervisor its parameters in order, with
    the port's clock keyword-only after them."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = _reference_order(module)
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)
    if module == "distributed.fleet.utils":
        sig = inspect.signature(port.recompute).parameters
        assert list(sig)[:2] == ["function", "args"]
        assert sig["preserve_rng_state"].kind == \
            inspect.Parameter.KEYWORD_ONLY
        assert sig["preserve_rng_state"].default is True
    if module == "distributed.elastic":
        from paddle_tpu.distributed import elastic as ref
        got = inspect.signature(port.ElasticSupervisor).parameters
        want = inspect.signature(ref.ElasticSupervisor).parameters
        assert list(got)[:len(want)] == list(want)
        assert [got[n].default for n in want] == \
            [want[n].default for n in want]
        assert list(got)[len(want):] == ["clock"]
        assert got["clock"].kind == inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("package", ["distributed", "distributed.fleet",
                                     "text", "dataset"])
def test_slice_8c_packages_export_every_reference_name(package):
    """distributed exports elastic, fleet and the supervisor's names as
    the JAX package does (paddle_tpu/distributed/__init__.py:21-24);
    fleet, for now, utils and recompute; text and dataset every name;
    the top level text, dataset, reader and batch."""
    ref = importlib.import_module(f"paddle_tpu.{package}")
    port = importlib.import_module(f"paddle_tpu_torch.{package}")
    wanted = {
        "distributed": {"elastic", "fleet", "ElasticSupervisor",
                        "ElasticJobError", "WorkerSpec", "elastic_spawn"},
        "distributed.fleet": {"utils", "recompute"},
    }.get(package, {n for n in dir(ref) if not n.startswith("_")}
          - {"annotations"})
    assert wanted <= set(dir(ref))
    missing = sorted(wanted - set(dir(port)))
    assert not missing, (package, missing)
    for name in ("text", "dataset", "reader", "batch"):
        assert hasattr(paddle_tpu_torch, name), name


# ------------------------------------------- slice 9a: every public name
SLICE_9A = ("parallel.mesh", "parallel.api", "distributed.parallel",
            "distributed.collective", "distributed.spawn",
            "distributed.launch", "distributed.tp_layers",
            "distributed.moe", "distributed.fleet.distributed_strategy",
            "distributed.fleet.role_maker", "distributed.fleet.fleet_base")


@pytest.mark.parametrize("module", SLICE_9A)
def test_slice_9a_module_has_every_reference_name(module):
    """Every public function, class and constant of slice 9a's JAX
    modules (the mesh, the sharded train step, the parallel env, the
    collectives, spawn and launch, the tensor-parallel layers, MoE and
    the fleet's collective path) has a counterpart of the same name in
    the port's module, defined in the reference's order; the walk above
    holds each callable's positional order."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = _reference_order(module)
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)


# the names of the JAX packages the port has no counterpart for:
# parallel/compat.py's shard_map shim (a rank here is a process)
SLICE_9A_WAITS = {
    "distributed": set(),
    "distributed.fleet": set(),
    "parallel": {"compat", "shard_map"},
}


@pytest.mark.parametrize("package", sorted(SLICE_9A_WAITS))
def test_slice_9a_packages_export_every_reference_name(package):
    """distributed, distributed.fleet and parallel export every public
    name of the JAX package (slices 9a and 9b: all but the shard_map
    shim), and the top level has paddle.DataParallel and parallel."""
    ref = importlib.import_module(f"paddle_tpu.{package}")
    port = importlib.import_module(f"paddle_tpu_torch.{package}")
    names = {n for n in dir(ref) if not n.startswith("_")} - {
        "annotations"}
    missing = sorted(names - SLICE_9A_WAITS[package] - set(dir(port)))
    assert not missing, (package, missing)
    for name in ("DataParallel", "parallel", "distributed"):
        assert hasattr(paddle_tpu_torch, name), name


def test_slice_9a_waits_raise_naming_their_slice():
    """What slice 9a left to later slices no longer raises: GPTConfig's
    sequence and context parallelism, the fleet's LocalSGD / DGC /
    fp16_allreduce and parameter server (slice 9b). What is still left
    raises NotImplementedError naming slice 10: the transpiler (it
    splits a static Program) and the native datafeed that consumes the
    data generators' files (the transpiler came with the static graph,
    slice 10a)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed import (DistributeTranspiler,
                                              DistributeTranspilerConfig,
                                              fleet)
    for kw in ("sequence_parallel", "context_parallel"):
        GPT(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                      num_heads=2, max_seq_len=8, **{kw: True}),
            device="cpu")
    for flag, step in (("localsgd", "LocalSGDStep"), ("dgc", "DGCStep"),
                       ("fp16_allreduce", "Fp16AllReduceStep")):
        s = fleet.DistributedStrategy()
        setattr(s, flag, True)
        model = tnn.Linear(2, 2)
        got = fleet.fleet.distributed_train_step(
            model, lambda m, x: m(x).sum(),
            paddle_tpu_torch.optimizer.SGD(0.1,
                                           parameters=model.parameters()),
            s)
        assert type(got).__name__ == step
    srv = fleet.init_server(dense_tables={0: dict(shape=(2,))})
    fleet.run_server()
    srv.stop()
    # slice 10a ported the transpiler: it refuses only a program with no
    # backward op
    from paddle_tpu_torch import static
    main = static.Program()
    with pytest.raises(ValueError, match="no backward op"):
        DistributeTranspiler(DistributeTranspilerConfig()).transpile(
            0, program=main, pservers="127.0.0.1:1")
    for cls in (io.InMemoryDataset, io.QueueDataset):
        with pytest.raises(NotImplementedError, match="slice 10"):
            cls()


# ------------------------------------------- slice 9b: every public name
SLICE_9B = ("parallel.pipeline", "parallel.ring_attention",
            "distributed.fleet.comm_opt", "distributed.fleet.metrics",
            "distributed.fleet.data_generator", "distributed.ps.table",
            "distributed.ps.server", "distributed.ps.client",
            "distributed.ps.device_cache")


@pytest.mark.parametrize("module", SLICE_9B)
def test_slice_9b_module_has_every_reference_name(module):
    """Every public function, class and constant of slice 9b's JAX
    modules (pipeline and ring / Ulysses attention, the fleet's
    comm-opt steps, metrics and data generators, the parameter server)
    has a counterpart of the same name in the port's module, defined in
    the reference's order, and every public method of each class exists
    with the reference's positional order (port-only trailing
    parameters in PORT_ONLY_TRAILING)."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    ref_mod = importlib.import_module(f"paddle_tpu.{module}")
    # JAX's PartitionSpec, imported as P, is no name of the module's own
    names = [n for n in _reference_order(module) if not (
        callable(getattr(ref_mod, n)) and getattr(
            getattr(ref_mod, n), "__module__", "") != ref_mod.__name__)]
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)
    for name in names:
        ref = getattr(ref_mod, name)
        if not inspect.isclass(ref):
            continue
        obj = getattr(port, name)
        for meth, fn in vars(ref).items():
            if meth.startswith("_") or not callable(fn):
                continue
            assert callable(getattr(obj, meth, None)), (name, meth)
            case = f"{module}.{name}.{meth}"
            want = _positional(getattr(ref, meth))
            got = _positional(getattr(obj, meth))
            assert got[:len(want)] == want, (case, got, want)
            assert got[len(want):] == PORT_ONLY_TRAILING.get(case, []), \
                (case, got, want)


# ------------------------------------------ slice 10a: every public name
SLICE_10A = ("static.mode", "static.program", "static.executor",
             "static.backward", "static.nn", "static.amp", "static.io",
             "static.proto_io", "static.compat", "static.debug_ops",
             "static.rnn_shims", "distributed.transpiler")


@pytest.mark.parametrize("module", SLICE_10A)
def test_slice_10a_module_has_every_reference_name(module):
    """Every public function, class and constant of the JAX package's
    static modules and transpiler has a counterpart of the same name in
    the port's module, defined in the reference's order, and every
    public method of each class exists with the reference's positional
    order."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    ref_mod = importlib.import_module(f"paddle_tpu.{module}")
    names = _reference_order(module)
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)
    for name in names:
        ref = getattr(ref_mod, name)
        if not inspect.isclass(ref):
            continue
        obj = getattr(port, name)
        for meth, fn in vars(ref).items():
            if meth.startswith("_") or not callable(fn):
                continue
            assert callable(getattr(obj, meth, None)), (name, meth)
            want = _positional(getattr(ref, meth))
            assert _positional(getattr(obj, meth))[:len(want)] == want, \
                (module, name, meth)


def test_slice_10a_packages_export_every_reference_name():
    """paddle.static exports every public name of the JAX package's but
    auc (the port has no batch-AUC op; paddle.metric.Auc streams it);
    the top level has the mode switches, data, create_parameter and
    create_global_var; jit has InputSpec; utils has unique_name."""
    ref = importlib.import_module("paddle_tpu.static")
    port = importlib.import_module("paddle_tpu_torch.static")
    names = {n for n in dir(ref) if not n.startswith("_")}
    assert sorted(names - {"auc"} - set(dir(port))) == []
    for name in ("enable_static", "disable_static", "in_dynamic_mode",
                 "in_dygraph_mode", "enable_dygraph", "disable_dygraph",
                 "data", "create_parameter", "create_global_var", "static",
                 "utils"):
        assert hasattr(paddle_tpu_torch, name), name
    assert hasattr(paddle_tpu_torch.jit, "InputSpec")
    assert hasattr(paddle_tpu_torch.utils, "unique_name")


SLICE_10B = ("jit", "jit.dy2static", "ops.control_flow", "inference",
             "onnx.export", "models.generation")


@pytest.mark.parametrize("module", SLICE_10B)
def test_slice_10b_module_has_every_reference_name(module):
    """Every public function, class and constant of the JAX modules of
    slice 10b (to_static and dy2static, control flow, the artifact
    Predictor, onnx, export_decoder) has a counterpart of the same name
    in the port's module, defined in the reference's order, and every
    public method of each class exists with the reference's positional
    order."""
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    ref_mod = importlib.import_module(f"paddle_tpu.{module}")
    names = _reference_order(module)
    assert names, module
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (module, missing)
    order = [n for n in vars(port) if n in set(names)]
    assert order == names, (module, order, names)
    for name in names:
        ref = getattr(ref_mod, name)
        if not inspect.isclass(ref):
            continue
        obj = getattr(port, name)
        for meth, fn in vars(ref).items():
            if meth.startswith("_") or not callable(fn):
                continue
            assert callable(getattr(obj, meth, None)), (name, meth)
            want = _positional(getattr(ref, meth))
            assert _positional(getattr(obj, meth))[:len(want)] == want, \
                (module, name, meth)


def test_slice_10b_packages_export_every_reference_name():
    """jit exports every public name of the JAX package's jit but its
    imports (jax, numpy, typing ...); inference every name of the JAX
    inference's; the top level has onnx and ops.control_flow."""
    ref = importlib.import_module("paddle_tpu.jit")
    port = importlib.import_module("paddle_tpu_torch.jit")
    leaked = {"annotations", "jax", "jnp", "np", "os", "pickle", "time",
              "functools", "jaxplan", "Callable", "Dict", "Optional",
              "Tensor", "Layer", "convert_dtype", "no_grad"}
    names = {n for n in dir(ref) if not n.startswith("_")} - leaked
    assert sorted(names - set(dir(port))) == []
    ref = importlib.import_module("paddle_tpu.inference")
    port = importlib.import_module("paddle_tpu_torch.inference")
    names = {n for n in dir(ref) if not n.startswith("_")} - {
        "annotations", "jax", "jnp", "np", "os", "pickle", "Dict", "List",
        "Optional", "serving"}
    assert sorted(names - set(dir(port))) == []
    assert hasattr(paddle_tpu_torch, "onnx")
    assert hasattr(paddle_tpu_torch.ops, "control_flow")

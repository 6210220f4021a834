"""The port's BERT/ERNIE pretraining model and train step
(paddle_tpu_torch.models.bert, tools/train_bench.py's MLM recipe)
against the JAX package, on the CPU.

Both packages get the same weights (`BertForPretraining.load_jax_params`
over the numpy form of the JAX `state_dict()`) and the same numpy
batches (`make_bert_pretrain_batch`, which draws the same arrays from one
RandomState in both). Geometries:
- bench.py's `_tiny_mlm_cfg` (vocab 512, hidden 64, 2 layers, 4 heads of
  16) at T 32: composed attention in both packages;
- a 2-layer config with 2 heads of 64 at T 128 and
  flash_attention_min_seq 128 in both packages: the port routes
  attention to K2 non-causal as packed pairs (its plain version on the
  CPU), the JAX package takes composed attention (its K2 needs a TPU);
- 1-layer variants of bert_base() and ernie_large() for names and
  shapes.

Tolerances (float32 on both sides; the frameworks sum their reductions
in different orders):
- logits and losses within 1e-5 relative to the largest entry;
- gradients within 1e-5 relative to each tensor's largest entry;
- parameters after one AdamW step within 1e-5 absolute, except entries
  whose gradient is zero in exact arithmetic (the key bias: softmax
  ignores a per-row constant), which Adam moves by a rounding-noise
  fraction of lr in either package: those are held to 0.5 * lr, as in
  tests/test_torch_train_step.py;
- the 5-step loss curve within 1e-4 relative.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core import flags as jflags
from paddle_tpu.jit import _FunctionalizedLayer
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.nn.functional import attention as A
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.tools import train_bench

LR = 1e-4
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            max_position=64)                  # bench.py _tiny_mlm_cfg
K2_GEOM = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
               max_position=128)


def _pair(geom, seed=0):
    paddle.seed(seed)
    jm = jbert.BertForPretraining(jbert.BertConfig(**geom))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = bert.BertForPretraining.load_jax_params(bert.BertConfig(**geom),
                                                 state, device="cpu")
    return jm, tm


def _batch(geom, bs, seq, seed=1):
    return bert.make_bert_pretrain_batch(np.random.RandomState(seed),
                                         geom["vocab_size"], bs, seq)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return np.abs(got.astype(np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


@pytest.fixture
def min_seq_128():
    jprev = jflags.flag("flash_attention_min_seq")
    prev = flags.flag("flash_attention_min_seq")
    paddle.set_flags({"FLAGS_flash_attention_min_seq": 128})
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    paddle.set_flags({"FLAGS_flash_attention_min_seq": jprev})
    flags.set_flags({"FLAGS_flash_attention_min_seq": prev})


@pytest.mark.parametrize("bs,seq", [(2, 32), (3, 128), (4, 512)])
def test_batch_equals_jax(bs, seq):
    got = bert.make_bert_pretrain_batch(np.random.RandomState(7), 18000, bs,
                                        seq)
    want = jbert.make_bert_pretrain_batch(np.random.RandomState(7), 18000,
                                          bs, seq)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[4].shape[1] == max(1, int(round(seq * 0.15)))
    assert np.all(np.diff(got[4], axis=1) > 0)


@pytest.mark.parametrize("masked", [True, False])
def test_logits_match_jax(masked):
    jm, tm = _pair(TINY)
    ids, tt, _, _, pos = _batch(TINY, 2, 32)
    kw = {"masked_positions": pos} if masked else {}
    jl, jn = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                **{k: paddle.to_tensor(v) for k, v in kw.items()})
    tl, tn = tm(ids, tt, **kw)
    assert A.LAST_PATH == "composed"
    assert tuple(tl.shape) == ((2, pos.shape[1], 512) if masked
                               else (2, 32, 512))
    assert _rel(tl, jl.numpy()) <= 1e-5
    assert _rel(tn, jn.numpy()) <= 1e-5


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_attention_mask_matches_jax(kind):
    """A [B, 1, 1, T] key mask (row 1's last 9 keys masked): the
    sequence output and the pooled output, in both packages through
    composed attention."""
    jm, tm = _pair(TINY)
    ids, tt, _, _, _ = _batch(TINY, 2, 32)
    keep = np.ones((2, 1, 1, 32), bool)
    keep[1, ..., 23:] = False
    mask = keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(
        np.float32)
    js, jp = jm.bert(paddle.to_tensor(ids), paddle.to_tensor(tt),
                     paddle.to_tensor(mask))
    ts, tp = tm.bert(ids, tt, mask)
    assert not tm.bert.layers[0].attn._pack_gate(32, mask)
    assert _rel(ts, js.numpy()) <= 1e-5
    assert _rel(tp, jp.numpy()) <= 1e-5
    free, _ = tm.bert(ids, tt)
    assert _rel(free[1], ts[1].detach().numpy()) > 1e-3


def _jax_value_and_grads(jm, batch):
    inner = _FunctionalizedLayer(
        lambda *a: jbert.bert_pretrain_loss_fn(jm, *a), jm)
    params, _ = inner.collect_state()
    args = tuple(jnp.asarray(a) for a in batch)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: inner.pure_call(
        p, {}, jax.random.PRNGKey(0), args, {})[0]))(params)
    return float(loss), {k: np.asarray(g) for k, g in grads.items()}


def _check_loss_and_grads(jm, tm, batch):
    jl, jgrads = _jax_value_and_grads(jm, batch)
    tl = bert.bert_pretrain_loss_fn(tm, *(torch.from_numpy(a)
                                          for a in batch))
    names = [k for k, _ in tm.named_parameters()]
    tgrads = torch.autograd.grad(tl, [p for _, p in tm.named_parameters()])
    assert abs(tl.item() - jl) <= 1e-5 * abs(jl)
    assert set(names) == set(jgrads)
    for k, g in zip(names, tgrads):
        assert _rel(g, jgrads[k]) <= 1e-5, k
    return jgrads


def test_k2_route_loss_and_gradients_match_jax(min_seq_128):
    """At T 128 with min_seq 128 the port takes K2 (its plain version
    here, non-causal), the JAX package composed attention."""
    jm, tm = _pair(K2_GEOM)
    batch = _batch(K2_GEOM, 2, 128)
    attn = tm.bert.layers[0].attn
    assert attn.head_dim == 64 and attn._pack_gate(128, None)
    _check_loss_and_grads(jm, tm, batch)
    assert A.LAST_PATH == "flash"


def _steps(geom):
    jm, tm = _pair(geom)
    jo = jopt.AdamW(LR, parameters=jm.parameters())
    to = AdamW(LR, parameters=tm.parameters())
    return (jm, paddle.jit.TrainStep(jm, jbert.bert_pretrain_loss_fn, jo),
            tm, jit.TrainStep(tm, bert.bert_pretrain_loss_fn, to))


def test_one_adamw_step_matches_jax():
    batch = _batch(TINY, 2, 32)
    jm, jstep, tm, tstep = _steps(TINY)
    jgrads = _check_loss_and_grads(jm, tm, batch)
    p0 = {k: p.detach().clone().numpy() for k, p in tm.named_parameters()}
    jloss = float(jstep(*(paddle.to_tensor(a) for a in batch)).numpy())
    tloss = tstep(*batch).item()
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert tstep.optimizer._global_step == 1
    jp = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for k, p in tm.named_parameters():
        got = p.detach().numpy()
        if np.abs(jgrads[k]).max() > 0:
            assert np.abs(got - p0[k]).max() > 0.5 * LR, k
        err = np.abs(got - jp[k])
        noise = np.abs(jgrads[k]) < 1e-6 * np.abs(jgrads[k]).max() + 1e-12
        assert err[~noise].max(initial=0) <= 1e-5, k
        assert err[noise].max(initial=0) <= 0.5 * LR, k


def test_loss_curve_matches_jax():
    batch = _batch(TINY, 2, 32, seed=2)
    _, jstep, _, tstep = _steps(TINY)
    jl = [float(jstep(*(paddle.to_tensor(a) for a in batch)).numpy())
          for _ in range(5)]
    tl = [tstep(*batch).item() for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("preset", ["bert_base", "ernie_large"])
def test_parameter_names_and_shapes_equal_jax(preset):
    jcfg = dataclasses.replace(getattr(jbert, preset)(), num_layers=1)
    tcfg = dataclasses.replace(getattr(bert, preset)(), num_layers=1)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    paddle.seed(0)
    jshapes = {k: tuple(v.shape) for k, v in
               jbert.BertForPretraining(jcfg).state_dict().items()}
    tm = bert.BertForPretraining(tcfg, device="cpu")
    assert {k: tuple(p.shape) for k, p in tm.named_parameters()} == jshapes
    tshapes = {k: tuple(p.shape) for k, p in tm.bert.named_parameters()}
    assert tshapes == {k[len("bert."):]: v for k, v in jshapes.items()
                       if k.startswith("bert.")}


def test_config_fields_equal_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jbert.BertConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(bert.BertConfig)]
    assert tf == jf


def test_o2_dtypes_masters_and_loss_curve_match_jax():
    """amp.decorate(level="O2") makes every parameter bf16 in both
    packages. Four AdamW(1e-4) steps on one repeated batch (4 layers,
    hidden 256, 4 heads of 64, T 64): the port's losses follow the JAX
    package's within one bf16 ulp relative (2**-8: the frameworks round
    their bf16 products at different points), including the rise at the
    second step that both show (Adam's first steps move every weight by
    about lr before the moments settle); each parameter, the tied word
    embedding once, has an f32 master that holds its bf16 value."""
    geom = dict(vocab_size=512, hidden_size=256, num_layers=4, num_heads=4,
                max_position=64)
    jm, tm = _pair(geom)
    jo = jopt.AdamW(LR, parameters=jm.parameters())
    to = AdamW(LR, parameters=tm.parameters())
    jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    assert {str(v.dtype).split(".")[-1] for v in
            jm.state_dict().values()} == {"bfloat16"}
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    batch = _batch(geom, 4, 64, seed=0)
    jstep = paddle.jit.TrainStep(jm, jbert.bert_pretrain_loss_fn, jo)
    step = jit.TrainStep(tm, bert.bert_pretrain_loss_fn, to)
    jl = [float(jstep(*(paddle.to_tensor(a) for a in batch)).numpy())
          for _ in range(4)]
    tl = [step(*batch).item() for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8, atol=0)
    for curve in (jl, tl):
        assert curve[1] > curve[0] > curve[3], curve
    names = [k for k, _ in tm.named_parameters()]
    assert names.count("bert.word_emb.weight") == 1
    assert set(step._opt_state) == set(names) == set(jm.state_dict())
    for k, p in tm.named_parameters():
        master = step._opt_state[k]["master"]
        assert master.dtype == torch.float32, k
        assert torch.equal(master.to(torch.bfloat16), p.detach()), k


def _bench_expression():
    """bench.py's FLOPs-per-sample statements in `_bench_mlm_pretrain`, as
    code objects."""
    src = (Path(__file__).resolve().parents[1] / "bench.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef)
              and n.name == "_bench_mlm_pretrain")
    stmts = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Name)
             and n.targets[0].id in ("per_layer", "flops_per_sample")]
    stmts.sort(key=lambda n: n.lineno)
    assert [n.targets[0].id for n in stmts] == ["per_layer",
                                                "flops_per_sample"]
    return [compile(ast.Module([n], []), "bench.py", "exec") for n in stmts]


@pytest.mark.parametrize("model,P", [("bert", 19), ("ernie", 77)])
def test_flops_per_sample_is_bench_expression(model, P):
    cfg = train_bench.mlm_config(model)
    seq = train_bench.MLM_GEOMETRY[model][1]
    ns = dict(cfg=cfg, h=cfg.hidden_size, L=cfg.num_layers,
              V=cfg.vocab_size, T=seq, P=P)
    for code in _bench_expression():
        exec(code, ns)
    assert train_bench.flops_per_sample(cfg, seq, P) == ns[
        "flops_per_sample"]


def test_mlm_bench_builds_the_bench_recipe():
    """build_mlm at a tiny geometry: O2 bf16 parameters, AdamW(1e-4)
    without clipping, the batch from make_bert_pretrain_batch on the
    model's device, and a step that trains."""
    prev = train_bench.mlm_config, dict(train_bench.MLM_GEOMETRY)
    train_bench.mlm_config = lambda m: bert.BertConfig(**TINY)
    train_bench.MLM_GEOMETRY["bert"] = (2, 32)
    try:
        net, step, args = train_bench.build_mlm("bert", 0, "cpu")
        res = train_bench.run_mlm("bert", 1, 2, built=(net, step, args))
    finally:
        train_bench.mlm_config = prev[0]
        train_bench.MLM_GEOMETRY.update(prev[1])
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    assert step.optimizer.get_lr() == 1e-4
    assert step.optimizer._grad_clip is None
    want = bert.make_bert_pretrain_batch(np.random.RandomState(0), 512, 2,
                                         32)
    for a, w in zip(args, want):
        np.testing.assert_array_equal(a.numpy(), w)
    assert res["last_path"] == "composed" and res["masked"] == 5
    assert all(np.isfinite(res["losses"])) and len(res["losses"]) == 3

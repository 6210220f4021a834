"""The port's activations, losses and common functionals and their
layers against the JAX package's, on the CPU.

Each case hands both packages the same seeded numpy inputs, compares
the outputs, and then the gradient of sum(out * w) (w seeded) with
respect to each float input, in float32 to RTOL / ATOL below (the
formulas are the same; the two libraries' transcendentals and
reduction orders differ in the last bits). Every name of the ported
modules is a case: activations (and their layers), losses with every
reduction, weight, ignore_index and soft_label, and the common
functionals. The random ones (rrelu in training, gumbel_softmax, the
dropouts) draw from different streams in the two packages, so they are
held to their distributions and their eval forms exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import place as _place

RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    tp.set_device("cpu")
    yield
    _place._default = prev


def _tensors(pkg, arrays, grad):
    return [pkg.to_tensor(a, stop_gradient=i not in grad)
            if isinstance(a, np.ndarray) else a
            for i, a in enumerate(arrays)]


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _run(pkg, fn, arrays, grad, kwargs):
    ts = _tensors(pkg, arrays, grad)
    kwargs = {k: pkg.to_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kwargs.items()}
    outs = _outs(fn(*ts, **kwargs))
    rng = np.random.RandomState(99)
    total = None
    for o in outs:
        if np.issubdtype(o.numpy().dtype, np.floating):
            w = pkg.to_tensor(np.asarray(rng.rand(*o.shape) + 0.5,
                                         np.float32))
            term = (o * w).sum()
            total = term if total is None else total + term
    if grad:
        total.backward()
    # an input the output does not reach has no gradient in the port
    # (torch leaves .grad None) and zeros in the JAX package
    return ([o.numpy() for o in outs],
            [np.zeros(ts[i].shape, np.float32) if ts[i].grad is None
             else ts[i].grad.numpy() for i in grad])


def both(name, arrays, grad=(0,), rtol=RTOL, atol=ATOL, module=None,
         **kwargs):
    """name's functional in both packages on the same inputs: outputs
    and input gradients equal within rtol / atol."""
    jf = getattr(module[0] if module else JF, name)
    tf = getattr(module[1] if module else TF, name)
    jo, jg = _run(jp, jf, arrays, grad, kwargs)
    to, tg = _run(tp, tf, arrays, grad, kwargs)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def _x(*shape, scale=2.0, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------ activations
ACTIVATIONS = {
    "relu": {}, "relu6": {"scale": 5.0}, "sigmoid": {}, "silu": {},
    "swish": {}, "tanh": {}, "tanhshrink": {}, "mish": {},
    "log_sigmoid": {}, "hardsigmoid": {"scale": 5.0},
    "hardswish": {"scale": 5.0}, "gelu": {}, "gelu/approximate":
        {"kw": {"approximate": True}},
    "leaky_relu": {"kw": {"negative_slope": 0.2}}, "elu": {"kw":
        {"alpha": 0.7}}, "celu": {"kw": {"alpha": 1.3}}, "selu": {},
    "hardtanh": {"kw": {"min": -0.5, "max": 1.5}},
    "hardshrink": {"kw": {"threshold": 0.7}},
    "softshrink": {"kw": {"threshold": 0.3}},
    "softplus": {"kw": {"beta": 2.0, "threshold": 3.0}}, "softsign": {},
    "thresholded_relu": {"kw": {"threshold": 0.4}},
    "softmax": {"kw": {"axis": 1}}, "log_softmax": {"kw": {"axis": -1}},
    "maxout": {"kw": {"groups": 3, "axis": 1}}, "glu": {"kw": {"axis": 1}},
    "rrelu/eval": {"kw": {"lower": 0.1, "upper": 0.4, "training": False}},
}


@pytest.mark.parametrize("case", sorted(ACTIVATIONS))
def test_activation_matches_jax(case):
    spec = ACTIVATIONS[case]
    both(case.split("/")[0], [_x(2, 6, 3, 4, scale=spec.get("scale", 2.0))],
         **spec.get("kw", {}))


@pytest.mark.parametrize("data_format,wshape",
                         [("NCHW", (1,)), ("NCHW", (6,)), ("NHWC", (4,))])
def test_prelu_matches_jax(data_format, wshape):
    w = np.random.RandomState(1).rand(*wshape).astype(np.float32)
    both("prelu", [_x(2, 6, 3, 4), w], grad=(0, 1),
         data_format=data_format)


@pytest.mark.parametrize("name", ["relu_", "elu_", "softmax_", "tanh_"])
def test_inplace_activation_writes_its_argument(name):
    x = _x(3, 5)
    jt, tt = jp.to_tensor(x), tp.to_tensor(x)
    out = getattr(TF, name)(tt)
    getattr(JF, name)(jt)
    assert out is tt
    np.testing.assert_allclose(tt.numpy(), jt.numpy(), rtol=RTOL, atol=ATOL)


def test_rrelu_training_draws_one_slope_in_range():
    """One slope a call from U(lower, upper): the negative entries of a
    call share it; calls differ; positives pass."""
    x = -np.abs(_x(64)) - 0.1
    slopes = set()
    tp.seed(4)
    for _ in range(20):
        out = TF.rrelu(tp.to_tensor(x), 0.1, 0.3, training=True).numpy()
        s = out / x
        assert np.allclose(s, s[0]) and 0.1 <= s[0] <= 0.3
        slopes.add(round(float(s[0]), 6))
    assert len(slopes) > 10
    pos = np.abs(x)
    np.testing.assert_array_equal(
        TF.rrelu(tp.to_tensor(pos), training=True).numpy(), pos)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_distribution(hard):
    """Samples are distributions over the last axis (one-hot with hard,
    whose gradient is the soft sample's); the argmax frequencies follow
    softmax(x) within 0.03 over 4000 draws, in both packages; a seed
    repeats the port's draws."""
    logits = np.array([[1.0, 0.0, -1.0, 0.5]], np.float32)
    p = np.exp(logits) / np.exp(logits).sum()
    x = np.repeat(logits, 4000, axis=0)
    for pkg, F in ((jp, JF), (tp, TF)):
        pkg.seed(7)
        # axis 1, not -1: the JAX package's hard form indexes its axis
        # by its non-negative position
        out = F.gumbel_softmax(pkg.to_tensor(x), 1.0, hard, 1).numpy()
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
        if hard:
            assert set(np.unique(out.round(5))) <= {0.0, 1.0}
        freq = np.bincount(out.argmax(-1), minlength=4) / len(x)
        np.testing.assert_allclose(freq, p[0], atol=0.03)
    tp.seed(3)
    a = TF.gumbel_softmax(tp.to_tensor(x[:5]), 0.5).numpy()
    tp.seed(3)
    np.testing.assert_array_equal(
        a, TF.gumbel_softmax(tp.to_tensor(x[:5]), 0.5).numpy())
    t = tp.to_tensor(x[:3], stop_gradient=False)
    (TF.gumbel_softmax(t, 1.0, True) * tp.to_tensor(
        np.arange(12, dtype=np.float32).reshape(3, 4))).sum().backward()
    assert np.abs(t.grad.numpy()).sum() > 0


ACT_LAYERS = {
    "ReLU": (), "ReLU6": (), "Sigmoid": (), "Tanh": (), "Tanhshrink": (),
    "Silu": (), "Swish": (), "Mish": (), "LogSigmoid": (), "Hardsigmoid": (),
    "Hardswish": (), "Softsign": (), "GELU": (True,), "LeakyReLU": (0.3,),
    "ELU": (0.5,), "CELU": (0.8,), "SELU": (), "Hardtanh": (-0.3, 0.9),
    "Hardshrink": (0.4,), "Softshrink": (0.2,), "Softplus": (1.5, 4.0),
    "ThresholdedReLU": (0.6,), "PReLU": (6, 0.1), "Softmax": (1,),
    "LogSoftmax": (2,), "Maxout": (2, 1), "GLU": (1,), "RReLU": (0.2, 0.25),
}


@pytest.mark.parametrize("name", sorted(ACT_LAYERS))
def test_activation_layer_matches_jax(name):
    """Each activation layer, constructed with the same positional
    arguments, in eval mode (RReLU's eval slope), against the JAX one."""
    args = ACT_LAYERS[name]
    jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    jl.eval(), tl.eval()
    x = _x(2, 6, 4, 2)
    both("__call__", [x], module=(jl, tl))


# ------------------------------------------------------------- common
def test_one_hot_and_label_smooth_match_jax():
    ids = np.array([[0, 3, 2], [4, 1, 1]], np.int64)
    np.testing.assert_array_equal(TF.one_hot(tp.to_tensor(ids), 5).numpy(),
                                  JF.one_hot(jp.to_tensor(ids), 5).numpy())
    assert TF.one_hot(tp.to_tensor(ids), 5).dtype == torch.float32
    lab = np.eye(5, dtype=np.float32)[ids]
    both("label_smooth", [lab], epsilon=0.2)
    prior = np.random.RandomState(2).dirichlet(np.ones(5)).astype(
        np.float32)
    both("label_smooth", [lab, prior], grad=(0,), epsilon=0.1)


@pytest.mark.parametrize("name,arrays,kw", [
    ("cosine_similarity", [_x(4, 6), _x(4, 6, seed=1)], {"axis": 1}),
    ("cosine_similarity", [_x(3, 5, 2), _x(3, 5, 2, seed=1)],
     {"axis": -1, "eps": 1e-6}),
    ("normalize", [_x(4, 6)], {}),
    ("normalize", [_x(4, 6)], {"p": 3, "axis": 0}),
    ("bilinear", [_x(4, 3), _x(4, 5, seed=1), _x(2, 3, 5, seed=2),
                  _x(2, seed=3)], {}),
    ("bilinear", [_x(4, 3), _x(4, 5, seed=1), _x(2, 3, 5, seed=2)], {}),
    ("linear", [_x(4, 3), _x(3, 5, seed=1), _x(5, seed=2)], {}),
])
def test_common_functional_matches_jax(name, arrays, kw):
    both(name, arrays, grad=tuple(range(len(arrays))), **kw)


@pytest.mark.parametrize("name", ["dropout", "dropout2d", "dropout3d",
                                  "alpha_dropout"])
def test_dropouts_in_eval_are_the_jax_forms(name):
    shape = (2, 3, 4, 5, 2) if name == "dropout3d" else (2, 3, 4, 5)
    x = _x(*shape)
    got = getattr(TF, name)(tp.to_tensor(x), 0.3, training=False).numpy()
    want = getattr(JF, name)(jp.to_tensor(x), 0.3, training=False).numpy()
    np.testing.assert_array_equal(got, want)
    got = TF.dropout(tp.to_tensor(x), 0.3, training=False,
                     mode="downscale_in_infer").numpy()
    want = JF.dropout(jp.to_tensor(x), 0.3, training=False,
                      mode="downscale_in_infer").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("name,fmt,shape,axes", [
    ("dropout2d", "NCHW", (8, 16, 3, 3), (0, 1)),
    ("dropout2d", "NHWC", (8, 3, 3, 16), (0, 3)),
    ("dropout3d", "NCDHW", (8, 16, 2, 2, 2), (0, 1))])
def test_channel_dropout_masks_whole_channels(name, fmt, shape, axes):
    x = np.abs(_x(*shape)) + 0.5
    tp.seed(1)
    out = getattr(TF, name)(tp.to_tensor(x), 0.5, True, fmt).numpy()
    kept = out != 0
    other = tuple(i for i in range(len(shape)) if i not in axes)
    assert (kept.all(axis=other) == kept.any(axis=other)).all()
    np.testing.assert_allclose(out[kept], 2 * x[kept], rtol=1e-6)
    assert 0.3 < kept.mean() < 0.7


def test_alpha_dropout_follows_the_jax_formula():
    """Dropped values become a alpha' + b and kept ones a x + b with the
    JAX package's constants; over 200000 draws the output's mean and
    standard deviation equal the JAX output's within 0.01, and a p share
    is dropped."""
    x = np.random.RandomState(0).randn(200000).astype(np.float32)
    tp.seed(2)
    out = TF.alpha_dropout(tp.to_tensor(x), 0.2).numpy()
    jp.seed(2)
    jout = JF.alpha_dropout(jp.to_tensor(x), 0.2).numpy()
    assert abs(out.mean() - jout.mean()) < 0.01
    assert abs(out.std() - jout.std()) < 0.01
    p, alpha_p = 0.2, -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / (1.0 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    dropped = np.isclose(out, a * alpha_p + b, atol=1e-6)
    assert 0.18 < dropped.mean() < 0.22
    np.testing.assert_allclose(out[~dropped], a * x[~dropped] + b,
                               rtol=1e-5, atol=1e-6)


def test_common_layers_match_jax():
    """Identity, Flatten, CosineSimilarity, PairwiseDistance and Bilinear
    (the JAX layer's weights copied) against the JAX layers."""
    x, y = _x(3, 4, 5), _x(3, 4, 5, seed=1)
    cases = [(jnn.Identity(), tnn.Identity(), [x]),
             (jnn.Flatten(), tnn.Flatten(), [x]),
             (jnn.Flatten(0, 1), tnn.Flatten(0, 1), [x]),
             (jnn.CosineSimilarity(2), tnn.CosineSimilarity(2), [x, y]),
             (jnn.PairwiseDistance(), tnn.PairwiseDistance(), [x, y]),
             (jnn.PairwiseDistance(1.0, 1e-3, True),
              tnn.PairwiseDistance(1.0, 1e-3, True), [x, y])]
    jb, tb = jnn.Bilinear(5, 5, 3), tnn.Bilinear(5, 5, 3)
    tb.set_state_dict({k: v.numpy() for k, v in jb.state_dict().items()})
    cases.append((jb, tb, [x[0], y[0]]))
    for jl, tl, arrays in cases:
        both("__call__", arrays, grad=tuple(range(len(arrays))),
             module=(jl, tl))
    assert [k for k, _ in tb.named_parameters()] == ["weight", "bias"]
    assert tuple(tb.weight.shape) == (3, 5, 5)


# ---------------------------------------------------------------- losses
def _logits_labels(n=6, c=5, seed=0, ignore=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32) * 2
    lab = rng.randint(0, c, (n,)).astype(np.int64)
    if ignore:
        lab[1] = -100
    return x, lab


def _soft(shape, axis=-1, seed=3):
    s = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return s / s.sum(axis=axis, keepdims=True)


def _probs(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


REDUCTIONS = ("none", "mean", "sum")
X, LAB = _logits_labels()
X3 = _x(3, 4, 5)
LAB3 = np.random.RandomState(4).randint(0, 4, (3, 5)).astype(np.int64)
W5 = (np.random.RandomState(5).rand(5) + 0.5).astype(np.float32)
A, B = _x(4, 7), _x(4, 7, seed=1)
P01 = np.random.RandomState(6).rand(4, 7).astype(np.float32) * 0.9 + 0.05
Y01 = (np.random.RandomState(7).rand(4, 7) > 0.5).astype(np.float32)
SIGN = np.where(np.random.RandomState(8).rand(4) > 0.5, 1.0,
                -1.0).astype(np.float32)

LOSSES = {
    "cross_entropy/hard": ([X, LAB], {}),
    "cross_entropy/hard_keepdim_label": ([X, LAB[:, None]], {}),
    "cross_entropy/weight": ([X, LAB, W5], {}),
    "cross_entropy/soft": ([X, _soft(X.shape)], {"soft_label": True}),
    "cross_entropy/soft_weight": ([X, _soft(X.shape), W5],
                                  {"soft_label": True}),
    "cross_entropy/axis1": ([X3, LAB3], {"axis": 1}),
    "cross_entropy/probs": ([_probs(X), LAB], {"use_softmax": False}),
    "cross_entropy/probs_soft": ([_probs(X), _soft(X.shape)],
                                 {"use_softmax": False,
                                  "soft_label": True}),
    "cross_entropy/ignore_7": ([X, np.where(LAB < 0, 7, LAB)],
                               {"ignore_index": 7}),
    "nll_loss/plain": ([np.log(_probs(X)), LAB], {}),
    "nll_loss/weight": ([np.log(_probs(X)), LAB, W5], {}),
    "nll_loss/spatial": ([np.log(_probs(X3, 1)), LAB3], {}),
    "mse_loss": ([A, B], {}), "l1_loss": ([A, B], {}),
    "smooth_l1_loss": ([A, B], {"delta": 0.5}),
    "binary_cross_entropy/plain": ([P01, Y01], {}),
    "binary_cross_entropy/weight": ([P01, Y01, P01[0]], {}),
    "binary_cross_entropy_with_logits/plain": ([A, Y01], {}),
    "binary_cross_entropy_with_logits/weights": (
        [A, Y01, P01[0]], {"pos_weight": P01[1] + 0.5}),
    "kl_div": ([np.log(P01), P01[::-1].copy()], {}),
    "margin_ranking_loss": ([A[:, 0], B[:, 0], SIGN], {"margin": 0.3}),
    "hinge_embedding_loss": ([np.abs(A), np.where(Y01 > 0, 1.0, -1.0)
                              .astype(np.float32)], {"margin": 1.5}),
    "cosine_embedding_loss": ([A, B, SIGN], {"margin": 0.1}),
    "triplet_margin_loss/plain": ([A, B, _x(4, 7, seed=2)], {}),
    "triplet_margin_loss/swap": ([A, B, _x(4, 7, seed=2)],
                                 {"p": 3.0, "swap": True, "margin": 0.5}),
}


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case, reduction):
    """Every loss with every reduction ("none" is "batchmean" for
    kl_div), values and the gradients of its float inputs (not of hard
    labels or class weights)."""
    arrays, kw = LOSSES[case]
    name = case.split("/")[0]
    kw = dict(kw, reduction=reduction)
    if name == "kl_div" and reduction == "none":
        kw["reduction"] = "batchmean"
    floats = tuple(i for i, a in enumerate(arrays[:2])
                   if isinstance(a, np.ndarray)
                   and a.dtype == np.float32 and not (
                       name in ("cross_entropy", "nll_loss") and i == 1
                       and "soft_label" not in kw))
    both(name, arrays, grad=floats, **kw)


@pytest.mark.parametrize("soft,axis,ret", [
    (False, -1, False), (False, -1, True), (True, -1, False),
    (False, 1, False), (True, 1, True)])
def test_softmax_with_cross_entropy_matches_jax(soft, axis, ret):
    x = X3
    if soft:
        lab = _soft(x.shape, axis)
    else:
        shape = list(x.shape)
        shape[axis] = 1
        lab = np.random.RandomState(9).randint(0, x.shape[axis], shape)
        lab.reshape(-1)[0] = -100
    both("softmax_with_cross_entropy", [x, lab], grad=(0,),
         soft_label=soft, axis=axis, return_softmax=ret)


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_cross_entropy_with_logits_matches_jax(normalize):
    lab = Y01.copy()
    lab[0, :3] = -100
    both("sigmoid_cross_entropy_with_logits", [A, lab], grad=(0,),
         ignore_index=-100, normalize=normalize)


def test_square_error_cost_and_log_loss_match_jax():
    both("square_error_cost", [A, B], grad=(0, 1))
    both("log_loss", [P01, Y01], grad=(0,), epsilon=1e-3)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_ctc_loss_matches_jax(reduction):
    """Log-space alpha recursion over [T 12, B 3, C 6] with labels of
    lengths 4, 2, 3 (a repeated label among them) and input lengths 12,
    9, 10."""
    rng = np.random.RandomState(10)
    lp = rng.randn(12, 3, 6).astype(np.float32)
    labels = np.array([[1, 2, 2, 5], [3, 4, 0, 0], [5, 1, 3, 0]], np.int64)
    both("ctc_loss", [lp, labels, np.array([12, 9, 10], np.int64),
                      np.array([4, 2, 3], np.int64)], grad=(0,),
         reduction=reduction)


def test_dice_and_npair_losses_match_jax():
    probs = _probs(_x(4, 3, 5), -1)
    lab = np.random.RandomState(11).randint(0, 5, (4, 3, 1))
    both("dice_loss", [probs, lab], grad=(0,))
    labels = np.array([0, 1, 0, 2], np.int64)
    both("npair_loss", [_x(4, 6, scale=0.5), _x(4, 6, scale=0.5, seed=1),
                        labels], grad=(0, 1), l2_reg=0.01)


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss_matches_jax(custom):
    rng = np.random.RandomState(12)
    x = rng.randn(5, 4).astype(np.float32)
    lab = rng.randint(0, 6, (5, 1)).astype(np.int64)
    rows = 6 if custom else 5
    w = rng.randn(rows, 4).astype(np.float32)
    b = rng.randn(rows).astype(np.float32)
    kw = {}
    if custom:
        kw = dict(path_table=rng.randint(-1, 6, (5, 3)).astype(np.int64),
                  path_code=(rng.rand(5, 3) > 0.5).astype(np.float32))
        jkw = {k: jp.to_tensor(v) for k, v in kw.items()}
        tkw = {k: tp.to_tensor(v) for k, v in kw.items()}
    args = [x, lab, 6, w, b]
    jo, jg = _run(jp, lambda *a: JF.hsigmoid_loss(*a, **(jkw if custom
                                                         else {})),
                  args, (0, 3), {})
    to, tg = _run(tp, lambda *a: TF.hsigmoid_loss(*a, **(tkw if custom
                                                         else {})),
                  args, (0, 3), {})
    for a, b_ in zip(to + tg, jo + jg):
        np.testing.assert_allclose(a, b_, rtol=RTOL, atol=ATOL)


LOSS_LAYERS = {
    "CrossEntropyLoss": ((W5, -100, "sum"), [X, LAB]),
    "MSELoss": (("sum",), [A, B]), "L1Loss": ((), [A, B]),
    "NLLLoss": ((None, -100, "none"), [np.log(_probs(X)), LAB]),
    "BCELoss": ((None, "sum"), [P01, Y01]),
    "BCEWithLogitsLoss": ((P01[0], "mean"), [A, Y01]),
    "KLDivLoss": (("batchmean",), [np.log(P01), P01[::-1].copy()]),
    "SmoothL1Loss": (("mean", 0.4), [A, B]),
    "MarginRankingLoss": ((0.2,), [A[:, 0], B[:, 0], SIGN]),
    "HingeEmbeddingLoss": ((0.7,), [np.abs(A), np.where(
        Y01 > 0, 1.0, -1.0).astype(np.float32)]),
    "CosineEmbeddingLoss": ((0.2, "sum"), [A, B, SIGN]),
    "TripletMarginLoss": ((0.5, 2.0, 1e-6, True), [A, B, _x(4, 7, seed=2)]),
    "CTCLoss": ((0, "sum"), [np.random.RandomState(10).randn(8, 2, 5)
                             .astype(np.float32),
                             np.array([[1, 2], [3, 3]], np.int64),
                             np.array([8, 7], np.int64),
                             np.array([2, 2], np.int64)]),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layer_matches_jax(name):
    args, arrays = LOSS_LAYERS[name]
    jargs = [jp.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [tp.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    jl, tl = getattr(jnn, name)(*jargs), getattr(tnn, name)(*targs)
    both("__call__", arrays, grad=(0,), module=(jl, tl))


def test_hsigmoid_loss_layer_matches_jax():
    jl, tl = jnn.HSigmoidLoss(4, 6), tnn.HSigmoidLoss(4, 6)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    assert [k for k, _ in tl.named_parameters()] == ["weight", "bias"]
    x = _x(5, 4)
    lab = np.random.RandomState(13).randint(0, 6, (5, 1)).astype(np.int64)
    both("__call__", [x, lab], grad=(0,), module=(jl, tl))
    with pytest.raises(ValueError):
        tnn.HSigmoidLoss(4, 6, is_custom=True)(tp.to_tensor(x),
                                               tp.to_tensor(lab))


# ------------------------------------------------------------ containers
def test_layer_dict_and_parameter_list_names_match_jax():
    def build(pkg):
        nn = pkg.nn

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.heads = nn.LayerDict({"a": nn.Linear(2, 3),
                                           "b": nn.Linear(3, 1)})
                self.extra = nn.ParameterList([self.create_parameter([2]),
                                               self.create_parameter([4])])
        return Net()
    jnet, tnet = build(jp), build(tp)
    names = list(tnet.state_dict())
    assert names == list(jnet.state_dict())
    assert names == ["heads.a.weight", "heads.a.bias", "heads.b.weight",
                     "heads.b.bias", "extra.0", "extra.1"]
    d = tnet.heads
    assert list(d.keys()) == ["a", "b"] and "a" in d and len(d) == 2
    d["c"] = tnn.Identity()
    assert isinstance(d.pop("a"), tnn.Linear) and list(d) == ["b", "c"]
    pl = tnet.extra
    pl.append(tnet.create_parameter([1]))
    assert len(pl) == 3 and tuple(pl[2].shape) == (1,)
    ll = tnn.LayerList([tnn.ReLU(), tnn.Tanh()])
    ll.insert(1, tnn.Sigmoid())
    ll.extend([tnn.GELU()])
    del ll[0]
    assert [type(m).__name__ for m in ll] == ["Sigmoid", "Tanh", "GELU"]
    assert list(ll._modules) == ["0", "1", "2"]

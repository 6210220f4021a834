"""The port's recurrent layers, seq2seq decoding and the ops decoding
reaches, against the JAX package's, on the CPU.

The port takes the JAX layers' weights by structured name and both get
the same seeded numpy inputs: outputs, final states, input gradients and
every parameter's gradient agree in float32 within RTOL / ATOL (the JAX
time loop is a scan, the port's a Python loop over the same step body).
BeamSearchDecoder and BasicDecoder (Training and GreedyEmbedding
helpers) give the same ids, parents and scores as the JAX decoders on
the same cell, embedding and output layer; SampleEmbeddingHelper draws
from another stream, so the port is compared with itself.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.ops import extra_ops as jextra
from paddle_tpu.ops import logic as jlogic
from paddle_tpu.ops import manipulation as jman
from paddle_tpu.ops import math as jmath
from paddle_tpu.ops import search as jsearch

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.ops import extra_ops as textra
from paddle_tpu_torch.ops import logic as tlogic
from paddle_tpu_torch.ops import manipulation as tman
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.ops import search as tsearch

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = _place._default
    tp.set_device("cpu")
    yield
    _place._default = prev


def _copy(jl, tl):
    tl.set_state_dict({k: np.array(v.numpy())
                       for k, v in jl.state_dict().items()})


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _pair(jl, tl, x, states=None):
    """Both layers on x (and initial states): outputs, final states,
    input and parameter gradients."""
    got = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        args = [xt]
        if states is not None:
            args.append(type(states)(pkg.to_tensor(s) for s in states)
                        if isinstance(states, tuple)
                        else pkg.to_tensor(states))
        y, final = layer(*args)
        leaves = [y] + _flat(final)
        w = np.random.RandomState(5)
        sum((t * pkg.to_tensor(w.rand(*t.shape).astype(np.float32))).sum()
            for t in leaves).backward()
        got.append(([t.numpy() for t in leaves], xt.grad.numpy(),
                    {k: p.grad.numpy() for k, p in layer.named_parameters()}))
    (jv, jg, jpg), (tv, tg, tpg) = got
    assert len(jv) == len(tv)
    for a, b in zip(tv + [tg], jv + [jg]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert set(tpg) == set(jpg)
    for k in jpg:
        np.testing.assert_allclose(tpg[k], jpg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ----------------------------------------------------------------- cells
@pytest.mark.parametrize("cell,kw", [
    ("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
    ("LSTMCell", {}), ("GRUCell", {})])
def test_cells_match_jax(cell, kw):
    """A step with given states and one from zeros; the weight shapes
    are [G H, I] with the reference's gate order."""
    jl, tl = getattr(jnn, cell)(5, 7, **kw), getattr(tnn, cell)(5, 7, **kw)
    gates = {"SimpleRNNCell": 1, "LSTMCell": 4, "GRUCell": 3}[cell]
    assert tuple(tl.weight_ih.shape) == (gates * 7, 5)
    assert tuple(tl.weight_hh.shape) == (gates * 7, 7)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _copy(jl, tl)
    x = _x(3, 5)
    states = (_x(3, 7, seed=1), _x(3, 7, seed=2)) if cell == "LSTMCell" \
        else _x(3, 7, seed=1)
    _pair(jl, tl, x, states)
    _pair(jl, tl, x)


def test_lstm_cell_uniform_init_bounds():
    tl = tnn.LSTMCell(4, 16)
    for p in tl.parameters():
        assert np.abs(p.numpy()).max() <= 0.25 + 1e-7


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("reverse,time_major", [(False, False),
                                                (True, False), (False, True)])
def test_rnn_matches_jax(cell, reverse, time_major):
    jl = jnn.RNN(getattr(jnn, cell)(4, 6), reverse, time_major)
    tl = tnn.RNN(getattr(tnn, cell)(4, 6), reverse, time_major)
    _copy(jl, tl)
    _pair(jl, tl, _x(5, 3, 4) if time_major else _x(3, 5, 4))


def test_birnn_matches_jax_with_initial_states():
    jl = jnn.BiRNN(jnn.GRUCell(4, 6), jnn.GRUCell(4, 6))
    tl = tnn.BiRNN(tnn.GRUCell(4, 6), tnn.GRUCell(4, 6))
    _copy(jl, tl)
    x, h0, h1 = _x(3, 5, 4), _x(3, 6, seed=1), _x(3, 6, seed=2)
    got = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        y, (f, b) = layer(pkg.to_tensor(x), (pkg.to_tensor(h0),
                                             pkg.to_tensor(h1)))
        got.append([y.numpy(), f.numpy(), b.numpy()])
    for a, b in zip(*got[::-1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    _pair(jl, tl, x)


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction,time_major", [
    ("forward", False), ("bidirect", False), ("bidirectional", True),
    ("backward", False)])
def test_multi_layer_rnns_match_jax(cls, direction, time_major):
    """2 layers: outputs, final states [num_layers * num_dir, B, H],
    input and parameter gradients, in eval mode (dropout 0.3 between
    layers off); parameter names as the JAX package's."""
    jl = getattr(jnn, cls)(4, 6, 2, direction, time_major, 0.3)
    tl = getattr(tnn, cls)(4, 6, 2, direction, time_major, 0.3)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _copy(jl, tl)
    jl.eval(), tl.eval()
    _pair(jl, tl, _x(5, 3, 4) if time_major else _x(3, 5, 4))


def test_multi_layer_initial_states_feed_each_layer():
    """initial_states [num_layers * num_dir, B, H] ((h, c) for LSTM): the
    same as running each layer's BiRNN with its slice (the JAX package
    starts every layer at zeros, which None gives)."""
    tl = tnn.LSTM(4, 6, 2, "bidirect")
    tl.eval()
    x = tp.to_tensor(_x(3, 5, 4))
    h0, c0 = tp.to_tensor(_x(4, 3, 6, seed=1)), tp.to_tensor(
        _x(4, 3, 6, seed=2))
    y, (h, c) = tl(x, (h0, c0))
    y1, s1 = tl._layers[0](x, ((h0[0], c0[0]), (h0[1], c0[1])))
    y2, s2 = tl._layers[1](y1, ((h0[2], c0[2]), (h0[3], c0[3])))
    np.testing.assert_allclose(y.numpy(), y2.numpy(), rtol=1e-6)
    np.testing.assert_allclose(h.numpy()[3], s2[1][0].numpy(), rtol=1e-6)
    zeros = tl(x)
    with_zero = tl(x, (h0 * 0, c0 * 0))
    np.testing.assert_allclose(zeros[0].numpy(), with_zero[0].numpy())


def test_rnn_drives_other_cells_as_simple_rnn_cells():
    """A cell that is neither LSTMCell nor GRUCell runs the SimpleRNN step
    over its weights (the JAX package's rule): its own forward is not
    called."""
    class Odd(tnn.SimpleRNNCell):
        def forward(self, inputs, states=None):
            raise AssertionError("RNN must not call the cell")
    cell = Odd(4, 6)
    ref = tnn.SimpleRNNCell(4, 6)
    ref.set_state_dict(cell.state_dict())
    x = tp.to_tensor(_x(2, 3, 4))
    np.testing.assert_allclose(tnn.RNN(cell)(x)[0].numpy(),
                               tnn.RNN(ref)(x)[0].numpy())


# ------------------------------------------------------------------ ops
def test_decode_ops_match_jax():
    x = _x(3, 7)
    cases = [
        (jsearch.topk, tsearch.topk, [x, 3], {}),
        (jsearch.topk, tsearch.topk, [x, 2], {"axis": 0}),
        (jsearch.topk, tsearch.topk, [x, 2], {"largest": False}),
        (jsearch.argmax, tsearch.argmax, [x], {"axis": 1}),
        (jsearch.argmax, tsearch.argmax, [x], {}),
        (jsearch.argmax, tsearch.argmax, [x], {"axis": 0, "keepdim": True}),
        (jlogic.logical_or, tlogic.logical_or, [x > 0, x < -1], {}),
        (jlogic.logical_not, tlogic.logical_not, [x > 0], {}),
        (jman.expand, tman.expand, [x[:1], [4, 3, 7]], {}),
        (jman.expand, tman.expand, [x[:, :1], [-1, 5]], {}),
        (jman.index_select, tman.index_select,
         [x, np.array([2, 0, 2], np.int64)], {"axis": 0}),
        (jman.take_along_axis, tman.take_along_axis,
         [x, np.array([[1, 0], [6, 6], [3, 2]], np.int64), 1], {}),
        (jman.where, tman.where, [x > 0, x, -x], {}),
        (jmath.all, tmath.all, [x > -5], {}),
        (jmath.all, tmath.all, [x > 0], {"axis": 1}),
    ]
    for jf, tf, args, kw in cases:
        ja = [jp.to_tensor(a) if isinstance(a, np.ndarray) else a
              for a in args]
        ta = [tp.to_tensor(a) if isinstance(a, np.ndarray) else a
              for a in args]
        jo, to = jf(*ja, **kw), tf(*ta, **kw)
        jo = jo if isinstance(jo, tuple) else (jo,)
        to = to if isinstance(to, tuple) else (to,)
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=jf.__name__)
            assert a.numpy().dtype == b.numpy().dtype, jf.__name__
    nz = tman.where(tp.to_tensor(x > 0))
    jnz = jman.where(jp.to_tensor(x > 0))
    for a, b in zip(nz, jnz):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 9, (6, 2, 4)).astype(np.int64)
    parents = rng.randint(0, 4, (6, 2, 4)).astype(np.int64)
    np.testing.assert_array_equal(
        textra.gather_tree(tp.to_tensor(ids), tp.to_tensor(parents)).numpy(),
        jextra.gather_tree(jp.to_tensor(ids), jp.to_tensor(parents)).numpy())
    np.testing.assert_array_equal(
        tp.nn.functional.gather_tree(tp.to_tensor(ids),
                                     tp.to_tensor(parents)).numpy(),
        jp.nn.functional.gather_tree(jp.to_tensor(ids),
                                     jp.to_tensor(parents)).numpy())


# --------------------------------------------------------------- decoding
def _seq2seq(pkg, vocab=11, hidden=8):
    nn = pkg.nn
    return (nn.Embedding(vocab, hidden), nn.LSTMCell(hidden, hidden),
            nn.Linear(hidden, vocab))


def _aligned_decoders(vocab=11, hidden=8):
    jparts, tparts = _seq2seq(jp, vocab, hidden), _seq2seq(tp, vocab, hidden)
    for j, t in zip(jparts, tparts):
        _copy(j, t)
    return jparts, tparts


@pytest.mark.parametrize("impute", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_decoder_matches_jax(impute, time_major):
    """BeamSearchDecoder (beam 3, end token 2) under dynamic_decode (8
    steps) from 2 rows of random states: predicted ids (back-tracked by
    gather_tree), parent ids and scores equal the JAX decoder's, and so
    do the final lengths."""
    (jemb, jcell, jout), (temb, tcell, tout) = _aligned_decoders()
    h0, c0 = _x(2, 8, seed=4), _x(2, 8, seed=5)
    res = []
    for pkg, emb, cell, out in ((jp, jemb, jcell, jout),
                                (tp, temb, tcell, tout)):
        dec = pkg.nn.BeamSearchDecoder(cell, 1, 2, 3, embedding_fn=emb,
                                       output_fn=out)
        outs, states, lengths = pkg.nn.dynamic_decode(
            dec, (pkg.to_tensor(h0), pkg.to_tensor(c0)), max_step_num=8,
            output_time_major=time_major, impute_finished=impute,
            return_length=True)
        res.append(({k: v.numpy() for k, v in outs.items()},
                    lengths.numpy()))
    (jo, jlen), (to, tlen) = res
    assert set(to) == {"scores", "predicted_ids", "parent_ids"}
    for k in ("predicted_ids", "parent_ids"):
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    np.testing.assert_allclose(to["scores"], jo["scores"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tlen, jlen)


def test_tile_beam_merge_with_batch_matches_jax():
    x = _x(2, 3)
    np.testing.assert_array_equal(
        tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            tp.to_tensor(x), 3).numpy(),
        jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            jp.to_tensor(x), 3).numpy())


@pytest.mark.parametrize("helper", ["training", "greedy"])
def test_basic_decoder_matches_jax(helper):
    """BasicDecoder with TrainingHelper (teacher forcing over given
    inputs, one row cut short by sequence_length) or
    GreedyEmbeddingHelper (argmax fed back through the embedding, end
    token 3): cell outputs and sample ids equal the JAX decoder's."""
    (jemb, jcell, jout), (temb, tcell, tout) = _aligned_decoders()
    inputs = _x(2, 5, 8, seed=6)
    res = []
    for pkg, emb, cell, out in ((jp, jemb, jcell, jout),
                                (tp, temb, tcell, tout)):
        nn = pkg.nn
        if helper == "training":
            h = nn.TrainingHelper(pkg.to_tensor(inputs),
                                  sequence_length=np.array([5, 3]))
        else:
            h = nn.GreedyEmbeddingHelper(emb, [1, 4], 3)
        dec = nn.BasicDecoder(cell, h, output_fn=out)
        init = cell.get_initial_states(pkg.to_tensor(inputs[:, 0]),
                                       cell.state_shape)
        outs, _ = nn.dynamic_decode(dec, init, max_step_num=7)
        res.append({k: v.numpy() for k, v in outs.items()})
    jo, to = res
    np.testing.assert_array_equal(to["sample_ids"], jo["sample_ids"])
    np.testing.assert_allclose(to["cell_outputs"], jo["cell_outputs"],
                               rtol=RTOL, atol=ATOL)


def test_sample_embedding_helper_repeats_with_a_seed():
    """A seeded SampleEmbeddingHelper repeats its draws; the draws follow
    softmax(logits / temperature) (a 1000-row decode's first step)."""
    emb, cell, out = _seq2seq(tp)
    rows = 1000

    def run(seed, temperature=None):
        h = tnn.SampleEmbeddingHelper(emb, [1] * rows, 99,
                                      softmax_temperature=temperature,
                                      seed=seed)
        dec = tnn.BasicDecoder(cell, h, output_fn=out)
        init = cell.get_initial_states(tp.to_tensor(np.zeros((rows, 8),
                                                             np.float32)),
                                       cell.state_shape)
        outs, _ = tnn.dynamic_decode(dec, init, max_step_num=3)
        return outs
    a, b = run(7), run(7)
    np.testing.assert_array_equal(a["sample_ids"].numpy(),
                                  b["sample_ids"].numpy())
    assert not np.array_equal(run(8)["sample_ids"].numpy(),
                              a["sample_ids"].numpy())
    logits = a["cell_outputs"].numpy()[0, 0]
    p = np.exp(logits - logits.max())
    p /= p.sum()
    freq = np.bincount(a["sample_ids"].numpy()[:, 0], minlength=11) / rows
    np.testing.assert_allclose(freq, p, atol=0.06)
    hot = run(None, temperature=1e-3)["sample_ids"].numpy()[:, 0]
    assert (hot == logits.argmax()).mean() > 0.9

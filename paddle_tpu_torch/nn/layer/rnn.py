"""Recurrent layers (port of paddle_tpu/nn/layer/rnn.py): RNNCellBase,
SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN and the multi-layer
SimpleRNN, LSTM and GRU.

Gate order and weight shapes are the reference's (rnn.py:41-56):
weight_ih [G H, I] and weight_hh [G H, H] with G = 4 gates i, f, g, o
for LSTM, 3 gates r, z, n for GRU, 1 for SimpleRNN; each step is
z = x W_ih^T + h W_hh^T (+ b_ih + b_hh). Every weight and bias starts
at U(-1/sqrt(H), 1/sqrt(H)) unless its ParamAttr says otherwise.

The time loop is a plain torch loop over the JAX scan's step body (one
step per time index, reversed for the backward direction), so autograd
records each step; it does not route to cuDNN's fused RNNs. The loops
register under the JAX package's op types ("rnn_scan_lstm", ...), and
the initial states are promoted to the step's result dtype, as the
JAX scan's carry is.

`RNN` drives an LSTMCell or a GRUCell with their own step, and treats
every other cell as a SimpleRNNCell (its weight_ih, weight_hh, biases
and activation), as the JAX package does (rnn.py:267-272): a custom
cell's own forward is not called by RNN. `sequence_length` is accepted
and ignored, as in the JAX package (every sequence runs its full
length). The multi-layer layers take initial_states [num_layers *
num_directions, B, H] ((h, c) for LSTM) and feed each layer and
direction its slice; the JAX package's multi-layer forward ignores
them and starts every layer at zeros, which is what they give when
initial_states is None.
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import op
from .. import functional as F
from .. import initializer as I
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


def _affine(x, h, wi, wh, bi, bh):
    z = x @ wi.t() + h @ wh.t()
    if bi is not None:
        z = z + bi + bh
    return z


def _cell_step_simple(x_t, h, wi, wh, bi, bh, activation):
    z = _affine(x_t, h, wi, wh, bi, bh)
    return torch.tanh(z) if activation == "tanh" else torch.clamp(z, min=0)


def _cell_step_lstm(x_t, h, c, wi, wh, bi, bh):
    i, f, g, o = torch.chunk(_affine(x_t, h, wi, wh, bi, bh), 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    return o * torch.tanh(c2), c2


def _cell_step_gru(x_t, h, wi, wh, bi, bh):
    zi = x_t @ wi.t()
    zh = h @ wh.t()
    if bi is not None:
        zi = zi + bi
        zh = zh + bh
    ri, zi_, ni = torch.chunk(zi, 3, dim=-1)
    rh, zh_, nh = torch.chunk(zh, 3, dim=-1)
    r = torch.sigmoid(ri + rh)
    z = torch.sigmoid(zi_ + zh_)
    n = torch.tanh(ni + r * nh)
    return (1 - z) * n + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States filled with init_value, [batch] + shape each (a tuple of
        them when shape is a tuple of shapes); float32 unless dtype."""
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dt = dtype or torch.float32

        def full(s):
            return torch.full((batch,) + tuple(s), init_value, dtype=dt,
                              device=batch_ref.device)
        if isinstance(shape, (list, tuple)) and isinstance(
                shape[0], (list, tuple)):
            return tuple(full(s) for s in shape)
        return full(shape)

    def _gate_params(self, gates, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr):
        init = I.Uniform(-1.0 / math.sqrt(hidden_size),
                         1.0 / math.sqrt(hidden_size))
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=init)
        self.bias_ih = None if bias_ih_attr is False else \
            self.create_parameter([gates * hidden_size], bias_ih_attr,
                                  is_bias=True, default_initializer=init)
        self.bias_hh = None if bias_hh_attr is False else \
            self.create_parameter([gates * hidden_size], bias_hh_attr,
                                  is_bias=True, default_initializer=init)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._gate_params(1, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _simple_cell_op(inputs, states, self.weight_ih, self.weight_hh,
                            self.bias_ih, self.bias_hh, self.activation)
        return h, h


@op("simple_rnn_cell")
def _simple_cell_op(x, h, wi, wh, bi, bh, activation):
    return _cell_step_simple(x, h, wi, wh, bi, bh, activation)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._gate_params(4, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        h, c = states
        h2, c2 = _lstm_cell_op(inputs, h, c, self.weight_ih, self.weight_hh,
                               self.bias_ih, self.bias_hh)
        return h2, (h2, c2)


@op("lstm_cell")
def _lstm_cell_op(x, h, c, wi, wh, bi, bh):
    return _cell_step_lstm(x, h, c, wi, wh, bi, bh)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._gate_params(3, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _gru_cell_op(inputs, states, self.weight_ih, self.weight_hh,
                         self.bias_ih, self.bias_hh)
        return h, h


@op("gru_cell")
def _gru_cell_op(x, h, wi, wh, bi, bh):
    return _cell_step_gru(x, h, wi, wh, bi, bh)


# -------------------------------------------------------------- time loops
def _promote_carry(x, wi, *states):
    """The inputs and states in the step's result dtype (the JAX scan's
    carry must keep one dtype)."""
    dt = x.dtype
    for t in (wi, *states):
        dt = torch.promote_types(dt, t.dtype)
    return (x.to(dt),) + tuple(s.to(dt) for s in states)


def _loop(step, x, carry, reverse):
    """Run step(carry, x_t) -> (carry, y_t) over x [B, T, ...]; returns
    (ys [B, T, ...] in time order, last carry)."""
    T = x.shape[1]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry, ys[t] = step(carry, x[:, t])
    return torch.stack(ys, dim=1), carry


@op("rnn_scan_simple")
def _scan_simple(x, h0, wi, wh, bi, bh, activation, reverse):
    x, h0 = _promote_carry(x, wi, h0)

    def step(h, x_t):
        h2 = _cell_step_simple(x_t, h, wi, wh, bi, bh, activation)
        return h2, h2
    return _loop(step, x, h0, reverse)


@op("rnn_scan_lstm")
def _scan_lstm(x, h0, c0, wi, wh, bi, bh, reverse):
    x, h0, c0 = _promote_carry(x, wi, h0, c0)

    def step(carry, x_t):
        h2, c2 = _cell_step_lstm(x_t, *carry, wi, wh, bi, bh)
        return (h2, c2), h2
    ys, (hT, cT) = _loop(step, x, (h0, c0), reverse)
    return ys, hT, cT


@op("rnn_scan_gru")
def _scan_gru(x, h0, wi, wh, bi, bh, reverse):
    x, h0 = _promote_carry(x, wi, h0)

    def step(h, x_t):
        h2 = _cell_step_gru(x_t, h, wi, wh, bi, bh)
        return h2, h2
    return _loop(step, x, h0, reverse)


class RNN(Layer):
    """Runs `cell` over the time axis (see the module docstring for
    which step a cell gets). Returns (outputs [B, T, H], final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        c = self.cell
        if initial_states is None:
            initial_states = c.get_initial_states(
                x, getattr(c, "state_shape", (c.hidden_size,)))
        if isinstance(c, LSTMCell):
            h0, c0 = initial_states
            ys, hT, cT = _scan_lstm(x, h0, c0, c.weight_ih, c.weight_hh,
                                    c.bias_ih, c.bias_hh, self.is_reverse)
            final = (hT, cT)
        elif isinstance(c, GRUCell):
            ys, final = _scan_gru(x, initial_states, c.weight_ih,
                                  c.weight_hh, c.bias_ih, c.bias_hh,
                                  self.is_reverse)
        else:
            ys, final = _scan_simple(x, initial_states, c.weight_ih,
                                     c.weight_hh, c.bias_ih, c.bias_hh,
                                     c.activation, self.is_reverse)
        if self.time_major:
            ys = ys.transpose(0, 1)
        return ys, final


class BiRNN(Layer):
    """A forward and a backward RNN over the same inputs, outputs
    concatenated on the last axis; final states (forward, backward)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw = s_bw = None
        if initial_states is not None:
            s_fw, s_bw = initial_states
        y_fw, f_fw = self.rnn_fw(inputs, s_fw)
        y_bw, f_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([y_fw, y_bw], dim=-1), (f_fw, f_bw)


class _MultiLayerRNN(Layer):
    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 **cell_kwargs):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirectional else 1
        attrs = dict(weight_ih_attr=weight_ih_attr,
                     weight_hh_attr=weight_hh_attr,
                     bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr,
                     **cell_kwargs)
        self._layers = LayerList()
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * num_dir
            if self.bidirectional:
                self._layers.append(BiRNN(
                    self.CELL(in_sz, hidden_size, **attrs),
                    self.CELL(in_sz, hidden_size, **attrs), time_major))
            else:
                self._layers.append(RNN(
                    self.CELL(in_sz, hidden_size, **attrs),
                    direction == "backward", time_major))

    def _initial(self, initial_states, i):
        """Layer i's slice of [num_layers * num_dir, B, H] states."""
        if initial_states is None:
            return None
        lstm = isinstance(self, LSTM)
        if self.bidirectional:
            pick = [(initial_states[0][2 * i + d], initial_states[1][2 * i + d])
                    if lstm else initial_states[2 * i + d] for d in (0, 1)]
            return tuple(pick)
        if lstm:
            return (initial_states[0][i], initial_states[1][i])
        return initial_states[i]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        finals = []
        for i, rnn in enumerate(self._layers):
            x, final = rnn(x, self._initial(initial_states, i))
            finals.append(final)
            if self.dropout > 0 and i < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        # finals stacked [num_layers * num_dir, B, H]
        dirs = (0, 1) if self.bidirectional else (None,)

        def pick(f, d):
            return f if d is None else f[d]
        if isinstance(self, LSTM):
            hs = [pick(f, d)[0] for f in finals for d in dirs]
            cs = [pick(f, d)[1] for f in finals for d in dirs]
            return x, (torch.stack(hs, 0), torch.stack(cs, 0))
        return x, torch.stack([pick(f, d) for f in finals for d in dirs], 0)


class SimpleRNN(_MultiLayerRNN):
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kwargs)


class LSTM(_MultiLayerRNN):
    CELL = LSTMCell


class GRU(_MultiLayerRNN):
    CELL = GRUCell

"""Seq2seq decoding (port of paddle_tpu/nn/decode.py): Decoder,
BeamSearchDecoder, dynamic_decode, BasicDecoder and the helpers
DecodeHelper, TrainingHelper, GreedyEmbeddingHelper and
SampleEmbeddingHelper.

The decode loop is a Python loop over steps (the reference's dygraph
branch) that reads one flag from the device a step (whether every
sequence has finished). BeamSearchDecoder is length-unnormalised beam
search over an RNN cell: at each step the beam x vocabulary totals go
through topk (ops/search.py), parents index the cell states, and
finalize back-tracks the parents with gather_tree (ops/extra_ops.py).
Beams that finished extend only with end_token at log-probability 0.
The first step starts beam 0 at 0 and the others at -1e9, so it picks
beam 0's tokens. Tensors are made on the device of the states (or of
the start tokens) they go with.

SampleEmbeddingHelper samples by the Gumbel-max rule (argmax of the
logits plus Gumbel noise) from the port's generator of the logits'
device, or, given a seed, from a generator seeded by (seed, step), so a
seeded decode repeats itself; its draws differ from the JAX package's
(tests compare the port with itself).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import place as _place
from ..core import random as _random
from ..core.tensor import box, plain
from ..ops.extra_ops import gather_tree
from ..ops.search import argmax, topk
from .functional import log_softmax

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode",
           "BasicDecoder", "DecodeHelper", "TrainingHelper",
           "GreedyEmbeddingHelper", "SampleEmbeddingHelper"]


class Decoder:
    """The decode protocol: initialize(inits) -> (initial_inputs,
    initial_states, initial_finished); step(time, inputs, states,
    **kwargs) -> (outputs, next_states, next_inputs, finished); optional
    finalize(outputs, final_states, sequence_lengths)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


def _map_state(tree, fn):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_state(t, fn) for t in tree)
    return fn(tree)


def _map_state2(a, b, fn):
    if isinstance(a, (list, tuple)):
        return type(a)(_map_state2(x, y, fn) for x, y in zip(a, b))
    return fn(a, b)


def _as_tensor(x, dtype=None):
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=_place.resolve_device(None))


class BeamSearchDecoder(Decoder):
    """Beam search over `cell` (cell(inputs, states) -> (cell_out,
    next_states)); output_fn maps cell_out to vocabulary logits,
    embedding_fn maps token ids to the next step's inputs."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self._impute_finished = False
        self._end_only = None

    @property
    def tracks_own_finished(self):
        """Beams are reordered every step, so slot j's finished flag
        belongs to another hypothesis each step: dynamic_decode takes the
        decoder's flags instead of accumulating them by slot."""
        return True

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam_size, ...], each row repeated beam_size
        times."""
        x = _as_tensor(x)
        tiled = x.unsqueeze(1).expand(x.shape[0], beam_size, *x.shape[1:])
        return tiled.reshape(x.shape[0] * beam_size, *x.shape[1:])

    def _merge(self, x):
        return x.reshape(-1, *x.shape[2:])

    def _split(self, x):
        return x.reshape(-1, self.beam_size, *x.shape[1:])

    def initialize(self, initial_cell_states):
        leaf = initial_cell_states
        while isinstance(leaf, (list, tuple)):
            leaf = leaf[0]
        batch, dev = leaf.shape[0], leaf.device
        self._batch = batch
        cell_states = _map_state(
            initial_cell_states,
            lambda s: self.tile_beam_merge_with_batch(s, self.beam_size))
        start = box(torch.full((batch, self.beam_size), self.start_token,
                               dtype=torch.int64, device=dev))
        lp = torch.full((batch, self.beam_size), -1e9, dtype=torch.float32,
                        device=dev)
        lp[:, 0] = 0.0
        finished = torch.zeros(batch, self.beam_size, dtype=torch.bool,
                               device=dev)
        init = {"cell_states": cell_states, "log_probs": box(lp),
                "finished": box(finished),
                "lengths": box(torch.zeros(batch, self.beam_size,
                                           dtype=torch.int64, device=dev))}
        inputs = self.embedding_fn(start) if self.embedding_fn else start
        return inputs, init, init["finished"]

    def _end_only_row(self, V, like):
        """[1, 1, V]: 0 at end_token, -1e9 elsewhere (a finished beam's
        step log-probabilities)."""
        e = self._end_only
        if e is None or e.shape[-1] != V or e.device != like.device:
            e = torch.full((1, 1, V), -1e9, dtype=torch.float32,
                           device=like.device)
            e[0, 0, self.end_token] = 0.0
            self._end_only = e
        return e

    def step(self, time, inputs, states, **kwargs):
        cell_states = states["cell_states"]
        flat_in = self._merge(inputs) if inputs.ndim > 2 else \
            inputs.reshape(self._batch * self.beam_size, -1)
        cell_out, next_cell_states = self.cell(flat_in, cell_states,
                                               **kwargs)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        V = logits.shape[-1]
        step_lp = self._split(log_softmax(logits, axis=-1))   # [B, bm, V]
        fin = states["finished"]
        step_lp = torch.where(fin.unsqueeze(-1),
                              self._end_only_row(V, step_lp), step_lp)
        total = states["log_probs"].unsqueeze(-1) + step_lp
        top_lp, top_idx = topk(total.reshape(self._batch,
                                             self.beam_size * V),
                               self.beam_size, axis=-1)
        parent = top_idx // V                                 # [B, beam]
        token = top_idx % V
        offs = torch.arange(self._batch, device=parent.device) \
            * self.beam_size
        flat_parent = (parent + offs.unsqueeze(-1)).reshape(-1)
        next_cell_states = _map_state(
            next_cell_states,
            lambda s: torch.index_select(s, 0, plain(flat_parent)))
        prev_fin = torch.gather(fin, 1, parent)
        now_fin = prev_fin | (token == self.end_token)
        if self._impute_finished:
            # the states of beams that had finished pass through unchanged
            old = _map_state(cell_states,
                             lambda s: torch.index_select(
                                 s, 0, plain(flat_parent)))
            flat_fin = prev_fin.reshape(-1)

            def impute(new_s, old_s):
                m = flat_fin.reshape(-1, *([1] * (new_s.ndim - 1)))
                return torch.where(m, old_s, new_s)
            next_cell_states = _map_state2(next_cell_states, old, impute)
        lengths = torch.gather(states["lengths"], 1, parent) \
            + (~prev_fin).to(torch.int64)
        next_states = {"cell_states": next_cell_states, "log_probs": top_lp,
                       "finished": now_fin, "lengths": lengths}
        outputs = {"scores": top_lp, "predicted_ids": token,
                   "parent_ids": parent}
        next_inputs = self.embedding_fn(token) if self.embedding_fn \
            else token
        return outputs, next_states, next_inputs, now_fin

    def finalize(self, outputs, final_states, sequence_lengths):
        """predicted_ids [T, B, beam] back-tracked into whole
        sequences."""
        out = dict(outputs)
        out["predicted_ids"] = gather_tree(outputs["predicted_ids"],
                                           outputs["parent_ids"])
        return out, final_states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step `decoder` until every sequence has finished or max_step_num
    steps; outputs stacked over time (batch-major unless
    output_time_major), then finalize. Returns (outputs, final states)
    and, with return_length, the lengths. is_test is accepted and
    ignored, as in the JAX package."""
    decoder._impute_finished = bool(impute_finished)
    inputs, states, finished = decoder.initialize(inits)
    step_outputs = []
    time = 0
    while True:
        outputs, states, inputs, step_finished = decoder.step(
            time, inputs, states, **kwargs)
        # a sequence never un-finishes, unless the decoder keeps its own
        # flags
        if getattr(decoder, "tracks_own_finished", False):
            finished = step_finished
        else:
            finished = finished | step_finished
        step_outputs.append(outputs)
        time += 1
        if bool(finished.all()) or (max_step_num is not None
                                    and time >= max_step_num):
            break
    stacked = {k: torch.stack([o[k] for o in step_outputs], dim=0)
               for k in step_outputs[0]}
    lengths = states.get("lengths") if isinstance(states, dict) else None
    try:
        stacked, states = decoder.finalize(stacked, states, lengths)
    except NotImplementedError:
        pass
    if not output_time_major:
        stacked = {k: v.transpose(0, 1) for k, v in stacked.items()}
    stacked = {k: box(v) for k, v in stacked.items()}
    if return_length:
        return stacked, states, lengths
    return stacked, states


class DecodeHelper:
    """BasicDecoder's sampling strategy: initialize() -> (inputs,
    finished); sample(time, outputs, states) -> sample_ids;
    next_inputs(time, outputs, states, sample_ids) -> (finished,
    next_inputs, next_states)."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: the next step's inputs are the given sequence's
    (batch-major unless time_major); a row finishes past its
    sequence_length or at the sequence's end."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        self.inputs = _as_tensor(inputs)
        if not time_major:
            self.inputs = self.inputs.transpose(0, 1)
        self.sequence_length = None if sequence_length is None \
            else _as_tensor(sequence_length).to(self.inputs.device)
        self._T = self.inputs.shape[0]
        self._B = self.inputs.shape[1]

    def _full(self, value):
        return torch.full((self._B,), value, dtype=torch.bool,
                          device=self.inputs.device)

    def initialize(self):
        return self.inputs[0], self._full(False)

    def sample(self, time, outputs, states):
        return argmax(outputs, axis=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        next_time = time + 1
        finished = self._full(next_time >= self._T)
        if self.sequence_length is not None:
            finished = finished | (next_time >= self.sequence_length)
        return finished, self.inputs[min(next_time, self._T - 1)], states


class GreedyEmbeddingHelper(DecodeHelper):
    """The previous step's argmax, embedded, is the next input; a row
    finishes when it emits end_token."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = _as_tensor(start_tokens, torch.int64)
        self.end_token = int(end_token)

    def initialize(self):
        finished = torch.zeros(self.start_tokens.shape[0], dtype=torch.bool,
                               device=self.start_tokens.device)
        return self.embedding_fn(self.start_tokens), finished

    def sample(self, time, outputs, states):
        return argmax(outputs, axis=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        finished = sample_ids == self.end_token
        return finished, self.embedding_fn(sample_ids), states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """A draw from softmax(logits / softmax_temperature) instead of the
    argmax (see the module docstring for the generator)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature
        self.seed = seed

    def sample(self, time, outputs, states):
        logits = outputs if self.temperature is None \
            else outputs / self.temperature
        logits = plain(logits).float()
        if self.seed is not None:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(int(self.seed) * 1000003 + int(time))
        else:
            gen = _random.generator(logits.device)
        e = torch.empty_like(logits).exponential_(generator=gen)
        return box((logits - e.log()).argmax(dim=-1))


class BasicDecoder(Decoder):
    """One hypothesis a row: the cell's step, output_fn, then the
    helper's sample and next inputs."""

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        inputs, finished = self.helper.initialize()
        return inputs, initial_cell_states, finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        sample_ids = self.helper.sample(time, cell_out, next_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, cell_out, next_states, sample_ids)
        outputs = {"cell_outputs": cell_out, "sample_ids": sample_ids}
        return outputs, next_states, next_inputs, finished

"""Serving traffic, driven through the port's engine.

- `bench_traffic`: the serving bench's requests (bench.py:569-573):
  n_req greedy requests with prompts of p_lo..p_hi tokens and outputs of
  t_lo..t_hi tokens, drawn from a seed; `drive_engine` sends a full
  batch first and one more request every other engine step.
- `prefix_traffic` and `tiered_traffic`: templated arrivals shaped like
  tools/load_suite.py's `prefix_heavy` and `tiered_prefix` scenarios
  (one system prompt or few-shot template, many short user turns),
  scaled to the full-width serving model; `drive_arrivals` submits each
  request at its arrival step.

chip_smoke.py and profile_serving.py drive the engine with these.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..inference.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["bench_traffic", "drive_engine", "prefix_traffic",
           "tiered_traffic", "drive_arrivals"]

Arrival = Tuple[int, np.ndarray, int]        # (step, prompt, max_tokens)


def bench_traffic(vocab: int, seed: int, n_req: int = 16, p_lo: int = 64,
                  p_hi: int = 256, t_lo: int = 64, t_hi: int = 256
                  ) -> List[Tuple[np.ndarray, int]]:
    """[(prompt int32 [T], max_tokens)] for n_req requests."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (int(rng.randint(p_lo, p_hi)),),
                         dtype=np.int32), int(rng.randint(t_lo, t_hi)))
            for _ in range(n_req)]


def drive_engine(model, ecfg: EngineConfig, specs, device,
                 before_step: Optional[Callable[[int], None]] = None):
    """LLMEngine.from_model -> add_request -> step until drained, with
    staggered arrivals. before_step(i), when given, runs before step i
    (a profiler window hooks in here). Returns (engine, request ids in
    the order of specs)."""
    eng = LLMEngine.from_model(model, ecfg, device=device)
    pending = list(specs)
    rids = []
    for _ in range(min(ecfg.max_num_seqs, len(pending))):
        p, mt = pending.pop(0)
        rids.append(eng.add_request(p, SamplingParams(max_tokens=mt)))
    steps = 0
    while eng.has_unfinished() or pending:
        if before_step is not None:
            before_step(steps)
        eng.step()
        steps += 1
        if steps % 2 == 0 and pending:
            p, mt = pending.pop(0)
            rids.append(eng.add_request(p, SamplingParams(max_tokens=mt)))
        if steps >= 20000:
            raise RuntimeError("engine did not drain within 20000 steps")
    return eng, rids


def _templated(rng, vocab: int, template: np.ndarray, s_lo: int,
               s_hi: int) -> np.ndarray:
    suffix = rng.randint(1, vocab, (int(rng.randint(s_lo, s_hi + 1)),),
                         dtype=np.int32)
    return np.concatenate([template, suffix])


def prefix_traffic(vocab: int, seed: int, n_templates: int = 4,
                   template_len: int = 512, n_followers: int = 28,
                   burst: int = 7, s_lo: int = 16, s_hi: int = 64,
                   t_lo: int = 64, t_hi: int = 128) -> List[Arrival]:
    """Shared-prefix traffic (load_suite's prefix_heavy at full width):
    n_templates templates of template_len tokens; one leader per
    template at step 0, then n_followers followers in bursts of `burst`,
    one burst every other step from step 2, cycling over the templates.
    Each request is its template plus a unique suffix of s_lo..s_hi
    tokens and asks for t_lo..t_hi new tokens."""
    rng = np.random.RandomState(seed)
    templates = [rng.randint(1, vocab, (template_len,), dtype=np.int32)
                 for _ in range(n_templates)]
    arr = [(0, _templated(rng, vocab, templates[t], s_lo, s_hi),
            int(rng.randint(t_lo, t_hi + 1))) for t in range(n_templates)]
    for i in range(n_followers):
        arr.append((2 * (1 + i // burst),
                    _templated(rng, vocab, templates[i % n_templates],
                               s_lo, s_hi),
                    int(rng.randint(t_lo, t_hi + 1))))
    return arr


def tiered_traffic(vocab: int, seed: int, n_templates: int = 8,
                   template_len: int = 512, visits: int = 3,
                   s_lo: int = 16, s_hi: int = 64, t_lo: int = 16,
                   t_hi: int = 32, r_lo: int = 8, r_hi: int = 16
                   ) -> List[Arrival]:
    """Working set larger than the device pool (load_suite's
    tiered_prefix at full width): phase 1 visits the templates in order,
    `visits` requests each (template t's at steps 2i for i in
    [visits*t, visits*(t+1))), asking t_lo..t_hi new tokens; phase 2
    revisits every template in one burst, landing 4 steps before phase
    1's last arrival, asking r_lo..r_hi. Suffixes are s_lo..s_hi
    tokens."""
    rng = np.random.RandomState(seed)
    templates = [rng.randint(1, vocab, (template_len,), dtype=np.int32)
                 for _ in range(n_templates)]
    n1 = n_templates * visits
    arr = [(2 * i, _templated(rng, vocab, templates[i // visits], s_lo,
                              s_hi), int(rng.randint(t_lo, t_hi + 1)))
           for i in range(n1)]
    base = 2 * n1 - 4
    for t in range(n_templates):
        arr.append((base, _templated(rng, vocab, templates[t], s_lo, s_hi),
                    int(rng.randint(r_lo, r_hi + 1))))
    return arr


def drive_arrivals(model, ecfg: EngineConfig, arrivals: List[Arrival],
                   device, max_steps: int = 20000,
                   after_step: Optional[Callable] = None):
    """LLMEngine.from_model -> add_request at each arrival's step ->
    step until drained (arrivals due at or before a step are submitted
    before it); after_step(engine), when given, runs after each step.
    Returns (engine, request ids in the order of arrivals)."""
    eng = LLMEngine.from_model(model, ecfg, device=device)
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    rids: List[Optional[str]] = [None] * len(arrivals)
    nxt = step = 0
    while nxt < len(order) or eng.has_unfinished():
        while nxt < len(order) and arrivals[order[nxt]][0] <= step:
            _, p, mt = arrivals[order[nxt]]
            rids[order[nxt]] = eng.add_request(
                p, SamplingParams(max_tokens=mt))
            nxt += 1
        if eng.has_unfinished():
            eng.step()
            if after_step is not None:
                after_step(eng)
        step += 1
        if step > max_steps:
            raise RuntimeError(
                f"engine did not drain within {max_steps} steps")
    return eng, rids

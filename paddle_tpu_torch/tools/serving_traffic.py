"""The serving bench's request traffic, driven through the port's engine.

The traffic is the one bench.py's serving workload sends
(bench.py:569-573): n_req greedy requests with prompts of p_lo..p_hi
tokens and outputs of t_lo..t_hi tokens, drawn from a seed; a full batch
arrives first and one more request every other engine step.
chip_smoke.py and profile_serving.py drive the engine with it.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..inference.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["bench_traffic", "drive_engine"]


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

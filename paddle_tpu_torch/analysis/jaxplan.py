"""The committed plan's admission pricing, read as data.

Port of the reader half of paddle_tpu/analysis/jaxplan.py:
`PrefillCostModel` (a copy of the reference's), `load_plan` (the plan
file at the repo root, `jaxplan.json`) and `default_admission_model`,
which `EngineConfig(prefill_cost_model="auto")` resolves through.

The committed cost model (base 6224, 57034 a token, 362 a token
squared) was fit by the reference's planner on its small registry GPT;
the port reads the same numbers at every width, as the reference does.
Left out: the planners themselves (remat, donation, the fit of the
admission quadratic); they trace JAX programs (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["DEFAULT_PLAN_PATH", "PrefillCostModel", "load_plan",
           "default_admission_model"]

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PLAN_PATH = os.path.join(_REPO, "jaxplan.json")


@functools.lru_cache(maxsize=16)
def _load_plan_cached(path: str, mtime_ns: int) -> Optional[dict]:
    with open(path) as f:
        return json.load(f)


def load_plan(path: str = DEFAULT_PLAN_PATH) -> Optional[dict]:
    """The committed plan payload, or None when no plan file exists
    (cached per path and mtime)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return _load_plan_cached(os.path.abspath(path), st.st_mtime_ns)


def default_admission_model(path: str = DEFAULT_PLAN_PATH
                            ) -> Optional["PrefillCostModel"]:
    """The committed prefill cost model, or None (flat token budget)."""
    plan = load_plan(path) or {}
    entry = plan.get("admission", {}).get("prefill_cost_model")
    return PrefillCostModel.from_dict(entry) if entry else None


@dataclass(frozen=True)
class PrefillCostModel:
    """Static price of one prefill as a function of prompt length:
    cost(n) = base + a*n + b*n^2 FLOPs (the matmuls are the linear term,
    causal attention the quadratic one). The scheduler charges
    `cost(len)` per admission against `budget(max_prefill_tokens) =
    cost(max_prefill_tokens)`, so one maximal prompt still fills a step
    while a long prompt pays super-linearly for its attention."""
    base_flops: float
    flops_per_token: float
    flops_per_token_sq: float

    def cost(self, num_tokens: int) -> float:
        n = float(num_tokens)
        return (self.base_flops + self.flops_per_token * n
                + self.flops_per_token_sq * n * n)

    def budget(self, max_prefill_tokens: int) -> float:
        return self.cost(max_prefill_tokens)

    def as_dict(self) -> dict:
        return {"base_flops": self.base_flops,
                "flops_per_token": self.flops_per_token,
                "flops_per_token_sq": self.flops_per_token_sq}

    @classmethod
    def from_dict(cls, d: dict) -> "PrefillCostModel":
        return cls(base_flops=float(d["base_flops"]),
                   flops_per_token=float(d["flops_per_token"]),
                   flops_per_token_sq=float(d["flops_per_token_sq"]))

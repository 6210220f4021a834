"""The committed plan's admission pricing and remat policy, read as
data.

Port of the reader half of paddle_tpu/analysis/jaxplan.py:
`PrefillCostModel` (a copy of the reference's), `load_plan` (the plan
file at the repo root, `jaxplan.json`), `default_admission_model`,
which `EngineConfig(prefill_cost_model="auto")` resolves through, and
`committed_remat_policy` / `remat_group_size`, which
`GPTConfig(use_recompute="auto")` resolves through (the committed
policy for the train step is "none": on the reference's registry GPT no
remat fits the envelope best).

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
           "default_admission_model", "remat_group_size",
           "committed_remat_policy"]

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


def remat_group_size(policy: str, num_layers: int) -> int:
    """Checkpoint group size for a policy string: 0 = no remat, 1 =
    per-block, k = contiguous k-block groups. Group sizes larger than
    the model clamp to one whole-model group (a plan computed on a
    deeper model stays applicable to a shallower one)."""
    if policy in ("none", ""):
        return 0
    if policy == "full":
        return 1
    if isinstance(policy, str) and policy.startswith("group:"):
        k = int(policy.split(":", 1)[1])
        if k < 1:
            raise ValueError(f"group size must be >= 1, got {policy!r}")
        return min(k, max(int(num_layers), 1))
    raise ValueError(
        f"unknown remat policy {policy!r}; expected 'none', 'full' or "
        f"'group:<k>'")


def committed_remat_policy(path: str = DEFAULT_PLAN_PATH,
                           program: str = "train_step") -> str:
    """The remat policy `use_recompute="auto"` resolves to. No plan file
    (or no entry) means no remat."""
    plan = load_plan(path) or {}
    entry = plan.get("remat", {}).get(program) or {}
    return str(entry.get("policy", "none"))


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

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
- `tenant_traffic`: three tenants against one WFQ engine, shaped like
  tools/load_suite.py's `multi_tenant` scenario; `drive_tenants` submits
  each tagged request at its step (request ids "req-<i>" in
  submission order) and counts the refusals, and
  `replay_admissions` runs the same traffic through a scheduler alone
  (no model) and returns the admission order the engine must take.

- the fleet's traffic (ReplicaSet, router.py), shaped like
  tools/load_suite.py's fleet scenarios at the serving bench's widths:
  `fleet_traffic` (replica_kill, and the rolling deploy's live
  traffic), `disagg_traffic` (disagg: a decode floor of mixed greedy
  and sampled requests plus long prompts) and `diurnal_traffic`
  (autoscale_diurnal: trickle, burst, trickle); `drive_fleet` submits
  each request at its router step, and `migration_ab` is the controlled
  A/B of a live drain: the same requests decoded in place and after
  `drain(index, recompute=False)` moved them to an empty replica.

chip_smoke.py and profile_serving.py drive the engine with these.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..inference.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["bench_traffic", "drive_engine", "prefix_traffic",
           "tiered_traffic", "drive_arrivals", "TENANTS", "TENANT_ENGINE",
           "tenant_traffic", "make_tenant_registry", "drive_tenants",
           "replay_admissions", "fleet_traffic", "disagg_traffic",
           "diurnal_traffic", "drive_fleet", "migration_ab"]

Arrival = Tuple[int, np.ndarray, int]        # (step, prompt, max_tokens)
# (step, prompt, max_tokens, tenant)
TenantArrival = Tuple[int, np.ndarray, int, str]
# (router step, prompt, SamplingParams keyword arguments)
FleetArrival = Tuple[int, np.ndarray, dict]


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


# the tenant pass's tenants (load_suite's multi_tenant): a latency-class
# tenant, a batch-class one, and a standard one whose token quota holds
# about two of its admissions (prompt + max_tokens each), so the tail of
# its burst is refused at the door
TENANTS = (dict(name="latency", priority="latency"),
           dict(name="bulk", priority="batch"),
           dict(name="burst", quota_tokens=600, quota_window_s=300.0))
# the tenant pass's changes to the serving bench's engine: a per-step
# prefill budget priced by the committed cost model, a bounded queue and
# its own obs label (the registry is added per pass)
TENANT_ENGINE = dict(max_prefill_tokens=512, max_waiting=32,
                     prefill_cost_model="auto",
                     obs_label="chip-multi-tenant")


def make_tenant_registry(serving, tenants=None):
    """A fresh TenantRegistry of `serving` (a serving package: this
    port's, or any with the same TenantRegistry/TenantConfig) holding
    `tenants` (default: TENANTS)."""
    return serving.TenantRegistry(
        [serving.TenantConfig(**t) for t in (tenants or TENANTS)])


def tenant_traffic(vocab: int, seed: int, n: int = 32, b_lo: int = 320,
                   b_hi: int = 448, l_lo: int = 32, l_hi: int = 72,
                   template_len: int = 192, s_lo: int = 16,
                   s_hi: int = 40, t_lo: int = 32, t_hi: int = 64
                   ) -> List[TenantArrival]:
    """Multi-tenant traffic (load_suite's multi_tenant grown from block 4
    to block 32): n // 2 `bulk` requests with prompts of b_lo..b_hi
    tokens, all at step 0; n // 3 `latency` requests of l_lo..l_hi
    tokens at steps 1, 3, 5, ...; the rest `burst`: a template of
    template_len tokens plus a suffix of s_lo..s_hi, all at step 2.
    Every request asks for t_lo..t_hi new tokens (bounds inclusive)."""
    rng = np.random.RandomState(seed)
    nb, nl = n // 2, n // 3
    nq = n - nb - nl

    def prompt(lo, hi):
        return rng.randint(1, vocab, (int(rng.randint(lo, hi + 1)),),
                           dtype=np.int32)

    def new_tokens():
        return int(rng.randint(t_lo, t_hi + 1))

    arr: List[TenantArrival] = []
    for _ in range(nb):
        arr.append((0, prompt(b_lo, b_hi), new_tokens(), "bulk"))
    for i in range(nl):
        arr.append((1 + 2 * i, prompt(l_lo, l_hi), new_tokens(),
                    "latency"))
    template = rng.randint(1, vocab, (template_len,), dtype=np.int32)
    for _ in range(nq):
        arr.append((2, np.concatenate([template, prompt(s_lo, s_hi)]),
                    new_tokens(), "burst"))
    return arr


def drive_tenants(model, ecfg: EngineConfig,
                  arrivals: List[TenantArrival], device,
                  max_steps: int = 20000):
    """LLMEngine.from_model -> add_request (tenant-tagged) at each
    arrival's step -> step until drained. Returns (engine, {tenant:
    admitted request ids}, quota-refused request ids, other refused
    request ids)."""
    from ..inference.serving import EngineOverloaded, TenantQuotaExceeded
    eng = LLMEngine.from_model(model, ecfg, device=device)
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    by_tenant: dict = {}
    quota, rejected = [], []
    nxt = step = 0
    while nxt < len(order) or eng.has_unfinished():
        while nxt < len(order) and arrivals[order[nxt]][0] <= step:
            _, p, mt, tenant = arrivals[order[nxt]]
            rid = f"req-{nxt}"
            nxt += 1
            try:
                eng.add_request(p, SamplingParams(max_tokens=mt,
                                                  tenant=tenant),
                                request_id=rid)
            except TenantQuotaExceeded:
                quota.append(rid)
            except EngineOverloaded:
                rejected.append(rid)
            else:
                by_tenant.setdefault(tenant, []).append(rid)
        if eng.has_unfinished():
            eng.step()
        step += 1
        if step > max_steps:
            raise RuntimeError(
                f"engine did not drain within {max_steps} steps")
    return eng, by_tenant, quota, rejected


def replay_admissions(arrivals: List[TenantArrival], ecfg: EngineConfig,
                      serving, reqtrace, cache, registry,
                      cost_model=None, max_steps: int = 20000) -> dict:
    """The admission order an engine takes on tenant traffic, from a
    scheduler alone. `serving` is a serving package (this port's, or one
    with the same classes and engine accounting), `reqtrace` its request
    trace module, `cache` a PagedKVCache of it with the engine's block
    geometry (no model runs, so one layer of small heads will do),
    `registry` a fresh TenantRegistry (None: no tenants, FCFS) and
    `cost_model` the resolved prefill cost model. The engine's
    accounting is replayed: each arrival is charged to its tenant's
    quota (refunded if the scheduler refuses it), a dense prefill emits
    one token, and a decode chunk emits, per row, one token per trip
    after the row's last prompt token (that trip's included), up to
    max_tokens. No EOS: every request runs to max_tokens. Returns {"scheduled": request ids in admission order,
    "quota": quota-refused ids, "rejected": other refused ids,
    "preemptions": n, "chunks": decode chunks, "steps": steps}."""
    sch = serving.Scheduler(serving.SchedulerConfig(
        max_num_seqs=ecfg.max_num_seqs,
        max_prefill_tokens=ecfg.max_prefill_tokens,
        decode_chunk_size=ecfg.decode_chunk_size,
        max_waiting=ecfg.max_waiting,
        admission_policy=ecfg.admission_policy,
        cache_high_watermark=ecfg.cache_high_watermark,
        prefill_cost_model=cost_model,
        prefill_chunk_threshold=ecfg.prefill_chunk_threshold,
        tenants=registry), cache)
    k = ecfg.decode_chunk_size
    prefix = f"replay-{id(sch)}-"
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    out = {"scheduled": [], "quota": [], "rejected": [], "preemptions": 0,
           "chunks": 0, "steps": 0}

    def emit(req, n):
        for _ in range(n):
            req.output_ids.append(1)
        if len(req.output_ids) >= req.params.max_tokens:
            sch.finish(req, serving.RequestState.FINISHED_LENGTH)

    nxt = step = 0
    while nxt < len(order) or sch.has_unfinished():
        while nxt < len(order) and arrivals[order[nxt]][0] <= step:
            _, p, mt, tenant = arrivals[order[nxt]]
            rid = f"req-{nxt}"
            nxt += 1
            req = serving.Request(
                request_id=rid, prompt_ids=np.asarray(p, np.int32),
                params=serving.SamplingParams(max_tokens=mt,
                                              tenant=tenant))
            req.trace_id = prefix + rid
            if registry is not None:
                registry.resolve(tenant)
                try:
                    registry.charge(tenant, len(p) + mt, model="default")
                except serving.TenantQuotaExceeded:
                    out["quota"].append(rid)
                    continue
            try:
                sch.add(req)
            except serving.EngineOverloaded:
                if registry is not None:
                    registry.refund(tenant, len(p) + mt, model="default")
                out["rejected"].append(rid)
        if sch.has_unfinished():
            batch = sch.schedule()
            out["preemptions"] += len(batch.preempted)
            for req in batch.prefill:
                emit(req, 1)
            decode = [r for r in batch.decode if not r.finished]
            if decode:
                out["chunks"] += 1
            for req in decode:
                remaining = req.params.max_tokens - len(req.output_ids)
                if req.prefill_pos < req.pf_target:
                    pf_rem = req.pf_target - req.prefill_pos
                    req.prefill_pos += min(k, pf_rem)
                    n = k - pf_rem + 1 if pf_rem <= k else 0
                else:
                    n = k
                emit(req, min(n, remaining))
        step += 1
        if step > max_steps:
            raise RuntimeError(
                f"replay did not drain within {max_steps} steps")
    out["steps"] = step
    out["scheduled"] = [e.request_id for e in reqtrace.events(prefix=prefix)
                        if e.kind == "scheduled"]
    return out


# ------------------------------------------------------------------ fleet
def fleet_traffic(vocab: int, seed: int, n: int = 24, p_lo: int = 64,
                  p_hi: int = 256, t_lo: int = 32, t_hi: int = 64
                  ) -> List[FleetArrival]:
    """load_suite's replica_kill mix at the serving bench's prompt
    lengths: n greedy requests, prompts of p_lo..p_hi tokens, t_lo..t_hi
    new tokens (bounds inclusive), request i at router step 2 * i."""
    rng = np.random.RandomState(seed)
    return [(2 * i, rng.randint(1, vocab, (int(rng.randint(
        p_lo, p_hi + 1)),), dtype=np.int32),
        dict(max_tokens=int(rng.randint(t_lo, t_hi + 1))))
        for i in range(n)]


def disagg_traffic(vocab: int, seed: int, n_floor: int = 12,
                   floor_len: int = 64, f_lo: int = 128, f_hi: int = 192,
                   n_long: int = 6, l_lo: int = 512, l_hi: int = 768,
                   lt_lo: int = 16, lt_hi: int = 32) -> List[FleetArrival]:
    """load_suite's disagg (its mixed_prefill_decode layout) at the
    serving bench's widths: a decode floor of n_floor requests with
    fixed floor_len-token prompts and f_lo..f_hi new tokens at router
    steps 0, 2, 4, ..., every other one sampled (temperature 0.8, top_k
    50, its own seed) and the rest greedy; then n_long long prompts of
    l_lo..l_hi tokens asking lt_lo..lt_hi new tokens at steps 3, 5, ...
    (bounds inclusive)."""
    rng = np.random.RandomState(seed)
    arr: List[FleetArrival] = []
    for i in range(n_floor):
        kw = dict(max_tokens=int(rng.randint(f_lo, f_hi + 1)))
        if i % 2:
            kw.update(temperature=0.8, top_k=50,
                      seed=int(rng.randint(1, 2 ** 31 - 1)))
        arr.append((2 * i, rng.randint(1, vocab, (floor_len,),
                                       dtype=np.int32), kw))
    for j in range(n_long):
        arr.append((3 + 2 * j, rng.randint(1, vocab, (int(rng.randint(
            l_lo, l_hi + 1)),), dtype=np.int32),
            dict(max_tokens=int(rng.randint(lt_lo, lt_hi + 1)))))
    return arr


def diurnal_traffic(vocab: int, seed: int, trickle: int = 4,
                    burst: int = 24, p_lo: int = 64, p_hi: int = 256,
                    t_lo: int = 16, t_hi: int = 32) -> List[FleetArrival]:
    """load_suite's autoscale_diurnal shape: `trickle` requests one every
    6 router steps (night), then `burst` requests at one step (noon),
    then another trickle (evening). Greedy; prompts p_lo..p_hi,
    t_lo..t_hi new tokens (bounds inclusive)."""
    rng = np.random.RandomState(seed)

    def req(step):
        return (step, rng.randint(1, vocab, (int(rng.randint(
            p_lo, p_hi + 1)),), dtype=np.int32),
            dict(max_tokens=int(rng.randint(t_lo, t_hi + 1))))

    arr = [req(6 * i) for i in range(trickle)]
    arr += [req(6 * trickle) for _ in range(burst)]
    arr += [req(6 * (trickle + i + 2)) for i in range(trickle)]
    return arr


def drive_fleet(rs, arrivals: List[FleetArrival], max_steps: int = 20000,
                before_step: Optional[Callable[[int], None]] = None,
                after_step: Optional[Callable[[int], None]] = None,
                model: Optional[str] = None):
    """Submit each arrival to the ReplicaSet `rs` at its router step
    (arrivals due at or before a step are submitted before it) and step
    until every request is terminal. `before_step(i)` / `after_step(i)`
    run around router step
    i; `model` names the model pool of a registry-built fleet. Idles
    2 ms a step while the only pending work is a restart backoff.
    Returns the request ids in the order of `arrivals`."""
    import time
    from ..inference.serving import SamplingParams
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    rids: List[Optional[str]] = [None] * len(arrivals)
    extra = {} if model is None else {"model": model}
    nxt = step = 0
    while nxt < len(order) or rs.has_unfinished():
        while nxt < len(order) and arrivals[order[nxt]][0] <= step:
            _, p, kw = arrivals[order[nxt]]
            rids[order[nxt]] = rs.add_request(
                p, SamplingParams(**kw, **extra))
            nxt += 1
        if before_step is not None:
            before_step(step)
        rs.step()
        if after_step is not None:
            after_step(step)
        step += 1
        if step > max_steps:
            raise RuntimeError(
                f"fleet did not drain within {max_steps} router steps")
        if not any(r.has_unfinished() for r in rs.replicas) \
                and rs.has_unfinished():
            time.sleep(0.002)
    return rids


def migration_ab(model, ecfg: EngineConfig, specs, warm: int,
                 k: Optional[int] = None, action: str = "drain") -> dict:
    """The controlled A/B of a live migration. Two identical fleets of
    two replicas of `ecfg` on the model's device, roles ("mixed",
    "decode"), so every request is admitted on replica 0 and replica 1
    stays empty. Both take
    `specs` ([(prompt, SamplingParams keyword arguments)], at most
    max_num_seqs of them) and run `warm` router steps; then fleet B
    migrates (`action` "drain": drain(0, recompute=False) moves every
    live request to replica 1; "rebalance": rebalance() with the
    watermark at half of replica 0's measured block use moves its
    coldest requests) while fleet A leaves them in place, and both
    run k more router steps (None: until drained). Returns {"a": tokens
    per request, "b": tokens per request, "migrated": B's committed
    migrations, "bytes": their payload bytes, "live": requests
    unfinished at the migration, "homes": their replicas after it,
    "use": replica 0's block use then, "watermark", "failovers": the
    replica quarantines in both fleets, "aborted": B's aborted and
    rolled-back migrations}; a sound migration gives a == b, token for
    token, with no failover and no abort."""
    from ..inference.serving import ReplicaSet, RouterConfig, SamplingParams
    if action not in ("drain", "rebalance"):
        raise ValueError(f"action must be 'drain' or 'rebalance', got "
                         f"{action!r}")
    out = {}
    for arm in ("a", "b"):
        rs = ReplicaSet.from_model(
            model, RouterConfig(num_replicas=2, roles=("mixed", "decode"),
                                obs_label=f"migration-ab-{arm}"),
            engine_config=ecfg)
        rids = [rs.add_request(p, SamplingParams(**kw)) for p, kw in specs]
        for _ in range(warm):
            rs.step()
        if arm == "b":
            cache = rs.replicas[0].engine.cache
            use = (cache.num_blocks - cache.num_free()) / cache.num_blocks
            out.update(live=sum(1 for r in rids
                                if not rs.get_request(r).finished),
                       use=use, watermark=None)
            if action == "drain":
                rs.drain(0, recompute=False)
            else:
                out["watermark"] = use / 2
                rs.rebalance(watermark=out["watermark"])
            st = rs.migrator.stats()
            out.update(migrated=st["migrations"], bytes=st["bytes_moved"],
                       homes=[rs.get_request(r).replica for r in rids],
                       aborted=st["aborted"] + st["rolled_back"])
        steps = 0
        while (rs.has_unfinished() if k is None else steps < k):
            rs.step()
            steps += 1
        out[arm] = [list(rs.get_request(r).tokens) for r in rids]
        out["failovers"] = out.get("failovers", 0) + sum(
            len(r.history) for r in rs.replicas)
        for audit in rs.check_integrity().values():
            if audit is None:
                raise RuntimeError("a replica of the A/B lost its engine")
        del rs
    return out

"""Fleet chaos harnesses of the port: replica failover, kill mid-migration
and a killed rolling deploy, each audited against its unfaulted twin.

Counterparts of tools/chaos_serve.py's `run_chaos_replicas`,
`run_chaos_disagg` and `run_chaos_deploy`, driving this package's
ReplicaSet with the same seeded workloads, fault schedules and gates:

- `run_chaos_replicas`: a seeded workload through a ReplicaSet while
  kill_replica / wedge_replica crash or wedge whole engines and
  engine-level faults (nan_logits, stall) land mid-traffic. Gates: every
  request terminal, every live pool audits clean, requests on untouched
  replicas equal the unfaulted run token for token, and every faulted
  replica rejoins after its warmup probe and serves a canary.
- `run_chaos_disagg`: replica 0 is a prefill tier handing every
  prefill-complete request to decode replicas by live KV-block
  migration while kill_migration kills the source inside the commit
  window. Gates: every request completes, both ends of every migration
  audit clean, every completed request equals the unfaulted
  disaggregated run, handoffs committed and the kill rolled one back.
- `run_chaos_deploy`: a 3-replica fleet over a ModelRegistry runs two
  rollouts of a different revision under traffic; kill_deploy kills a
  replica between its swap and its canary after another slot already
  rejoined, so the rollback must unwind a live slot. Gates: the first
  deploy rolls back, the second commits, nothing is lost, the pools
  audit clean, rollout drains moved live KV, and the causality checker
  (revision pinning included) is clean.

Each returns its report dict and raises AssertionError on a failed gate.
The lock-order witness of the JAX harnesses is not ported (the port has
no lock witness yet). The model defaults to the serving tests' tiny GPT
with random weights from `seed`; pass `model` (and `models` for the
deploy harness) to drive given weights; the engines run on the model's
device (the default model is built on CUDA; `--device cpu` builds it on
the CPU).

    python -m paddle_tpu_torch.tools.chaos_serve [replicas|disagg|deploy] \
        [--seed N] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

__all__ = ["DEFAULT_REPLICA_FAULTS", "DEFAULT_DISAGG_FAULTS",
           "DEFAULT_DEPLOY_FAULTS", "build_model", "run_chaos_replicas",
           "run_chaos_disagg", "run_chaos_deploy"]

DEFAULT_REPLICA_FAULTS = "kill_replica@6:1,nan_logits@10,stall@12:0.05"
DEFAULT_DISAGG_FAULTS = "kill_migration@3:0,kill_migration@7:0"
DEFAULT_DEPLOY_FAULTS = "kill_deploy@1:1"


def build_model(seed: int = 0, device=None, vocab=97, hidden=32, layers=2,
                heads=4, seq=48):
    """The harnesses' tiny GPT, in eval mode, random weights from seed."""
    from ..models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                    num_heads=heads, max_seq_len=seq)
    m = GPT(cfg, device=device, seed=seed)
    m.eval()
    return m


def _drain(rs, max_steps: int, what: str) -> None:
    steps = 0
    while rs.has_unfinished():
        rs.step()
        steps += 1
        assert steps <= max_steps, what
        if not any(r.has_unfinished() for r in rs.replicas) \
                and rs.has_unfinished():
            time.sleep(0.002)               # restart backoff pending


def _slo(rs, st, n: int) -> dict:
    p99 = rs.ttft_quantile(0.99)
    unserved = sum(v for k, v in st["finish_reasons"].items()
                   if k not in ("stop", "length"))
    return {"ttft_p99_s": None if math.isnan(p99) else round(p99, 4),
            "reject_rate": round(unserved / max(n, 1), 4)}


def run_chaos_replicas(seed: int = 0, n_requests: int = 24,
                       replicas: int = 3,
                       faults: str = DEFAULT_REPLICA_FAULTS,
                       max_steps: int = 4000, model=None) -> dict:
    """One seeded multi-replica chaos run (module docstring). Raises
    AssertionError on a lost request, a leaked block on any live
    replica, an untouched-replica token divergence, or a faulted replica
    that fails to rejoin and serve again."""
    from ..inference.serving import (EngineConfig, ReplicaSet,
                                      RouterConfig, SamplingParams)
    from ..testing.faults import ServingFaultInjector

    model = build_model(0) if model is None else model
    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(seed)
    specs = [(rng.randint(0, vocab, (int(rng.randint(3, 9)),),
                          dtype=np.int32),
              int(rng.randint(6, 12))) for _ in range(n_requests)]
    # decode_chunk_size=2 keeps requests in flight across many router
    # steps, so mid-traffic faults land on live work
    ecfg = EngineConfig(block_size=4, num_blocks=32, max_num_seqs=4,
                        decode_chunk_size=2)

    def drive(injector):
        rs = ReplicaSet.from_model(
            model, RouterConfig(
                num_replicas=replicas, heartbeat_timeout_s=0.02,
                backoff_base=0.01, backoff_max=0.05, backoff_jitter=0.0),
            engine_config=ecfg, faults=injector)
        pending = list(enumerate(specs))
        rids, homes = {}, {}
        for i, (p, mt) in pending[:2 * replicas]:
            rids[i] = rs.add_request(p, SamplingParams(max_tokens=mt))
            homes[i] = rs.get_request(rids[i]).replica
        pending = pending[2 * replicas:]
        steps = 0
        while rs.has_unfinished() or pending:
            rs.step()
            steps += 1
            assert steps <= max_steps, \
                f"router failed to drain within {max_steps} steps"
            if steps % 2 == 0 and pending:      # staggered arrivals
                i, (p, mt) = pending.pop(0)
                rids[i] = rs.add_request(p, SamplingParams(max_tokens=mt))
                homes[i] = rs.get_request(rids[i]).replica
            if not any(r.has_unfinished() for r in rs.replicas) \
                    and rs.has_unfinished():
                time.sleep(0.002)
        return rs, rids, homes

    # reference pass: greedy tokens depend only on the prompt, so the
    # comparison does not depend on routing
    ref_rs, ref_rids, _ = drive(ServingFaultInjector(""))
    for idx, audit in ref_rs.check_integrity().items():
        assert audit is not None, f"reference replica {idx} lost engine"
    ref_tokens = {i: list(ref_rs.get_request(r).tokens)
                  for i, r in ref_rids.items()}

    injector = ServingFaultInjector(faults)
    targeted = sorted({(0 if arg is None or arg != arg else int(arg))
                       for k, s, arg in injector.faults
                       if k in ("kill_replica", "wedge_replica")})
    rs, rids, homes = drive(injector)
    st = rs.router_stats()
    report = {
        "seed": seed, "requests": n_requests, "replicas": replicas,
        "faults": faults, "fired": list(injector.fired_log),
        "targeted_replicas": targeted, "requeues": st["requeues"],
        "finish_reasons": st["finish_reasons"],
        "replica_states": {k: str(v)
                           for k, v in st["replica_states"].items()},
        "recovery_times_s": st["recovery_times_s"],
        "slo": _slo(rs, st, n_requests),
    }
    # 1. no lost requests
    lost = [i for i, r in rids.items() if not rs.get_request(r).finished]
    assert not lost, f"non-terminal requests after drain: {lost}"
    # 2. zero leaked blocks on every live replica (a faulted replica must
    #    be live again by now, so None is a failure)
    report["integrity"] = rs.check_integrity()
    for idx, audit in report["integrity"].items():
        assert audit is not None, \
            f"replica {idx} ended the run without a live engine"
    # 3. untouched-replica requests equal the unfaulted run
    mismatched, untouched = [], 0
    for i, r in rids.items():
        rec = rs.get_request(r)
        if rec.requeues or homes[i] in targeted \
                or rec.finish_reason not in ("stop", "length"):
            continue
        untouched += 1
        if list(rec.tokens) != ref_tokens[i]:
            mismatched.append({"request": i, "trace_id": rec.trace_id})
    report["untouched_survivors"] = untouched
    assert not mismatched, \
        f"untouched-replica token divergence vs unfaulted run: {mismatched}"
    # 4. every faulted replica rejoined and serves a canary in this run
    for idx in targeted:
        assert str(rs.states()[idx]) == "up", \
            f"faulted replica {idx} did not rejoin (state " \
            f"{rs.states()[idx]})"
    for other in range(replicas):
        if other not in targeted:
            rs.drain(other)
    canaries = {}
    for idx in targeted:
        rid = rs.add_request(specs[0][0], SamplingParams(max_tokens=2))
        canaries[idx] = rid
        assert rs.get_request(rid).replica == idx, \
            f"canary for rejoined replica {idx} routed to " \
            f"{rs.get_request(rid).replica}"
    _drain(rs, max_steps, "canary requests failed to drain")
    for idx, rid in canaries.items():
        reason = rs.get_request(rid).finish_reason
        assert reason in ("stop", "length"), \
            f"rejoined replica {idx} canary ended {reason!r}"
    for other in range(replicas):
        if other not in targeted:
            rs.undrain(other)
    report["canaries_served"] = len(canaries)
    return report


def run_chaos_disagg(seed: int = 0, n_requests: int = 18,
                     replicas: int = 3,
                     faults: str = DEFAULT_DISAGG_FAULTS,
                     max_steps: int = 4000, model=None) -> dict:
    """One seeded disaggregated-serving chaos run (module docstring):
    replica 0 is the prefill tier, the others decode; kill_migration
    kills the source between destination admit and source release.
    Raises AssertionError unless every request completes, every pool
    audits clean, every completed request equals the unfaulted
    disaggregated run, handoffs committed and (when a kill_migration is
    scheduled) a migration rolled back."""
    from ..inference.serving import (EngineConfig, ReplicaSet,
                                      RouterConfig, SamplingParams)
    from ..testing.faults import ServingFaultInjector

    if replicas < 2:
        raise ValueError("disaggregated chaos needs >= 2 replicas "
                         "(one prefill, one+ decode)")
    model = build_model(0) if model is None else model
    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(seed)
    specs = [(rng.randint(0, vocab, (int(rng.randint(4, 12)),),
                          dtype=np.int32),
              int(rng.randint(8, 16))) for _ in range(n_requests)]
    ecfg = EngineConfig(block_size=4, num_blocks=48, max_num_seqs=4,
                        decode_chunk_size=2, enable_prefix_cache=True)
    roles = ("prefill",) + ("decode",) * (replicas - 1)

    def drive(injector):
        rs = ReplicaSet.from_model(
            model, RouterConfig(num_replicas=replicas, roles=roles,
                                heartbeat_timeout_s=0.02,
                                backoff_base=0.01, backoff_max=0.05,
                                backoff_jitter=0.0),
            engine_config=ecfg, faults=injector)
        pending = list(enumerate(specs))
        rids = {}
        for i, (p, mt) in pending[:2 * replicas]:
            rids[i] = rs.add_request(p, SamplingParams(max_tokens=mt))
        pending = pending[2 * replicas:]
        steps = 0
        while rs.has_unfinished() or pending:
            rs.step()
            steps += 1
            assert steps <= max_steps, \
                f"router failed to drain within {max_steps} steps"
            if steps % 2 == 0 and pending:
                i, (p, mt) = pending.pop(0)
                rids[i] = rs.add_request(p, SamplingParams(max_tokens=mt))
            if not any(r.has_unfinished() for r in rs.replicas) \
                    and rs.has_unfinished():
                time.sleep(0.002)
        return rs, rids

    # reference pass: same tiers, no faults (handoffs still happen, so
    # the comparison also holds migration invariance)
    ref_rs, ref_rids = drive(ServingFaultInjector(""))
    assert ref_rs.migrator.stats()["migrations"] > 0, \
        "disagg reference run committed no handoffs"
    ref_tokens = {i: list(ref_rs.get_request(r).tokens)
                  for i, r in ref_rids.items()}

    injector = ServingFaultInjector(faults)
    scheduled_kills = sum(1 for k, _s, _a in injector.faults
                          if k == "kill_migration")
    rs, rids = drive(injector)
    st = rs.router_stats()
    mig = rs.migrator.stats()
    report = {
        "seed": seed, "requests": n_requests, "replicas": replicas,
        "roles": list(roles), "faults": faults,
        "fired": list(injector.fired_log), "migrations": mig,
        "requeues": st["requeues"], "finish_reasons": st["finish_reasons"],
        "replica_states": {k: str(v)
                           for k, v in st["replica_states"].items()},
        "slo": _slo(rs, st, n_requests),
    }
    # 1. every request completes: the half-migrated victim re-prefills
    #    from the router's token log
    lost = [i for i, r in rids.items()
            if rs.get_request(r).finish_reason not in ("stop", "length")]
    assert not lost, f"requests lost or errored after drain: {lost}"
    # 2. zero leaked blocks on both ends
    report["integrity"] = rs.check_integrity()
    for idx, audit in report["integrity"].items():
        assert audit is not None, \
            f"replica {idx} ended the run without a live engine"
    # 3. every completed request equals the unfaulted disaggregated run
    mismatched, survivors = [], 0
    for i, r in rids.items():
        rec = rs.get_request(r)
        if rec.finish_reason not in ("stop", "length"):
            continue
        survivors += 1
        if list(rec.tokens) != ref_tokens[i]:
            mismatched.append({"request": i, "trace_id": rec.trace_id})
    report["survivors"] = survivors
    assert not mismatched, \
        f"survivor token divergence vs unfaulted run: {mismatched}"
    # 4. non-vacuous: handoffs committed, and a scheduled kill rolled a
    #    destination back
    assert mig["migrations"] > 0, "disagg chaos run committed no handoffs"
    if scheduled_kills:
        assert mig["rolled_back"] > 0, \
            "kill_migration was scheduled but no migration rolled back"
    return report


def run_chaos_deploy(seed: int = 0, n_requests: int = 24,
                     replicas: int = 3,
                     faults: str = DEFAULT_DEPLOY_FAULTS,
                     max_steps: int = 4000, models=None) -> dict:
    """One seeded rolling-deploy chaos run (module docstring): two
    rollouts of the same candidate under continuous traffic, the first
    killed in the swap->canary window after another slot rejoined (it
    must roll back), the second with the fault budget spent (it must
    commit). `models` is the (old, new) pair of GPTs (default: the tiny
    GPT with weights from seeds 0 and 1). Raises AssertionError on a
    failed gate."""
    from .. import obs
    from ..inference.serving import (DeployConfig, DeployController,
                                      EngineConfig, ModelRegistry,
                                      ReplicaSet, RouterConfig,
                                      SamplingParams)
    from ..testing.faults import ServingFaultInjector

    rng = np.random.RandomState(seed)
    obs.reqtrace.enable()
    old, new = models if models is not None \
        else (build_model(0), build_model(1))
    vocab = old.cfg.vocab_size
    ecfg = EngineConfig(block_size=4, num_blocks=48, max_num_seqs=4,
                        decode_chunk_size=2, max_waiting=64,
                        enable_prefix_cache=True)
    reg = ModelRegistry()
    rev_old = reg.publish("m", old, engine_config=ecfg)
    rev_new = reg.publish("m", new, engine_config=ecfg)
    assert rev_new != rev_old, "seeded revisions collided"

    injector = ServingFaultInjector(faults)
    rs = ReplicaSet.from_registry(
        reg, ("m",) * replicas,
        config=RouterConfig(num_replicas=replicas, heartbeat_timeout_s=0.02,
                            backoff_base=0.01, backoff_max=0.05,
                            backoff_jitter=0.0),
        faults=injector)
    # the candidate is meant to diverge: the tolerance covers the whole
    # canary set, and the parity gate's refusal is exercised elsewhere
    dcfg = DeployConfig(canary_tolerance=3)

    rids = []
    submitted = step = 0
    ctl = None
    done_deploys = []
    kill_obs = None
    next_deploy_at = 3                      # traffic in flight before it
    while (submitted < n_requests or rs.has_unfinished()
           or len(done_deploys) < 2):
        if submitted < n_requests and step % 2 == 0:
            plen = int(rng.randint(4, 10))
            p = rng.randint(0, vocab, (plen,), dtype=np.int32)
            rids.append(rs.add_request(
                p, SamplingParams(max_tokens=int(rng.randint(6, 11)),
                                  model="m")))
            submitted += 1
        rs.step()
        if ctl is not None:
            kills_before = sum(1 for k, _s in injector.fired_log
                               if k == "kill_deploy")
            ctl.tick()
            if sum(1 for k, _s in injector.fired_log
                   if k == "kill_deploy") > kills_before:
                kill_obs = {"step": step, "tick": ctl.status()["ticks"],
                            "swapped_before_kill":
                                len(ctl.status()["swapped"]) - 1}
            if ctl.done():
                done_deploys.append(ctl.status())
                next_deploy_at = step + 2
                ctl = None
        elif len(done_deploys) < 2 and step >= next_deploy_at:
            ctl = DeployController(rs, "m", rev_new, config=dcfg,
                                   faults=injector)
            ctl.start()
        step += 1
        assert step <= max_steps, \
            f"run incomplete after {max_steps} steps (deploys " \
            f"{len(done_deploys)}/2, unfinished {rs.has_unfinished()})"
        if not any(r.has_unfinished() for r in rs.replicas) \
                and rs.has_unfinished():
            time.sleep(0.002)

    st = rs.router_stats()
    report = {
        "seed": seed, "requests": submitted, "replicas": replicas,
        "faults": faults, "fired": list(injector.fired_log),
        "revisions": {"old": rev_old, "new": rev_new},
        "deploys": done_deploys, "kill": kill_obs,
        "requeues": st["requeues"], "migrations": st["migrations"],
        "finish_reasons": st["finish_reasons"], "pools": st["pools"],
        "replica_states": {k: str(v)
                           for k, v in st["replica_states"].items()},
        "slo": _slo(rs, st, submitted),
    }
    # 1. deploy 1 rolled back, deploy 2 committed
    assert len(done_deploys) == 2, f"deploys: {done_deploys}"
    assert done_deploys[0]["outcome"] == "rolled_back", \
        f"killed deploy did not roll back: {done_deploys[0]}"
    assert done_deploys[1]["outcome"] == "committed", \
        f"clean deploy did not commit: {done_deploys[1]}"
    assert reg.active("m") == rev_new, \
        "registry not on the new revision after the committed deploy"
    # 2. the kill landed after a real swap
    assert kill_obs is not None, "kill_deploy fault never fired"
    assert kill_obs["swapped_before_kill"] >= 1, \
        f"kill landed before any other slot swapped: {kill_obs}"
    # 3. zero lost
    lost = [r for r in rids
            if rs.get_request(r).finish_reason not in ("stop", "length")]
    assert not lost, f"requests not served: {lost}"
    # 4. the fleet converged and every pool audits clean
    for idx, state in rs.states().items():
        assert str(state) == "up", \
            f"replica {idx} did not converge (state {state})"
    report["integrity"] = rs.check_integrity()
    for idx, audit in report["integrity"].items():
        assert audit is not None, \
            f"replica {idx} ended the run without a live engine"
    # 5. the rollout drains moved live KV
    assert st["migrations"]["migrations"] > 0, \
        "no KV migrations during the rollout drains (vacuous run)"
    # 6. causality, revision pinning included, over the recorded traces
    evs = [e.as_dict() for e in obs.reqtrace.events(
        prefix=f"tr-{rs.label}-")]
    evs += [e.as_dict() for e in obs.reqtrace.events(prefix="deploy-")]
    evs.sort(key=lambda d: d["seq"])
    dump = {"reason": "deploy_chaos", "complete": True, "events": evs}
    assert dump["events"], "reqtrace recorded nothing for this router"
    violations = obs.reqtrace.check_causality(dump)
    assert not violations, \
        f"causality violations (incl. revision pinning): {violations}"
    report["causality_events"] = len(dump["events"])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("harness", nargs="?", default="replicas",
                    choices=("replicas", "disagg", "deploy"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the engines run (default: CUDA)")
    args = ap.parse_args(argv)
    if args.harness == "deploy":
        report = run_chaos_deploy(args.seed, models=(
            build_model(0, args.device), build_model(1, args.device)))
    elif args.harness == "disagg":
        report = run_chaos_disagg(args.seed,
                                  model=build_model(0, args.device))
    else:
        report = run_chaos_replicas(args.seed,
                                    model=build_model(0, args.device))
    print(json.dumps(report, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

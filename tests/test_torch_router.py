"""The port's ReplicaSet and EngineReplica against the JAX package's, on
the CPU: twins of tests/test_serving_router.py, plus the trace-continuity
case of tests/test_reqtrace.py.

Each case runs one scenario on both packages (the same tiny GPT, the
port's taking the JAX weights; the same engine and router configs, fault
specs, prompts and step sequence) and compares what both make
deterministic: tokens, finish reasons, homes, FCFS tickets, requeue and
failover counts, replica states and audits. The JAX test's own
invariants are then asserted on the port. Where a case depends on wall
time (deadlines, the heartbeat), only what the timing cannot move is
compared. Backoff and heartbeat values are the JAX tests' own, so no
case sleeps for long.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.serving as jserving
import paddle_tpu.models.generation as jgen
from paddle_tpu import obs as jobs
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch.inference.serving as serving
from paddle_tpu_torch import obs
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.testing import faults

VOCAB = 97
GEOM = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=24)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**GEOM), params, device="cpu")


class Pkg:
    """One package's serving surface over its model."""

    def __init__(self, port: bool, model):
        self.port = port
        self.model = model
        self.s = serving if port else jserving
        self.obs = obs if port else jobs
        self.Faults = faults.ServingFaultInjector if port \
            else jfaults.ServingFaultInjector

    def ecfg(self, **kw):
        kw.setdefault("block_size", 4)
        kw.setdefault("num_blocks", 16)
        kw.setdefault("max_num_seqs", 4)
        kw.setdefault("decode_chunk_size", 2)
        return self.s.EngineConfig(**kw)

    def from_model(self, rcfg, ecfg, faults=None):
        return self.s.ReplicaSet.from_model(
            self.model, rcfg, engine_config=ecfg, faults=faults)

    def router(self, n=2, spec="", ecfg=None, **rkw):
        rkw.setdefault("backoff_base", 0.01)
        rkw.setdefault("backoff_max", 0.05)
        rkw.setdefault("backoff_jitter", 0.0)
        return self.from_model(self.s.RouterConfig(num_replicas=n, **rkw),
                               ecfg or self.ecfg(), self.Faults(spec))

    def engine(self, ecfg):
        if self.port:
            return self.s.LLMEngine.from_model(self.model, ecfg,
                                               device="cpu")
        return self.s.LLMEngine.from_model(self.model, ecfg)

    def sp(self, **kw):
        return self.s.SamplingParams(**kw)


def _both(models):
    jm, tm = models
    return Pkg(True, tm), Pkg(False, jm)


def _twin(models, scenario):
    """scenario(pkg) -> (router, comparable result); the results of the
    two packages must be equal. Returns the port's router and result."""
    port, ref = _both(models)
    got_rs, got = scenario(port)
    _, want = scenario(ref)
    assert got == want
    return got_rs, got


def _prompts(n, seed=7, lo=3, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, int(rng.randint(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _assert_no_leaks(rs):
    for idx, audit in rs.check_integrity().items():
        assert audit is not None, f"replica {idx} has no live engine"
        assert audit["leaked"] == 0, (idx, audit)


def _records(rs, rids):
    """Per request: id, home, FCFS ticket (relative to the scenario's
    first: each package counts tickets process-wide), finish reason,
    requeues and tokens."""
    base = min(rs.get_request(r).arrival for r in rids)
    return [(r, rs.get_request(r).replica, rs.get_request(r).arrival - base,
             rs.get_request(r).finish_reason, rs.get_request(r).requeues,
             list(rs.get_request(r).tokens)) for r in rids]


def _reference(tm, prompt, max_new):
    import paddle_tpu_torch.models.generation as gen
    return [int(t) for t in gen.generate(tm, np.asarray(prompt)[None],
                                         max_new)[0, len(prompt):]]


# ---------------------------------------------------------- balancing
def test_free_block_balancing_beats_round_robin(models):
    long_p = np.arange(1, 15, dtype=np.int32)
    short_p = np.arange(1, 4, dtype=np.int32)
    order = [long_p, short_p, long_p, short_p]

    def scenario(pkg):
        out = {}
        for balance in ("free_blocks", "round_robin"):
            rs = pkg.from_model(
                pkg.s.RouterConfig(num_replicas=2, balance=balance),
                pkg.ecfg(num_blocks=32))
            rids = [rs.add_request(p, pkg.sp(max_tokens=4)) for p in order]
            d = [r.load_info()["block_demand"] for r in rs.replicas]
            rs.run(max_steps=500)
            _assert_no_leaks(rs)
            out[balance] = (abs(d[0] - d[1]), _records(rs, rids))
        return rs, out

    _, got = _twin(models, scenario)
    assert got["free_blocks"][0] < got["round_robin"][0]


def test_round_robin_rotates(models):
    def scenario(pkg):
        rs = pkg.from_model(
            pkg.s.RouterConfig(num_replicas=3, balance="round_robin"),
            pkg.ecfg())
        homes = []
        for p in _prompts(6):
            rid = rs.add_request(p, pkg.sp(max_tokens=2))
            homes.append(rs.get_request(rid).replica)
        rs.run(max_steps=500)
        _assert_no_leaks(rs)
        return rs, homes

    _, homes = _twin(models, scenario)
    assert homes == [0, 1, 2, 0, 1, 2]


# ----------------------------------------------------------- failover
def test_failover_zero_lost_and_bitwise_untouched(models):
    prompts = _prompts(6)

    def scenario(pkg):
        f = pkg.Faults("kill_replica@3:1")
        rs = pkg.from_model(pkg.s.RouterConfig(
            num_replicas=3, backoff_base=0.01, backoff_max=0.05,
            backoff_jitter=0.0), pkg.ecfg(), f)
        rids = [rs.add_request(p, pkg.sp(max_tokens=8)) for p in prompts]
        homes = [rs.get_request(r).replica for r in rids]
        rs.run(max_steps=3000)
        assert f.fired_log, "kill fault never fired"
        st = rs.router_stats()
        _assert_no_leaks(rs)
        return rs, (homes, _records(rs, rids), st["unfinished"],
                    st["requeues"], st["finish_reasons"],
                    list(f.fired_log))

    rs, (homes, recs, unfinished, requeues, reasons, _) = \
        _twin(models, scenario)
    assert unfinished == 0 and requeues >= 1
    assert all(r[3] == "length" for r in recs)
    # every request's greedy tokens equal dense generate(), failed over
    # or not; untouched requests exist
    assert any(r[4] == 0 and h != 1 for r, h in zip(recs, homes))
    for (rid, *_rest, toks), p in zip(recs, prompts):
        assert toks == _reference(models[1], p, 8), rid


def test_fcfs_arrival_order_preserved_across_requeue(models):
    def scenario(pkg):
        rs = pkg.router(n=2, spec="kill_replica@1:1")
        rids = [rs.add_request(p, pkg.sp(max_tokens=6))
                for p in _prompts(6)]
        tickets = {r: rs.get_request(r).arrival for r in rids}
        rs.step()                                    # fires the kill
        state1 = str(rs.states()[1])
        live = [(r, rs.get_request(r).replica,
                 rs.get_request(r).arrival == tickets[r])
                for r in rids if not rs.get_request(r).finished]
        waiting = [q.arrival - min(tickets.values())
                   for q in rs.replicas[0].engine.scheduler.waiting]
        rs.run(max_steps=3000)
        _assert_no_leaks(rs)
        return rs, (state1, live, waiting, rs.router_stats()["unfinished"],
                    _records(rs, rids)[-1][3:])

    _, (state1, live, waiting, unfinished, _) = _twin(models, scenario)
    assert state1 in ("down", "failed")
    assert all(home == 0 and same for _, home, same in live)
    assert waiting == sorted(waiting)
    assert unfinished == 0


def test_deadline_counts_from_original_arrival_across_failover(models):
    def scenario(pkg):
        rs = pkg.router(n=2, spec="kill_replica@1:1")
        keep = rs.add_request(_prompts(1)[0], pkg.sp(max_tokens=4))
        doomed = rs.add_request(_prompts(2)[1],
                                pkg.sp(max_tokens=16, deadline_s=0.05))
        home = rs.get_request(doomed).replica
        t_orig = rs.get_request(doomed).arrival_time
        rs.step()                                    # kill + readmit
        rec = rs.get_request(doomed)
        eng_req = rs.replicas[0].engine.get_request(doomed)
        moved = (rec.requeues, rec.replica, eng_req.arrival_time == t_orig)
        time.sleep(0.06)                             # blow the budget
        rs.run(max_steps=3000)
        _assert_no_leaks(rs)
        return rs, (home, moved, rs.get_request(doomed).finish_reason,
                    rs.get_request(keep).finish_reason)

    _, (home, moved, doomed, keep) = _twin(models, scenario)
    assert home == 1 and moved == (1, 0, True)
    assert doomed == "timeout" and keep == "length"


def test_wedge_failover_via_heartbeat(models):
    def scenario(pkg):
        rs = pkg.router(n=2, spec="wedge_replica@2:0",
                        heartbeat_timeout_s=0.01)
        rids = [rs.add_request(p, pkg.sp(max_tokens=6))
                for p in _prompts(6)]
        steps = 0
        while rs.has_unfinished():
            rs.step()
            steps += 1
            assert steps < 3000
            time.sleep(0.002)
        st = rs.router_stats()
        wedged = any("wedge" in reason
                     for r in rs.replicas for _, reason in r.history)
        # when the wedge is caught depends on wall time: compare what
        # it cannot move (greedy tokens, terminal reasons)
        return rs, (st["unfinished"], st["requeues"] >= 1, wedged,
                    [(rec[3], rec[5]) for rec in _records(rs, rids)])

    _, (unfinished, requeued, wedged, recs) = _twin(models, scenario)
    assert unfinished == 0 and requeued and wedged
    assert all(reason == "length" for reason, _ in recs)


# ----------------------------------------------------- restart/rejoin
def test_killed_replica_rejoins_after_warmup_probe(models):
    def scenario(pkg):
        rs = pkg.router(n=2, spec="kill_replica@2:1")
        rids = [rs.add_request(p, pkg.sp(max_tokens=8))
                for p in _prompts(6)]
        rs.run(max_steps=3000)
        rep = rs.replicas[1]
        out = [str(rep.state), rep.restarts, rep.probe_tokens,
               len(rs.recovery_times), rs.router_stats()["unfinished"]]
        rs.drain(0)
        canary = rs.add_request(_prompts(1)[0], pkg.sp(max_tokens=2))
        out.append(rs.get_request(canary).replica)
        rs.run(max_steps=1000)
        out.append(rs.get_request(canary).finish_reason)
        rs.undrain(0)
        _assert_no_leaks(rs)
        out.append(all(rs.get_request(r).finished for r in rids))
        return rs, out

    _, out = _twin(models, scenario)
    assert out[:2] == ["up", 1] and out[2] >= 1
    assert out[3:] == [1, 0, 1, "length", True]


def test_dropped_fleet_frees_every_pool_without_a_collection(models):
    """The port's own check of what a restart must not leak on the card:
    the killed incarnation's pool is gone once the replica is back up,
    and dropping the fleet frees every live pool by reference counting
    alone (no cycle holds an engine, so nothing waits for the garbage
    collector)."""
    import gc
    import weakref
    pkg = Pkg(True, models[1])
    rs = pkg.router(n=2, spec="kill_replica@2:1")
    made = [weakref.ref(rep.engine.cache) for rep in rs.replicas]
    first = made[1]
    gc.disable()
    try:
        rids = [rs.add_request(p, pkg.sp(max_tokens=8))
                for p in _prompts(6)]
        while str(rs.states()[1]) == "up":
            rs.step()
        while str(rs.states()[1]) != "up":
            rs.step()
        assert first() is None
        made.append(weakref.ref(rs.replicas[1].engine.cache))
        rs.run(max_steps=3000)
        assert all(rs.get_request(r).finished for r in rids)
        _assert_no_leaks(rs)
        del rs
        assert [ref() for ref in made] == [None] * len(made)
    finally:
        gc.enable()


def test_probe_failure_counts_against_restart_budget(models):
    def scenario(pkg):
        calls = []

        def factory(index, incarnation):
            calls.append(incarnation)
            if incarnation > 0:
                raise RuntimeError("fresh engine refuses to boot")
            return pkg.engine(pkg.ecfg())

        rs = pkg.s.ReplicaSet(
            factory, pkg.s.RouterConfig(num_replicas=1, max_restarts=2,
                                        backoff_base=0.005,
                                        backoff_max=0.01,
                                        backoff_jitter=0.0),
            faults=pkg.Faults("kill_replica@2:0"))
        rids = [rs.add_request(p, pkg.sp(max_tokens=6))
                for p in _prompts(3)]
        steps = 0
        while rs.has_unfinished():
            rs.step()
            steps += 1
            assert steps < 3000
            time.sleep(0.002)
        return rs, (str(rs.states()[0]),
                    [rs.get_request(r).finish_reason for r in rids],
                    sorted(set(calls)))

    _, (state, reasons, calls) = _twin(models, scenario)
    assert state == "failed" and reasons == ["error"] * 3
    assert calls == [0, 1, 2]


# ------------------------------------------------------- backpressure
def test_router_reject_carries_retry_after_hint(models):
    def scenario(pkg):
        rs = pkg.router(n=1, max_waiting=1, admission_policy="reject",
                        ecfg=pkg.ecfg(max_num_seqs=1))
        rs.add_request(_prompts(1)[0], pkg.sp(max_tokens=4))
        rs.step()
        rs.add_request(_prompts(2)[1], pkg.sp(max_tokens=4))
        with pytest.raises(pkg.s.EngineOverloaded) as ei:
            rs.add_request(_prompts(3)[2], pkg.sp(max_tokens=4))
        hint = ei.value.retry_after_s
        assert hint is not None and hint > 0
        assert "retry after" in str(ei.value)
        rs.run(max_steps=1000)
        _assert_no_leaks(rs)
        return rs, (ei.value.depth, ei.value.limit,
                    rs.router_stats()["finish_reasons"])

    _twin(models, scenario)


def test_router_shed_oldest_spans_replicas(models):
    def scenario(pkg):
        rs = pkg.router(n=2, max_waiting=2, admission_policy="shed_oldest",
                        ecfg=pkg.ecfg(max_num_seqs=1))
        prompts = _prompts(6)
        rids = [rs.add_request(p, pkg.sp(max_tokens=8))
                for p in prompts[:2]]
        rs.step()
        rids += [rs.add_request(p, pkg.sp(max_tokens=8))
                 for p in prompts[2:4]]
        victim = min(rids[2:], key=lambda r: rs.get_request(r).arrival)
        extra = rs.add_request(prompts[4], pkg.sp(max_tokens=4))
        rs.run(max_steps=1000)
        _assert_no_leaks(rs)
        return rs, (rids.index(victim), _records(rs, rids + [extra]))

    _, (victim, recs) = _twin(models, scenario)
    assert recs[victim][3] == "shed" and recs[-1][3] == "length"


def test_no_up_replica_rejects_with_hint(models):
    def scenario(pkg):
        rs = pkg.router(n=1)
        rs.drain(0)
        with pytest.raises(pkg.s.EngineOverloaded) as ei:
            rs.add_request(_prompts(1)[0], pkg.sp(max_tokens=2))
        return rs, ei.value.retry_after_s is not None

    assert _twin(models, scenario)[1]


# ------------------------------------------------------------- churn
def test_churn_zero_leak_with_failover(models):
    def scenario(pkg):
        rng = np.random.RandomState(3)
        n = 200
        specs = [(rng.randint(0, VOCAB, int(rng.randint(3, 8)))
                  .astype(np.int32), int(rng.randint(2, 5)))
                 for _ in range(n)]
        f = pkg.Faults("kill_replica@8:2")
        rs = pkg.from_model(pkg.s.RouterConfig(
            num_replicas=3, backoff_base=0.01, backoff_max=0.05,
            backoff_jitter=0.0),
            pkg.ecfg(decode_chunk_size=4, num_blocks=24), f)
        pending = list(specs)
        rids, cancelled = [], []
        steps = 0
        while pending or rs.has_unfinished():
            for _ in range(min(2, len(pending))):
                p, mt = pending.pop(0)
                rids.append(rs.add_request(p, pkg.sp(max_tokens=mt)))
            rs.step()
            steps += 1
            assert steps < 6000
            if steps % 7 == 0 and rids:
                live = [r for r in rids if not rs.get_request(r).finished]
                if live:
                    victim = live[int(rng.randint(len(live)))]
                    if rs.cancel(victim):
                        cancelled.append(victim)
            if not any(r.has_unfinished() for r in rs.replicas) \
                    and rs.has_unfinished():
                time.sleep(0.002)
        assert f.fired_log
        _assert_no_leaks(rs)
        st = rs.router_stats()
        # the restart's timing can move when the restarted replica
        # rejoins, so homes are not compared; greedy tokens are
        return rs, (len(rids), st["unfinished"], st["requeues"] >= 1,
                    cancelled, st["finish_reasons"],
                    [list(rs.get_request(r).tokens) for r in rids])

    _, (n, unfinished, requeued, cancelled, _, _) = _twin(models, scenario)
    assert n == 200 and unfinished == 0 and requeued and cancelled


# -------------------------------------------------- chaos acceptance
@pytest.mark.chaos
def test_replica_chaos_acceptance(models):
    import tools.chaos_serve as jcs
    from paddle_tpu_torch.tools import chaos_serve as cs
    got = cs.run_chaos_replicas(seed=0, n_requests=12, replicas=3,
                                model=models[1])
    want = jcs.run_chaos_replicas(seed=0, n_requests=12, replicas=3)
    assert got["requeues"] >= 1
    assert got["canaries_served"] >= 1
    assert got["untouched_survivors"] > 0
    for audit in got["integrity"].values():
        assert audit["leaked"] == 0
    for key in ("fired", "targeted_replicas", "requeues", "finish_reasons",
                "replica_states", "untouched_survivors", "canaries_served",
                "integrity"):
        assert got[key] == want[key], key


# ------------------------------------------------------------- obs
def _series(pkg, name, label):
    fams = {f["name"]: f for f in pkg.obs.snapshot()["metrics"]}
    return [s for s in fams[name]["series"]
            if s["labels"]["router"] == label]


def test_router_metrics_families(models):
    def scenario(pkg):
        rs = pkg.router(n=2, spec="kill_replica@2:0")
        for p in _prompts(4):
            rs.add_request(p, pkg.sp(max_tokens=6))
        rs.run(max_steps=3000)
        fams = {f["name"] for f in pkg.obs.snapshot()["metrics"]}
        ups = [s["value"] for s in
               _series(pkg, "serving_replica_up", rs.label)]
        fo = [(s["labels"]["replica"], s["labels"]["reason"], s["value"])
              for s in _series(pkg, "serving_failovers_total", rs.label)]
        req = sum(s["value"] for s in
                  _series(pkg, "serving_requeued_total", rs.label))
        rec = sum(s["count"] for s in _series(
            pkg, "serving_failover_recovery_seconds", rs.label))
        names = {n for n in ("serving_replica_up", "serving_failovers_total",
                             "serving_requeued_total",
                             "serving_router_ttft_seconds",
                             "serving_failover_recovery_seconds")
                 if n in fams}
        return rs, (sorted(names), ups, fo, req, rec)

    _, (names, ups, fo, req, rec) = _twin(models, scenario)
    assert len(names) == 5
    assert ups == [1, 1]
    assert sum(v for *_, v in fo) >= 1 and any(r == "crash" for _, r, _v in fo)
    assert req >= 1 and rec == 1


# ------------------------------------------- trace continuity (reqtrace)
def test_trace_continuity_across_kill_replica_failover(models):
    def scenario(pkg):
        pkg.obs.reqtrace.clear()
        pkg.obs.reqtrace.enable()
        rs = pkg.from_model(
            pkg.s.RouterConfig(num_replicas=3, backoff_base=0.01,
                               backoff_max=0.05, backoff_jitter=0.0),
            pkg.ecfg(), pkg.Faults("kill_replica@3:1"))
        rids = [rs.add_request(p, pkg.sp(max_tokens=8))
                for p in _prompts(6)]
        rs.run(max_steps=3000)
        assert rs.router_stats()["requeues"] >= 1
        prefix = f"tr-{rs.label}-"
        traces = pkg.obs.reqtrace.traces(prefix=prefix)
        assert len(traces) == len(rids)
        shapes = {}
        for tid, evts in traces.items():
            ks = [e.kind for e in evts]
            if "failover" not in ks:
                continue
            i_fo = ks.index("failover")
            i_re = ks.index("readmit", i_fo)
            fo, re_ = evts[i_fo], evts[i_re]
            admits = [e for e in evts if e.kind == "engine_admit"]
            shapes[tid[len(prefix):]] = (
                ks.count("finish"), ks.index("finish") > i_re,
                re_.attrs["from_replica"], re_.attrs["to_replica"],
                fo.attrs["replica"], fo.attrs["tokens_streamed"],
                len(admits), admits[-1].attrs["readmit"],
                admits[-1].attrs["resume"])
        dump = pkg.obs.reqtrace.dump_payload(
            "kill_replica", trace_ids=sorted(traces), complete=True)
        violations = pkg.obs.reqtrace.check_causality(dump)
        return rs, (shapes, violations, dump)

    port, ref = _both(models)
    _, (shapes, violations, dump) = scenario(port)
    _, (want_shapes, _, _) = scenario(ref)
    assert shapes == want_shapes and shapes
    for n_finish, after, frm, to, dead, streamed, n_admit, readmit, \
            resume in shapes.values():
        assert n_finish == 1 and after
        assert frm == dead and to != dead
        assert n_admit == 2 and readmit and resume == streamed
    assert violations == []
    # the JAX package's checker reads the port's dump the same way
    assert jobs.reqtrace.check_causality(dump) == []

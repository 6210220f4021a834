"""The port's request tracing (paddle_tpu_torch/obs/reqtrace.py and the
engine's and scheduler's record sites) against paddle_tpu's, on the CPU.

Twins of tests/test_reqtrace.py but the kill-replica failover (the
router is a later slice). The engine tests drive a JAX engine and a port
engine (the same weights, the same obs_label, both packages' engine-id
and arrival counters aligned) through the same calls and require
every trace to hold the same events: the same trace ids, kinds and
attributes but the wall-clock readings (TIME_ATTRS). The ring, the
checker and the flight recorder are held to the reference's assertions
and to each other.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.inference.serving.engine as jengine_mod
import paddle_tpu.inference.serving.scheduler as jsched_mod
import paddle_tpu.models.generation as jgen
from paddle_tpu import obs as jobs
from paddle_tpu.inference.serving import (EngineConfig as JEngineConfig,
                                          LLMEngine as JLLMEngine,
                                          SamplingParams as JSamplingParams)
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.obs.reqtrace import ReqTraceRing as JRing
from paddle_tpu.testing.faults import ServingFaultInjector as JFaults

import paddle_tpu_torch.inference.serving.engine as tengine_mod
import paddle_tpu_torch.inference.serving.scheduler as tsched_mod
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.inference.serving import (EngineConfig, LLMEngine,
                                                SamplingParams)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.obs.reqtrace import ReqTraceRing
from paddle_tpu_torch.testing.faults import ServingFaultInjector

VOCAB = 97
GEOM_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=24)
# attributes that are wall-clock readings (everything else must match)
TIME_ATTRS = ("ttft_s", "seconds", "estimate_s", "retry_after_s")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**GEOM_KW))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**GEOM_KW), params,
                                   device="cpu")


def _align(a, b):
    """Advance the lagging of two itertools counters until both give the
    same next value (counters only advance, so no value repeats)."""
    x, y = next(a), next(b)
    while x < y:
        x = next(a)
    while y < x:
        y = next(b)


@pytest.fixture(autouse=True)
def recording():
    """Fresh, enabled rings per test (always disarmed after); both
    packages' engine ids and arrival tickets are aligned, so the trace
    ids and tickets of the two engines match letter for letter, and no
    label repeats one the registries hold."""
    for obs in (jobs, tobs):
        obs.reqtrace.clear()
        obs.reqtrace.enable()
    for pair, name in (((jengine_mod, tengine_mod), "_ENGINE_IDS"),
                       ((jsched_mod, tsched_mod), "_arrival_counter")):
        _align(*(getattr(m, name) for m in pair))
    yield
    for obs in (jobs, tobs):
        obs.reqtrace.disarm()
        obs.reqtrace.enable()
        obs.reqtrace.clear()


def _pair(models, jfaults=None, tfaults=None, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("obs_label", "rt")
    jm, tm = models
    jeng = JLLMEngine.from_model(jm, JEngineConfig(**kw),
                                 faults=jfaults or JFaults(""))
    teng = LLMEngine.from_model(tm, EngineConfig(**kw),
                                faults=tfaults or ServingFaultInjector(""),
                                device="cpu")
    assert jeng.stats.label == teng.stats.label
    return jeng, teng


def _prompts(n, seed=7, lo=3, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(rng.randint(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _timeline(obs, label):
    """trace id -> [(kind, request id, attrs without wall-clock)]."""
    return {tid: [(e.kind, e.request_id,
                   {k: v for k, v in e.attrs.items()
                    if k not in TIME_ATTRS})
                  for e in evts]
            for tid, evts in obs.reqtrace.traces(
                prefix=f"tr-{label}-").items()}


def _same_timelines(jeng, teng):
    j = _timeline(jobs, jeng.stats.label)
    t = _timeline(tobs, teng.stats.label)
    assert sorted(t) == sorted(j)
    for tid in j:
        assert t[tid] == j[tid], tid
    return t


def _dump(obs, prefix=None, complete=True, reason="test"):
    ids = None
    if prefix is not None:
        ids = sorted(obs.reqtrace.traces(prefix=prefix))
    return obs.reqtrace.dump_payload(reason, trace_ids=ids,
                                     complete=complete)


def _kinds(evts):
    return [e[0] for e in evts]


# ------------------------------------------------------------- ring unit
@pytest.mark.parametrize("ring", [JRing, ReqTraceRing], ids=["jax", "torch"])
def test_ring_bounded_gated_and_closed_catalog(ring):
    r = ring(capacity=4)
    for i in range(10):
        r.record("finish", f"t{i}", reason="stop")
    assert len(r) == 4
    assert [e.trace_id for e in r.events()] == ["t6", "t7", "t8", "t9"]
    r.enabled = False
    r.record("finish", "t-off", reason="stop")
    assert len(r) == 4
    r.enabled = True
    with pytest.raises(ValueError):
        r.record("not_a_kind", "t0")
    r.clear()
    assert len(r) == 0


def test_catalog_and_schema_match_jax():
    assert tobs.reqtrace.EVENT_KINDS == jobs.reqtrace.EVENT_KINDS
    assert tobs.reqtrace.DEPLOY_KINDS == jobs.reqtrace.DEPLOY_KINDS
    assert tobs.reqtrace.TERMINAL_REASONS == jobs.reqtrace.TERMINAL_REASONS
    out = []
    for ring in (JRing(), ReqTraceRing()):
        ring.bind_tenant("t0", "gold")
        ring.record("engine_admit", "t0", request_id="r0", engine="e-0")
        ring.record("finish", "t0", reason="stop", tokens=3)
        a, b = ring.events()
        assert b.seq > a.seq and b.ts >= a.ts
        d = b.as_dict()
        assert json.loads(json.dumps(d)) == d
        out.append([{k: v for k, v in e.as_dict().items() if k != "ts"}
                    for e in ring.events()])
    assert out[1] == out[0]
    assert out[1][1]["attrs"] == {"reason": "stop", "tokens": 3,
                                  "tenant": "gold"}


# ------------------------------------------------- single-engine timeline
def test_single_engine_timeline_and_checker(models):
    jeng, teng = _pair(models)
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        for p in _prompts(3):
            eng.add_request(p, sp(max_tokens=4))
        eng.run()
    traces = _same_timelines(jeng, teng)
    assert len(traces) == 3
    for tid, evts in traces.items():
        ks = _kinds(evts)
        for a, b in [("engine_admit", "scheduled"),
                     ("scheduled", "prefill"),
                     ("prefill", "first_token"),
                     ("first_token", "finish")]:
            assert ks.index(a) < ks.index(b), (tid, ks)
        assert ks.count("finish") == 1
    prefix = f"tr-{teng.stats.label}-"
    assert tobs.reqtrace.check_causality(_dump(tobs, prefix)) == []


def test_ttft_decomposition_components_sane(models):
    _, teng = _pair(models)
    for p in _prompts(4):
        teng.add_request(p, SamplingParams(max_tokens=3))
    teng.run()
    prefix = f"tr-{teng.stats.label}-"
    evts = [e.as_dict() for e in tobs.reqtrace.events(prefix=prefix)]
    d = tobs.reqtrace.ttft_decomposition(evts)
    assert d["n"] == 4
    for k in ("queue_s", "prefill_s", "first_gap_s", "ttft_s"):
        assert d[k] >= 0.0
    for evts_one in tobs.reqtrace.traces(prefix=prefix).values():
        c = tobs.reqtrace.ttft_components([e.as_dict() for e in evts_one])
        assert c is not None
        total = (c["admission_s"] + c["queue_s"] + c["prefill_s"]
                 + c["first_gap_s"])
        assert abs(total - c["ttft_s"]) < 1e-6
    # the pure helpers agree with the reference's on the same dicts
    assert jobs.reqtrace.ttft_decomposition(evts) == d
    assert jobs.reqtrace.ttft_by_tenant(evts) == \
        tobs.reqtrace.ttft_by_tenant(evts)


# ------------------------------------------------- continuity: preemption
@pytest.mark.parametrize("kw", [dict(), dict(decode_chunk_size=2,
                                             prefill_chunk_threshold=4)],
                         ids=["dense", "chunked"])
def test_trace_continuity_across_preemption(models, kw):
    jeng, teng = _pair(models, num_blocks=6, **kw)
    rng = np.random.RandomState(3)
    lens = [3, 6, 2, 8, 5, 4, 7, 3]
    max_toks = [8, 5, 10, 6, 8, 12, 4, 9]
    prompts = [rng.randint(1, VOCAB, (n,)).astype(np.int32) for n in lens]
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        for i, (p, mt) in enumerate(zip(prompts, max_toks)):
            eng.add_request(p, sp(max_tokens=mt))
            if i % 3 == 2:
                eng.step()
        eng.run()
    assert teng.stats.preemptions == jeng.stats.preemptions >= 1
    traces = _same_timelines(jeng, teng)
    assert len(traces) == len(prompts)
    preempted = [t for t, evts in traces.items()
                 if "preempt" in _kinds(evts)]
    assert preempted
    for tid in preempted:
        ks = _kinds(traces[tid])
        assert ks.index("preempt") < len(ks) - 1 - ks[::-1].index(
            "scheduled")
        assert ks.count("finish") == 1
        arr = {a["arrival"] for _, _, a in traces[tid] if "arrival" in a}
        assert len(arr) == 1
    prefix = f"tr-{teng.stats.label}-"
    assert tobs.reqtrace.check_causality(_dump(tobs, prefix)) == []


# --------------------------------------------------- churn with cancels
def test_checker_on_200_request_churn_with_cancels(models):
    jeng, teng = _pair(models, max_num_seqs=8, num_blocks=48,
                       max_waiting=200)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, VOCAB, int(rng.randint(3, 6)))
               .astype(np.int32) for _ in range(200)]
    rids, cancelled, submitted, steps = [], set(), 0, 0
    engines = ((jeng, JSamplingParams), (teng, SamplingParams))
    while submitted < 200 or teng.has_unfinished():
        for _ in range(4):                   # staggered arrivals
            if submitted < 200:
                got = {eng.add_request(prompts[submitted],
                                       sp(max_tokens=2))
                       for eng, sp in engines}
                assert len(got) == 1
                rids.append(got.pop())
                submitted += 1
        for eng, _ in engines:
            if eng.has_unfinished():
                eng.step()
        steps += 1
        if steps % 5 == 0:                   # churn: cancel a live one
            live = [r for r in rids if r not in cancelled
                    and not teng.get_request(r).finished]
            assert live == [r for r in rids if r not in cancelled
                            and not jeng.get_request(r).finished]
            if live:
                victim = live[int(rng.randint(len(live)))]
                assert jeng.cancel(victim) == teng.cancel(victim)
                cancelled.add(victim)
        assert steps < 4000
    assert submitted == 200 and cancelled
    assert not jeng.has_unfinished()
    traces = _same_timelines(jeng, teng)
    assert len(traces) == 200
    for tid, evts in traces.items():
        assert _kinds(evts).count("finish") == 1, tid
    reasons = {a["reason"] for r in cancelled
               for k, _, a in traces[teng.get_request(r).tid]
               if k == "finish"}
    assert reasons <= {"cancelled"}
    prefix = f"tr-{teng.stats.label}-"
    assert tobs.reqtrace.check_causality(_dump(tobs, prefix)) == []


# ------------------------------------------------ flight recorder: auto
@pytest.fixture
def fresh_flight_recorders():
    """Leave both packages' process-wide flight recorders as they were
    found: disarmed, with no dump paths (tests/test_reqtrace.py, which
    may run later in the same process, counts the JAX ring's dumps)."""
    yield
    for obs in (jobs, tobs):
        obs.reqtrace.disarm()
        with obs.reqtrace.RING._lock:
            obs.reqtrace.RING._dumps.clear()


def test_quarantine_auto_flight_dump(models, tmp_path,
                                     fresh_flight_recorders):
    dumps = []
    jeng, teng = _pair(models, jfaults=JFaults("nan_logits@1"),
                       tfaults=ServingFaultInjector("nan_logits@1"))
    for obs, eng, sp, sub in ((jobs, jeng, JSamplingParams, "jax"),
                              (tobs, teng, SamplingParams, "torch")):
        obs.reqtrace.arm(str(tmp_path / sub), max_dumps=2)
        rids = [eng.add_request(p, sp(max_tokens=5)) for p in _prompts(3)]
        eng.run()
        assert eng.stats.errors == 1
        paths = obs.reqtrace.RING.dumps()
        assert len(paths) == 1 and "quarantine" in paths[0]
        dump = json.loads(open(paths[0]).read())
        assert dump["complete"] is False and dump["reason"] == "quarantine"
        assert eng.get_request(rids[0]).tid in dump["trace_ids"]
        assert "quarantine" in [e["kind"] for e in dump["events"]]
        assert dump["extra"]["why"].startswith("non-finite")
        assert "metrics" in dump["registry"]
        assert obs.reqtrace.check_causality(dump) == []
        obs.reqtrace.maybe_flight("failover")
        obs.reqtrace.maybe_flight("failover")
        assert len(obs.reqtrace.RING.dumps()) == 2
        dumps.append(dump)
    jd, td = dumps
    assert td["trace_ids"] == jd["trace_ids"]
    assert td["extra"] == jd["extra"]
    strip = [[(e["trace_id"], e["kind"],
               {k: v for k, v in e["attrs"].items() if k not in TIME_ATTRS})
              for e in d["events"]] for d in dumps]
    assert strip[1] == strip[0]
    _same_timelines(jeng, teng)


# ------------------------------------------------- checker on synthetics
def _synthetic_dumps():
    out = []
    for build in (
            # token emission before prefill completes
            [("engine_admit", "tA", dict(engine="e-9", arrival=0)),
             ("scheduled", "tA", dict(arrival=0)),
             ("first_token", "tA", {}),
             ("finish", "tA", dict(reason="stop"))],
            # two terminal events
            [("engine_admit", "tB", dict(engine="e-9", arrival=0)),
             ("scheduled", "tB", dict(arrival=0)),
             ("prefill", "tB", {}),
             ("finish", "tB", dict(reason="stop")),
             ("finish", "tB", dict(reason="stop"))],
            # missing terminal (an in-flight dump tolerates it)
            [("engine_admit", "tC", dict(engine="e-9", arrival=0))],
            # changed ticket, unknown reason, readmit without failover,
            # host-resident emission (the finish resolves the abort)
            [("engine_admit", "tD", dict(engine="e-1", arrival=1)),
             ("prefix_match", "tD", dict(host_tokens=8)),
             ("scheduled", "tD", dict(arrival=2)),
             ("prefill", "tD", {}),
             ("first_token", "tD", {}),
             ("promote_abort", "tD", dict(outcome="timeout")),
             ("readmit", "tD", dict(from_replica=3)),
             ("finish", "tD", dict(reason="bogus"))],
            # FCFS within a tenant broken, across tenants legal
            [("engine_admit", "A1", dict(engine="e0", arrival=1.0,
                                         tenant="a")),
             ("engine_admit", "A2", dict(engine="e0", arrival=2.0,
                                         tenant="a")),
             ("engine_admit", "B1", dict(engine="e0", arrival=3.0,
                                         tenant="b")),
             ("scheduled", "B1", {}), ("scheduled", "A2", {}),
             ("scheduled", "A1", {}),
             ("finish", "A1", dict(reason="stop")),
             ("finish", "A2", dict(reason="stop")),
             ("finish", "B1", dict(reason="stop"))],
            # a quota refusal is terminal
            [("rejected", "R1", dict(reason="quota", tenant="q"))]):
        r = ReqTraceRing()
        for kind, tid, attrs in build:
            r.record(kind, tid, **attrs)
        evs = [e.as_dict() for e in r.events()]
        out.append({"version": 1, "complete": True, "events": evs})
        out.append({"version": 1, "complete": False, "events": evs})
    return out


def test_checker_gives_the_reference_violations_on_synthetic_dumps():
    dumps = _synthetic_dumps()
    got = [tobs.reqtrace.check_causality(d) for d in dumps]
    assert got == [jobs.reqtrace.check_causality(d) for d in dumps]
    # the reference test's own readings
    assert any("prefill" in v for v in got[0])
    assert any("terminal" in v for v in got[2])
    assert got[5] == [] and any("terminal" in v for v in got[4])
    assert len(got[6]) == 4
    assert any("FCFS" in v and "tenant 'a'" in v for v in got[8])
    assert got[10] == []


# ------------------------------------------- prefix cache and host tier
@pytest.fixture(scope="module")
def models64():
    paddle.seed(0)
    kw = dict(GEOM_KW, max_seq_len=64)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**kw), params, device="cpu")


def test_prefix_and_tier_events_match_jax(models64):
    """Templated prompts through a 20-block pool with a host tier
    (tests/test_serving_tiered.py's workload), one request at a time:
    prefix matches with their copy-on-write flags, demotions and
    promotions land on the same traces with the same attributes as the
    JAX engine's, and the dump passes the checker's tier invariants."""
    jeng, teng = _pair(models64, num_blocks=20, decode_chunk_size=4,
                       enable_prefix_cache=True, host_tier_blocks=64)
    rng = np.random.RandomState(0)
    tpls = [rng.randint(1, VOCAB, (24,), dtype=np.int32) for _ in range(4)]
    prompts = [np.concatenate([tpls[t], rng.randint(1, VOCAB, (4,),
                                                    dtype=np.int32)])
               for t in (0, 1, 2, 3, 0, 1)]
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        for p in prompts:
            eng.add_request(p, sp(max_tokens=6))
            while eng.has_unfinished():
                eng.step()
    traces = _same_timelines(jeng, teng)
    kinds = {k for evts in traces.values() for k in _kinds(evts)}
    assert {"prefix_match", "demote", "promote"} <= kinds, kinds
    prefix = f"tr-{teng.stats.label}-"
    assert tobs.reqtrace.check_causality(_dump(tobs, prefix)) == []

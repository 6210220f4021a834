"""The hardened serving step of the port (deadlines, admission control,
the watchdog, crash recovery and fault injection) against the JAX
package: twins of tests/test_serving_robustness.py, on the CPU.

Each scenario runs on the port's engine and on the JAX engine with the
same requests, the same fault spec and the same step sequence. Each
request's finish_reason and state, and every survivor's tokens, must be
equal in the two, and the survivors' tokens equal dense generate(). The
cache audits clean after every scenario. Timing follows the reference
file: a budget of 0.0 s or a sleep just past a tiny budget, and the
watchdog's 2 s budget against a 2.5 s stall, with the JAX engine's
programs compiled before the guarded run.
"""
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
from paddle_tpu.inference.serving import EngineConfig as JEngineConfig
from paddle_tpu.inference.serving import EngineOverloaded as JOverloaded
from paddle_tpu.inference.serving import LLMEngine as JLLMEngine
from paddle_tpu.inference.serving import SamplingParams as JSamplingParams
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch.models.generation as gen
from paddle_tpu_torch.inference.serving import (EngineConfig,
                                                EngineOverloaded, LLMEngine,
                                                SamplingParams)
from paddle_tpu_torch.inference.serving.paged_cache import PagedKVCache
from paddle_tpu_torch.inference.serving.scheduler import (Request,
                                                          RequestState,
                                                          Scheduler,
                                                          SchedulerConfig)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.testing import faults

VOCAB = 97
GEOM_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=24)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**GEOM_KW))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    tm = GPT.load_jax_params(GPTConfig(**GEOM_KW), params, device="cpu")
    # compile the JAX prefill at every prompt length a scenario can
    # reach, so no compile lands inside a timed step
    for t in range(1, 24):
        jgen.prefill(jgen.extract_params(jm),
                     jnp.zeros((1, t), jnp.int32), tm.cfg.geom)
    return jm, tm


class Pkg:
    """One package's engine factory and types."""

    def __init__(self, port: bool, model):
        self.port = port
        self.model = model
        self.SP = SamplingParams if port else JSamplingParams
        self.Overloaded = EngineOverloaded if port else JOverloaded
        self.Faults = faults.ServingFaultInjector if port \
            else jfaults.ServingFaultInjector

    def engine(self, spec="", **kw):
        cfg = dict(dict(block_size=4, num_blocks=16, max_num_seqs=4), **kw)
        if self.port:
            return LLMEngine.from_model(self.model, EngineConfig(**cfg),
                                        self.Faults(spec), device="cpu")
        return JLLMEngine.from_model(self.model, JEngineConfig(**cfg),
                                     faults=self.Faults(spec))


def _both(models):
    jm, tm = models
    return Pkg(True, tm), Pkg(False, jm)


def _prompts(n, seed=7, lo=3, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, int(rng.randint(lo, hi))).astype(np.int32)
            for _ in range(n)]


class Log:
    """Terminal reasons from every streamed output, by request id."""

    def __init__(self, eng):
        self.eng = eng
        self.reasons = {}

    def step(self):
        for o in self.eng.step():
            if o.finished:
                self.reasons[o.request_id] = o.finish_reason

    def drain(self, max_steps=400):
        n = 0
        while self.eng.has_unfinished():
            self.step()
            n += 1
            assert n < max_steps
        return self


def _record(log, rids):
    eng = log.eng
    return [(r, eng.get_request(r).state, log.reasons.get(r),
             list(eng.get_request(r).output_ids)) for r in rids]


def _reference(tm, prompt, max_new):
    return list(gen.generate(tm, np.asarray(prompt)[None],
                             max_new)[0, len(prompt):])


def _check_survivors(tm, records, specs):
    for (rid, state, reason, toks), (p, mt) in zip(records, specs):
        if reason in ("stop", "length"):
            assert toks == _reference(tm, p, mt), rid


def _twin(models, scenario):
    """scenario(pkg) -> (log, rids, specs); the records must agree."""
    port, ref = _both(models)
    got = scenario(port)
    want = scenario(ref)
    assert _record(got[0], got[1]) == _record(want[0], want[1])
    got[0].eng.cache.check_integrity()
    _check_survivors(models[1], _record(got[0], got[1]), got[2])
    return got[0].eng, want[0].eng


# --------------------------------------------------------- deadlines / TTL
def test_queue_ttl_expires_waiting_request(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1)
        p = _prompts(2)
        rids = [eng.add_request(p[0], pkg.SP(max_tokens=3)),
                eng.add_request(p[1], pkg.SP(max_tokens=3, queue_ttl_s=0.0))]
        time.sleep(0.01)
        log = Log(eng)
        log.step()
        assert log.reasons[rids[1]] == "timeout"
        assert eng.stats.expired == 1
        return log.drain(), rids, [(p[0], 3), (p[1], 3)]
    eng, _ = _twin(models, scenario)
    assert eng.get_request("req-1").state == RequestState.FINISHED_TIMEOUT


def test_deadline_aborts_running_request(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1)
        p = _prompts(1)[0]
        rid = eng.add_request(p, pkg.SP(max_tokens=16, deadline_s=0.05))
        log = Log(eng)
        log.step()                               # admit + prefill
        assert eng.get_request(rid).state == RequestState.RUNNING
        time.sleep(0.08)
        log.step()                               # overdue: aborted
        assert eng.stats.timeouts == 1 and not eng.has_unfinished()
        return log, [rid], [(p, 16)]
    _twin(models, scenario)


# --------------------------------------------------------- admission control
def test_bounded_queue_rejects_when_full(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1, max_waiting=2)
        p = _prompts(3)
        rids = [eng.add_request(q, pkg.SP(max_tokens=2)) for q in p[:2]]
        with pytest.raises(pkg.Overloaded) as ei:
            eng.add_request(p[2], pkg.SP(max_tokens=2))
        assert ei.value.depth == 2 and ei.value.limit == 2
        return Log(eng).drain(), rids, [(q, 2) for q in p[:2]]
    eng, jeng = _twin(models, scenario)
    assert eng.stats.rejected == jeng.stats.rejected == 1


def test_shed_oldest_evicts_and_streams_terminal(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1, max_waiting=1,
                         admission_policy="shed_oldest")
        p = _prompts(2)
        rids = [eng.add_request(q, pkg.SP(max_tokens=2)) for q in p]
        assert eng.get_request(rids[0]).state == RequestState.FINISHED_SHED
        return Log(eng).drain(), rids, [(q, 2) for q in p]
    eng, _ = _twin(models, scenario)
    assert eng.stats.shed == 1


def test_shed_oldest_waiting_and_oldest_arrival(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1)
        p = _prompts(3)
        rids = [eng.add_request(q, pkg.SP(max_tokens=2)) for q in p]
        log = Log(eng)
        log.step()
        head = eng.get_request(rids[1]).arrival
        assert eng.oldest_waiting_arrival() == head
        assert eng.shed_oldest_waiting() == rids[1]
        return log.drain(), rids, [(q, 2) for q in p]
    _twin(models, scenario)


def test_cache_high_watermark_pauses_admission(models):
    def scenario(pkg):
        eng = pkg.engine(num_blocks=8, max_num_seqs=4,
                         cache_high_watermark=0.45)
        p = _prompts(2, lo=7, hi=8)
        rids = [eng.add_request(q, pkg.SP(max_tokens=8)) for q in p]
        log = Log(eng)
        log.step()
        assert eng.get_request(rids[0]).state == RequestState.RUNNING
        assert eng.get_request(rids[1]).state == RequestState.WAITING
        assert eng.scheduler.watermark_holds >= 1
        return log.drain(), rids, [(q, 8) for q in p]
    _twin(models, scenario)


def test_cache_high_watermark_is_validated(models):
    port, _ = _both(models)
    with pytest.raises(ValueError, match="cache_high_watermark"):
        port.engine(cache_high_watermark=0.0)


# ------------------------------------------------- anomaly guard + recovery
def _fault_run(spec, n, max_tokens, **kw):
    def scenario(pkg):
        eng = pkg.engine(spec, **kw)
        p = _prompts(n)
        rids = [eng.add_request(q, pkg.SP(max_tokens=max_tokens)) for q in p]
        return Log(eng).drain(), rids, [(q, max_tokens) for q in p]
    return scenario


def test_prefill_nan_quarantines_only_offender(models):
    eng, jeng = _twin(models, _fault_run("nan_logits@1", 3, 5))
    assert eng.get_request("req-0").state == RequestState.FINISHED_ERROR
    assert eng.stats.errors == jeng.stats.errors == 1
    assert eng.stats.recoveries == 0


def test_decode_nan_recovery_keeps_survivors_bitwise(models):
    eng, jeng = _twin(models, _fault_run("nan_logits@2:1", 4, 6))
    assert eng.stats.errors == 1 and eng.stats.recoveries == 1
    assert eng.stats.rebuilt == jeng.stats.rebuilt == 3
    assert ("nan_logits", 2) in eng.faults.fired_log


@pytest.mark.parametrize("kvdt", ["float32", "int8"])
def test_cache_corruption_detected_and_recovered(models, kvdt):
    eng, _ = _twin(models, _fault_run("cache_corrupt@2", 4, 6,
                                      kv_cache_dtype=kvdt))
    assert eng.stats.errors >= 1 and eng.stats.recoveries >= 1
    for kp, vp in eng.cache.pools:                  # scrub left no NaN
        assert bool(torch.isfinite(kp).all() and torch.isfinite(vp).all())


def test_stall_trips_watchdog_and_engine_drains(models):
    def scenario(pkg):
        clean = pkg.engine()                     # warm every program
        for q in _prompts(4):
            clean.add_request(q, pkg.SP(max_tokens=4))
        clean.run()
        return _fault_run("stall@2:2.5", 4, 4, step_timeout_s=2.0)(pkg)
    eng, _ = _twin(models, scenario)
    assert eng.stats.watchdog_trips >= 1 and eng.stats.errors >= 1


# ------------------------------------------------------ starvation / FCFS
def test_requeue_preserves_arrival_order():
    cache = PagedKVCache(1, 2, 4, 16, 4, device="cpu")
    sched = Scheduler(SchedulerConfig(max_num_seqs=4), cache)
    reqs = [Request(request_id=f"r{i}", prompt_ids=np.ones(3, np.int32),
                    params=SamplingParams(max_tokens=4)) for i in range(4)]
    for r in reqs:
        sched.add(r)
    sched.schedule()
    assert [r.request_id for r in sched.running] == ["r0", "r1", "r2", "r3"]
    sched.add(Request(request_id="late", prompt_ids=np.ones(3, np.int32),
                      params=SamplingParams(max_tokens=4)))
    sched.requeue_for_recovery(reqs[3])
    sched.requeue_for_recovery(reqs[1])
    assert [r.request_id for r in sched.waiting] == ["r1", "r3", "late"]
    cache.check_integrity()


def test_repeatedly_preempted_request_not_starved(models):
    def scenario(pkg):
        eng = pkg.engine(num_blocks=6, max_num_seqs=2)
        first = _prompts(1, seed=3, lo=6, hi=7)[0]
        rids, specs = [eng.add_request(first, pkg.SP(max_tokens=10))], \
            [(first, 10)]
        log, steps = Log(eng), 0
        while eng.has_unfinished():
            log.step()
            steps += 1
            assert steps < 200
            if steps % 2 == 0 and len(rids) < 7:
                q = _prompts(1, seed=40 + steps, lo=4, hi=6)[0]
                rids.append(eng.add_request(q, pkg.SP(max_tokens=6)))
                specs.append((q, 6))
        return log, rids, specs
    eng, jeng = _twin(models, scenario)
    assert eng.stats.preemptions == jeng.stats.preemptions
    t_first = eng.get_request("req-0").finish_time
    for i in range(1, 7):
        assert t_first <= eng.get_request(f"req-{i}").finish_time


# ----------------------------------------------------- cancellation races
def test_cancel_waiting_request_before_prefill(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1)
        p = _prompts(2)
        rids = [eng.add_request(q, pkg.SP(max_tokens=3)) for q in p]
        assert eng.cancel(rids[1])
        log = Log(eng).drain()
        assert log.reasons[rids[1]] == "cancelled"
        assert eng.get_request(rids[1]).output_ids == []
        return log, rids, [(q, 3) for q in p]
    _twin(models, scenario)


def test_cancel_expired_request_is_noop(models):
    def scenario(pkg):
        eng = pkg.engine(max_num_seqs=1)
        p = _prompts(2)
        rids = [eng.add_request(p[0], pkg.SP(max_tokens=3)),
                eng.add_request(p[1], pkg.SP(max_tokens=3, queue_ttl_s=0.0))]
        time.sleep(0.01)
        log = Log(eng)
        log.step()
        assert not eng.cancel(rids[1])
        assert eng.stats.cancelled == 0
        return log.drain(), rids, [(q, 3) for q in p]
    _twin(models, scenario)


def test_churn_cancel_expire_complete_leaks_nothing(models):
    """200 random request fates with recovery faults mixed in: every
    request reaches the same end in both packages, and the pool ends
    whole."""
    def scenario(pkg):
        eng = pkg.engine("nan_logits@9,cache_corrupt@21,nan_logits@33",
                         num_blocks=32, max_num_seqs=4, max_waiting=8,
                         admission_policy="shed_oldest")
        rng = np.random.RandomState(0)
        rids, specs, log = [], [], Log(eng)
        steps = 0
        while len(rids) < 200 or eng.has_unfinished():
            if len(rids) < 200 and rng.rand() < 0.7:
                ttl = 0.0 if rng.rand() < 0.1 else None
                q = rng.randint(0, VOCAB, int(rng.randint(3, 7))).astype(
                    np.int32)
                mt = int(rng.randint(2, 5))
                rids.append(eng.add_request(q, pkg.SP(max_tokens=mt,
                                                      queue_ttl_s=ttl)))
                specs.append((q, mt))
            if rids and rng.rand() < 0.15:
                eng.cancel(rids[int(rng.randint(len(rids)))])
            log.step()
            steps += 1
            assert steps < 3000
        return log, rids, specs
    eng, _ = _twin(models, scenario)
    assert all(eng.get_request(r).finished for r in eng._requests)
    assert eng.cache.num_free() == eng.cache.num_blocks
    assert eng.cache.blocks_allocated == eng.cache.blocks_freed


def test_chaos_sixteen_requests_through_faults(models):
    """16 staggered requests through a seeded nan / stall /
    cache-corrupt schedule: every request terminal, at least one
    quarantine, survivors bitwise."""
    def scenario(pkg):
        eng = pkg.engine(
            "nan_logits@4,stall@7:0.1,cache_corrupt@10,nan_logits@13",
            num_blocks=64, max_num_seqs=4, max_waiting=16,
            admission_policy="shed_oldest", cache_high_watermark=0.9)
        rng = np.random.RandomState(0)
        specs = [(rng.randint(0, VOCAB, int(rng.randint(3, 9))).astype(
            np.int32), int(rng.randint(4, 10))) for _ in range(16)]
        rids = [eng.add_request(p, pkg.SP(max_tokens=mt))
                for p, mt in specs[:4]]
        pending, log, steps = list(specs[4:]), Log(eng), 0
        while eng.has_unfinished() or pending:
            log.step()
            steps += 1
            assert steps < 400
            if steps % 2 == 0 and pending:
                p, mt = pending.pop(0)
                rids.append(eng.add_request(p, pkg.SP(max_tokens=mt)))
        return log, rids, specs
    eng, _ = _twin(models, scenario)
    assert eng.stats.errors >= 1 and len(eng.faults.fired_log) == 4
    survivors = sum(eng.get_request(r).state in (
        RequestState.FINISHED_STOPPED, RequestState.FINISHED_LENGTH)
        for r in eng._requests)
    assert survivors >= 8


# ------------------------------------------------------- fault injectors
def test_serving_fault_spec_grammar_matches_jax(monkeypatch):
    spec = ("nan_logits@5:1,stall@7:0.2,cache_corrupt@9,burst@3:8,"
            "kill_replica@6:1,wedge_replica@8,kill_migration@6:2,"
            "kill_promotion@4,kill_demotion@6,corrupt_host_block@8,"
            "kill_deploy@5:1")
    t, j = faults.ServingFaultInjector(spec), \
        jfaults.ServingFaultInjector(spec)
    assert t.faults == j.faults and t.enabled
    for inj in (t, j):
        assert inj.burst(2) == 0 and inj.burst(3) == 8
        assert not inj.kill_replica(9, 0) and inj.kill_replica(9, 1)
        assert inj.wedge_replica(8, 0) and inj.kill_migration(6, 2)
        assert inj.kill_deploy(5, 1) and inj.kill_promotion(4)
        assert inj.kill_demotion(7) and not inj.kill_demotion(8)
    assert t.fired_log == j.fired_log
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.ServingFaultInjector("explode@1")
    monkeypatch.setenv(faults.SERVE_SPEC_ENV, "nan_logits@2")
    assert faults.ServingFaultInjector().faults == [("nan_logits", 2, None)]
    monkeypatch.delenv(faults.SERVE_SPEC_ENV)
    assert not faults.ServingFaultInjector().enabled


def test_poison_hooks_match_jax():
    t = faults.ServingFaultInjector("nan_logits@1:2,nan_logits@3")
    j = jfaults.ServingFaultInjector("nan_logits@1:2,nan_logits@3")
    lg = np.zeros((4, 5), np.float32)
    np.testing.assert_array_equal(t.poison_logits(1, lg),
                                  j.poison_logits(1, lg))
    bad = np.zeros(4, bool)
    np.testing.assert_array_equal(t.poison_chunk(3, bad),
                                  j.poison_chunk(3, bad))
    assert not lg.any() and not bad.any()       # private copies


def test_training_fault_injector_fires_once(tmp_path):
    inj = faults.FaultInjector("nan@2,corrupt@3", state_dir=str(tmp_path))
    assert np.isnan(inj.poison_loss(2, 1.0)) and inj.fired("nan", 2)
    assert inj.poison_loss(2, 1.0) == 1.0       # fired once
    snap = tmp_path / "ckpt" / "step_1"
    snap.mkdir(parents=True)
    (snap / "meta.json").write_text('{"time": 1}')
    (snap / "state.pdparams").write_bytes(b"x" * 100)
    inj.step(3, checkpoint_dir=str(tmp_path / "ckpt"))
    assert (snap / "state.pdparams").stat().st_size == 10
    assert faults.corrupt_checkpoint(str(tmp_path / "ckpt"), "delete")
    assert not (snap / "state.pdparams").exists()
    with pytest.raises(ValueError):
        faults.FaultInjector("melt@1")

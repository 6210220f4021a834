"""The port's multi-tenant serving (tenancy.py, WFQ admission priced by
the prefill cost model, quotas, the deadline early reject,
share-weighted prefix eviction) against paddle_tpu's, on the CPU.

Twins of tests/test_tenancy.py's nine non-autoscaler tests (the
autoscaler is a later slice): each runs the reference's scenario on a
JAX engine and a port engine with the same weights and holds the port
to the reference's assertions and to the JAX engine's outcome (finish
order, greedy tokens, quota windows, retry hints, censuses). Then the
scheduler-only replay of chip_smoke.py phase 6d's full-width traffic
(block 32 over 512 blocks, no model) through both packages' schedulers:
the same admission order, refusals and preemptions. Last, chip_smoke's
phase 6 additions and phase 6d at a tiny size on the CPU, with a count
of device->host reads showing that tracing adds none.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.serving as jserving
import paddle_tpu.inference.serving.engine as jengine_mod
import paddle_tpu.inference.serving.scheduler as jsched_mod
import paddle_tpu.models.generation as jgen
from paddle_tpu import obs as jobs
from paddle_tpu.analysis import jaxplan as jjaxplan
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

import paddle_tpu_torch.inference.serving as tserving
import paddle_tpu_torch.inference.serving.engine as tengine_mod
import paddle_tpu_torch.inference.serving.scheduler as tsched_mod
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.analysis import jaxplan as tjaxplan
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.tools import serving_traffic as st
from paddle_tpu_torch.tools.engine_bench import ENGINE_CONFIG, GPT_CONFIG

VOCAB = 97
PACKAGES = {"jax": jserving, "torch": tserving}


@pytest.fixture(scope="module")
def models():
    """The reference test's model (vocab 97, hidden 32, 2 layers, 4
    heads, 48 positions), its weights copied into the port's GPT."""
    paddle.seed(0)
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=48)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**kw), params, device="cpu")


def _align(a, b):
    """Advance the lagging of two itertools counters until both give the
    same next value (counters only advance, so no value repeats)."""
    x, y = next(a), next(b)
    while x < y:
        x = next(a)
    while y < x:
        y = next(b)


@pytest.fixture(autouse=True)
def fresh_counters():
    """Both packages' engine ids and arrival tickets are aligned, so the
    two engines' labels, trace ids and tickets match, and no label
    repeats one the registries already hold."""
    for pair, name in (((jengine_mod, tengine_mod), "_ENGINE_IDS"),
                       ((jsched_mod, tsched_mod), "_arrival_counter")):
        _align(*(getattr(m, name) for m in pair))
    for obs in (jobs, tobs):
        obs.reqtrace.clear()
    yield


def _engine(pkg, models, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("decode_chunk_size", 2)
    jm, tm = models
    if pkg == "jax":
        return jserving.LLMEngine.from_model(jm,
                                             jserving.EngineConfig(**kw))
    return tserving.LLMEngine.from_model(tm, tserving.EngineConfig(**kw),
                                         device="cpu")


def _drain(eng, max_steps=600):
    finish_order = []
    steps = 0
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finish_order.append(out.request_id)
        steps += 1
        assert steps <= max_steps, "engine failed to drain"
    return finish_order


# ------------------------------------------------------------- tenancy
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_tenant_config_validation_and_weights(pkg):
    s = PACKAGES[pkg]
    assert s.TenantConfig("t", priority="latency", weight=2.0) \
        .wfq_weight == pytest.approx(8.0)
    assert s.TenantConfig("t", priority="batch").wfq_weight \
        == pytest.approx(0.25)
    for bad in (dict(priority="realtime"), dict(weight=0.0),
                dict(quota_tokens=0), dict(prefix_share=0.0),
                dict(quota_window_s=0.0)):
        with pytest.raises(ValueError):
            s.TenantConfig("t", **bad)
    assert s.tenancy.PRIORITY_CLASSES == \
        jserving.tenancy.PRIORITY_CLASSES


def test_registry_quota_charge_refund_and_retry_hint():
    hints = []
    for s in (jserving, tserving):
        reg = s.TenantRegistry([s.TenantConfig("q", quota_tokens=30,
                                               quota_window_s=300.0)])
        reg.charge("q", 20, now=100.0, model="m")
        with pytest.raises(s.TenantQuotaExceeded) as ei:
            reg.charge("q", 20, now=150.0, model="m")
        assert isinstance(ei.value, s.EngineOverloaded)
        assert ei.value.tenant == "q" and ei.value.retry_after_s > 0
        hints.append((ei.value.retry_after_s, ei.value.depth,
                      ei.value.limit))
        assert reg.window_spend("q", now=150.0) == 20
        reg.refund("q", 20, model="m")
        reg.charge("q", 20, now=160.0)
        assert reg.window_spend("q", now=460.5) == 0
        assert reg.resolve("default").quota_tokens is None
        with pytest.raises(ValueError):
            reg.resolve("unregistered")
        assert reg.model_spend() == {"q": {"m": 0}}
        hints.append(reg.as_dict())
    assert hints[2:] == hints[:2]
    assert hints[0] == (250.0, 40, 30)


# ----------------------------------------- single-tenant bitwise pins
@pytest.mark.parametrize("sampling_kw", [
    {},
    {"temperature": 0.9, "top_k": 9, "top_p": 0.8},
], ids=["greedy", "stochastic"])
def test_single_tenant_bitwise_identical_to_fcfs(models, sampling_kw):
    """A registry holding only the default tenant changes nothing: the
    port with and without it emits the same tokens in the same finish
    order; greedy, both equal the JAX engine's (stochastic draws differ
    between the packages by design)."""
    rng = np.random.RandomState(3)
    specs = [(rng.randint(0, VOCAB, (int(rng.randint(3, 9)),),
                          dtype=np.int32), int(rng.randint(4, 9)))
             for _ in range(8)]

    def run(pkg, tenants):
        s = PACKAGES[pkg]
        eng = _engine(pkg, models, max_num_seqs=2, tenants=tenants)
        rids = [eng.add_request(p, s.SamplingParams(
                    max_tokens=mt, seed=i, **sampling_kw))
                for i, (p, mt) in enumerate(specs)]
        order = _drain(eng)
        return order, [list(eng.get_request(r).output_ids) for r in rids]

    ref = run("torch", None)
    assert run("torch", tserving.TenantRegistry()) == ref
    if not sampling_kw:
        assert run("jax", jserving.TenantRegistry()) == ref


# ------------------------------------------------------ WFQ admission
def test_wfq_reorders_across_tenants_never_within(models):
    orders = []
    for pkg, s in sorted(PACKAGES.items()):
        reg = s.TenantRegistry([s.TenantConfig("bulk", priority="batch"),
                                s.TenantConfig("fast", priority="latency")])
        eng = _engine(pkg, models, max_num_seqs=1, tenants=reg)
        rng = np.random.RandomState(0)
        bulk = [eng.add_request(
                    rng.randint(0, VOCAB, (8,), dtype=np.int32),
                    s.SamplingParams(max_tokens=4, tenant="bulk"))
                for _ in range(4)]
        fast = [eng.add_request(
                    rng.randint(0, VOCAB, (4,), dtype=np.int32),
                    s.SamplingParams(max_tokens=4, tenant="fast"))
                for _ in range(2)]
        order = _drain(eng)
        assert [r for r in order if r in set(bulk)] == bulk
        assert [r for r in order if r in set(fast)] == fast
        assert order.index(fast[0]) < order.index(bulk[-1])
        orders.append((order, [list(eng.get_request(r).output_ids)
                               for r in bulk + fast]))
    assert orders[1] == orders[0]


def test_deadline_early_reject_is_certain_and_hinted(models):
    got = []
    for pkg, s in sorted(PACKAGES.items()):
        reg = s.TenantRegistry([s.TenantConfig("dl", deadline_slo_s=0.001),
                                s.TenantConfig("bg")])
        eng = _engine(pkg, models, max_num_seqs=1, tenants=reg)
        rng = np.random.RandomState(1)
        for _ in range(4):
            eng.add_request(rng.randint(0, VOCAB, (8,), dtype=np.int32),
                            s.SamplingParams(max_tokens=4, tenant="bg"))
        ok = eng.add_request(rng.randint(0, VOCAB, (4,), dtype=np.int32),
                             s.SamplingParams(max_tokens=2, tenant="dl"))
        eng.scheduler.note_step_seconds(0.5)
        with pytest.raises(s.EngineOverloaded) as ei:
            eng.add_request(rng.randint(0, VOCAB, (4,), dtype=np.int32),
                            s.SamplingParams(max_tokens=2, tenant="dl"))
        assert not isinstance(ei.value, s.TenantQuotaExceeded)
        assert ei.value.retry_after_s > 0
        assert eng.scheduler.deadline_rejects == 1
        got.append((ei.value.retry_after_s, eng.stats.rejected))
        eng.cancel(ok)
        _drain(eng)
    assert got[1] == got[0]


def test_engine_quota_charge_and_refund_on_downstream_reject(models):
    spends = []
    for pkg, s in sorted(PACKAGES.items()):
        reg = s.TenantRegistry([s.TenantConfig("q", quota_tokens=40,
                                               quota_window_s=300.0)])
        eng = _engine(pkg, models, max_num_seqs=1, max_waiting=1,
                      admission_policy="reject", tenants=reg)
        p = np.random.RandomState(2).randint(0, VOCAB, (6,),
                                             dtype=np.int32)
        eng.add_request(p, s.SamplingParams(max_tokens=4, tenant="q"))
        eng.step()
        eng.add_request(p, s.SamplingParams(max_tokens=4, tenant="q"))
        with pytest.raises(s.EngineOverloaded):
            eng.add_request(p, s.SamplingParams(max_tokens=4, tenant="q"))
        assert reg.window_spend("q") == 20
        with pytest.raises(s.TenantQuotaExceeded) as ei:
            eng.add_request(p, s.SamplingParams(max_tokens=25, tenant="q"))
        assert ei.value.retry_after_s is not None
        assert reg.window_spend("q") == 20
        _drain(eng)
        spends.append((reg.window_spend("q"), eng.stats.rejected,
                       eng.stats.completed))
    assert spends[1] == spends[0] == (20, 2, 2)


# ------------------------------------- per-tenant cache reconciliation
def test_two_tenant_churn_reconciles_census_counters_and_gauge(models):
    """200 requests of two-tenant templated churn through a pool small
    enough to force weighted eviction: lifetime counters, live census
    and the per-tenant gauge agree, and equal the JAX engine's."""
    seen = []
    for pkg, s in sorted(PACKAGES.items()):
        reg = s.TenantRegistry([s.TenantConfig("a", prefix_share=3.0),
                                s.TenantConfig("b", prefix_share=1.0)])
        eng = _engine(pkg, models, num_blocks=24, enable_prefix_cache=True,
                      tenants=reg)
        rng = np.random.RandomState(4)
        tpls = {t: rng.randint(0, VOCAB, (8,), dtype=np.int32)
                for t in ("a", "b")}
        for i in range(200):
            t = "a" if i % 2 == 0 else "b"
            sfx = rng.randint(0, VOCAB, (int(rng.randint(2, 5)),),
                              dtype=np.int32)
            eng.add_request(np.concatenate([tpls[t], sfx]),
                            s.SamplingParams(max_tokens=3, tenant=t))
            if i % 4 == 3:
                eng.step()
        _drain(eng, max_steps=2000)
        assert eng.cache.check_integrity()["tenant_drift"] == 0
        idx = eng.cache.prefix_index
        census = idx.tenant_census()
        for t in set(census) | set(idx.tenant_inserted):
            assert idx.tenant_inserted.get(t, 0) \
                - idx.tenant_removed.get(t, 0) == census.get(t, 0)
        stats = eng.cache.prefix_stats()
        assert stats["tenant_blocks"] == idx.tenant_device_blocks()
        for t, n in stats["tenant_blocks"].items():
            assert eng.stats.prefix_tenant_blocks(t) == n
        assert stats["evictions"] > 0, "churn never evicted: vacuous test"
        seen.append((census, dict(idx.tenant_inserted),
                     dict(idx.tenant_removed), stats["evictions"],
                     stats["hits"], eng.stats.as_dict()["generated_tokens"]))
    assert seen[1] == seen[0]


def test_weighted_eviction_charges_the_over_share_tenant_first():
    """The victim comes from the tenant over its prefix share while one
    exists, in both packages; without weights it is the global LRU."""
    picks = []
    for s in (jserving, tserving):
        kw = {} if s is jserving else {"device": "cpu"}
        for weights in (None, {"a": 1.0, "b": 1.0}):
            cache = s.PagedKVCache(1, 1, 4, 12, 2,
                                   enable_prefix_cache=True, **kw)
            cache.set_tenant_weights(weights)
            for sid, tenant, toks in (("x", "b", [1, 2, 3, 4]),
                                      ("y", "a", [5, 6, 7, 8, 9, 10]),
                                      ("z", "a", [11, 12, 13, 14])):
                cache.note_seq_tenant(sid, tenant)
                cache.allocate(sid, len(toks))
                cache.free(sid, cache_tokens=np.asarray(toks, np.int32))
            cache.allocate("w", 2 * 6)       # 6 blocks, 5 free: evicts one
            picks.append((sorted(cache.prefix_index.tenant_census()
                                 .items()),
                          cache.prefix_index.evictions))
            cache.check_integrity()
    assert picks[2:] == picks[:2]
    (plain, _), (weighted, _) = picks[:2]
    assert plain == [("a", 5), ("b", 1)]     # global LRU: b's oldest leaf
    assert weighted == [("a", 4), ("b", 2)]  # a holds 5 of 6 > its half


# ----------------------------------------------- reqtrace FCFS checker
def _evt(seq, tid, kind, **attrs):
    return {"seq": seq, "ts": float(seq), "trace_id": tid,
            "request_id": tid, "kind": kind, "attrs": attrs}


def test_check_causality_intra_tenant_fcfs_fixture():
    legal = {"complete": True, "events": [
        _evt(1, "A1", "engine_admit", engine="e0", arrival=1.0,
             tenant="a"),
        _evt(2, "B1", "engine_admit", engine="e0", arrival=2.0,
             tenant="b"),
        _evt(3, "B1", "scheduled"),
        _evt(4, "A1", "scheduled"),
        _evt(5, "A1", "finish", reason="stop"),
        _evt(6, "B1", "finish", reason="stop"),
    ]}
    violation = {"complete": True, "events": [
        _evt(1, "A1", "engine_admit", engine="e0", arrival=1.0,
             tenant="a"),
        _evt(2, "A2", "engine_admit", engine="e0", arrival=2.0,
             tenant="a"),
        _evt(3, "A2", "scheduled"),
        _evt(4, "A1", "scheduled"),
        _evt(5, "A1", "finish", reason="stop"),
        _evt(6, "A2", "finish", reason="stop"),
    ]}
    assert tobs.reqtrace.check_causality(legal) == []
    out = tobs.reqtrace.check_causality(violation)
    assert any("FCFS" in v and "tenant 'a'" in v for v in out)
    assert out == jobs.reqtrace.check_causality(violation)


def test_check_causality_rejected_is_terminal():
    dump = {"complete": True, "events": [
        _evt(1, "R1", "rejected", reason="quota", tenant="q")]}
    assert tobs.reqtrace.check_causality(dump) == [] == \
        jobs.reqtrace.check_causality(dump)


def test_tenant_traces_carry_the_tag_and_match_jax(models):
    """With a registry every event of a trace carries its tenant (quota
    refusals included), the same events as the JAX engine's; the
    scheduler's backlog (blocks owed, queued re-prefills priced by the
    cost model) equals the JAX scheduler's."""
    timelines = []
    for pkg, s in sorted(PACKAGES.items()):
        obs = jobs if pkg == "jax" else tobs
        reg = s.TenantRegistry([s.TenantConfig("bulk", priority="batch"),
                                s.TenantConfig("q", quota_tokens=15)])
        eng = _engine(pkg, models, max_num_seqs=2, tenants=reg,
                      obs_label="tag", prefill_chunk_threshold=6,
                      prefill_cost_model="auto")
        rng = np.random.RandomState(5)
        for t in ("bulk", "q", "bulk", "q", "q"):
            try:
                eng.add_request(rng.randint(0, VOCAB, (8,), dtype=np.int32),
                                s.SamplingParams(max_tokens=3, tenant=t))
            except s.TenantQuotaExceeded:
                pass
        eng.step()
        backlog = eng.scheduler.backlog()
        assert backlog["prefill_cost"] > 0
        _drain(eng)
        evs = [(e.trace_id, e.kind, {k: v for k, v in e.attrs.items()
                                     if k not in ("ttft_s",
                                                  "retry_after_s")})
               for e in obs.reqtrace.events(prefix="tr-tag-")]
        assert all("tenant" in a for _, _, a in evs)
        assert sum(k == "rejected" for _, k, _ in evs) == 2
        timelines.append((evs, backlog, eng.waiting_by_tenant()))
        assert obs.reqtrace.check_causality(obs.reqtrace.dump_payload(
            "t", trace_ids=sorted({t for t, _, _ in evs}))) == []
    assert timelines[1] == timelines[0]


# ------------------------- phase 6d's traffic, scheduler-only replay
def test_full_width_admission_replay_matches_jax_scheduler():
    """Phase 6d's traffic at the serving bench's width (block 32 over 512
    blocks, 8 rows, chunk 8, threshold 128, the committed cost model,
    the three tenants): the port's and the JAX scheduler take the same
    admission order, refuse the same requests and preempt the same
    number of times; and a registry with one tenant admits in the FCFS
    order of no registry."""
    ecfg = tserving.EngineConfig(**dict(ENGINE_CONFIG, **st.TENANT_ENGINE))
    arrivals = st.tenant_traffic(GPT_CONFIG["vocab_size"], 4)
    jout = st.replay_admissions(
        arrivals, ecfg, jserving, jobs.reqtrace,
        jserving.PagedKVCache(1, 1, 8, ecfg.num_blocks, ecfg.block_size),
        st.make_tenant_registry(jserving),
        jjaxplan.default_admission_model())
    tout = st.replay_admissions(
        arrivals, ecfg, tserving, tobs.reqtrace,
        tserving.PagedKVCache(1, 1, 8, ecfg.num_blocks, ecfg.block_size,
                              device="cpu"),
        st.make_tenant_registry(tserving),
        tjaxplan.default_admission_model())
    assert tout == jout
    assert len(tout["quota"]) >= 1 and len(tout["scheduled"]) == \
        len(arrivals) - len(tout["quota"])
    tenant = {f"req-{n}": arrivals[i][3] for n, i in enumerate(
        sorted(range(len(arrivals)), key=lambda i: arrivals[i][0]))}
    firsts = [tenant[r] for r in tout["scheduled"]]
    # the latency tenant overtakes the queued bulk backlog
    assert firsts.index("latency") < len(firsts) - firsts[::-1].index(
        "bulk") - 1
    # one tenant: WFQ is the FCFS order of no registry
    single = [(s, p, mt, "default") for s, p, mt, _ in arrivals]
    runs = []
    for reg in (None, tserving.TenantRegistry()):
        cache = tserving.PagedKVCache(1, 1, 8, ecfg.num_blocks,
                                      ecfg.block_size, device="cpu")
        runs.append(st.replay_admissions(
            single, ecfg, tserving, tobs.reqtrace, cache, reg,
            tjaxplan.default_admission_model()))
    assert runs[1] == runs[0]


# ------------------------------------ chip_smoke rehearsals on the CPU
TINY_TENANTS = (dict(name="latency", priority="latency"),
                dict(name="bulk", priority="batch"),
                dict(name="burst", quota_tokens=70, quota_window_s=300.0))


@pytest.fixture
def tiny(monkeypatch):
    import chip_smoke
    threads = torch.get_num_threads()
    torch.set_num_threads(2)                 # more thrash on these tiny ops
    monkeypatch.setattr(st, "TENANTS", TINY_TENANTS)
    monkeypatch.setattr(chip_smoke, "TENANT_TRAFFIC", dict(
        n=16, b_lo=40, b_hi=55, l_lo=4, l_hi=8, template_len=24, s_lo=2,
        s_hi=4, t_lo=4, t_hi=6))
    monkeypatch.setattr(chip_smoke, "FACADE", dict(n=4, p_lo=8, p_hi=30,
                                                   max_tokens=6))
    model = GPT(GPTConfig(vocab_size=101, hidden_size=32, num_layers=2,
                          num_heads=2, max_seq_len=128), device="cpu")
    ecfg = tserving.EngineConfig(block_size=4, num_blocks=128,
                                 max_num_seqs=4, decode_chunk_size=2,
                                 prefill_chunk_threshold=16)
    yield chip_smoke, model, ecfg
    torch.set_num_threads(threads)


def test_chip_smoke_tenant_and_facade_phases_run_on_cpu(tiny):
    """Phases 6d and 6e at a tiny size with every gate live (K3's
    wrapper runs its plain version here and counts no launch)."""
    chip_smoke, model, ecfg = tiny
    assert chip_smoke.run_tenant_pass(model, ecfg, torch.device("cpu"),
                                      0) == 0
    chip_smoke.run_facade(model, ecfg, torch.device("cpu"), 0)


# the Tensor methods that read a device tensor's value on the host
READS = ("item", "cpu", "tolist", "__float__", "__int__", "__bool__",
         "__index__")


def _count_reads(mp):
    """Count calls of READS through `mp` (a pytest MonkeyPatch)."""
    counts = {"n": 0}
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            counts["n"] += 1
            return _orig(self, *a, **k)
        mp.setattr(torch.Tensor, name, wrapped)
    return counts


def test_phase6_tracing_adds_no_device_read(tiny):
    """Phase 6's TTFT check and tracing-off pass at a tiny size; the
    same traffic with request tracing on and off makes the same number
    of host reads of tensor values, equal to the host syncs the stats
    count (one per prefill, one per decode chunk): the instrumentation
    adds none."""
    chip_smoke, model, ecfg = tiny
    specs = st.bench_traffic(101, 0, n_req=5, p_lo=4, p_hi=24, t_lo=4,
                             t_hi=20)
    reads = []
    for on in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            counts = _count_reads(mp)
            (tobs.reqtrace.enable if on else tobs.reqtrace.disable)()
            try:
                eng, rids = st.drive_engine(model, ecfg, specs, "cpu")
            finally:
                tobs.reqtrace.enable()
        syncs = eng.stats.host_syncs
        reads.append((counts["n"], syncs["prefill"] + syncs["decode"]))
    assert reads[0] == reads[1] and reads[0][0] == reads[0][1] > 0
    ttft = np.array([eng.get_request(r).first_token_time
                     - eng.get_request(r).arrival_time for r in rids])
    chip_smoke.check_registry_ttft(eng, ttft)
    chip_smoke.tracing_off(model, ecfg, specs, "cpu", 1.0)

"""The port's obs package (registry, spans, exporters) and the
registry-backed EngineStats against paddle_tpu.obs, on the CPU.

Each registry, export and span test makes the same calls on the JAX
package's obs and the port's and holds both to the reference's own
assertions (tests/test_observability.py) and to each other: the same
values, quantiles, buckets, snapshots and Prometheus text. The engine
tests run the same traffic through a JAX engine and a port engine (the
same weights) and compare what the two registries hold: EngineStats.
as_dict() is equal but for the wall-clock entries, and so are the
histogram counts and block gauges.
"""
import json
import math
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
from paddle_tpu import obs as jobs
from paddle_tpu.inference.serving import (EngineConfig as JEngineConfig,
                                          LLMEngine as JLLMEngine,
                                          SamplingParams as JSamplingParams)
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.inference.serving import (EngineConfig, LLMEngine,
                                                SamplingParams)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

PACKAGES = {"jax": jobs, "torch": tobs}


def _both(fn):
    """fn(obs) in both packages; returns (jax result, port result)."""
    return fn(jobs), fn(tobs)


# ------------------------------------------------------------- registry
def _counter(obs):
    reg = obs.registry.MetricRegistry()
    c = reg.counter("c_total")
    c.inc()
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1)
    return c.value


def test_counter_monotonic_and_negative_rejected():
    j, t = _both(_counter)
    assert j == t == 3.5


def _gauge(obs):
    g = obs.registry.MetricRegistry().gauge("g")
    g.set(4)
    g.inc(2)
    g.dec(5)
    return g.value


def test_gauge_set_inc_dec():
    j, t = _both(_gauge)
    assert j == t == 1.0


def test_histogram_quantiles_exact_vs_numpy():
    xs = np.random.RandomState(0).lognormal(mean=-4.0, sigma=1.5,
                                            size=1000)

    def run(obs):
        h = obs.registry.MetricRegistry().histogram("h_seconds")
        for x in xs:
            h.observe(x)
        child = h.labels()
        return ([h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
                child.count, child.sum, child.buckets())

    j, t = _both(run)
    assert t == j
    assert t[0] == [float(np.quantile(xs, q))
                    for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
    assert t[1] == 1000 and t[2] == pytest.approx(float(xs.sum()))
    for bound, cum in t[3].items():
        assert cum == int((xs <= bound).sum())


def test_histogram_window_rolls_past_cap():
    def run(obs):
        h = obs.registry.MetricRegistry().histogram("h2", sample_cap=100)
        for v in range(200):
            h.observe(float(v))
        return h.labels().count, h.labels().sum, h.quantile(0.0), \
            h.quantile(1.0)

    j, t = _both(run)
    assert t == j == (200, sum(range(200)), 100.0, 199.0)


def test_histogram_empty_quantile_nan_and_bad_bounds():
    for obs in PACKAGES.values():
        reg = obs.registry.MetricRegistry()
        h = reg.histogram("h3")
        assert math.isnan(h.quantile(0.5))
        with pytest.raises(ValueError):
            h.quantile(1.5)
        with pytest.raises(ValueError):
            reg.histogram("h4", buckets=(1.0, 0.5))
    assert tobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS


def test_label_isolation_and_get_never_creates():
    def run(obs):
        fam = obs.registry.MetricRegistry().counter(
            "events_total", labels=("engine", "event"))
        fam.labels(engine="a", event="steps").inc(3)
        fam.labels(engine="b", event="steps").inc(5)
        assert fam.get(engine="c", event="steps") is None
        with pytest.raises(ValueError):
            fam.labels(engine="a")
        with pytest.raises(ValueError):
            fam.inc()
        return (fam.labels(engine="a", event="steps").value,
                fam.labels(engine="b", event="steps").value,
                len(fam.children()))

    j, t = _both(run)
    assert t == j == (3, 5, 2)


def test_redeclare_idempotent_but_shape_mismatch_raises():
    for obs in PACKAGES.values():
        reg = obs.registry.MetricRegistry()
        a = reg.counter("x_total", labels=("k",))
        assert reg.counter("x_total", labels=("k",)) is a
        with pytest.raises(ValueError):
            reg.gauge("x_total", labels=("k",))
        with pytest.raises(ValueError):
            reg.counter("x_total", labels=("other",))


def test_thread_safety_concurrent_recording():
    n_threads, n_iter = 8, 2000

    def run(obs):
        reg = obs.registry.MetricRegistry()
        c = reg.counter("c_total")
        h = reg.histogram("h_seconds", sample_cap=100_000)

        def work():
            for i in range(n_iter):
                c.inc()
                h.observe(i * 1e-4)

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return c.value, h.labels().count, len(h.labels()._samples)

    j, t = _both(run)
    assert t == j == (n_threads * n_iter,) * 3


# ------------------------------------------------------------- exporters
def _sample_registry(obs):
    reg = obs.registry.MetricRegistry()
    reg.counter("req_total", help="requests", labels=("engine",)) \
       .labels(engine="e0").inc(7)
    reg.gauge("depth").set(3)
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0, float("inf")))
    for v in (0.05, 0.5, 2.0, 0.07):
        h.observe(v)
    return reg


def test_snapshot_json_round_trip(tmp_path):
    def run(obs):
        p = tmp_path / f"snap-{obs.__name__}.json"
        obs.dump_snapshot(str(p), _sample_registry(obs))
        return json.loads(p.read_text())["metrics"]

    j, t = _both(run)
    assert t == j
    by_name = {m["name"]: m for m in t}
    assert by_name["req_total"]["series"][0] == {
        "labels": {"engine": "e0"}, "value": 7.0}
    hist = by_name["lat_seconds"]["series"][0]
    assert hist["count"] == 4
    assert hist["buckets"] == {"0.1": 2, "1.0": 3, "+Inf": 4}
    assert hist["p50"] == float(np.quantile([0.05, 0.5, 2.0, 0.07], 0.5))


def test_prometheus_text_shape():
    j, t = _both(lambda obs: obs.to_prometheus(_sample_registry(obs)))
    assert t == j
    lines = t.splitlines()
    assert "# TYPE req_total counter" in lines
    assert 'req_total{engine="e0"} 7.0' in lines
    assert "# TYPE lat_seconds histogram" in lines
    assert 'lat_seconds_bucket{le="0.1"} 2' in lines
    assert 'lat_seconds_bucket{le="1.0"} 3' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 4' in lines
    assert "lat_seconds_count 4" in lines
    assert any(line.startswith("lat_seconds_sum ") for line in lines)


def test_snapshot_exporter_writes_file(tmp_path):
    def run(obs):
        p = tmp_path / f"periodic-{obs.__name__}.json"
        with obs.SnapshotExporter(str(p), interval_s=60.0,
                                  registry=_sample_registry(obs)):
            pass                              # stop() writes a final snap
        return sorted(m["name"] for m in json.loads(p.read_text())
                      ["metrics"])

    j, t = _both(run)
    assert t == j and "req_total" in t


def _chrome(obs, tmp_path):
    obs.trace.clear()
    obs.trace.enable()
    try:
        with obs.span("outer", cat="checkpoint", annotate=False):
            with obs.span("inner", annotate=False, args={"kind": "full"}):
                pass
    finally:
        obs.trace.disable()
    p = tmp_path / f"trace-{obs.__name__}.json"
    obs.export_chrome_trace(str(p))
    evs = json.loads(p.read_text())["traceEvents"]
    return {e["name"]: e for e in evs if e["ph"] == "X"}, \
        {e.name: e.depth for e in obs.trace.events()}


def test_chrome_trace_categories_and_nesting(tmp_path):
    (jx, jdepth), (tx, tdepth) = _chrome(jobs, tmp_path), \
        _chrome(tobs, tmp_path)
    assert tdepth == jdepth == {"outer": 0, "inner": 1}
    for by_name in (jx, tx):
        assert by_name["outer"]["cat"] == "checkpoint"
        assert by_name["inner"]["cat"] == "op"
        assert by_name["inner"]["args"] == {"kind": "full"}
        assert by_name["outer"]["ts"] <= by_name["inner"]["ts"]
        assert (by_name["inner"]["ts"] + by_name["inner"]["dur"]
                <= by_name["outer"]["ts"] + by_name["outer"]["dur"] + 1e-3)
    assert tobs.CATEGORIES == jobs.CATEGORIES


def test_span_annotates_a_torch_profiler_range():
    """An enabled span with annotate=True is a record_function range
    under torch.profiler (the reference's jax.profiler annotation)."""
    tobs.trace.clear()
    tobs.trace.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tobs.span("port-annotated", cat="decode"):
                torch.ones(4).sum()
    finally:
        tobs.trace.disable()
    assert any(e.key == "port-annotated" for e in prof.key_averages())
    assert [e.name for e in tobs.trace.events()] == ["port-annotated"]


def test_gauge_history_and_chrome_counter_track(tmp_path):
    def run(obs):
        reg = obs.registry.MetricRegistry()
        g = reg.gauge("serving_waiting", labels=("engine",)) \
               .labels(engine="e-0")
        g.set(2.0)                           # before enable(): clipped
        obs.trace.clear()
        obs.trace.enable()
        try:
            with obs.span("step", cat="decode", annotate=False):
                g.set(5.0)
                g.inc(1.0)
                g.dec(2.0)
        finally:
            obs.trace.disable()
        values = [v for _, v in g.samples()]
        ts = [t for t, _ in g.samples()]
        assert ts == sorted(ts)
        p = tmp_path / f"gauge-{obs.__name__}.json"
        obs.export_chrome_trace(str(p), registry=reg)
        evs = json.loads(p.read_text())["traceEvents"]
        counters = [e for e in evs if e["ph"] == "C"]
        assert all(e["name"] == "serving_waiting{engine=e-0}"
                   and e["ts"] >= 0 for e in counters)
        assert any(e["ph"] == "X" and e["name"] == "step" for e in evs)
        cap = obs.registry.GAUGE_HISTORY_CAP
        for i in range(cap + 10):
            g.set(float(i))
        return values, [e["args"]["value"] for e in counters], \
            len(g.samples()), cap

    j, t = _both(run)
    assert t == j
    assert t[0] == [2.0, 5.0, 6.0, 4.0] and t[1] == [5.0, 6.0, 4.0]
    assert t[2] == t[3] == 512


def test_roofline_publish_and_read():
    j, t = _both(lambda obs: (obs.set_roofline("test_prog", 1234.5),
                              obs.get_roofline("test_prog"),
                              obs.get_roofline("never_published")))
    assert t == j == (None, 1234.5, None)


# ----------------------------------------------------- engine step metrics
GEOM_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
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
    jm = JGPT(JGPTConfig(**GEOM_KW))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**GEOM_KW), params,
                                   device="cpu")


ECFG = dict(block_size=4, num_blocks=16, max_num_seqs=4,
            obs_label="obs-test")
# EngineStats.as_dict() entries that are wall-clock readings
TIMES = ("time_schedule", "time_prefill", "time_decode", "ttft_sum",
         "latency_sum", "avg_ttft_s", "avg_request_latency_s",
         "decode_tokens_per_sec")


def _engines(models, **kw):
    jm, tm = models
    cfg = dict(ECFG, **kw)
    return (JLLMEngine.from_model(jm, JEngineConfig(**cfg)),
            LLMEngine.from_model(tm, EngineConfig(**cfg), device="cpu"))


def _drive(models, n_req=3, **kw):
    jeng, teng = _engines(models, **kw)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, (5,)).astype(np.int32)
               for _ in range(n_req)]
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        for p in prompts:
            eng.add_request(p, sp(max_tokens=4))
        eng.run()
    return jeng, teng


def _series(obs, family, **labels):
    return obs.REGISTRY.get(family).get(**labels)


def test_engine_ttft_once_per_request_and_block_gauges(models):
    jeng, teng = _drive(models)
    for obs, eng in ((jobs, jeng), (tobs, teng)):
        label = eng.stats.label
        d = eng.stats.as_dict()
        assert d["completed"] == 3
        ttft = _series(obs, "serving_ttft_seconds", engine=label)
        assert ttft is not None and ttft.count == 3
        assert _series(obs, "serving_token_gap_seconds",
                       engine=label).count == d["generated_tokens"] - 3
        assert _series(obs, "serving_request_latency_seconds",
                       engine=label).count == 3
        assert _series(obs, "serving_step_seconds",
                       engine=label).count == d["steps"] > 0
        assert eng.stats.ttft_quantile(0.5) == ttft.quantile(0.5) > 0
        assert eng.cache.check_integrity()["leaked"] == 0
        blocks = obs.REGISTRY.get("serving_cache_blocks")
        assert blocks.get(engine=label, state="used").value \
            == eng.cache.num_used() == 0
        assert blocks.get(engine=label, state="free").value \
            == eng.cache.num_free()
        assert _series(obs, "serving_running", engine=label).value == 0
        assert _series(obs, "serving_waiting", engine=label).value == 0
    jd, td = jeng.stats.as_dict(), teng.stats.as_dict()
    assert set(td) == set(jd)
    assert {k: v for k, v in td.items() if k not in TIMES} == \
        {k: v for k, v in jd.items() if k not in TIMES}


@pytest.mark.parametrize("kw", [
    dict(decode_chunk_size=2),
    dict(decode_chunk_size=4, num_blocks=8, prefill_chunk_threshold=4),
    dict(decode_chunk_size=2, enable_prefix_cache=True),
], ids=["chunk2", "chunked-preempt", "prefix"])
def test_engine_stats_as_dict_matches_jax(models, kw):
    """On the same traffic (preemption and chunked prefill included) the
    two engines' registries agree: as_dict() but for wall-clock entries,
    host syncs, prefill chunks, and the prefix-cache families."""
    jeng, teng = _drive(models, n_req=6, **kw)
    jd, td = jeng.stats.as_dict(), teng.stats.as_dict()
    assert {k: v for k, v in td.items() if k not in TIMES} == \
        {k: v for k, v in jd.items() if k not in TIMES}
    for phase in ("prefill", "decode"):
        assert teng.stats.host_syncs(phase) == jeng.stats.host_syncs(phase)
    assert teng.stats.prefill_chunks() == jeng.stats.prefill_chunks()
    assert teng.stats.host_syncs_per_token() == \
        jeng.stats.host_syncs_per_token()
    for kind in ("hits", "misses", "evictions"):
        assert teng.stats.prefix_counter(kind) == \
            jeng.stats.prefix_counter(kind)
    for fam in ("serving_decode_chunk_seconds", "serving_step_seconds",
                "serving_token_gap_seconds"):
        assert _series(tobs, fam, engine=teng.stats.label).count == \
            _series(jobs, fam, engine=jeng.stats.label).count


def test_engine_labels_never_merge(models):
    _, tm = models
    eng_a = LLMEngine.from_model(tm, EngineConfig(**ECFG), device="cpu")
    eng_b = LLMEngine.from_model(tm, EngineConfig(**ECFG), device="cpu")
    assert eng_a.stats.label != eng_b.stats.label
    assert eng_a.stats.label.startswith("obs-test-")
    eng_a.stats.steps += 1
    fam = tobs.REGISTRY.get("serving_events_total")
    assert fam.labels(engine=eng_a.stats.label, event="steps").value == 1
    assert fam.labels(engine=eng_b.stats.label, event="steps").value == 0


def test_stats_thin_view_round_trip(models):
    _, tm = models
    s = LLMEngine.from_model(tm, EngineConfig(**ECFG), device="cpu").stats
    s.prefill_tokens += 7
    s.time_decode += 0.25
    assert s.prefill_tokens == 7
    assert s.time_decode == pytest.approx(0.25)
    with pytest.raises(ValueError):
        s.steps -= 1                          # counters never go down
    d = s.as_dict()
    assert d["prefill_tokens"] == 7 and isinstance(d["prefill_tokens"], int)
    s.inc_host_sync("decode")
    assert (s.host_syncs("prefill"), s.host_syncs("decode")) == (0, 1)

"""Disaggregated prefill/decode serving and live KV-block migration of the
port against the JAX package's, on the CPU: twins of
tests/test_serving_disagg.py, of the peer prefix fetch cases of
tests/test_serving_tiered.py, of the prefix-affinity case of
tests/test_serving_prefix.py and of the int8 peer export of
tests/test_serving_kv_quant.py.

Each case runs one scenario on both packages (the port's GPT holds the
JAX weights; the same configs, prompts and step sequence) and compares
tokens, homes, FCFS tickets, migration and prefix-fetch counters,
prefix statistics and audits; the JAX test's own invariants are then
asserted on the port. The chaos case compares the port's
`paddle_tpu_torch.tools.chaos_serve.run_chaos_disagg` report with the
JAX harness's.
"""
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(seq):
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=seq)
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**kw), params, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _pair(48)          # test_serving_disagg.py's model


@pytest.fixture(scope="module")
def models64():
    return _pair(64)          # test_serving_tiered.py's and _prefix.py's


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
        kw.setdefault("num_blocks", 32)
        kw.setdefault("max_num_seqs", 4)
        kw.setdefault("decode_chunk_size", 2)
        return self.s.EngineConfig(**kw)

    def router(self, n=2, roles=None, ecfg=None, **rkw):
        rkw.setdefault("backoff_base", 0.01)
        rkw.setdefault("backoff_max", 0.05)
        rkw.setdefault("backoff_jitter", 0.0)
        return self.s.ReplicaSet.from_model(
            self.model, self.s.RouterConfig(num_replicas=n, roles=roles,
                                            **rkw),
            engine_config=ecfg or self.ecfg(), faults=self.Faults(""))

    def engine(self, **kw):
        if self.port:
            return self.s.LLMEngine.from_model(
                self.model, self.s.EngineConfig(**kw), device="cpu")
        return self.s.LLMEngine.from_model(self.model,
                                           self.s.EngineConfig(**kw))

    def sp(self, **kw):
        return self.s.SamplingParams(**kw)


def _twin(pair, scenario):
    """scenario(pkg) -> (router, comparable result); both packages' results
    must be equal. Returns the port's."""
    jm, tm = pair
    got_rs, got = scenario(Pkg(True, tm))
    _, want = scenario(Pkg(False, jm))
    assert got == want
    return got_rs, got


def _prompts(n, seed=7, lo=6, hi=14):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(rng.randint(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _run(pkg, rs, prompts, max_tokens=12, max_steps=400):
    rids = [rs.add_request(p, pkg.sp(max_tokens=max_tokens))
            for p in prompts]
    steps = 0
    while rs.has_unfinished():
        rs.step()
        steps += 1
        assert steps <= max_steps, "router failed to drain"
    return rids


def _tokens(rs, rids):
    return [list(rs.get_request(r).tokens) for r in rids]


def _assert_clean(rs):
    for idx, audit in rs.check_integrity().items():
        assert audit is not None, f"replica {idx} has no live engine"
        for k, v in audit.items():
            if isinstance(v, int):
                assert v == 0, (idx, k, audit)


def _mig(rs):
    st = rs.migrator.stats()
    return {k: st[k] for k in ("migrations", "aborted", "rolled_back",
                               "revision_refused", "bytes_moved",
                               "prefix_fetches", "prefix_aborted",
                               "prefix_bytes")}


# ------------------------------------------------------- role plumbing
def test_roles_validation(models):
    def scenario(pkg):
        for roles in (("prefill",), ("prefill", "turbo"),
                      ("prefill", "prefill")):
            with pytest.raises(ValueError):
                pkg.router(n=2, roles=roles)
        rs = pkg.router(n=2, roles=("prefill", "decode"))
        rs2 = pkg.router(n=2)
        return rs, ([r.role for r in rs.replicas],
                    [r.role for r in rs2.replicas])

    assert _twin(models, scenario)[1] == (["prefill", "decode"],
                                          ["mixed", "mixed"])


# ------------------------------------------------ handoff: bitwise pin
def test_handoff_bitwise_and_integrity(models):
    prompts = _prompts(5)

    def scenario(pkg):
        base_rs = pkg.router(n=2)
        base = _tokens(base_rs, _run(pkg, base_rs, prompts))
        tiered = pkg.router(n=2, roles=("prefill", "decode"))
        rids = _run(pkg, tiered, prompts)
        _assert_clean(tiered)
        return tiered, (base, _tokens(tiered, rids), _mig(tiered),
                        [tiered.get_request(r).replica for r in rids])

    _, (base, toks, mig, homes) = _twin(models, scenario)
    assert mig["migrations"] == len(prompts)
    assert homes == [1] * len(prompts)
    assert toks == base


def test_handoff_preserves_fcfs_arrival_ticket(models):
    def scenario(pkg):
        tiered = pkg.router(n=2, roles=("prefill", "decode"))
        rids = _run(pkg, tiered, _prompts(4, seed=11))
        arrivals = [tiered.get_request(r).arrival for r in rids]
        return tiered, (_mig(tiered)["migrations"],
                        [a - arrivals[0] for a in arrivals])

    _, (migrations, arrivals) = _twin(models, scenario)
    assert migrations == 4 and arrivals == sorted(arrivals)


# ---------------------------- shared prefix: copied, never stolen
def test_migration_copies_shared_prefix_blocks(models):
    tpl = np.arange(1, 17, dtype=np.int32)
    leader = np.concatenate([tpl, np.array([40, 41, 42], np.int32)])
    follower = np.concatenate([tpl, np.array([50, 51], np.int32)])

    def scenario(pkg):
        ref = pkg.router(n=2, roles=("prefill", "decode"))
        ref_toks = _tokens(ref, _run(pkg, ref, [leader, follower]))
        rs = pkg.router(n=2, roles=("prefill", "decode"),
                        ecfg=pkg.ecfg(enable_prefix_cache=True))
        r0 = rs.add_request(leader, pkg.sp(max_tokens=12))
        steps = 0
        while rs.migrator.stats()["migrations"] < 1:
            rs.step()
            steps += 1
            assert steps <= 50, "leader never handed off"
        r1 = rs.add_request(follower, pkg.sp(max_tokens=12))
        while rs.has_unfinished():
            rs.step()
            steps += 1
            assert steps <= 400
        _assert_clean(rs)
        src = rs.replicas[0].engine.cache.prefix_stats()
        dst = rs.replicas[1].engine.cache.prefix_stats()
        keys = ("hits", "misses", "cached_blocks", "evictable_blocks",
                "cached_tokens_total", "prompt_tokens_total")
        return rs, (ref_toks, _tokens(rs, [r0, r1]), _mig(rs),
                    {k: src[k] for k in keys}, {k: dst[k] for k in keys})

    _, (ref_toks, toks, mig, src, dst) = _twin(models, scenario)
    assert src["hits"] >= 1 and dst["evictable_blocks"] > 0
    assert mig["migrations"] == 2
    assert toks == ref_toks


# ------------------------------------------------- rebalance: bitwise
def test_rebalance_moves_cold_requests_bitwise(models):
    prompts = _prompts(4, seed=3, lo=10, hi=14)

    def scenario(pkg):
        base_rs = pkg.router(n=2)
        base = _tokens(base_rs, _run(pkg, base_rs, prompts, max_tokens=16))
        skew = pkg.router(n=2, roles=("mixed", "decode"))
        rids = [skew.add_request(p, pkg.sp(max_tokens=16))
                for p in prompts]
        for _ in range(3):
            skew.step()
        occ0 = 1 - (skew.replicas[0].load_info()["free_blocks"]
                    / skew.replicas[0].engine.cache.num_blocks)
        moved = skew.rebalance(watermark=0.3)
        homes = [skew.get_request(r).replica for r in rids]
        steps = 0
        while skew.has_unfinished():
            skew.step()
            steps += 1
            assert steps <= 400
        _assert_clean(skew)
        return skew, (base, _tokens(skew, rids), occ0, moved, homes,
                      _mig(skew))

    _, (base, toks, occ0, moved, _, mig) = _twin(models, scenario)
    assert occ0 > 0.3 and moved >= 1 and mig["migrations"] == moved
    assert toks == base


def test_rebalance_noop_below_watermark(models):
    def scenario(pkg):
        rs = pkg.router(n=2)
        _run(pkg, rs, _prompts(3))
        with pytest.raises(ValueError):
            rs.rebalance(watermark=0.0)
        return rs, rs.rebalance(watermark=0.95)

    assert _twin(models, scenario)[1] == 0


# --------------------------------------- drain without recomputation
def test_drain_evacuates_with_zero_reprefill(models):
    prompts = _prompts(3, seed=5, lo=8, hi=12)

    def scenario(pkg):
        base_rs = pkg.router(n=2)
        base = _tokens(base_rs, _run(pkg, base_rs, prompts, max_tokens=16))
        rs = pkg.router(n=2)
        rids = [rs.add_request(p, pkg.sp(max_tokens=16)) for p in prompts]
        for _ in range(2):
            rs.step()

        def prefill_spend():
            return sum(r.engine.stats.as_dict()["prefill_tokens"]
                       + r.engine.stats.prefill_chunks()
                       for r in rs.replicas if r.engine is not None)

        spent = prefill_spend()
        rs.drain(0, recompute=False)
        steps = 0
        while rs.has_unfinished():
            rs.step()
            steps += 1
            assert steps <= 400
        _assert_clean(rs)
        return rs, (base, _tokens(rs, rids), spent, prefill_spend(),
                    _mig(rs), str(rs.states()[0]))

    _, (base, toks, spent, after, mig, state) = _twin(models, scenario)
    assert after == spent and mig["migrations"] >= 1
    assert state == "drained" and toks == base


# ------------------------------------------------ reqtrace invariants
def test_migrate_trace_events_pair_and_check_clean(models):
    def scenario(pkg):
        pkg.obs.reqtrace.enable()
        rs = pkg.router(n=2, roles=("prefill", "decode"))
        _run(pkg, rs, _prompts(3, seed=9))
        prefix = f"tr-{rs.label}-"
        ids = sorted(pkg.obs.reqtrace.traces(prefix=prefix))
        dump = pkg.obs.reqtrace.dump_payload("test", trace_ids=ids,
                                             complete=True)
        by_trace = {}
        for e in dump["events"]:
            by_trace.setdefault(e["trace_id"][len(prefix):], []).append(e)
        pairs = {}
        for tid, evts in by_trace.items():
            o = [e["attrs"] for e in evts if e["kind"] == "migrate_out"]
            i = [e["attrs"] for e in evts if e["kind"] == "migrate_in"]
            pairs[tid] = (len(o), len(i), o[0]["to_replica"],
                          i[0]["replica"], i[0]["from_replica"],
                          o[0]["replica"], o[0]["arrival"] - i[0]["arrival"],
                          o[0]["blocks"], i[0]["blocks"], o[0]["bytes"],
                          i[0]["bytes"], i[0]["prefilled"])
        return rs, (pairs, pkg.obs.reqtrace.check_causality(dump))

    _, (pairs, violations) = _twin(models, scenario)
    assert violations == [] and len(pairs) == 3
    for n_out, n_in, to, at, frm, src, d_arr, b_o, b_i, y_o, y_i, pf \
            in pairs.values():
        assert (n_out, n_in) == (1, 1)
        assert to == at and frm == src and d_arr == 0
        assert b_o == b_i and y_o == y_i and pf is True


def test_checker_flags_migrate_violations():
    cases = {
        "migrate_out": [("engine_admit", dict(engine="e-0", arrival=0)),
                        ("scheduled", dict(arrival=0)), ("prefill", {}),
                        ("migrate_in", dict(replica=1, from_replica=0,
                                            engine="e-1", arrival=0,
                                            prefilled=True)),
                        ("finish", dict(reason="stop"))],
        "source replica": [
            ("engine_admit", dict(engine="e-0", arrival=0)),
            ("scheduled", dict(arrival=0)), ("prefill", {}),
            ("migrate_out", dict(replica=0, to_replica=1, arrival=0)),
            ("migrate_in", dict(replica=1, from_replica=2, engine="e-1",
                                arrival=0, prefilled=True)),
            ("finish", dict(reason="stop"))],
        "prefill": [("engine_admit", dict(engine="e-0", arrival=0)),
                    ("scheduled", dict(arrival=0)), ("prefill", {}),
                    ("migrate_out", dict(replica=0, to_replica=1,
                                         arrival=0)),
                    ("first_token", {}),
                    ("migrate_in", dict(replica=1, from_replica=0,
                                        engine="e-1", arrival=0,
                                        prefilled=True)),
                    ("finish", dict(reason="stop"))],
    }
    for want, events in cases.items():
        got = []
        for ob in (obs, jobs):
            ring = ob.reqtrace.ReqTraceRing()
            for kind, attrs in events:
                ring.record(kind, "tM", **attrs)
            bad = {"version": 1, "complete": True,
                   "events": [e.as_dict() for e in ring.events()]}
            got.append(ob.reqtrace.check_causality(bad))
        assert got[0] == got[1]
        assert any(want in v for v in got[0]), (want, got[0])


# ------------------------------------------- chaos: kill mid-migration
@pytest.mark.chaos
def test_chaos_kill_mid_migration(models):
    import tools.chaos_serve as jcs
    from paddle_tpu_torch.tools import chaos_serve as cs
    got = cs.run_chaos_disagg(seed=0, n_requests=10, model=models[1])
    assert got["migrations"]["rolled_back"] >= 1
    assert got["migrations"]["migrations"] >= 1
    assert got["survivors"] == 10
    want = jcs.run_chaos_disagg(seed=0, n_requests=10)
    for key in ("fired", "migrations", "requeues", "finish_reasons",
                "replica_states", "survivors", "integrity"):
        assert got[key] == want[key], key


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [1, 2])
def test_chaos_kill_mid_migration_more_seeds(models, seed):
    """The JAX test's other seeds, on the port alone (the JAX harness at
    these seeds runs only in its slow set)."""
    from paddle_tpu_torch.tools import chaos_serve as cs
    rep = cs.run_chaos_disagg(seed=seed, n_requests=10, model=models[1])
    assert rep["migrations"]["rolled_back"] >= 1
    assert rep["survivors"] == 10


# ---------------------------------------------------- peer prefix fetch
def _fleet(pkg, num_replicas=2, **ekw):
    ekw.setdefault("block_size", 4)
    ekw.setdefault("num_blocks", 32)
    ekw.setdefault("max_num_seqs", 4)
    ekw.setdefault("decode_chunk_size", 4)
    ekw.setdefault("enable_prefix_cache", True)
    ekw.setdefault("host_tier_blocks", 32)
    return pkg.s.ReplicaSet.from_model(
        pkg.model, pkg.s.RouterConfig(
            num_replicas=num_replicas, balance="round_robin",
            peer_prefix_fetch=True, backoff_base=0.01, backoff_max=0.05,
            backoff_jitter=0.0),
        engine_config=pkg.s.EngineConfig(**ekw))


def _drain(x, max_steps=600):
    steps = 0
    while x.has_unfinished():
        x.step()
        steps += 1
        assert steps <= max_steps


def test_peer_fetch_fills_cold_replica_bitwise(models64):
    def scenario(pkg):
        pkg.obs.reqtrace.clear()
        pkg.obs.reqtrace.enable()
        rng = np.random.RandomState(7)
        tpl = rng.randint(1, VOCAB, (24,), dtype=np.int32)
        leader = np.concatenate([tpl, rng.randint(1, VOCAB, (4,),
                                                  dtype=np.int32)])
        follower = np.concatenate([tpl, rng.randint(1, VOCAB, (4,),
                                                    dtype=np.int32)])
        params = pkg.sp(max_tokens=6)
        rs = _fleet(pkg)
        r0 = rs.add_request(leader, params)
        _drain(rs)
        r1 = rs.add_request(follower, params)
        _drain(rs)
        off = pkg.engine(block_size=4, num_blocks=32, max_num_seqs=4,
                         decode_chunk_size=4)
        out_off = []
        for p in (leader, follower):
            r = off.add_request(p, params)
            _drain(off)
            out_off.append([int(t) for t in off.get_request(r).output_ids])
        for audit in rs.check_integrity().values():
            assert audit is None or (audit["leaked"] == 0
                                     and audit["host_leaked"] == 0)
        kinds = {e.kind for e in pkg.obs.reqtrace.events()}
        return rs, (_mig(rs), [rs.get_request(r).replica for r in (r0, r1)],
                    _tokens(rs, [r0, r1]), out_off, "peer_fetch" in kinds)

    _, (mig, homes, toks, out_off, fetched) = _twin(models64, scenario)
    assert mig["prefix_fetches"] >= 1 and mig["prefix_aborted"] == 0
    assert mig["prefix_bytes"] > 0 and sorted(homes) == [0, 1]
    assert toks == out_off and fetched


def test_peer_fetch_aborts_atomically(models64):
    def scenario(pkg):
        rng = np.random.RandomState(8)
        tpl = rng.randint(1, VOCAB, (24,), dtype=np.int32)
        params = pkg.sp(max_tokens=4)
        rs = _fleet(pkg, num_blocks=16)
        src, dst = rs.replicas[0], rs.replicas[1]
        src.engine.add_request(tpl, params)
        _drain(src.engine)
        snap = src.export_prefix(tpl)
        n_blocks = len(snap["blocks"])
        free_before = dst.engine.cache.num_free()
        payload0, _digest0 = snap["blocks"][0]
        payload0[0][0].flat[0] += 1.0              # layer-0 K, one value
        with pytest.raises(ValueError):
            dst.admit_prefix(tpl, snap["blocks"])
        untouched = dst.engine.cache.num_free() == free_before
        dst.engine.cache.check_integrity()
        hog = rng.randint(1, VOCAB, (48,), dtype=np.int32)
        dst.engine.add_request(hog, pkg.sp(max_tokens=8))
        dst.engine.step()
        pulled = rs.migrator.fetch_prefix(src, dst, "rq-abort", "tr-abort",
                                          tpl)
        dst.engine.cache.check_integrity()
        return rs, (n_blocks, untouched, pulled, _mig(rs))

    _, (n_blocks, untouched, pulled, mig) = _twin(models64, scenario)
    assert n_blocks >= 1 and untouched and pulled is None
    assert mig["prefix_aborted"] >= 1


# ------------------------------------------------------------ affinity
def test_affinity_retains_hit_rate_across_replicas(models64):
    def scenario(pkg):
        rng = np.random.RandomState(6)
        tpls = [rng.randint(1, VOCAB, (24,), dtype=np.int32)
                for _ in range(2)]
        prompts = [np.concatenate(
            [tpls[i % 2], rng.randint(1, VOCAB, (int(rng.randint(2, 6)),),
                                      dtype=np.int32)]) for i in range(12)]
        params = pkg.sp(max_tokens=4)
        rs = pkg.s.ReplicaSet.from_model(
            pkg.model, pkg.s.RouterConfig(
                num_replicas=3, balance="prefix_affinity",
                backoff_base=0.01, backoff_max=0.05, backoff_jitter=0.0),
            engine_config=pkg.s.EngineConfig(
                block_size=4, num_blocks=64, max_num_seqs=4,
                decode_chunk_size=4, enable_prefix_cache=True))
        rids = [rs.add_request(p, params) for p in prompts[:2]]
        _drain(rs)
        rids += [rs.add_request(p, params) for p in prompts[2:]]
        _drain(rs)
        for audit in rs.check_integrity().values():
            assert audit is None or audit["leaked"] == 0
        fps = rs.prefix_stats()
        return rs, ([rs.get_request(r).replica for r in rids],
                    {k: fps[k] for k in ("hits", "misses",
                                         "cached_tokens_total",
                                         "prompt_tokens_total")},
                    _tokens(rs, rids))

    _, (homes, fps, _) = _twin(models64, scenario)
    assert all(len({homes[i] for i in range(t, 12, 2)}) == 1
               for t in (0, 1))
    fleet_rate = fps["hits"] / (fps["hits"] + fps["misses"])
    assert fleet_rate >= 0.8 * (12 - 2) / 12


# ---------------------------------------------------- int8 peer export
def test_int8_export_prefix_ships_uniform_f32_to_peers():
    """export_prefix decodes the quantized host payloads and re-digests
    them: the port ships the JAX package's f32 blocks, digests and
    tokens, and a plain-f32 peer admits the snapshot."""
    import jax.numpy as jnp
    from paddle_tpu.inference.serving import PagedKVCache as JPagedKVCache
    rng = np.random.RandomState(5)
    raw = tuple((rng.randn(8, 2, 2, 4).astype(np.float32),
                 rng.randn(8, 2, 2, 4).astype(np.float32))
                for _ in range(2))
    toks = list(range(1, 17))
    exports = []
    for c, pools in (
            (serving.PagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                                  host_tier_blocks=8, kv_cache_dtype="int8",
                                  device="cpu"),
             tuple((torch.from_numpy(k), torch.from_numpy(v))
                   for k, v in raw)),
            (JPagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                           host_tier_blocks=8, kv_cache_dtype="int8"),
             tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in raw))):
        c.allocate("a", 16)
        c.pools = pools
        c.free("a", cache_tokens=toks)
        ids = c._take_blocks("hog", 8)
        assert c.tier_demotions == 8
        for b in ids:
            del c._refcount[b]
            c._free.append(b)
            c.blocks_freed += 1
        exports.append(c.export_prefix(toks + [99]))
    got, want = exports
    assert got["tokens"] == want["tokens"] and got["bytes"] == want["bytes"]
    assert len(got["blocks"]) == len(want["blocks"]) == 8
    c = serving.PagedKVCache(2, 2, 4, 8, 2, device="cpu")
    for (payload, digest), (jpayload, jdigest) in zip(got["blocks"],
                                                      want["blocks"]):
        assert digest == jdigest
        assert len(payload) == 2
        for (k, v), (jk, jv) in zip(payload, jpayload):
            assert k.dtype == v.dtype == np.float32
            np.testing.assert_array_equal(k.view(np.int32),
                                          np.asarray(jk).view(np.int32))
            np.testing.assert_array_equal(v.view(np.int32),
                                          np.asarray(jv).view(np.int32))
        assert c._payload_digest(payload) == digest
    peer = serving.PagedKVCache(2, 2, 4, 8, 2, enable_prefix_cache=True,
                                device="cpu")
    assert peer.admit_prefix(got["tokens"], got["blocks"]) == 8
    peer.check_integrity()

"""The port's model registry, rolling deploys and autoscaler against the
JAX package's, on the CPU: twins of tests/test_serving_deploy.py and of
the three autoscaler cases of tests/test_tenancy.py, and the jax-free
pieces the fleet copies (BackoffPolicy, the checkpoint manifest and the
revision id) against the JAX package's on the same inputs.

Each fleet case runs one scenario on both packages (the port's GPTs hold
the JAX weights, so both publish the same revision ids) and compares
deploy outcomes and errors, swapped slots, revisions, route weights,
tokens, finish reasons, autoscaler decisions and audits; the JAX test's
own invariants are then asserted on the port.
"""
import json
import random

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


def _pair(seed, seq=24):
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=seq)
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return jm, GPT.load_jax_params(GPTConfig(**kw), params, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """(JAX, port) GPTs of the deploy tests: the old weights (seed 0) and
    a genuinely different candidate (seed 1)."""
    return _pair(0), _pair(1)


class Pkg:
    def __init__(self, port: bool, old, new):
        self.port = port
        self.old, self.new = old, new
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

    def registry(self):
        reg = self.s.ModelRegistry()
        r0 = reg.publish("m", self.old, engine_config=self.ecfg())
        r1 = reg.publish("m", self.new, engine_config=self.ecfg())
        assert r0 != r1
        return reg, r0, r1

    def fleet(self, reg, n=2, spec="", **rkw):
        rkw.setdefault("backoff_base", 0.01)
        rkw.setdefault("backoff_max", 0.05)
        rkw.setdefault("backoff_jitter", 0.0)
        return self.s.ReplicaSet.from_registry(
            reg, ("m",) * n,
            config=self.s.RouterConfig(num_replicas=n, **rkw),
            faults=self.Faults(spec))

    def sp(self, mt=6):
        return self.s.SamplingParams(max_tokens=mt, model="m")


def _twin(pairs, scenario):
    """scenario(pkg) -> (router, comparable result); both packages' must
    be equal. Returns the port's."""
    (jo, to), (jn, tn) = pairs
    got_rs, got = scenario(Pkg(True, to, tn))
    _, want = scenario(Pkg(False, jo, jn))
    assert got == want
    return got_rs, got


def _prompts(n, seed=7, lo=3, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, int(rng.randint(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _assert_no_leaks(rs):
    for idx, audit in rs.check_integrity().items():
        assert audit is not None, f"replica {idx} has no live engine"
        assert audit["leaked"] == 0, (idx, audit)


def _served(rs, rids):
    out = []
    for rid in rids:
        rec = rs.get_request(rid)
        assert rec.finished and rec.finish_reason in ("stop", "length"), \
            (rid, rec.finish_reason)
        out.append((rec.finish_reason, list(rec.tokens), rec.revision))
    return out


def _status(st):
    return {k: st[k] for k in ("phase", "outcome", "error", "model",
                               "from_revision", "to_revision", "swapped",
                               "pool")}


# ---------------------------------------------- the jax-free copies
def test_backoff_policy_delays_equal_jax():
    from paddle_tpu.distributed.elastic import BackoffPolicy as JBP
    from paddle_tpu_torch.distributed.elastic import BackoffPolicy as TBP
    for kw in (dict(), dict(base=0.01, factor=3.0, max_delay=0.05,
                            jitter=0.5, seed=7),
               dict(jitter=0.0, seed=None), dict(seed=123)):
        random.seed(0)
        t = [TBP(**kw).delay(n) for n in range(8)]
        random.seed(0)
        j = [JBP(**kw).delay(n) for n in range(8)]
        if kw.get("seed") is not None or kw.get("jitter") == 0.0:
            assert t == j, kw
        assert all(d <= TBP(**kw).max_delay * (1 + TBP(**kw).jitter)
                   for d in t)
    tb, jb = TBP(seed=3), JBP(seed=3)
    assert [tb.delay(n) for n in (0, 1, 5, 20)] == \
        [jb.delay(n) for n in (0, 1, 5, 20)]


def test_array_manifest_and_revision_id_equal_jax(pairs):
    import paddle_tpu.incubate.checkpoint as jck
    from paddle_tpu.inference.serving.deploy import _revision_id as jrid
    import paddle_tpu_torch.incubate.checkpoint as tck
    import paddle_tpu_torch.models.generation as gen
    from paddle_tpu_torch.inference.serving.deploy import _revision_id
    assert tck.CHECKSUM_FILE == jck.CHECKSUM_FILE
    rng = np.random.RandomState(0)
    tree = {"b": [rng.randn(3, 2).astype(np.float32),
                  (rng.randn(2).astype(np.float64),
                   rng.randint(0, 9, (4,)).astype(np.int32))],
            "a": {"w": np.asfortranarray(rng.randn(4, 3))}, "s": "skip"}
    torch_tree = {"b": [torch.from_numpy(tree["b"][0]),
                        (torch.from_numpy(tree["b"][1][0]),
                         torch.from_numpy(tree["b"][1][1]))],
                  "a": {"w": torch.from_numpy(
                      np.ascontiguousarray(tree["a"]["w"]))}, "s": "skip"}
    want = jck._array_manifest(tree)
    assert tck._array_manifest(tree) == want
    assert tck._array_manifest(tck._to_host(torch_tree)) == want
    assert _revision_id(want) == jrid(want)
    for jm, tm in pairs:
        jman = jck._array_manifest(jck._to_host(jgen.extract_params(jm)))
        tman = tck._array_manifest(tck._to_host(gen.extract_params(tm)))
        assert tman == jman
        assert _revision_id(tman) == jrid(jman)


# ------------------------------------------------------------- registry
def test_publish_is_content_addressed_and_idempotent(pairs):
    def scenario(pkg):
        reg = pkg.s.ModelRegistry()
        r0 = reg.publish("m", pkg.old)
        assert r0.startswith("sha256:") and len(r0) == len("sha256:") + 12
        assert reg.publish("m", pkg.old) == r0
        assert reg.revisions("m") == (r0,)
        assert reg.active("m") == r0
        r1 = reg.publish("m", pkg.new)
        assert r1 != r0
        assert reg.revisions("m") == (r0, r1)
        assert reg.active("m") == r0
        reg.set_active("m", r1)
        assert reg.active("m") == r1
        with pytest.raises(ValueError, match="unknown model"):
            reg.active("ghost")
        with pytest.raises(ValueError, match="no revision"):
            reg.set_active("m", "sha256:000000000000")
        return reg, (r0, r1, reg.describe(), reg.version)

    _, (r0, r1, desc, _) = _twin(pairs, scenario)
    assert desc["m"] == {"revisions": [r0, r1], "active": r1}


def test_publish_artifact_requires_manifest(tmp_path, pairs):
    def scenario(pkg):
        reg = pkg.s.ModelRegistry()
        art = tmp_path / f"artifact-{pkg.port}"
        art.mkdir()
        with pytest.raises(IOError, match="checksums.json"):
            reg.publish("m", pkg.old, artifact_dir=str(art))
        assert not reg.has_model("m")
        (art / "checksums.json").write_text("[]")
        with pytest.raises(IOError, match="empty or malformed"):
            reg.publish("m", pkg.old, artifact_dir=str(art))
        manifest = {"layer0/w": "ab" * 32, "layer0/b": "cd" * 32}
        (art / "checksums.json").write_text(json.dumps(manifest))
        rid = reg.publish("m", pkg.old, artifact_dir=str(art))
        assert reg.manifest("m", rid) == manifest
        return reg, rid

    assert _twin(pairs, scenario)[1].startswith("sha256:")


def test_registry_engines_are_revision_stamped(pairs):
    def scenario(pkg):
        reg, r0, r1 = pkg.registry()
        eng = reg.build_engine("m", None, 0, 0)
        eng2 = reg.engine_factory("m", r1)(3, 0)
        with pytest.raises(ValueError, match="no revision"):
            reg.build_engine("m", "sha256:000000000000", 0, 0)
        with pytest.raises(ValueError, match="unknown model"):
            reg.engine_factory("ghost", r0)
        return reg, ((eng.config.model, eng.config.revision) == ("m", r0),
                     (eng2.config.model, eng2.config.revision) == ("m", r1))

    rs, got = _twin(pairs, scenario)
    assert got == (True, True)
    # the port's engines run on the model's device and share its weights
    eng = rs.build_engine("m", None, 0, 0)
    assert eng.device.type == "cpu"
    assert eng.params["wte.weight"].data_ptr() == \
        pairs[0][1].wte.weight.data_ptr()


def test_controller_preconditions(pairs):
    def scenario(pkg):
        reg, r0, r1 = pkg.registry()
        plain = pkg.s.ReplicaSet.from_model(
            pkg.old, pkg.s.RouterConfig(num_replicas=1),
            engine_config=pkg.ecfg())
        with pytest.raises(ValueError, match="ModelRegistry"):
            pkg.s.DeployController(plain, "m", r1)
        rs = pkg.fleet(reg, n=1)
        with pytest.raises(ValueError, match="already at"):
            pkg.s.DeployController(rs, "m", r0)
        with pytest.raises(ValueError, match="no revision"):
            pkg.s.DeployController(rs, "m", "sha256:000000000000")
        return rs, True

    _twin(pairs, scenario)


# -------------------------------------------------------------- commits
def _deploy_trace(pkg, ctl, rs):
    dep = [e.kind for e in pkg.obs.reqtrace.events(trace_id=ctl.deploy_id)]
    ids = sorted(pkg.obs.reqtrace.traces(prefix=ctl.deploy_id))
    ids += sorted(pkg.obs.reqtrace.traces(prefix=f"tr-{rs.label}-"))
    dump = pkg.obs.reqtrace.dump_payload("deploy-test", trace_ids=ids,
                                         complete=True)
    return dep, pkg.obs.reqtrace.check_causality(dump)


def test_rolling_deploy_commits_under_live_traffic(pairs):
    def scenario(pkg):
        pkg.obs.reqtrace.enable()
        reg, r0, r1 = pkg.registry()
        rs = pkg.fleet(reg, n=2)
        rids = [rs.add_request(p, pkg.sp()) for p in _prompts(6)]
        ctl = pkg.s.DeployController(
            rs, "m", r1, config=pkg.s.DeployConfig(canary_tolerance=3))
        ctl.start()
        while not ctl.done():
            rs.step()
            ctl.tick()
        rs.run(max_steps=2000)
        st = _status(ctl.status())
        served = _served(rs, rids)
        _assert_no_leaks(rs)
        out = [st, reg.active("m") == r1,
               [rep.revision == r1 and rep.is_serving()
                for rep in rs.replicas],
               rs.route_weights("m"), served]
        rid = rs.add_request(np.arange(1, 5, dtype=np.int32), pkg.sp(3))
        out.append(rs.get_request(rid).revision == r1)
        rs.run(max_steps=500)
        _assert_no_leaks(rs)
        out.append(_deploy_trace(pkg, ctl, rs))
        return rs, out

    _, (st, active, reps, weights, _, new_rev, (dep, violations)) = \
        _twin(pairs, scenario)
    assert st["outcome"] == "committed" and st["error"] is None
    assert st["swapped"] == [0, 1] and active and all(reps)
    assert weights == {} and new_rev
    assert dep[0] == "deploy_start" and dep[-1] == "deploy_commit"
    assert dep.count("replica_swap") == 2 and dep.count("canary") == 2
    assert violations == []


def test_old_revision_requests_finish_bitwise(pairs):
    prompts = _prompts(5, seed=11)

    def scenario(pkg):
        ref = pkg.fleet(pkg.registry()[0], n=2)
        ref_rids = [ref.add_request(p, pkg.sp()) for p in prompts]
        ref.run(max_steps=2000)
        want = [list(ref.get_request(r).tokens) for r in ref_rids]
        _assert_no_leaks(ref)
        reg, r0, r1 = pkg.registry()
        rs = pkg.fleet(reg, n=2)
        rids = [rs.add_request(p, pkg.sp()) for p in prompts]
        for _ in range(3):
            rs.step()
        st = pkg.s.DeployController(
            rs, "m", r1, config=pkg.s.DeployConfig(canary_tolerance=3)).run()
        rs.run(max_steps=2000)
        served = _served(rs, rids)
        _assert_no_leaks(rs)
        on_old = [i for i, r in enumerate(rids)
                  if rs.get_request(r).revision == r0]
        return rs, (_status(st), want, served, on_old)

    _, (st, want, served, on_old) = _twin(pairs, scenario)
    assert st["outcome"] == "committed"
    assert on_old                              # the gate is not vacuous
    for i in on_old:
        assert served[i][1] == want[i], i


# ------------------------------------------------------------ rollbacks
def test_poisoned_revision_rolls_back(pairs):
    def scenario(pkg):
        reg, r0, r_bad = pkg.registry()
        rs = pkg.fleet(reg, n=2)
        rids = [rs.add_request(p, pkg.sp(mt=5)) for p in _prompts(4)]
        st = pkg.s.DeployController(rs, "m", r_bad).run()
        rs.run(max_steps=2000)
        out = [_status(st), reg.active("m") == r0,
               [rep.revision == r0 and rep.is_serving()
                for rep in rs.replicas], rs.route_weights("m"),
               _served(rs, rids)]
        _assert_no_leaks(rs)
        rid = rs.add_request(np.arange(1, 6, dtype=np.int32), pkg.sp(mt=3))
        out.append(rs.get_request(rid).revision == r0)
        rs.run(max_steps=500)
        _assert_no_leaks(rs)
        return rs, out

    _, (st, active, reps, weights, _, old_rev) = _twin(pairs, scenario)
    assert st["outcome"] == "rolled_back"
    assert "canary" in st["error"] and "diverged" in st["error"]
    assert active and all(reps) and weights == {} and old_rev


def test_rollback_unwinds_live_swapped_slot(pairs):
    def scenario(pkg):
        pkg.obs.reqtrace.enable()
        reg, r0, r1 = pkg.registry()
        rs = pkg.fleet(reg, n=3, spec="kill_deploy@1:1")
        ctl = pkg.s.DeployController(
            rs, "m", r1, config=pkg.s.DeployConfig(canary_tolerance=3))
        ctl.start()
        rids, k = [], 0
        while not ctl.done():
            if k < 12:
                rids.append(rs.add_request(
                    _prompts(1, seed=100 + k)[0], pkg.sp()))
                k += 1
            rs.step()
            ctl.tick()
        st = _status(ctl.status())
        rs.run(max_steps=3000)
        out = [st, reg.active("m") == r0,
               [rep.revision == r0 and rep.is_serving()
                for rep in rs.replicas], rs.route_weights("m"),
               _served(rs, rids)]
        _assert_no_leaks(rs)
        dep, violations = _deploy_trace(pkg, ctl, rs)
        out += [dep.count("rollback"), "deploy_commit" in dep, violations]
        return rs, out

    _, (st, active, reps, weights, _, n_rb, committed, violations) = \
        _twin(pairs, scenario)
    assert st["outcome"] == "rolled_back"
    assert "killed in the swap->canary window" in st["error"]
    assert st["swapped"] == [0, 1]
    assert active and all(reps) and weights == {}
    assert n_rb == 1 and not committed and violations == []


# -------------------------------------------------- cross-revision KV
def test_cross_revision_kv_is_refused(pairs):
    def scenario(pkg):
        reg, r0, r1 = pkg.registry()
        rs = pkg.fleet(reg, n=2)
        rs.drain(1, recompute=False)
        for _ in range(50):
            if rs.replicas[1].state == pkg.s.ReplicaState.DRAINED:
                break
            rs.step()
        assert rs.replicas[1].state == pkg.s.ReplicaState.DRAINED
        assert rs.replicas[1].swap_revision(reg.engine_factory("m", r1))
        assert rs.probe_grow(1)
        keys = [rs.replicas[0].revision_key() == ("m", r0),
                rs.replicas[1].revision_key() == ("m", r1)]
        rid = rs.add_request(_prompts(1, seed=21)[0], pkg.sp(mt=8))
        home = rs.get_request(rid).replica
        for _ in range(200):
            if rs.replicas[0].migratable_requests():
                break
            rs.step()
        cand = rs.replicas[0].migratable_requests()
        assert cand
        before = rs.migrator.stats()["revision_refused"]
        out = rs.migrator.migrate(rs.replicas[0], rs.replicas[1], cand[0],
                                  "rebalance")
        rec = rs.get_request(rid)
        pull = rs.migrator.fetch_prefix(rs.replicas[0], rs.replicas[1],
                                        rid, rec.trace_id,
                                        list(rec.prompt_ids))
        refused = rs.migrator.stats()["revision_refused"] - before
        rs.run(max_steps=1000)
        _assert_no_leaks(rs)
        return rs, (keys, home, out, pull, refused,
                    rs.get_request(rid).finished,
                    rs.get_request(rid).revision == r0,
                    list(rs.get_request(rid).tokens))

    _, (keys, home, out, pull, refused, finished, on_r0, _) = \
        _twin(pairs, scenario)
    assert keys == [True, True] and home == 0
    assert out is None and pull is None and refused == 2
    assert finished and on_r0


# --------------------------------------------------------- A/B routing
def test_route_weight_validation_and_steering(pairs):
    def scenario(pkg):
        reg, r0, r1 = pkg.registry()
        rs = pkg.fleet(reg, n=2)
        with pytest.raises(ValueError, match="non-negative"):
            rs.set_route_weights("m", {r0: -1.0})
        with pytest.raises(ValueError, match="positive sum"):
            rs.set_route_weights("m", {r0: 0.0})
        rs.set_route_weights("m", {r0: 1.0, r1: 3.0})
        weights = rs.route_weights("m")
        picks = [rs._pick_revision("m", f"req-{i}") for i in range(40)]
        rs.set_route_weights("m", {r1: 1.0})
        rid = rs.add_request(_prompts(1, seed=31)[0], pkg.sp(mt=2))
        pinned = rs.get_request(rid).revision == r0
        rs.set_route_weights("m", None)
        cleared = rs.route_weights("m")
        rs.run(max_steps=300)
        _assert_no_leaks(rs)
        return rs, (weights == {r0: 1.0, r1: 3.0},
                    [p == r1 for p in picks], pinned, cleared)

    _, (weights, picks, pinned, cleared) = _twin(pairs, scenario)
    assert weights and pinned and cleared == {}
    assert 0 < sum(picks) < len(picks)


# ------------------------------------------------- invariant 8 (checker)
def _checker_pair(events, complete=True):
    """Record `events` in a fresh ring of each package and run each
    package's checker; both readings must be equal. Returns the port's."""
    got = []
    for ob in (obs, jobs):
        ring = ob.reqtrace.ReqTraceRing()
        for kind, tid, attrs in events:
            ring.record(kind, tid, **attrs)
        got.append(ob.reqtrace.check_causality(
            {"version": 1, "reason": "test", "complete": complete,
             "events": [e.as_dict() for e in ring.events()]}))
    assert got[0] == got[1]
    return got[0]


def test_invariant8_synthetic_legal_and_violation():
    a, b = "sha256:aaa", "sha256:bbb"
    legal = [
        ("admitted", "t8", dict(router="r0", replica=0, model="m",
                                revision=a)),
        ("engine_admit", "t8", dict(engine="m-r0", arrival=0)),
        ("scheduled", "t8", dict(arrival=0)), ("prefill", "t8", {}),
        ("first_token", "t8", dict(revision=a)),
        ("requeue", "t8", dict(arrival=0)),
        ("admitted", "t8", dict(router="r0", replica=1, policy="repin",
                                model="m", revision=b)),
        ("engine_admit", "t8", dict(engine="m-r1", arrival=0)),
        ("scheduled", "t8", dict(arrival=0)), ("prefill", "t8", {}),
        ("decode_chunk", "t8", dict(revision=b)),
        ("finish", "t8", dict(reason="stop", revision=b))]
    assert _checker_pair(legal) == []
    bad = [
        ("admitted", "t9", dict(router="r0", replica=0, model="m",
                                revision=a)),
        ("engine_admit", "t9", dict(engine="m-r0", arrival=0)),
        ("scheduled", "t9", dict(arrival=0)), ("prefill", "t9", {}),
        ("first_token", "t9", dict(revision=b)),
        ("finish", "t9", dict(reason="stop", revision=b))]
    msgs = _checker_pair(bad)
    assert any("revision pinning broken" in v for v in msgs), msgs


def test_deploy_trace_terminal_rule():
    start = [("deploy_start", "dep-t", dict(
                 router="r0", model="m", from_revision="sha256:aaa",
                 to_revision="sha256:bbb", replicas=2)),
             ("replica_swap", "dep-t", dict(router="r0", replica=0,
                                            model="m",
                                            revision="sha256:bbb")),
             ("canary", "dep-t", dict(router="r0", replica=0, mismatches=0,
                                      passed=True))]
    commit = [("deploy_commit", "dep-t", dict(router="r0", model="m",
                                              revision="sha256:bbb",
                                              replicas=1))]
    rollback = [("rollback", "dep-t", dict(router="r0", model="m",
                                           reason="x", restored=0,
                                           revision="sha256:aaa"))]
    assert _checker_pair(start, complete=False) == []
    assert any("deploy ended 0 times" in v
               for v in _checker_pair(start))
    assert _checker_pair(start + commit) == []
    assert any("deploy ended 2 times" in v
               for v in _checker_pair(start + commit + rollback))


# ------------------------------------------------------ chaos: deploy
@pytest.mark.chaos
def test_chaos_deploy_rolls_back_then_commits(pairs, monkeypatch):
    """The port's rolling-deploy chaos harness (a kill in the
    swap->canary window after another slot rejoined, then a clean
    rollout) against the JAX harness on the same weights (the JAX
    harness's own models: seeds 0 and 1): the harness's own gates
    (rollback then commit, nothing lost, pools clean, live KV moved,
    causality with revision pinning clean) on both, and equal reports
    but the wall-clock SLO readings, the deploy ids (counted process-
    wide) and the JAX lock witness. Both run on a stepped clock
    (test_torch_fleet_clock.py), so the restart verdicts do not move
    with the host's load."""
    import tools.chaos_serve as jcs
    from paddle_tpu_torch.tools import chaos_serve as cs
    from test_torch_fleet_clock import jax_stepped_clock
    got = cs.run_chaos_deploy(seed=0, n_requests=8, models=(
        _pair(0, seq=48)[1], _pair(1, seq=48)[1]))
    jax_stepped_clock(monkeypatch)
    want = jcs.run_chaos_deploy(seed=0, n_requests=8)

    def deploys(rep):
        return [{k: v for k, v in d.items() if k != "deploy_id"}
                for d in rep["deploys"]]

    assert deploys(got) == deploys(want)
    for key in ("fired", "kill", "finish_reasons", "requeues",
                "migrations", "integrity", "replica_states", "pools",
                "revisions", "requests", "causality_events"):
        assert got[key] == want[key], key
    assert [d["outcome"] for d in got["deploys"]] == \
        ["rolled_back", "committed"]
    assert got["deploys"][0]["swapped"] == [0, 1]
    assert got["deploys"][1]["swapped"] == [0, 1, 2]
    assert got["kill"]["swapped_before_kill"] >= 1
    assert [kind for kind, _tick in got["fired"]] == ["kill_deploy"]
    assert set(got["finish_reasons"]) <= {"stop", "length"}


# ----------------------------------------------------------- autoscaler
def _signals(**kw):
    base = {"up": 2, "parked": 1, "waiting_total": 0, "free_frac": 1.0,
            "ttft_p99": 0.0, "prefill_frac": 0.5, "waiting_by_tenant": {}}
    base.update(kw)
    return base


def test_autoscaler_policy_is_pure_and_role_aware():
    cfg = dict(min_replicas=1, target_waiting_per_replica=4.0,
               low_waiting_per_replica=1.0, min_headroom_frac=0.1,
               ttft_p99_slo_s=0.5)
    pol = serving.AutoscalerPolicy(serving.AutoscalerConfig(**cfg))
    jpol = jserving.AutoscalerPolicy(jserving.AutoscalerConfig(**cfg))
    cases = [dict(waiting_total=20), dict(free_frac=0.05),
             dict(ttft_p99=0.9), dict(up=0),
             dict(parked=0, waiting_total=20),
             dict(waiting_total=0, prefill_frac=0.9),
             dict(waiting_total=0, prefill_frac=0.1),
             dict(waiting_total=0, ttft_p99=0.9), dict(up=3, parked=0),
             dict(waiting_total=3, free_frac=0.2)]
    got = [pol.decide(_signals(**c)) for c in cases]
    assert got == [jpol.decide(_signals(**c)) for c in cases]
    assert [(d["action"], d["reason"]) for d in got[:3]] == [
        ("grow", "queue_pressure"), ("grow", "block_headroom"),
        ("grow", "ttft_slo")]
    assert got[3]["reason"] == "below_min" and got[4]["action"] == "hold"
    assert (got[5]["action"], got[5]["role_pref"]) == ("shrink", "decode")
    assert (got[6]["action"], got[6]["role_pref"]) == ("shrink", "prefill")
    assert (got[7]["action"], got[7]["reason"]) == ("grow", "ttft_slo")
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(low_waiting_per_replica=9.0),
                dict(min_headroom_frac=1.0), dict(cooldown_steps=-1)):
        with pytest.raises(ValueError):
            serving.AutoscalerConfig(**bad)


def test_autoscaler_shrink_grow_on_live_fleet():
    jm, tm = _pair(0, seq=48)

    def scenario(pkg, model):
        rs = pkg.s.ReplicaSet.from_model(
            model, pkg.s.RouterConfig(num_replicas=3),
            engine_config=pkg.s.EngineConfig(
                block_size=4, num_blocks=32, max_num_seqs=2,
                decode_chunk_size=2))
        asc = pkg.s.Autoscaler(rs, pkg.s.AutoscalerConfig(
            min_replicas=1, max_replicas=3, target_waiting_per_replica=2.0,
            low_waiting_per_replica=1.0, cooldown_steps=2))
        log = []

        def tick():
            d = asc.step()
            log.append((d["action"], d["reason"], d["enacted"],
                        d["replica"], rs.num_up()))
            return d

        d = tick()
        rs.step()
        parked = str(rs.states()[d["replica"]])
        tick()
        tick()
        tick()
        rs.step()
        asc.cooldown = 0
        tick()
        rng = np.random.RandomState(5)
        rids = [rs.add_request(rng.randint(0, VOCAB, (4,), dtype=np.int32),
                               pkg.s.SamplingParams(max_tokens=4))
                for _ in range(8)]
        asc.cooldown = 0
        tick()
        steps = 0
        while rs.has_unfinished():
            rs.step()
            steps += 1
            assert steps <= 600
        return rs, (log, parked, asc.shrink_events, asc.grow_events,
                    [(rs.get_request(r).finish_reason,
                      list(rs.get_request(r).tokens)) for r in rids])

    _, got = scenario(Pkg(True, tm, None), tm)
    _, want = scenario(Pkg(False, jm, None), jm)
    assert got == want
    log, parked, shrinks, grows, served = got
    assert log[0][:3] == ("shrink", "idle_capacity", True) and \
        log[0][4] == 2
    assert parked == "drained"
    assert [e[1] for e in log[1:3]] == ["cooldown", "cooldown"]
    assert shrinks == 2 and log[3][4] == 1
    assert log[4][0] == "hold"
    assert log[5][:3] == ("grow", "queue_pressure", True) and \
        log[5][4] == 2 and grows == 1
    assert all(reason in ("stop", "length") for reason, _ in served)


def test_probe_rejoin_only_from_parked_state():
    jm, tm = _pair(0, seq=48)
    got = []
    for pkg, model in ((Pkg(True, tm, None), tm), (Pkg(False, jm, None),
                                                   jm)):
        rs = pkg.s.ReplicaSet.from_model(
            model, pkg.s.RouterConfig(num_replicas=2),
            engine_config=pkg.s.EngineConfig(block_size=4, num_blocks=16,
                                             max_num_seqs=2))
        out = [rs.probe_grow(0)]
        rs.drain(0, recompute=False)
        rs.step()
        out.append(str(rs.states()[0]))
        out.append(rs.probe_grow(0))
        out.append(str(rs.states()[0]))
        audit = rs.check_integrity()
        out.append(audit[0] is not None and audit[0]["leaked"] == 0)
        out.append(rs.replicas[0].probe_tokens)
        got.append(out)
    assert got[0] == got[1]
    assert got[0][:5] == [False, "drained", True, "up", True]


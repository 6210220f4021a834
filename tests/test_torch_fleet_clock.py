"""The fleet's heartbeat and restart-backoff verdicts under a stepped
clock, on the CPU.

The chaos harnesses decide "wedged" (a heartbeat stale past 20 ms) and
"restart due" (a 10-50 ms backoff) from a clock. On the wall clock, a
loaded host runs fewer router steps in those windows, so a killed
replica rejoins at another step and a scheduled fault lands on other
work: the same seed gave another report. The port's ReplicaSet reads an
injectable clock, and its harnesses run a `SteppedClock` that advances
one tick per router step, so a stall in one engine step moves nothing.

`jax_stepped_clock` runs the JAX harnesses under the same clock, by
pointing the JAX replica and router modules' `time` at it and ticking
at the start of each JAX router step: the parity tests of
test_torch_router.py, test_torch_disagg.py and test_torch_deploy.py
compare the two packages' reports under it.
"""
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.serving.replica as jreplica
import paddle_tpu.inference.serving.router as jrouter
import paddle_tpu.models.generation as jgen
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

from paddle_tpu_torch.inference.serving.engine import LLMEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.tools import chaos_serve as cs

COMPARED = ("fired", "migrations", "requeues", "finish_reasons",
            "replica_states", "survivors", "integrity")


def jax_stepped_clock(monkeypatch, tick_s: float = cs.TICK_S):
    """Run the JAX package's fleet on a `SteppedClock` for the rest of
    the test: its replica and router modules read the clock for
    `time.monotonic`, and each `ReplicaSet.step` ticks it first, as the
    port's router does. Returns the clock."""
    clock = cs.SteppedClock(tick_s)
    shim = types.SimpleNamespace(monotonic=clock, sleep=time.sleep,
                                 perf_counter=time.perf_counter,
                                 time=time.time)
    monkeypatch.setattr(jreplica, "time", shim)
    monkeypatch.setattr(jrouter, "time", shim)
    step = jrouter.ReplicaSet.step

    def ticked(self):
        clock.tick()
        return step(self)

    monkeypatch.setattr(jrouter.ReplicaSet, "step", ticked)
    return clock


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=48)
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**kw))
    jm.eval()
    params = {k: np.asarray(v) for k, v in jgen.extract_params(jm).items()}
    return GPT.load_jax_params(GPTConfig(**kw), params, device="cpu")


def _stall_engine_step(monkeypatch, at: int, seconds: float):
    """Sleep `seconds` inside the `at`-th LLMEngine.step of the process
    from now on (counting every replica's steps and warmup probes)."""
    step = LLMEngine.step
    calls = [0]

    def stalled(self, *a, **kw):
        calls[0] += 1
        if calls[0] == at:
            time.sleep(seconds)
        return step(self, *a, **kw)

    monkeypatch.setattr(LLMEngine, "step", stalled)
    return calls


@pytest.mark.chaos
@pytest.mark.parametrize("at", [8, 14, 20])
def test_disagg_report_ignores_a_stalled_engine_step(model, monkeypatch, at):
    """A 5 ms stall in one engine step around the first kill_migration
    (the faulted run's 8th, 14th or 20th engine step, counting every
    replica's) gives the same report as the run without it. On the wall
    clock it moves the killed prefill replica's restart by a router step
    wherever steps are shorter than its 10 ms backoff, and with it which
    scheduled kill finds a live migration."""
    want = cs.run_chaos_disagg(seed=0, n_requests=10, model=model)
    calls = _stall_engine_step(monkeypatch, at, 0.005)
    got = cs.run_chaos_disagg(seed=0, n_requests=10, model=model)
    assert calls[0] >= at
    for key in COMPARED:
        assert got[key] == want[key], key


@pytest.mark.chaos
def test_replicas_report_ignores_a_stalled_engine_step(model, monkeypatch):
    """A 30 ms stall in the 40th engine step leaves the replica
    harness's whole report as it was, its recovery seconds included (on
    the wall clock they read the stall)."""
    want = cs.run_chaos_replicas(seed=0, n_requests=12, replicas=3,
                                 model=model)
    _stall_engine_step(monkeypatch, 40, 0.03)
    got = cs.run_chaos_replicas(seed=0, n_requests=12, replicas=3,
                                model=model)
    for key in ("fired", "targeted_replicas", "requeues", "finish_reasons",
                "replica_states", "untouched_survivors", "canaries_served",
                "integrity", "recovery_times_s"):
        assert got[key] == want[key], key


def test_stepped_clock_drives_the_wedge_and_backoff_verdicts(model):
    """A wedged replica fails over after heartbeat_timeout / tick silent
    router steps, and rejoins backoff / tick steps after its quarantine,
    however long the steps take."""
    from paddle_tpu_torch.inference.serving import (EngineConfig,
                                                    ReplicaSet,
                                                    RouterConfig,
                                                    SamplingParams)
    from paddle_tpu_torch.testing.faults import ServingFaultInjector
    clock = cs.SteppedClock(0.01)
    rs = ReplicaSet.from_model(
        model, RouterConfig(num_replicas=2, heartbeat_timeout_s=0.035,
                            backoff_base=0.02, backoff_jitter=0.0),
        engine_config=EngineConfig(block_size=4, num_blocks=32,
                                   max_num_seqs=4, decode_chunk_size=2),
        faults=ServingFaultInjector("wedge_replica@2:0"), clock=clock)
    for i in range(4):
        rs.add_request(np.arange(3 + i, dtype=np.int32) + 1,
                       SamplingParams(max_tokens=30))
    down_at = up_at = None
    for step in range(1, 40):
        rs.step()
        time.sleep(0.001 * (step % 3))      # uneven wall-clock steps
        state = str(rs.replicas[0].state)
        if down_at is None and state != "up":
            down_at = step
        if down_at is not None and up_at is None and state == "up":
            up_at = step
    # wedged from step 2: last beat at step 1 (t 0.01); stale past 0.035
    # s once a wedged step ends at t 0.05, step 5
    assert down_at == 5
    # restart due at 0.05 + 0.02: the step that reads t 0.07, step 7
    assert up_at == 7
    assert clock.ticks == 39

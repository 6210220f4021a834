"""The elastic supervisor (paddle_tpu_torch/distributed/elastic.py) and
its heartbeat sites against the JAX package, on the CPU.

- Hang verdicts are decided on an injected stepped clock (the port's
  keyword-only `clock`), against fake worker processes whose beats are
  scripted per monitor pass, so no verdict rests on wall time (the JAX
  twin test_fault_tolerance.py::test_hang_detected_by_heartbeat_and_
  restarted does, and fails on some machines).
- Both supervisors run the same scripted `python -c` workers (success;
  one failure then success through a marker file; always failing until
  the restart budget is spent) and give equal reports.
- One subprocess kill-and-resume of tools/ft_worker.py's tiny GPT (float
  32, full recompute, one torch thread) ends with parameters bitwise
  equal to an uninterrupted run in this process.
- heartbeat() is a no-op unsupervised; AutoCheckpointManager's ranges,
  LLMEngine.step and ServingPredictor.run touch the heartbeat file.
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import elastic as jelastic

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import place
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed.elastic import (ElasticJobError,
                                                  ElasticSupervisor,
                                                  WorkerSpec)
from paddle_tpu_torch.tools import ft_worker
from paddle_tpu_torch.tools.chaos_serve import SteppedClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    prev_threads, prev_dev = torch.get_num_threads(), place._default
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    torch.set_num_threads(prev_threads)
    place._default = prev_dev


# ------------------------------------------------------- stepped verdicts
class FakeProc:
    """A worker incarnation scripted per monitor pass: `beats` lists the
    passes on which it touches its heartbeat file (with that pass number
    as the file's mtime), and it exits with `code` after `exit_after`
    passes (None: never)."""

    def __init__(self, hb_path, beats, exit_after=None, code=0):
        self.hb_path, self.beats = hb_path, set(beats)
        self.exit_after, self.code = exit_after, code
        self.polls, self.killed = 0, False

    def poll(self):
        if self.killed:
            return -9
        self.polls += 1
        if self.polls in self.beats:
            with open(self.hb_path, "a"):
                os.utime(self.hb_path, (self.polls, self.polls))
        if self.exit_after is not None and self.polls >= self.exit_after:
            return self.code
        return None

    def kill(self):
        self.killed = True

    def wait(self, timeout=None):
        return -9


def _fake_popen(scripts, started):
    """A Popen stand-in: incarnation n of the worker follows scripts[n]."""
    def popen(argv, env=None, stdout=None, stderr=None):
        n = int(env[elastic.RESTART_COUNT_ENV])
        started.append(n)
        return FakeProc(env[elastic.HEARTBEAT_FILE_ENV], **scripts[n])
    return popen


def test_hang_verdict_on_a_stepped_clock(tmp_path, monkeypatch):
    """Incarnation 0 beats on passes 2-5 and then stalls; with one
    second a pass and a 3 s timeout the hang is declared on pass 9
    (the stale beat was first seen on pass 5); incarnation 1 beats and
    exits 0. No beat before pass 2: start-up is never a hang."""
    started = []
    monkeypatch.setattr(elastic.subprocess, "Popen", _fake_popen(
        [dict(beats=range(2, 6)), dict(beats=range(1, 4), exit_after=4)],
        started))
    clock = SteppedClock(tick_s=1.0)
    sup = ElasticSupervisor(max_restarts=2, backoff_base=0.5, jitter=0.0,
                            heartbeat_timeout=3.0, monitor_interval=0.0,
                            heartbeat_dir=str(tmp_path), clock=clock)
    report = sup.run([["worker"]])
    assert report == {"nprocs": 1, "restarts": {0: 1},
                      "history": {0: [(0, "hang (heartbeat timeout)")]}}
    assert started == [0, 1]
    # 9 passes to the verdict, one pass of backoff (0.5 s), 4 passes of
    # the second incarnation
    assert clock.ticks == 14


def test_no_beat_is_never_a_hang(tmp_path):
    clock = SteppedClock(tick_s=100.0)
    sup = ElasticSupervisor(heartbeat_timeout=1.0, clock=clock)
    h = elastic._Handle(0, WorkerSpec(["w"]), str(tmp_path / "hb"))
    for _ in range(5):
        clock.tick()
        assert not sup._hung(h)
    with open(h.heartbeat_path, "w"):
        pass
    assert not sup._hung(h)          # the first beat seen: not stale
    clock.tick()
    assert sup._hung(h)              # 100 s later, no new beat
    os.utime(h.heartbeat_path, (1.0, 1.0))
    assert not sup._hung(h)          # a new beat resets the age
    assert not ElasticSupervisor(clock=clock)._hung(h)  # no timeout set


# ----------------------------------------------------- scripted workers
def _scripted(tmp_path):
    marker = tmp_path / "marker"
    return {
        "succeeds": [sys.executable, "-c", "import sys; sys.exit(0)"],
        "fails_once": [sys.executable, "-c",
                       "import os, sys\n"
                       f"m = {str(marker)!r}\n"
                       "if os.path.exists(m): sys.exit(0)\n"
                       "open(m, 'w').close(); sys.exit(3)"],
        "always_fails": [sys.executable, "-c", "import sys; sys.exit(5)"],
    }, marker


@pytest.mark.parametrize("case", ["succeeds", "fails_once", "always_fails"])
def test_supervisors_give_equal_reports(tmp_path, case):
    workers, marker = _scripted(tmp_path)
    results = []
    for mod in (jelastic, elastic):
        if marker.exists():
            marker.unlink()
        sup = mod.ElasticSupervisor(max_restarts=2, backoff_base=0.01,
                                    monitor_interval=0.01, seed=0,
                                    heartbeat_dir=str(tmp_path / "hb"))
        try:
            results.append(sup.run([workers[case]]))
        except mod.ElasticJobError as e:
            results.append(("ElasticJobError", e.history))
    assert results[0] == results[1]
    if case == "always_fails":
        assert len(results[1][1]) == 3   # max_restarts + 1 failures
    else:
        assert results[1]["restarts"] == {0: int(case == "fails_once")}


def test_backoff_delays_match_the_jax_package():
    a = ElasticSupervisor(backoff_base=0.5, backoff_factor=2.0,
                          backoff_max=3.0, jitter=0.25, seed=4)
    b = jelastic.ElasticSupervisor(backoff_base=0.5, backoff_factor=2.0,
                                   backoff_max=3.0, jitter=0.25, seed=4)
    assert [a.backoff_delay(n) for n in range(6)] == \
        [b.backoff_delay(n) for n in range(6)]


def test_elastic_spawn_and_cli(tmp_path, capsys):
    report = elastic.elastic_spawn(time.sleep, args=(0,), nprocs=1,
                                   max_restarts=1,
                                   heartbeat_dir=str(tmp_path / "hb"))
    assert report == {"nprocs": 1, "restarts": {0: 0}, "history": {0: []}}
    script = tmp_path / "w.py"
    script.write_text("import os, sys\n"
                      "assert os.environ['PADDLE_TRAINER_ID'] == '0'\n"
                      "sys.exit(0)\n")
    elastic.main(["--max_restarts", "2", "--heartbeat_timeout", "30",
                  "--log_dir", str(tmp_path / "logs"), str(script)])
    assert "elastic job done: restarts={0: 0}" in capsys.readouterr().out
    with pytest.raises(ElasticJobError):
        ElasticSupervisor(max_restarts=0, backoff_base=0.01).run(
            [[sys.executable, "-c", "import sys; sys.exit(2)"]])



@pytest.mark.parametrize("visible,want", [(None, ["0", "1"]),
                                          ("5,7", ["5", "7"])])
def test_cli_gives_each_worker_the_card_of_its_rank(tmp_path, capsys,
                                                     monkeypatch, visible,
                                                     want):
    """--nproc_per_node 2: each worker sees only the card of its rank,
    the rank-th of those the launcher sees."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys\n"
        f"want = {want!r}[int(os.environ['PADDLE_TRAINER_ID'])]\n"
        "sys.exit(0 if os.environ['CUDA_VISIBLE_DEVICES'] == want else 3)\n")
    elastic.main(["--nproc_per_node", "2", "--max_restarts", "0",
                  str(script)])
    assert "elastic job done: restarts={0: 0, 1: 0}" in \
        capsys.readouterr().out


# ------------------------------------------------------------ heartbeat
def test_heartbeat_is_a_no_op_unsupervised(tmp_path, monkeypatch):
    monkeypatch.delenv(elastic.HEARTBEAT_FILE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    elastic.heartbeat()
    assert os.listdir(tmp_path) == []
    hb = tmp_path / "hb"
    monkeypatch.setenv(elastic.HEARTBEAT_FILE_ENV, str(hb))
    elastic.heartbeat()
    assert hb.exists()


def _beats(path):
    return os.path.getmtime(path) if os.path.exists(path) else None


def test_checkpoint_ranges_and_serving_beat(tmp_path, monkeypatch):
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpointManager
    from paddle_tpu_torch.inference.serving import EngineConfig, LLMEngine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    hb = tmp_path / "hb"
    monkeypatch.setenv(elastic.HEARTBEAT_FILE_ENV, str(hb))
    net = paddle.nn.Linear(2, 2)
    acp = AutoCheckpointManager(str(tmp_path / "ck"), [net],
                                save_every_n_steps=5)

    def fresh():
        if hb.exists():
            hb.unlink()

    fresh()
    for _ in acp.train_step_range(1):
        assert hb.exists()
    fresh()
    for _ in acp.train_epoch_range(1):
        assert hb.exists()
    model = GPT(GPTConfig(vocab_size=61, hidden_size=32, num_layers=1,
                          num_heads=2, max_seq_len=16), device="cpu")
    eng = LLMEngine.from_model(model, EngineConfig(block_size=4,
                                                   num_blocks=8),
                               device="cpu")
    fresh()
    eng.step()
    assert hb.exists()
    cfg = inference.Config()
    cfg.disable_gpu()
    cfg.enable_llm_engine(model=model, block_size=4, num_blocks=8,
                          max_tokens=2)
    pred = inference.create_predictor(cfg)
    fresh()
    pred.run([np.array([[1, 2, 3]], np.int64), np.array([3], np.int64)])
    assert hb.exists()


# ----------------------------------------------------- kill and resume
def test_killed_worker_resumes_bitwise(tmp_path):
    """A supervised tools/ft_worker.py (tiny GPT, full recompute) killed
    at step 4 restarts once, restores the step-2 snapshot, and ends with
    every parameter bitwise equal to an uninterrupted run (here, in this
    process, at the same single torch thread)."""
    clean = ft_worker.main([
        "--ckpt-dir", str(tmp_path / "clean"), "--out",
        str(tmp_path / "clean.json"), "--device", "cpu", "--steps", "6",
        "--save-every", "3"])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop(elastic.HEARTBEAT_FILE_ENV, None)
    spec = WorkerSpec(
        [sys.executable, "-m", "paddle_tpu_torch.tools.ft_worker",
         "--ckpt-dir", str(tmp_path / "ck"), "--out",
         str(tmp_path / "kill.json"), "--device", "cpu", "--steps", "6",
         "--save-every", "3"],
        env={"PADDLE_TPU_FAULTS": "kill@4", "PYTHONPATH": env["PYTHONPATH"],
             "PADDLE_TPU_FAULT_STATE_DIR": str(tmp_path / "fs")},
        log_path=str(tmp_path / "worker.log"))
    report = ElasticSupervisor(max_restarts=2, backoff_base=0.05,
                               heartbeat_timeout=120.0,
                               heartbeat_dir=str(tmp_path / "hb")).run(
        [spec])
    assert report["restarts"] == {0: 1}
    assert report["history"] == {0: [(0, "exit code 37")]}
    with open(tmp_path / "kill.json") as f:
        got = json.load(f)
    assert got["incarnation"] == 1 and got["restored"] == 2
    assert got["first_step"] == 3
    assert got["params"] == clean["params"]
    assert got["losses"] == clean["losses"][3:]
    with open(str(tmp_path / "kill.json") + ".steps") as f:
        steps = [json.loads(line) for line in f]
    assert [(s["incarnation"], s["step"]) for s in steps] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (1, 3), (1, 4), (1, 5)]
    assert [s["loss"] for s in steps[:4]] == clean["losses"][:4]

"""The port's distributed slice on 4 gloo CPU ranks, against the JAX
package.

One module-scoped cluster: tests/test_torch_dist_worker.py starts 4 ranks
through paddle_tpu_torch.distributed.spawn (gloo, free local ports,
torch pinned to one thread in each rank). Each rank reads the weights
and batches this module wrote from the JAX package, runs every scenario
and writes its results to rank{r}.npz (files, not stdout: concurrent
ranks interleave their output). The JAX references run here, on one
device of the JAX package's virtual mesh, from the same initial
parameters.

Training runs are 5 Adam steps of test_distributed.py's tiny GPT
(dropout 0) on its 8 x 16 batch: dp 4, ZeRO stages 1/2/3 at sharding 4,
sharding 2 x tp 2 under ZeRO-2 and gradient merge (k 2) at dp 4, each
against the JAX ShardedTrainStep on one device, and the same runs under
SGD (Adam's update is blind to a gradient's scale; SGD's is not, and
its parameters agree within 1e-5, measured 3.4e-7). Losses agree within
1e-5 relative (measured 2e-7: the ranks' mean of local means and the
sharded sums reorder additions). Final parameters agree within 5e-5 of
each array's largest magnitude (measured 1.5e-5, sharding 2 x tp 2's
mlp.up.bias): 1e-5 is looser than the loss needs but too tight here,
because Adam divides each update by the running RMS of its gradient,
so an entry whose gradient is small beside its history moves by lr
times a ratio that carries the reordered sums' relative error
amplified. The key bias (the middle third of each qkv.bias) is the
exception: its gradient is zero in exact arithmetic, so what it holds
after 5 steps is Adam's update of rounding noise, which any change in
the order of additions moves. Adam's epsilon is 1e-6 in both packages
(at 1e-8 that noise becomes updates of +-lr), and the key bias is held
to 1e-6 absolute (5 steps of lr 1e-3 times noise / epsilon, measured
under 2e-7).
"""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.models.generation as jgen
import paddle_tpu.optimizer as jopt
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jgpt_loss_fn
from paddle_tpu.parallel import (ShardedTrainStep as JShardedTrainStep,
                                 build_mesh as jbuild_mesh,
                                 set_global_mesh as jset_global_mesh)

from test_torch_dist_worker import REPO, SGD_LR, run_cluster

WORLD = 4
REL = 1e-5
PARAM_REL = 5e-5
KEY_BIAS_ABS = 1e-6


def _tiny_cfg():
    return JGPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, max_seq_len=16)


def _jax_gpt():
    jpaddle.seed(0)
    return JGPT(_tiny_cfg())


def _params(model):
    return {k: np.asarray(v) for k, v in
            jgen.extract_params(model).items()}


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (8, 16)).astype(np.int64),
            rng.randint(0, 64, (8, 16)).astype(np.int64))


def _tp_inputs(rng):
    """Whole weights and inputs of the JAX TP layers (no mesh)."""
    from paddle_tpu.distributed import (ColumnParallelLinear,
                                        RowParallelLinear,
                                        VocabParallelEmbedding)
    jpaddle.seed(1)
    layers = {"col": ColumnParallelLinear(8, 16),
              "col_nogather": ColumnParallelLinear(8, 16,
                                                   gather_output=False),
              "row": RowParallelLinear(16, 8),
              "emb": VocabParallelEmbedding(32, 8)}
    inp = {"tp_x": rng.randn(4, 8).astype(np.float32),
           "tp_x16": rng.randn(4, 16).astype(np.float32),
           "tp_ids": rng.randint(0, 32, (4, 5)).astype(np.int64)}
    for name, layer in layers.items():
        for k, v in layer.state_dict().items():
            inp[f"{name}/{k}"] = np.asarray(v.numpy())
    inp["col/r"] = inp["col_nogather/r"] = rng.randn(4, 16).astype(
        np.float32)
    inp["row/r"] = rng.randn(4, 8).astype(np.float32)
    inp["emb/r"] = rng.randn(4, 5, 8).astype(np.float32)
    inp["ce/logits"] = rng.randn(6, 16).astype(np.float32)
    inp["ce/label"] = rng.randint(0, 16, (6,)).astype(np.int64)
    inp["ce/r"] = rng.randn(6).astype(np.float32)
    return layers, inp


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.RandomState(7)
    x, y = _batch()
    inputs = {"x": x, "y": y}
    inputs.update({f"gpt/{k}": v for k, v in _params(_jax_gpt()).items()})
    layers, tp = _tp_inputs(rng)
    inputs.update(tp)
    inputs.update({"bn/x": rng.randn(8, 3, 4, 4).astype(np.float32),
                   "bn/w": rng.randn(8, 3, 4, 4).astype(np.float32),
                   "bn/weight": rng.rand(3).astype(np.float32) + 0.5,
                   "bn/bias": rng.randn(3).astype(np.float32)})
    out = run_cluster(inputs, WORLD, "distributed")
    return {"inputs": inputs, "ranks": out, "layers": layers}


_REF = {}


def _jax_run(steps=5, k=1, sgd=False):
    """Losses and final parameters of the JAX ShardedTrainStep on one
    device (Adam 1e-3, epsilon 1e-6, or SGD at the worker's SGD_LR)."""
    if (steps, k, sgd) not in _REF:
        mesh = jbuild_mesh(dp=1, devices=jax.devices()[:1])
        jset_global_mesh(mesh)
        try:
            model = _jax_gpt()
            optim = jopt.SGD(SGD_LR, parameters=model.parameters()) \
                if sgd else jopt.Adam(1e-3, epsilon=1e-6,
                                      parameters=model.parameters())
            step = JShardedTrainStep(model, jgpt_loss_fn, optim, mesh=mesh,
                                     grad_accum_steps=k)
            x, y = _batch()
            xs, ys = jpaddle.to_tensor(x), jpaddle.to_tensor(y)
            losses = [float(step(xs, ys).numpy()) for _ in range(steps)]
            _REF[steps, k, sgd] = (np.array(losses), _params(model))
        finally:
            jset_global_mesh(None)
    return _REF[steps, k, sgd]


def _close(got, want, what, rel=REL):
    """|got - want| within rel of want's largest magnitude, and the same
    shape."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("run,k", [("dp4", 1), ("zero1", 1), ("zero2", 1),
                                   ("zero3", 1), ("tp2zero2", 1),
                                   ("merge2", 2)])
def test_training_matches_jax_single_device(cluster, run, k):
    """dp 4, ZeRO-1/2/3 at sharding 4, sharding 2 x tp 2 under ZeRO-2 and
    gradient merge (k 2): losses and final parameters equal the JAX
    ShardedTrainStep's on one device, and every rank's losses equal
    rank 0's."""
    _check_run(cluster["ranks"], run, *_jax_run(5, k), PARAM_REL)


@pytest.mark.parametrize("run,k", [("dp4", 1), ("zero1", 1), ("zero2", 1),
                                   ("zero3", 1), ("tp2zero2", 1),
                                   ("merge2", 2)])
def test_sgd_training_matches_jax_single_device(cluster, run, k):
    """The same runs under SGD (lr SGD_LR): its update is the gradient
    times lr, so a reduction at the wrong scale (a sum for the mean, a
    merge without its 1/k) moves the parameters by whole updates, where
    Adam's normalisation hides it. Parameters within REL (measured
    3.4e-7: with no normalisation the reordered sums' error stays at
    f32's scale)."""
    _check_run(cluster["ranks"], f"{run}_sgd", *_jax_run(5, k, sgd=True),
               REL)


def _check_run(ranks, run, losses, params, param_rel):
    """Every rank's losses equal rank 0's; rank 0's losses within REL of
    the JAX run's and falling; its gathered final parameters within
    param_rel of the JAX run's (the key bias within KEY_BIAS_ABS)."""
    for r in range(len(ranks)):
        np.testing.assert_array_equal(ranks[r][f"{run}/losses"],
                                      ranks[0][f"{run}/losses"])
    _close(ranks[0][f"{run}/losses"], losses, f"{run} losses")
    assert losses[-1] < losses[0]
    for name, want in params.items():
        got = ranks[0][f"{run}/{name}"]
        if name.endswith("attn.qkv.bias"):
            q, k_bias, v = np.split(got, 3)
            wq, wk, wv = np.split(want, 3)
            _close(np.concatenate([q, v]), np.concatenate([wq, wv]),
                   f"{run} {name} q, v", param_rel)
            assert np.abs(k_bias - wk).max() <= KEY_BIAS_ABS, (run, name)
            continue
        _close(got, want, f"{run} {name}", param_rel)


def test_collectives_on_four_ranks(cluster):
    """test_multiprocess.py's host checks (all_gather, reduce_scatter,
    ring send/recv in f32 and bf16) and broadcast, alltoall, the five
    all_reduce ops, the c_* aliases, all_gather_object, barrier and the
    mesh's TopologyError."""
    ranks = cluster["ranks"]
    w = WORLD
    for r in range(w):
        out = ranks[r]
        np.testing.assert_array_equal(
            out["all_gather"], [[float(s), s + 0.5] for s in range(w)])
        np.testing.assert_allclose(out["reduce_scatter"],
                                   [w * r + w * (w - 1) / 2])
        assert out["ring_float32"][0] == (r - 1) % w
        assert out["ring_bfloat16"][0] == (r - 1) % w
        np.testing.assert_array_equal(out["broadcast"], [3.0, 3.0])
        np.testing.assert_array_equal(out["alltoall"],
                                      [10.0 * s + r for s in range(w)])
        vals = np.arange(1.0, w + 1)
        for op, want in (("SUM", vals.sum()), ("MAX", vals.max()),
                         ("MIN", vals.min()), ("PROD", vals.prod()),
                         ("AVG", vals.mean())):
            np.testing.assert_allclose(out[f"all_reduce_{op}"], [want])
        np.testing.assert_allclose(out["c_allreduce_sum"], [vals.sum()])
        np.testing.assert_array_equal(out["c_allgather"], vals)
        np.testing.assert_array_equal(out["c_input_kept"], [r + 1.0])
        np.testing.assert_array_equal(out["all_gather_object"],
                                      np.arange(w))
        assert int(out["topology_error"]) == 1
        calls = json.loads(str(out["calls"]))
        assert calls["reduce_scatter"] > 0 and calls["all_gather"] > 0


def _jax_layer_run(layer, x, r):
    """(out, dx or None, {param: grad}) of the JAX layer, unsharded."""
    xt = jpaddle.to_tensor(x)
    if np.issubdtype(x.dtype, np.floating):
        xt.stop_gradient = False
    y = layer(xt)
    (y * jpaddle.to_tensor(r)).sum().backward()
    dx = xt.grad.numpy() if np.issubdtype(x.dtype, np.floating) else None
    grads = {k: np.asarray(p.grad.numpy())
             for k, p in layer.named_parameters()}
    return np.asarray(y.numpy()), dx, grads


def test_tp_layers_match_jax_unsharded(cluster):
    """Column (gathered and not), Row and VocabParallelEmbedding at tp 2
    (dp 2): outputs, input gradients, the gathered weight gradients and
    the gathered state dicts equal the JAX layers' unsharded (1e-5
    relative, f32: the tp sum adds the halves in another order)."""
    inputs, ranks = cluster["inputs"], cluster["ranks"]
    args = {"col": "tp_x", "col_nogather": "tp_x", "row": "tp_x16",
            "emb": "tp_ids"}
    for name, layer in cluster["layers"].items():
        out, dx, grads = _jax_layer_run(layer, inputs[args[name]],
                                        inputs[f"{name}/r"])
        for r in range(WORLD):
            got = ranks[r]
            _close(got[f"{name}/out"], out, f"{name} out rank {r}")
            if dx is not None:
                _close(got[f"{name}/dx"], dx, f"{name} dx rank {r}")
            for k, g in grads.items():
                _close(got[f"{name}/d{k}"], g, f"{name} d{k} rank {r}")
                np.testing.assert_array_equal(got[f"{name}/state/{k}"],
                                              inputs[f"{name}/{k}"])


def test_parallel_cross_entropy_matches_jax(cluster):
    """ParallelCrossEntropy over vocab-split logits at tp 2: the per-row
    losses and the logits' gradient equal the JAX layer's on the whole
    logits."""
    from paddle_tpu.distributed import ParallelCrossEntropy
    inputs, ranks = cluster["inputs"], cluster["ranks"]
    logits = jpaddle.to_tensor(inputs["ce/logits"])
    logits.stop_gradient = False
    loss = ParallelCrossEntropy()(logits, jpaddle.to_tensor(
        inputs["ce/label"]))
    (loss * jpaddle.to_tensor(inputs["ce/r"].reshape(loss.shape))
     ).sum().backward()
    for r in range(WORLD):
        assert ranks[r]["ce/loss"].shape == tuple(loss.shape)
        _close(ranks[r]["ce/loss"], np.asarray(loss.numpy()), "ce loss")
        _close(ranks[r]["ce/dlogits"], np.asarray(logits.grad.numpy()),
               "ce dlogits")


def test_gathered_gpt_state_is_the_jax_state(cluster):
    """A dp 2 x tp 2 GPT built from the JAX parameters holds a quarter of
    each qkv column block ([32, 48] of [32, 96]) and gathers back to the
    JAX arrays exactly."""
    inputs, ranks = cluster["inputs"], cluster["ranks"]
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["tp_local_qkv"], [32, 48])
        for k in inputs:
            if k.startswith("gpt/"):
                np.testing.assert_array_equal(
                    ranks[r][f"tp_state/{k[4:]}"], inputs[k])


def test_sync_batch_norm_matches_jax_full_batch(cluster):
    """SyncBatchNorm (convert_sync_batchnorm of a BatchNorm2D) at dp 2:
    each rank's half of the output and of the input gradient, the
    running statistics, and the weight and bias gradients summed over
    the dp ranks equal the JAX BatchNorm2D's over the whole batch (loss
    sum(y * w))."""
    from paddle_tpu.nn import BatchNorm2D
    inputs, ranks = cluster["inputs"], cluster["ranks"]
    bn = BatchNorm2D(3)
    bn.weight.set_value(inputs["bn/weight"])
    bn.bias.set_value(inputs["bn/bias"])
    x = jpaddle.to_tensor(inputs["bn/x"])
    x.stop_gradient = False
    y = bn(x)
    (y * jpaddle.to_tensor(inputs["bn/w"])).sum().backward()
    want = {"out": np.asarray(y.numpy()), "dx": np.asarray(x.grad.numpy())}
    # rank r is at dp coordinate r // 2 (tp innermost)
    for r in range(WORLD):
        d = r // 2
        got = ranks[r]
        assert bool(got["bn/type"])
        for k in ("out", "dx"):
            _close(got[f"bn/{k}"], want[k][d * 4:(d + 1) * 4], f"bn {k}")
        _close(got["bn/mean"], np.asarray(bn._mean.numpy()), "bn mean")
        _close(got["bn/var"], np.asarray(bn._variance.numpy()), "bn var")
    for k, p in (("dweight", bn.weight), ("dbias", bn.bias)):
        _close(ranks[0][f"bn/{k}"] + ranks[2][f"bn/{k}"],
               np.asarray(p.grad.numpy()), f"bn {k}")


def test_fleet_strategy_matches_jax(cluster):
    """test_fleet_end_to_end's strategy (sharding 2 at stage 2, hybrid
    dp 2 x mp 2) with amp off, on 4 ranks: the mesh rescales dp to 1
    (sharding 2 x tp 2, as the JAX fleet does when the degrees exceed the
    devices), and 4 steps of fleet.distributed_train_step give the JAX
    single-device losses; distributed_optimizer substitutes Lamb; the
    DistributedBatchSampler reads its replicas and rank from the group
    and the ranks' indices cover the dataset once."""
    ranks = cluster["ranks"]
    losses, _ = _jax_run(4, 1)
    seen = []
    for r in range(WORLD):
        got = ranks[r]
        np.testing.assert_array_equal(got["fleet/mesh"], [1, 2, 2])
        np.testing.assert_array_equal(got["fleet/worker"], [r, WORLD])
        _close(got["fleet/losses"], losses, "fleet losses")
        assert bool(got["fleet/lamb"])
        np.testing.assert_array_equal(got["sampler/nranks"], [WORLD, r])
        seen += list(got["sampler"])
    assert sorted(seen) == list(range(20))


def test_zero2_step_reads_parameters_written_between_steps():
    """ZeRO-2 keeps each parameter's chunk between steps and reloads it
    only when the parameter was written since its last gather: a
    set_value between steps reaches the next update. One process, no
    process group (sharding 1): the losses and parameters equal
    jit.TrainStep's with the same write."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit, optimizer as topt
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
    from paddle_tpu_torch.parallel import (ShardedTrainStep, build_mesh,
                                           set_global_mesh)
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle.set_device("cpu")
    x, y = (torch.from_numpy(a) for a in _batch())
    runs = []
    try:
        for sharded in (False, True):
            mesh = build_mesh(dp=1)
            set_global_mesh(mesh)
            model = GPT(GPTConfig(vocab_size=64, hidden_size=32,
                                  num_layers=2, num_heads=2,
                                  max_seq_len=16), device="cpu", seed=3)
            o = topt.Adam(1e-3, parameters=model.parameters())
            step = ShardedTrainStep(model, gpt_loss_fn, o, mesh=mesh,
                                    sharding_stage=2) if sharded else \
                jit.TrainStep(model, gpt_loss_fn, o)
            losses = [float(step(x, y)) for _ in range(2)]
            w = model.blocks[0].mlp.up.weight
            w.set_value(np.full(tuple(w.shape), 0.01, np.float32))
            losses += [float(step(x, y)) for _ in range(2)]
            runs.append((losses, [p.detach().clone()
                                  for p in model.parameters()]))
    finally:
        set_global_mesh(None)
        place._default = prev
    assert runs[1][0] == runs[0][0]
    for a, b in zip(runs[1][1], runs[0][1]):
        assert torch.equal(a, b)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_propagates_child_failure(tmp_path):
    """python -m paddle_tpu_torch.distributed.launch: a child that exits
    3 stops the pod and the launcher exits 3 (test_multiprocess.py:112);
    each child sees the env contract of its rank."""
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import os, sys\n"
        "r = os.environ['PADDLE_TRAINER_ID']\n"
        "open(os.path.join(os.path.dirname(__file__), 'env' + r), 'w')"
        ".write(os.environ['PADDLE_TRAINERS_NUM'] + ' ' + "
        "os.environ['CUDA_VISIBLE_DEVICES'])\n"
        "sys.exit(3 if r == '1' else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--port", str(_free_port()), str(bad)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert (tmp_path / "env1").read_text() == "2 1"

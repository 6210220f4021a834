"""Pipeline parallelism of the port (parallel/pipeline.py) against the
JAX package.

The multi-rank cases run on 4 gloo ranks (tests/test_torch_dist_worker.py,
suite "pipeline", one spawn for the module): PipelinedGPT at pp 2 x dp 2
(test_distributed.py:104's model) under 5 Adam and 5 SGD steps against
the JAX PipelinedGPT's ShardedTrainStep on one device, and PipelineLayer
at pp 4 with 16 microbatches (:267) against the JAX blocks run in
sequence, then 3 AdamW steps against the JAX PipelineLayer on one
device; then Lamb and Lars over ZeRO chunks and tp slices and a clip
of no built-in class, against the same steps on whole parameters in
this process. The remat bound (:316) and the refusals run in this
process.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jpaddle
import paddle_tpu.models.generation as jgen
import paddle_tpu.optimizer as jopt
from paddle_tpu import nn as jnn
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.parallel import (ShardedTrainStep as JShardedTrainStep,
                                 build_mesh as jbuild_mesh,
                                 set_global_mesh as jset_global_mesh)
from paddle_tpu.parallel.pipeline import (
    PipelinedGPT as JPipelinedGPT, PipelineLayer as JPipelineLayer,
    pipelined_gpt_loss_fn as jpipelined_gpt_loss_fn)

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel import build_mesh, set_global_mesh
from paddle_tpu_torch.parallel.pipeline import (PipelinedGPT,
                                                PipelineLayer,
                                                pipeline_spmd)

from test_torch_dist_worker import SGD_LR, run_cluster

# losses within REL (relative), parameters within PARAM_REL of each
# array's largest magnitude (SGD: REL), as in test_torch_distributed.py
REL = 1e-5
PARAM_REL = 5e-5
# the PipelineLayer's output against the blocks in sequence (f32)
OUT_TOL = 1e-5
# Lamb's key bias: its gradient is zero in exact arithmetic, so each
# package's update is lr times Adam's normalised rounding noise (the
# bias starts at 0, so the trust ratio is 1): under 3 steps of lr 1e-3
# times noise / (noise + epsilon 1e-6), itself under 1e-3 (measured
# 1.06e-6)
LAMB_KEY_BIAS_ABS = 3e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    from paddle_tpu_torch.core import place
    n, prev = torch.get_num_threads(), place._default
    torch.set_num_threads(1)
    tpaddle.set_device("cpu")
    yield
    torch.set_num_threads(n)
    place._default = prev


def _cfg(cls):
    return cls(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2,
               max_seq_len=16)


class JBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.fc2 = jnn.Linear(32, 16)
        self.ln = jnn.LayerNorm(16)

    def forward(self, x):
        return self.ln(x + self.fc2(jpaddle.tanh(self.fc1(x))))


def _one_device():
    mesh = jbuild_mesh(dp=1, devices=jax.devices()[:1])
    jset_global_mesh(mesh)
    return mesh


def _jax_pgpt():
    mesh = _one_device()
    jpaddle.seed(0)
    return JPipelinedGPT(_cfg(JGPTConfig), mesh), mesh


def _jax_blocks():
    jpaddle.seed(7)
    return [JBlock() for _ in range(4)]


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.RandomState(0)
    inputs = {"x": rng.randint(0, 64, (8, 16)).astype(np.int64),
              "y": rng.randint(0, 64, (8, 16)).astype(np.int64),
              "blk_x": rng.randn(16, 3, 16).astype(np.float32),
              "blk_y": rng.randn(16, 3, 16).astype(np.float32)}
    model, _ = _jax_pgpt()
    inputs.update({f"pgpt/{k}": np.asarray(v.numpy())
                   for k, v in model.state_dict().items()})
    for b, blk in enumerate(_jax_blocks()):
        inputs.update({f"blk{b}/{k}": np.asarray(v.numpy())
                       for k, v in blk.state_dict().items()})
    jset_global_mesh(None)
    inputs.update({f"gpt/{k}": v for k, v in _jax_tiny_gpt_params().items()})
    return {"inputs": inputs, "ranks": run_cluster(inputs, 4, "pipeline")}


def _jax_pgpt_run(inputs, sgd):
    model, mesh = _jax_pgpt()
    try:
        optim = jopt.SGD(SGD_LR, parameters=model.parameters()) if sgd \
            else jopt.Adam(1e-3, epsilon=1e-6,
                           parameters=model.parameters())
        step = JShardedTrainStep(model, jpipelined_gpt_loss_fn, optim,
                                 mesh=mesh)
        x, y = (jpaddle.to_tensor(inputs[k]) for k in ("x", "y"))
        losses = np.array([float(step(x, y).numpy()) for _ in range(5)])
        return losses, {k: np.asarray(v.numpy())
                        for k, v in model.state_dict().items()}
    finally:
        jset_global_mesh(None)


def _close(got, want, what, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("sgd", [False, True])
def test_pipelined_gpt_pp2_dp2_matches_jax(cluster, sgd):
    """PipelinedGPT at pp 2 x dp 2 (2 layers a stage, 2 microbatches of 2
    rows a dp rank) under ShardedTrainStep: every rank's losses equal,
    within REL of the JAX step's on one device and falling; the stacked
    state gathered over pp, under the JAX names, within PARAM_REL (SGD:
    REL, where a gradient at the wrong scale, a stage's embedding
    gradient summed twice, would move whole updates)."""
    losses, state = _jax_pgpt_run(cluster["inputs"], sgd)
    ranks = cluster["ranks"]
    tag = "pgpt" + ("_sgd" if sgd else "")
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][f"{tag}/losses"],
                                      ranks[0][f"{tag}/losses"])
    _close(ranks[0][f"{tag}/losses"], losses, f"{tag} losses", REL)
    assert losses[-1] < losses[0]
    for k, want in state.items():
        for r in range(4):
            _close(ranks[r][f"{tag}/{k}"], want, f"{tag} {k} rank {r}",
                   REL if sgd else PARAM_REL)
    # each stage holds its half of the stacked layers
    assert list(ranks[0][f"{tag}/local_qkv"]) == [2, 32, 96]


def test_pipeline_layer_pp4_micro16_matches_jax(cluster):
    """PipelineLayer at pp 4 with 16 microbatches equals the JAX blocks
    run in sequence on every rank, and 3 AdamW steps equal the JAX
    PipelineLayer's on one device."""
    inputs = cluster["inputs"]
    blocks = _jax_blocks()
    ref = jpaddle.to_tensor(inputs["blk_x"])
    for b in blocks:
        ref = b(ref)
    for r in range(4):
        np.testing.assert_allclose(cluster["ranks"][r]["pipe/out"],
                                   ref.numpy(), rtol=0, atol=OUT_TOL)
    mesh = _one_device()
    try:
        pipe = JPipelineLayer(blocks, mesh=mesh, num_micro=16)
        optim = jopt.AdamW(1e-2, parameters=pipe.parameters())
        step = JShardedTrainStep(
            pipe, lambda m, a, b: ((m(a) - b) ** 2).mean(), optim,
            mesh=mesh)
        x, y = (jpaddle.to_tensor(inputs[k]) for k in ("blk_x", "blk_y"))
        want = [float(step(x, y).numpy()) for _ in range(3)]
    finally:
        jset_global_mesh(None)
    got = cluster["ranks"][0]["pipe/losses"]
    _close(got, want, "PipelineLayer losses", REL)
    assert got[-1] < got[0]


def _jax_tiny_gpt_params():
    jpaddle.seed(0)
    cfg = JGPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, max_seq_len=16)
    return {k: np.asarray(v) for k, v in
            jgen.extract_params(JGPT(cfg)).items()}


def _one_process_run(inputs, name):
    """Losses and final parameters of the same 3 steps through the
    port's jit.TrainStep in this process, on whole parameters (the
    optimizers' formulas are held to the JAX package's in
    test_torch_optimizers.py)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.nn.layer.layers import gather_jax_state
    import test_torch_dist_worker as worker
    model = GPT.load_jax_params(
        GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                  max_seq_len=16),
        {k[4:]: v for k, v in inputs.items() if k.startswith("gpt/")},
        device="cpu")
    ps = model.parameters()
    optim = {"lamb": lambda: topt.Lamb(1e-3, parameters=ps),
             "lars": lambda: topt.Lars(0.1, momentum=0.9, parameters=ps),
             "clip": lambda: topt.SGD(
                 SGD_LR, parameters=ps,
                 grad_clip=worker._ScaleByGlobalNorm.make())}[name]()
    step = jit.TrainStep(model, gpt_loss_fn, optim)
    x, y = (torch.from_numpy(inputs[k]) for k in ("x", "y"))
    losses = np.array([float(step(x, y)) for _ in range(3)])
    return losses, gather_jax_state(model)


@pytest.mark.parametrize("name", ["lamb", "lars", "clip"])
def test_sharded_optimizers_take_whole_norms(cluster, name):
    """Lamb at sharding 2 x tp 2 under ZeRO-2, Lars at sharding 4 under
    ZeRO-1 (each update needs the whole parameter's norm: the pieces'
    sums of squares all-reduced) and SGD with a clip of no built-in
    class at sharding 2 x tp 2 (its clip_arrays on the whole gradients,
    gathered, as the JAX step calls it): 3 steps on 4 gloo ranks equal
    the same steps on whole parameters in one process, losses within
    REL, parameters within PARAM_REL (Lamb, whose Adam moments amplify
    rounding; its zero-gradient key bias within LAMB_KEY_BIAS_ABS) or
    REL."""
    losses, params = _one_process_run(cluster["inputs"], name)
    ranks = cluster["ranks"]
    tag = f"opt_{name}"
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][f"{tag}/losses"],
                                      ranks[0][f"{tag}/losses"])
    _close(ranks[0][f"{tag}/losses"], losses, f"{tag} losses", REL)
    rel = PARAM_REL if name == "lamb" else REL
    for k, want in params.items():
        got = ranks[0][f"{tag}/{k}"]
        if name == "lamb" and k.endswith("attn.qkv.bias"):
            q, kb, v = np.split(got, 3)
            wq, wk, wv = np.split(want, 3)
            _close(np.concatenate([q, v]), np.concatenate([wq, wv]),
                   f"{tag} {k}", rel)
            assert np.abs(kb - wk).max() <= LAMB_KEY_BIAS_ABS, (tag, k)
            continue
        _close(got, want, f"{tag} {k}", rel)


def _saved_bytes(num_micro, remat):
    """Bytes of the distinct storages autograd keeps for the backward of
    one pipelined forward (pp 1, 4 layers, a fixed global batch of 32),
    counted with saved_tensors_hooks, the stacked parameters' own
    storage left out."""
    set_global_mesh(build_mesh())
    try:
        H, inner = 16, 64

        def stage(p, x):
            return x + torch.nn.functional.gelu(x @ p["w1"]) @ p["w2"]
        rs = np.random.RandomState(0)
        stacked = {"w1": torch.tensor(rs.randn(4, H, inner),
                                      dtype=torch.float32,
                                      requires_grad=True),
                   "w2": torch.tensor(rs.randn(4, inner, H),
                                      dtype=torch.float32,
                                      requires_grad=True)}
        fn = pipeline_spmd(stage, build_mesh(), 1, num_micro,
                           remat_stages=remat)
        xs = torch.zeros(num_micro, 32 // num_micro, H)
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = (fn(stacked, xs) ** 2).sum()
        del loss
        params = {p.untyped_storage().data_ptr() for p in stacked.values()}
        return sum(b for ptr, b in seen.items() if ptr not in params)
    finally:
        set_global_mesh(None)


def test_pipeline_remat_bounds_saved_tensors():
    """With remat_stages each layer runs under recompute, so the bytes
    kept for the backward are one input per layer and microbatch (a
    fixed total at a fixed global batch), not every layer's internals:
    growing num_micro 4 -> 16 keeps them within 2x, and they stay under
    half of the build without remat (test_distributed.py:316's bound)."""
    remat_4 = _saved_bytes(4, True)
    remat_16 = _saved_bytes(16, True)
    plain_16 = _saved_bytes(16, False)
    assert remat_16 < 2 * remat_4, (remat_4, remat_16)
    assert remat_16 < plain_16 / 2, (remat_16, plain_16)


class Block(nn.Layer):
    def __init__(self, width=32, dropout=False, bn=False):
        super().__init__()
        self.fc1 = nn.Linear(16, width)
        self.fc2 = nn.Linear(width, 16)
        if dropout:
            self.drop = nn.Dropout(0.1)
        if bn:
            self.bn = nn.BatchNorm1D(16)

    def forward(self, x):
        return x + self.fc2(torch.tanh(self.fc1(x)))


def test_pipeline_layer_refusals_as_jax():
    """Blocks of different parameter structure, with buffers, or with
    dropout layers are refused, as in the JAX package."""
    mesh = build_mesh()
    with pytest.raises(ValueError, match="one parameter"):
        PipelineLayer([Block(), Block(width=8)], mesh=mesh)
    with pytest.raises(ValueError, match="buffer-free"):
        PipelineLayer([Block(bn=True)], mesh=mesh)
    with pytest.raises(ValueError, match="RNG layers"):
        PipelineLayer([Block(dropout=True)], mesh=mesh)
    with pytest.raises(ValueError, match="at least one"):
        PipelineLayer([], mesh=mesh)
    with pytest.raises(ValueError, match="microbatches"):
        PipelineLayer([Block()], mesh=mesh, num_micro=3)(torch.zeros(4, 16))


def test_pipelined_gpt_names_shapes_and_state_match_jax():
    """The port's PipelinedGPT lists the JAX model's parameters, names,
    order and shapes; load_jax_params and state_dict round-trip the JAX
    state; the first loss at pp 1 equals the JAX model's."""
    model, mesh = _jax_pgpt()
    try:
        state = {k: np.asarray(v.numpy())
                 for k, v in model.state_dict().items()}
        rng = np.random.RandomState(3)
        x = rng.randint(0, 64, (4, 16)).astype(np.int64)
        y = rng.randint(0, 64, (4, 16)).astype(np.int64)
        want = float(model.loss(jpaddle.to_tensor(x),
                                jpaddle.to_tensor(y)).numpy())
    finally:
        jset_global_mesh(None)
    port = PipelinedGPT.load_jax_params(_cfg(GPTConfig), state,
                                        device="cpu", mesh=build_mesh())
    assert [(k, tuple(p.shape)) for k, p in port.named_parameters()] == \
        [(k, v.shape) for k, v in state.items()]
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    got = float(port.loss(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) <= REL * abs(want), (got, want)
    with pytest.raises(ValueError, match="microbatches"):
        port.loss(torch.from_numpy(x), torch.from_numpy(y), num_micro=3)


def test_from_gpt_holds_the_gpts_function():
    """PipelinedGPT.from_gpt (chip_smoke phase 37 builds the 1.3B model's
    pipelined twin so) stacks a port GPT's weights: the same logits and
    loss at pp 1 over 2 microbatches, within OUT_TOL of the GPT's."""
    from paddle_tpu_torch.models.gpt import GPT
    gpt = GPT(_cfg(GPTConfig), device="cpu", seed=3)
    pipe = PipelinedGPT.from_gpt(gpt, mesh=build_mesh())
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(0, 64, (4, 16)))
    y = torch.from_numpy(rng.randint(0, 64, (4, 16)))
    with torch.no_grad():
        torch.testing.assert_close(pipe.logits(x, num_micro=2), gpt(x),
                                   rtol=0, atol=OUT_TOL)
        assert abs(float(pipe.loss(x, y, num_micro=2))
                   - float(gpt.loss(x, y))) <= OUT_TOL

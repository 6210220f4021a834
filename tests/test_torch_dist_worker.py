"""The ranks of tests/test_torch_distributed.py, test_torch_moe.py,
test_torch_ring_attention.py, test_torch_pipeline.py,
test_torch_comm_opt.py and test_torch_ps.py.

    python tests/test_torch_dist_worker.py OUT_DIR NPROCS SUITE

starts NPROCS gloo ranks on the CPU through the port's
paddle_tpu_torch.distributed.spawn. Each rank reads OUT_DIR/inputs.npz
(weights and batches the test wrote from the JAX package), runs the
scenarios of SUITE ("distributed": collectives, the training runs
under Adam and SGD, TP layers, SyncBatchNorm, the fleet; "moe": MoEMLP
and the MoE GPT at dp 2 x ep 2; "ring": ring and Ulysses attention at
sp 4 and the sequence- and context-parallel GPT; "pipeline":
PipelinedGPT at pp 2 x dp 2, PipelineLayer at pp 4, Lamb / Lars and a
clip of no built-in class over sharded parameters; "comm_opt":
LocalSGD, adaptive LocalSGD, DGC and the fp16 allreduce at dp 4;
"ps": fleet.metrics) and writes OUT_DIR/rank{r}.npz. This file imports
torch and the port only: the JAX references are computed in the pytest
process.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cluster(inputs: dict, nprocs: int, suite: str, timeout=300):
    """Run this file's ranks on `inputs` (from a test); {rank: results}.
    A rendezvous port taken by another process between its choice and
    its bind (other tests start clusters at the same time) gets one more
    try on fresh ports; any other failure fails the test."""
    with tempfile.TemporaryDirectory() as out_dir:
        np.savez(os.path.join(out_dir, "inputs.npz"), **inputs)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("PADDLE_TRAINERS_NUM", None)
        for _ in range(2):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), out_dir,
                 str(nprocs), suite],
                env=env, capture_output=True, text=True, timeout=timeout)
            if "Address already in use" not in proc.stderr:
                break
        assert proc.returncode == 0, \
            proc.stdout[-4000:] + proc.stderr[-8000:]
        out = {}
        for r in range(nprocs):
            with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
                out[r] = {k: f[k] for k in f.files}
        return out


def _cfg(**kw):
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, max_seq_len=16, **kw)


# the MoE GPT of test_torch_moe.py: every block MoE, 4 experts, top-2,
# capacity factor 1.0 (its 8 x 16 batch drops pairs)
MOE_GPT = dict(moe_experts=4, moe_top_k=2, moe_every=1,
               moe_capacity_factor=1.0)
SGD_LR = 0.1


def _gpt(inp, mesh, cfg_kw=None, prefix="gpt/"):
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.parallel import set_global_mesh
    set_global_mesh(mesh)
    state = {k[len(prefix):]: inp[k] for k in inp.files
             if k.startswith(prefix)}
    return GPT.load_jax_params(_cfg(**(cfg_kw or {})), state, device="cpu")


def _train(inp, out, name, mesh_kw, stage=0, k=1, steps=5, sgd=False,
           moe=False, batch_spec=("dp", "sharding"), cfg_kw=None,
           adamw=False, make_opt=None):
    """5 Adam (or SGD, or AdamW, or make_opt(parameters)'s) steps of the
    tiny GPT (or the MoE GPT, or the GPT with `cfg_kw`) under
    ShardedTrainStep; the losses and the gathered final parameters under
    `name`, and for the MoE GPT the pairs its blocks dropped at step
    1."""
    import torch
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.nn.layer.layers import gather_jax_state
    from paddle_tpu_torch.parallel import ShardedTrainStep, build_mesh
    model = _gpt(inp, build_mesh(**mesh_kw),
                 MOE_GPT if moe else cfg_kw, "moegpt/" if moe else "gpt/")
    o = make_opt(model.parameters()) if make_opt else \
        opt.SGD(SGD_LR, parameters=model.parameters()) if sgd else \
        opt.AdamW(1e-3, epsilon=1e-6, parameters=model.parameters()) \
        if adamw else \
        opt.Adam(1e-3, epsilon=1e-6, parameters=model.parameters())
    step = ShardedTrainStep(model, gpt_loss_fn, o, sharding_stage=stage,
                            batch_spec=batch_spec, grad_accum_steps=k)
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    losses = [float(step(x, y))]
    if moe:
        out[f"{name}/dropped"] = np.array(
            [int(b.mlp.dropped) for b in model.blocks])
    losses += [float(step(x, y)) for _ in range(steps - 1)]
    out[f"{name}/losses"] = np.array(losses)
    step.unshard()
    for key, v in gather_jax_state(model).items():
        out[f"{name}/{key}"] = v
    return model


def _collectives(out, rank, world):
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel import (TopologyError, build_mesh,
                                           set_global_mesh)
    set_global_mesh(None)
    got = dist.all_gather([], torch.tensor([float(rank), rank + 0.5]))
    out["all_gather"] = np.stack([t.numpy() for t in got])
    rs = torch.empty(1)
    dist.reduce_scatter(rs, torch.arange(world, dtype=torch.float32) + rank)
    out["reduce_scatter"] = rs.numpy()
    for dt in (torch.float32, torch.bfloat16):
        t = torch.tensor([float(rank)], dtype=dt)
        back = torch.empty(1, dtype=dt)
        dst, src = (rank + 1) % world, (rank - 1) % world
        if rank % 2:
            dist.recv(back, src)
            dist.send(t, dst)
        else:
            dist.send(t, dst)
            dist.recv(back, src)
        out[f"ring_{str(dt)[6:]}"] = back.float().numpy()
    b = torch.full([2], float(rank))
    dist.broadcast(b, src=3)
    out["broadcast"] = b.numpy()
    parts = [torch.tensor([10.0 * rank + s]) for s in range(world)]
    got = dist.alltoall(parts, [])
    out["alltoall"] = np.concatenate([t.numpy() for t in got])
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t, getattr(dist.ReduceOp, op))
        out[f"all_reduce_{op}"] = t.numpy()
    x = torch.tensor([rank + 1.0])
    out["c_allreduce_sum"] = dist.c_allreduce_sum(x).numpy()
    out["c_allgather"] = dist.c_allgather(x).numpy()
    out["c_input_kept"] = x.numpy()
    objs = dist.all_gather_object([], {"rank": rank})
    out["all_gather_object"] = np.array([o["rank"] for o in objs])
    dist.barrier()
    try:
        build_mesh(dp=3)
        out["topology_error"] = np.array(0)
    except TopologyError:
        out["topology_error"] = np.array(1)


def _tp_layers(inp, out):
    """The TP layers at tp 2 (dp 2): outputs, input gradients and the
    gathered weight gradients."""
    import torch
    from paddle_tpu_torch.distributed import (ColumnParallelLinear,
                                              ParallelCrossEntropy,
                                              RowParallelLinear,
                                              VocabParallelEmbedding)
    from paddle_tpu_torch.nn.layer.layers import (gather_jax_state,
                                                  load_jax_state)
    from paddle_tpu_torch.parallel import api, build_mesh, set_global_mesh
    set_global_mesh(build_mesh(dp=2, tp=2))

    def grads_of(layer):
        return {k: api.whole_piece(p.grad, p).numpy()
                for k, p in layer.named_parameters()}

    for name, layer, arg in (
            ("col", ColumnParallelLinear(8, 16), "tp_x"),
            ("col_nogather", ColumnParallelLinear(8, 16,
                                                  gather_output=False),
             "tp_x"),
            ("row", RowParallelLinear(16, 8), "tp_x16"),
            ("emb", VocabParallelEmbedding(32, 8), "tp_ids")):
        load_jax_state(layer, {k: inp[f"{name}/{k}"]
                               for k in ("weight", "bias")
                               if f"{name}/{k}" in inp.files})
        x = torch.from_numpy(inp[arg])
        if x.is_floating_point():
            x.requires_grad_(True)
        y = layer(x)
        r = torch.from_numpy(inp[f"{name}/r"])
        if name == "col_nogather":
            r = api.local_piece(r, _marked_last())
        (y * r).sum().backward()
        y = y.detach()
        if name == "col_nogather":
            y = api.whole_piece(y, _marked_last())
        out[f"{name}/out"] = y.numpy()
        if x.is_floating_point():
            out[f"{name}/dx"] = x.grad.numpy()
        for k, g in grads_of(layer).items():
            out[f"{name}/d{k}"] = g
        for k, v in gather_jax_state(layer).items():
            out[f"{name}/state/{k}"] = v
    logits = torch.from_numpy(inp["ce/logits"])
    from paddle_tpu_torch.distributed.tp_layers import _tp
    _, n, r = _tp()
    local = logits[:, r * 8:(r + 1) * 8].clone().requires_grad_(True)
    label = torch.from_numpy(inp["ce/label"])
    loss = ParallelCrossEntropy()(local, label)
    (loss * torch.from_numpy(inp["ce/r"]).reshape(loss.shape)).sum().backward()
    out["ce/loss"] = loss.detach().numpy()
    out["ce/dlogits"] = api.whole_piece(local.grad, _marked_last()).numpy()


def _marked_last():
    """A stand-in parameter whose spec splits the last of two dims over
    tp (whole_piece reads the spec only)."""
    class _P:
        _partition_spec = (None, "tp")
    return _P()


def _sync_bn(inp, out, rank):
    """SyncBatchNorm at dp 2 (tp 2): the rank's half of the batch."""
    import torch
    from paddle_tpu_torch.nn import BatchNorm2D, SyncBatchNorm
    from paddle_tpu_torch.parallel import build_mesh, set_global_mesh
    mesh = build_mesh(dp=2, tp=2)
    set_global_mesh(mesh)
    bn = SyncBatchNorm.convert_sync_batchnorm(BatchNorm2D(3))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn/weight"]))
        bn.bias.copy_(torch.from_numpy(inp["bn/bias"]))
    d = mesh.coord("dp")
    x = torch.from_numpy(inp["bn/x"][d * 4:(d + 1) * 4]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(inp["bn/w"][d * 4:(d + 1) * 4])).sum().backward()
    out["bn/type"] = np.array(type(bn).__name__ == "SyncBatchNorm")
    out["bn/out"] = y.detach().numpy()
    out["bn/dx"] = x.grad.numpy()
    out["bn/dweight"] = bn.weight.grad.numpy()
    out["bn/dbias"] = bn.bias.grad.numpy()
    out["bn/mean"] = bn._mean.numpy()
    out["bn/var"] = bn._variance.numpy()


def _fleet(inp, out, rank):
    """test_fleet_end_to_end's strategy with amp off, the Lamb
    substitution and DistributedBatchSampler under a dp 4 mesh."""
    import torch
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.io import DistributedBatchSampler, TensorDataset
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.parallel import build_mesh, get_global_mesh
    from paddle_tpu_torch.parallel import set_global_mesh
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"sharding_degree": 2, "sharding_stage": 2}
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    mesh = get_global_mesh()
    out["fleet/mesh"] = np.array([mesh.shape[a] for a in
                                  ("dp", "sharding", "tp")])
    out["fleet/worker"] = np.array([fleet.worker_index(),
                                    fleet.worker_num()])
    fleet.barrier_worker()
    model = _gpt(inp, mesh)
    o = opt.Adam(1e-3, epsilon=1e-6, parameters=model.parameters())
    step = fleet.distributed_train_step(model, gpt_loss_fn, o)
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    out["fleet/losses"] = np.array([float(step(x, y)) for _ in range(4)])
    lamb = fleet.DistributedStrategy()
    lamb.lamb = True
    wrapped = fleet.distributed_optimizer(opt.Adam(0.01, parameters=list(
        model.parameters())), lamb)
    out["fleet/lamb"] = np.array(type(wrapped._inner).__name__ == "Lamb")
    set_global_mesh(build_mesh(dp=4))
    ds = TensorDataset([torch.arange(20).reshape(20, 1)])
    s = DistributedBatchSampler(ds, batch_size=2)
    out["sampler"] = np.array([i for b in s for i in b])
    out["sampler/nranks"] = np.array([s.nranks, s.local_rank])


def _moe(inp, out, name, batch_axes):
    """MoEMLP at dp 2 x ep 2 with the batch's rows split over
    `batch_axes`: this rank's block of rows (its index along them), its
    experts; loss sum(y * r) + 0.5 aux on each rank."""
    import torch
    from paddle_tpu_torch.distributed.moe import MoEMLP
    from paddle_tpu_torch.nn.layer.layers import load_jax_state
    from paddle_tpu_torch.parallel import api, build_mesh, set_global_mesh
    mesh = build_mesh(dp=2, ep=2)
    mesh.batch_axes = batch_axes
    set_global_mesh(mesh)
    m = MoEMLP(16, 4, ffn_hidden_size=32, top_k=2, capacity_factor=1.0)
    load_jax_state(m, {k[4:]: inp[k] for k in inp.files
                       if k.startswith("moe/")})
    n, c = mesh.axis_size(batch_axes), mesh.coord(batch_axes)
    rows = len(inp["moe_x"]) // n
    x = torch.from_numpy(inp["moe_x"][c * rows:(c + 1) * rows])
    x.requires_grad_(True)
    y = m(x)
    ((y * torch.from_numpy(inp["moe_r"][c * rows:(c + 1) * rows])).sum()
     + 0.5 * m.aux_loss).backward()
    out[f"{name}/out"] = y.detach().numpy()
    out[f"{name}/aux"] = m.aux_loss.detach().numpy()
    out[f"{name}/dx"] = x.grad.numpy()
    out[f"{name}/dropped"] = np.array(int(m.dropped))
    for k, p in m.named_parameters():
        out[f"{name}/d{k}"] = api.whole_piece(p.grad, p).numpy()
        out[f"{name}/local/{k}"] = np.array(p.shape)


def _ring(inp, out):
    """Ring and Ulysses attention at sp 4, causal and full: this rank's
    chunk of the output and of dq, dk, dv under the loss sum(out * w);
    then the GPT with context_parallel at sp 4 and dp 2 x sp 2 and the
    all-gathered keys (sequence_parallel) at dp 2 x sp 2, 3 AdamW and 3
    SGD steps each."""
    import torch
    from paddle_tpu_torch.parallel import (build_mesh, ring_attention,
                                           set_global_mesh,
                                           ulysses_attention)
    mesh = build_mesh(sp=4)
    set_global_mesh(mesh)
    i = mesh.coord("sp")
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                ulysses_attention)):
        for causal in (True, False):
            whole = [torch.from_numpy(inp[f"attn/{t}"]) for t in "qkvw"]
            tl = whole[0].shape[2] // 4
            q, k, v, w = (t[:, :, i * tl:(i + 1) * tl].clone()
                          for t in whole)
            loc = [t.requires_grad_(True) for t in (q, k, v)]
            o = fn(*loc, "sp", causal=causal)
            grads = torch.autograd.grad((o * w).sum(), loc)
            tag = f"{name}/{'causal' if causal else 'full'}"
            out[f"{tag}/out"] = o.detach().numpy()
            for g, t in zip(grads, ("dq", "dk", "dv")):
                out[f"{tag}/{t}"] = g.numpy()
    for sgd in (False, True):
        tag = "_sgd" if sgd else ""
        _train(inp, out, "cp_sp4" + tag, dict(sp=4), steps=3, sgd=sgd,
               adamw=not sgd, cfg_kw=dict(context_parallel=True))
        _train(inp, out, "cp_dp2sp2" + tag, dict(dp=2, sp=2), steps=3,
               sgd=sgd, adamw=not sgd, cfg_kw=dict(context_parallel=True))
        _train(inp, out, "ag_dp2sp2" + tag, dict(dp=2, sp=2), steps=3,
               sgd=sgd, adamw=not sgd, cfg_kw=dict(sequence_parallel=True))


class _Block:
    """test_distributed.py's PipelineLayer block, built on first use (the
    port's nn needs the CPU set as the device first)."""

    @staticmethod
    def make():
        import torch
        from paddle_tpu_torch import nn

        class Block(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Linear(16, 32)
                self.fc2 = nn.Linear(32, 16)
                self.ln = nn.LayerNorm(16)

            def forward(self, x):
                return self.ln(x + self.fc2(torch.tanh(self.fc1(x))))
        return Block()


class _ScaleByGlobalNorm:
    """A clip of no built-in class: every gradient times 1 / (1 + the
    global norm), so each rank needs the whole gradients (the tests'
    JAX twin is the same formula)."""

    @staticmethod
    def make():
        import torch
        from paddle_tpu_torch.nn.clip import ClipGradBase

        class ScaleByGlobalNorm(ClipGradBase):
            def clip_arrays(self, grads, need_clip=None):
                norm = torch.sqrt(sum(g.float().square().sum()
                                      for g in grads))
                return [g / (1.0 + norm) for g in grads]
        return ScaleByGlobalNorm()


SHARDED_OPT = {
    # Lamb and Lars over ZeRO chunks and tp slices, and an SGD whose clip
    # is no built-in class: each needs whole parameters or gradients
    "lamb": (dict(sharding=2, tp=2), 2),
    "lars": (dict(sharding=4), 1),
    "clip": (dict(sharding=2, tp=2), 2),
}


def _sharded_opts(inp, out):
    from paddle_tpu_torch import optimizer as opt
    makers = {
        "lamb": lambda ps: opt.Lamb(1e-3, parameters=ps),
        "lars": lambda ps: opt.Lars(0.1, momentum=0.9, parameters=ps),
        "clip": lambda ps: opt.SGD(SGD_LR, parameters=ps,
                                   grad_clip=_ScaleByGlobalNorm.make())}
    for name, (mesh_kw, stage) in SHARDED_OPT.items():
        _train(inp, out, f"opt_{name}", mesh_kw, stage, steps=3,
               make_opt=makers[name])


def _pipeline(inp, out):
    """PipelinedGPT at pp 2 x dp 2 (5 Adam and 5 SGD steps: losses and
    the gathered state) and PipelineLayer at pp 4 with 16 microbatches
    (its output, then 3 AdamW steps); then the sharded optimizer runs
    (SHARDED_OPT)."""
    import torch
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.nn.layer.layers import load_jax_state
    from paddle_tpu_torch.parallel import (ShardedTrainStep, build_mesh,
                                           set_global_mesh)
    from paddle_tpu_torch.parallel.pipeline import (PipelinedGPT,
                                                    PipelineLayer,
                                                    pipelined_gpt_loss_fn)
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                    num_heads=2, max_seq_len=16)
    state = {k[5:]: inp[k] for k in inp.files if k.startswith("pgpt/")}
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    for sgd in (False, True):
        mesh = build_mesh(dp=2, pp=2)
        set_global_mesh(mesh)
        model = PipelinedGPT.load_jax_params(cfg, state, device="cpu",
                                             mesh=mesh)
        o = opt.SGD(SGD_LR, parameters=model.parameters()) if sgd else \
            opt.Adam(1e-3, epsilon=1e-6, parameters=model.parameters())
        step = ShardedTrainStep(model, pipelined_gpt_loss_fn, o, mesh=mesh)
        name = "pgpt" + ("_sgd" if sgd else "")
        out[f"{name}/losses"] = np.array([float(step(x, y))
                                          for _ in range(5)])
        for k, v in model.state_dict().items():
            out[f"{name}/{k}"] = v.numpy()
        out[f"{name}/local_qkv"] = np.array(
            model.param("blk.qkv_w").shape)
    mesh = build_mesh(pp=4)
    set_global_mesh(mesh)
    blocks = []
    for b in range(4):
        blk = _Block.make()
        load_jax_state(blk, {k[len(f"blk{b}/"):]: inp[k] for k in inp.files
                             if k.startswith(f"blk{b}/")})
        blocks.append(blk)
    pipe = PipelineLayer(blocks, mesh=mesh, num_micro=16)
    bx = torch.from_numpy(inp["blk_x"])
    out["pipe/out"] = pipe(bx).detach().numpy()
    o = opt.AdamW(1e-2, parameters=pipe.parameters())
    step = ShardedTrainStep(pipe, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                            o, mesh=mesh)
    by = torch.from_numpy(inp["blk_y"])
    out["pipe/losses"] = np.array([float(step(bx, by)) for _ in range(3)])
    _sharded_opts(inp, out)


def _toy(inp):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn.layer.layers import load_jax_state
    return load_jax_state(nn.Linear(4, 2), {"weight": inp["toy/weight"],
                                            "bias": inp["toy/bias"]})


def _toy_loss(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _comm_opt(inp, out, rank):
    """test_strategies.py's cases at dp 4 on its toy Linear(4, 2)."""
    import torch
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.distributed.fleet.comm_opt import (
        AdaptiveLocalSGDStep, DGCStep, Fp16AllReduceStep, LocalSGDStep)
    from paddle_tpu_torch.parallel import build_mesh, set_global_mesh
    set_global_mesh(build_mesh(dp=4))
    X, Y = torch.from_numpy(inp["toy/X"]), torch.from_numpy(inp["toy/Y"])

    def weights(tag, model):
        out[f"{tag}/weight"] = model.weight.detach().numpy().copy()
        out[f"{tag}/bias"] = model.bias.detach().numpy().copy()

    m = _toy(inp)
    step = LocalSGDStep(m, _toy_loss, opt.SGD(0.1, parameters=m.parameters()),
                        k_steps=1)
    out["localsgd_k1/losses"] = np.array([float(step(X, Y))
                                          for _ in range(3)])
    weights("localsgd_k1", m)

    m = _toy(inp)
    step = LocalSGDStep(m, _toy_loss, opt.SGD(0.1, parameters=m.parameters()),
                        k_steps=3)
    for i in range(3):
        step(X, Y)
        for r in (0, 1):
            out[f"localsgd_k3/{i}/rank{r}"] = \
                step.rank_params(r)["weight"].numpy()
    weights("localsgd_k3", m)

    for dt in ("bfloat16", "float16"):
        m = _toy(inp)
        step = Fp16AllReduceStep(m, _toy_loss,
                                 opt.SGD(0.1, parameters=m.parameters()),
                                 dtype=dt)
        out[f"fp16_{dt}/losses"] = np.array([float(step(X, Y))
                                             for _ in range(3)])
        weights(f"fp16_{dt}", m)

    m = _toy(inp)
    mom = opt.Momentum(0.05, momentum=0.9, parameters=m.parameters())
    step = DGCStep(m, _toy_loss, mom, rampup_begin_step=2, rampup_step=4,
                   sparsity=[0.75, 0.9])
    out["dgc/losses"] = np.array([float(step(X, Y)) for _ in range(20)])
    out["dgc/density"] = np.array(step.last_density)
    weights("dgc", m)

    m = _toy(inp)
    step = AdaptiveLocalSGDStep(m, _toy_loss,
                                opt.SGD(0.1, parameters=m.parameters()),
                                init_k_steps=2)
    losses, ks = [], []
    for _ in range(6):
        losses.append(float(step(X, Y)))
        ks.append(step._k)
    out["adaptive/losses"] = np.array(losses)
    out["adaptive/k"] = np.array(ks)
    weights("adaptive", m)

    for flag, cfg in (("dgc", {"rampup_begin_step": 1, "rampup_step": 2,
                               "sparsity": [0.8]}),
                      ("localsgd", {"k_steps": 2, "begin_step": 1})):
        strat = fleet.DistributedStrategy()
        setattr(strat, flag, True)
        setattr(strat, f"{flag}_configs", cfg)
        fleet.init(is_collective=True, strategy=strat)
        m = _toy(inp)
        o = opt.Momentum(0.05, momentum=0.9, parameters=m.parameters()) \
            if flag == "dgc" else opt.SGD(0.1, parameters=m.parameters())
        step = fleet.distributed_train_step(m, _toy_loss, o, strategy=strat)
        out[f"fleet_{flag}/type"] = np.array(type(step).__name__)
        out[f"fleet_{flag}/losses"] = np.array([float(step(X, Y))
                                                for _ in range(8)])
        if flag == "dgc":
            out["fleet_dgc/density"] = np.array(step.last_density)
    from paddle_tpu_torch.distributed import collective
    collective.reset_collective_calls()
    m = _toy(inp)
    step = LocalSGDStep(m, _toy_loss, opt.SGD(0.1, parameters=m.parameters()),
                        k_steps=4)
    for _ in range(4):
        step(X, Y)
    out["localsgd_k4/calls"] = np.array(json.dumps(
        collective.collective_calls()))


def _metrics(inp, out, rank):
    """fleet.metrics over this rank's statistics."""
    from paddle_tpu_torch.distributed.fleet import metrics as M
    st = {k: inp[f"metrics/{k}"][rank] for k in
          ("stat", "correct", "total", "abserr", "sqrerr", "pos", "neg")}
    out["metrics/sum"] = M.sum(st["stat"])
    out["metrics/max"] = M.max(st["stat"])
    out["metrics/min"] = M.min(st["stat"])
    out["metrics/acc"] = np.array(M.acc(st["correct"], st["total"]))
    out["metrics/mae"] = np.array(M.mae(st["abserr"], st["total"]))
    out["metrics/mse"] = np.array(M.mse(st["sqrerr"], st["total"]))
    out["metrics/rmse"] = np.array(M.rmse(st["sqrerr"], st["total"]))
    out["metrics/auc"] = np.array(M.auc(st["pos"], st["neg"]))


def _rank_main(out_dir, suite):
    import torch
    import paddle_tpu_torch as paddle
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    from paddle_tpu_torch.distributed import init_parallel_env
    env = init_parallel_env()
    rank, world = env.rank, env.world_size
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    out = {}
    if suite == "ring":
        _ring(inp, out)
    elif suite == "pipeline":
        _pipeline(inp, out)
    elif suite == "comm_opt":
        _comm_opt(inp, out, rank)
    elif suite == "ps":
        _metrics(inp, out, rank)
    elif suite == "moe":
        _moe(inp, out, "dp", ("dp", "sharding"))
        _moe(inp, out, "dpep", ("dp", "ep"))
        for name, spec in (("gpt_dp", ("dp", "sharding")),
                           ("gpt_dpep", ("dp", "ep"))):
            _train(inp, out, name, dict(dp=2, ep=2), sgd=True, moe=True,
                   batch_spec=spec)
    else:
        _collectives(out, rank, world)
        for sgd in (False, True):
            tag = "_sgd" if sgd else ""
            _train(inp, out, "dp4" + tag, dict(dp=4), sgd=sgd)
            for stage in (1, 2, 3):
                _train(inp, out, f"zero{stage}{tag}", dict(sharding=4),
                       stage, sgd=sgd)
            _train(inp, out, "tp2zero2" + tag, dict(sharding=2, tp=2), 2,
                   sgd=sgd)
            _train(inp, out, "merge2" + tag, dict(dp=4), 0, k=2, sgd=sgd)
        from paddle_tpu_torch.nn.layer.layers import gather_jax_state
        from paddle_tpu_torch.parallel import build_mesh
        model = _gpt(inp, build_mesh(dp=2, tp=2))
        for key, v in gather_jax_state(model).items():
            out[f"tp_state/{key}"] = v
        out["tp_local_qkv"] = np.array(
            model.blocks[0].attn.qkv.weight.shape)
        _tp_layers(inp, out)
        _sync_bn(inp, out, rank)
        _fleet(inp, out, rank)
    from paddle_tpu_torch.distributed import collective
    out["calls"] = np.array(json.dumps(collective.collective_calls()))
    tmp = os.path.join(out_dir, f"rank{rank}.tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.npz"))


if __name__ == "__main__":
    from paddle_tpu_torch.distributed import spawn
    spawn(_rank_main, args=(sys.argv[1], sys.argv[3]),
          nprocs=int(sys.argv[2]))

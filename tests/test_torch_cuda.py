"""The port's CUDA kernels on the card (marker `cuda`; every test skips
on a machine without an NVIDIA GPU).

This file imports neither jax nor paddle_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

- K3 (ops/kernels/ragged_paged_attention) against both plain versions
  (the one-pass stream and the split-and-merge order of the kernel):
  f32 within 1e-5 (they sum their dot products and the split merge in
  different orders), bf16 pools within 1e-2 (bf16 output rounding,
  2**-8 relative on values of magnitude < 2), at the serving shape and
  at small shapes that force many splits (d 16, bs 4, 40 table columns,
  1-3 blocks a split); bitwise-equal output over repeated calls (the
  merge reads the partials in split order); a grid with fewer live CTAs
  than SMs; back-to-back calls on one stream with other N and table
  widths (the cached scratch and arrival counters are resized and left
  at zero); dead rows exact zeros; its launch counter and input checks;
- fused_decode_chunk on CUDA (through K3) against the same chunk on the
  CPU (through the plain version): tokens and flags exactly, pools
  within 1e-5;
- the engine on CUDA: ragged (K3) and bucketed (gather) routes give the
  same greedy tokens, and K3 launches layers x k x chunks times; with
  the prefix cache (f32 and int8 pools, dense and chunked admission)
  and with the host tier, the port's CPU tokens exactly, K3 reading
  blocks that several rows' tables name; generate() sampling and beam
  search equal to the CPU's; three tenants under WFQ admission priced
  by the committed cost model (one quota refusal) and the inference
  facade (Config.enable_llm_engine -> create_predictor -> run), each
  equal to the CPU's admission order and tokens;
- K1 (ops/kernels/flash_attention) and K2 (ops/kernels/packed_flash),
  forward (out, lse) and backward (dq, dk, dv), against their plain
  versions at T 128, 512 (ERNIE-large's), 640, 1024 and 2176, causal
  and not, in f32 (within
  1e-4 of each tensor's largest entry: blocked sums in another order),
  bf16 (within 2e-2: both round f32 results to bf16, 2**-8 relative,
  and the inputs of the gradients' products differ by that) and f16
  (within 2.5e-3, the bf16 limit over the ratio of the two types' unit
  roundoffs, 8);
  also non-causal K1 with Tq != Tk, a grid of 8-16 CTAs (fewer than the
  132 SMs), and bitwise-equal bf16 gradients from two runs (no atomics);
- a tiny GPT TrainStep on CUDA (through K1 and K2) against the same
  step on the CPU (through their plain versions): losses within 1e-4
  relative over 3 steps, in f32;
- the eager O1 loop (train_bench.eager_step) on a tiny GPT on CUDA in
  bf16 through K1 against the same loop on the CPU in f32 (losses
  within 2e-2 relative over 4 steps), and the same loop in float16
  through K1's float16 instance against the CPU's f32 loop (within
  2.5e-3: f16's unit roundoff is 2**-11);
- a bare Layer built without set_device makes its parameters on the
  card, as to_tensor makes tensors there;
- a tiny BERT MLM + NSP TrainStep (2 layers, 2 heads of 64, T 128,
  flash_attention_min_seq 128) on CUDA, through K2 non-causal, against
  the same step on the CPU through its plain version: losses within
  1e-4 relative over 3 steps, in f32, and K2 launched once a layer and
  step each way; a LeNet Adam TrainStep (batch 8) on CUDA against the
  CPU the same way, and MultiStepTrainStep(k=3) on CUDA equal to three
  TrainStep calls there (losses within 1e-5 relative);
- the static Executor on the card (a 2-layer GPT Program, K1 forward
  and backward once per layer a step) against the same program on the
  CPU, in f32 and under static.amp, and the inference artifact of its
  clone(for_test) (save_inference_model / load_inference_model)
  launching K1's forward once per layer with the Executor's logits;
- slice 10b: K2's custom ops (fake versions on meta tensors, the card
  against the plain version), a head-dim-64 GPT as a static Program on
  the card through K2 against the CPU, jit.save artifacts holding K1 or
  K2 as a graph node and serving two batch sizes through jit.load and
  the Predictor, to_static on card tensors equal to eager (control flow
  and a GPT's AdamW steps), and export_decoder / DecoderPredictor
  against generate();
- K4 (ops/kernels/fused_conv) against its plain version at M 1, 97,
  300, 512 and 6272, K 16 to 2048, N 16 to 512, with and without the
  residual: each element within one bf16 ulp of the plain value plus
  1e-3 of the output's rms (both round one f32 sum to bf16; the sums run
  in different orders, which near a cancellation moves the f32 value by
  more than a bf16 ulp of the small result); the same at every tile
  width the rule can choose (pinned through `block_n=`), at K not a
  multiple of 64 (16, 48, 80) and N not a multiple of the tile (16, 80,
  320), with more tiles than SMs (the ring runs on across tiles) and
  with fewer; scale and shift as [:K] views of buffers whose
  tail holds NaN (columns past K must transform to exactly 0);
  bitwise-equal output over three calls; its launch counter and the
  inputs it refuses;
- the batch-norm autograd Functions (`_BNCore`, `_BNActCore` with no,
  full and broadcast z) on the card in f32 against torch autograd of the
  same formulas written as plain ops (within 1e-4 of each tensor's
  largest entry: the statistics are summed in other orders) and against
  the same Functions on the CPU (within 1e-5);
- a ResNet-18 TrainStep (Momentum, batch 4 at 64x64, f32) on CUDA
  against the same step on the CPU: losses within 1e-4 relative over 3
  steps and running stats within 1e-4 of their largest entry; and one
  AMP O2 step on CUDA: finite loss, bf16 parameters, f32 running stats.

- a tiny Transformer (seq2seq_bench, d_model 128 in 2 heads of 64,
  T 128, flash_attention_min_seq 128) on CUDA through K1 non-causal
  against the same loop on the CPU (losses within 1e-4 relative over 3
  steps in f32, K1 launched once a layer pair each way; O1 bf16 within
  2e-2); the LSTM language model's loop and beam search on CUDA against
  the CPU (losses within 1e-5, beam ids and parents equal, scores within
  1e-5); the new optimizers on CUDA against the CPU (parameters within
  1e-5 relative L2 after 5 steps); paddle.save / load of card tensors.

- slice 6c, the vision half of nn, on CUDA against the CPU on the same
  inputs in f32: each family of functionals (convolutions and their
  transposes in both layouts, pooling with ceil mode and masks, the
  norms, resizing and the other vision ops) and every new layer, within
  1e-5 of the CPU's largest entry (values and, for the differentiable
  families, input gradients within 1e-4 relative L2: sums in other
  orders); MobileNetV2 (scale 0.25, RMSProp, 64x64) and VGG-11 with BN
  (features, Momentum) TrainSteps, and channel-last ResNet-18 with the
  space-to-depth stem, losses within 1e-4 relative over 3 steps; EMA,
  ModelAverage and Lookahead over 4 Momentum steps within 1e-5 relative
  L2.

- slice 7, the serving fleet: the controlled migration A/B
  (serving_traffic.migration_ab: greedy and sampled rows moved by
  drain(0, recompute=False) to an empty replica) on the card in f32 and
  int8 pools, the moved streams equal to the ones left in place token
  for token and to the CPU's; a kill -> restart on a tiny 3-replica
  fleet (chaos_serve.run_chaos_replicas with kill_replica) equal to the
  CPU's run, with the card's allocated memory after the restart within
  one pool of its value before the kill.

- slice 8a, the training runtime: DeviceLoader's batches pinned on the
  host (one pin_memory per tensor), then on the card, in order and
  bitwise equal to the CPU's; a skip_step TrainStep over a NaN batch
  leaves the parameters and Adam's moments bitwise as they were; an
  AutoCheckpointManager run killed after epoch 1 resumes on the card
  into a model from another seed with the uninterrupted run's losses
  (bitwise: one device, one order of operations); Model.fit of a tiny
  MLP on the card equal to Model.fit on the CPU (losses within 1e-5
  relative, f32 with TF32 off).

- slice 8b, the core op corpus: every replayed op case of
  paddle_tpu_torch/testing/op_cases (the cases that
  tests/test_torch_op_suite.py, _op_grad_suite.py and _op_tail.py hold
  to the JAX package on the CPU) on CUDA tensors against the port's own
  CPU result for the same inputs, forward and gradient: integer, index
  and sort/argsort/topk/mode/unique outputs exactly, float32 within
  1e-5 relative, float64 gradients within 1e-10, decompositions and
  solves (cuSOLVER against LAPACK) within 1e-4 up to sign or basis;
  every output on the card.

- slice 9a, data/ZeRO/expert parallelism over one card: over an NCCL
  process group of world size 1 (`nccl_world`), a ZeRO-2
  ShardedTrainStep of a tiny GPT (K1) against jit.TrainStep on the same
  weights, losses and parameters bitwise equal over 3 steps (the bucket
  path's reduce-scatter and all-gather over one rank move the same
  values, and the update runs the same elementwise ops), with its
  reduce-scatter and all-gather counters above 0; the indexed MoE
  routing against its dense twin at a capacity factor that drops pairs
  (outputs, aux, the dropped count and gradients within 1e-5 of each
  tensor's largest entry: sums in other orders); SyncBatchNorm
  against BatchNorm (outputs, input and weight gradients and running
  statistics within 1e-5: one-pass against two-pass variance; the
  gradients bitwise, one rank's backward being BatchNorm's arithmetic).

- slice 9b: one ring hop on K1 (a block's forward merged by lse with
  the diagonal's; the block's backward given the merged o and the whole
  row's lse) against the plain versions on the CPU, bf16 within 2e-2;
  DeviceEmbeddingCache on the card against the same cache on the CPU,
  sgd and adagrad with cold and negative ids: pulled rows and the
  flushed table bitwise.

float32 matmuls and convolutions run in full float32 (TF32 off for
cuBLAS and cuDNN, set by the fixture).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import (PACK_COLS, EngineConfig,
                                                LLMEngine, SamplingParams,
                                                fused_decode_chunk, pack_f32)
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.ops.kernels import packed_flash as k2
from paddle_tpu_torch.ops.kernels.fused_conv import (
    fused_scale_relu_matmul, fused_scale_relu_matmul_reference)
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k3
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    default_blocks_per_split, ragged_attention_reference,
    ragged_attention_split_reference, ragged_decode_attention, sm_count)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k3_inputs(device, dtype, n=8, h=6, d=128, bs=32, nb=512, mb=32,
               lengths=(0, 1, 31, 32, 33, 300, 1023, 1024)):
    rng = np.random.RandomState(0)
    tables = rng.permutation(nb)[:n * mb].reshape(n, mb).astype(np.int32)
    if n > 3:
        tables[3, 0] = nb                 # out of range inside the length
    g = torch.Generator().manual_seed(0)
    q = torch.randn(n, h, d, generator=g)
    kp = torch.randn(nb, bs, h, d, generator=g)
    vp = torch.randn(nb, bs, h, d, generator=g)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.from_numpy(tables).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain(cuda, dtype, atol):
    args = _k3_inputs(cuda, dtype)
    before = ragged_decode_attention.launches
    got = ragged_decode_attention(*args)
    torch.cuda.synchronize()
    assert ragged_decode_attention.launches == before + 1
    want = ragged_attention_reference(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    split = ragged_attention_split_reference(
        *args, default_blocks_per_split(8, 6, 32, sm_count(cuda)))
    torch.testing.assert_close(got.float(), split.float(), rtol=0,
                               atol=atol)
    assert torch.all(got[0] == 0)         # dead row


def test_kernel_small_head_dim_and_block(cuda):
    args = _k3_inputs(cuda, torch.float32, n=5, h=3, d=16, bs=4, nb=300,
                      mb=4, lengths=(0, 1, 6, 15, 16))
    got = ragged_decode_attention(*args)
    torch.testing.assert_close(got, ragged_attention_reference(*args),
                               rtol=0, atol=1e-5)


def _many_splits(cuda, dtype, n=6, lengths=(0, 1, 37, 80, 157, 160)):
    """d 16, bs 4, 40 table columns; row 4 has an out-of-range entry
    inside its length, row 5 a whole split of them at 2 a split."""
    args = list(_k3_inputs(cuda, dtype, n=n, h=3, d=16, bs=4, nb=300,
                           mb=40, lengths=lengths))
    tables = args[3].cpu()
    tables[n - 2, 5] = -1
    tables[n - 1, 2:4] = 300
    args[3] = tables.to(cuda)
    return args


@pytest.mark.parametrize("bps", [1, 2, 3, None])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_kernel_many_splits_matches_both_plain(cuda, bps, dtype, atol):
    args = _many_splits(cuda, dtype)
    got = ragged_decode_attention(*args, blocks_per_split=bps)
    torch.cuda.synchronize()
    split = ragged_attention_split_reference(
        *args, bps or default_blocks_per_split(6, 3, 40, sm_count(cuda)))
    for want in (ragged_attention_reference(*args), split):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)
    assert torch.all(got[0] == 0)


def test_kernel_is_bitwise_repeatable(cuda):
    for args, bps in ((_k3_inputs(cuda, torch.float32), None),
                      (_many_splits(cuda, torch.float32), 1)):
        outs = [ragged_decode_attention(*args, blocks_per_split=bps)
                for _ in range(3)]
        torch.cuda.synchronize()
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


def test_kernel_grid_smaller_than_the_card(cuda):
    """2 rows x 1 head x 4 splits: 8 CTAs, fewer than the 132 SMs."""
    args = _k3_inputs(cuda, torch.float32, n=2, h=1, d=128, bs=32, nb=64,
                      mb=8, lengths=(200, 7))
    got = ragged_decode_attention(*args, blocks_per_split=2)
    torch.testing.assert_close(got, ragged_attention_reference(*args),
                               rtol=0, atol=1e-5)


def test_kernel_back_to_back_shapes_reuse_scratch(cuda):
    """Calls on one stream with growing and shrinking N and table widths:
    each matches its plain version, and the arrival counters are zero
    after each call."""
    shapes = [(3, 8, (9, 0, 32)), (8, 40, (0, 1, 37, 80, 157, 160, 5, 99)),
              (2, 4, (16, 3)), (8, 40, (160, 159, 1, 0, 77, 4, 44, 8))]
    outs = []
    for n, mb, lengths in shapes:
        args = _k3_inputs(cuda, torch.float32, n=n, h=3, d=16, bs=4,
                          nb=400, mb=mb, lengths=lengths)
        outs.append((ragged_decode_attention(*args, blocks_per_split=1),
                     args))
    torch.cuda.synchronize()
    for got, args in outs:
        torch.testing.assert_close(got, ragged_attention_reference(*args),
                                   rtol=0, atol=1e-5)
    for _, counters in k3._SCRATCH.values():
        assert int(counters.abs().sum()) == 0


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, tables, lengths = _k3_inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        ragged_decode_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(TypeError):
        ragged_decode_attention(q.half(), kp.half(), vp.half(), tables,
                                lengths)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_decode_attention(q, kp.transpose(1, 2), vp, tables, lengths)
    with pytest.raises(ValueError):
        ragged_decode_attention(q, kp, vp, tables.cpu(), lengths)
    with pytest.raises(ValueError, match="blocks_per_split"):
        ragged_decode_attention(q, kp, vp, tables, lengths,
                                blocks_per_split=0)
    with pytest.raises(ValueError, match="16 bytes"):
        ragged_decode_attention(q[..., :10].contiguous(),
                                kp[..., :10].contiguous(),
                                vp[..., :10].contiguous(), tables, lengths)


def _tiny_model(device):
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                    num_heads=2, max_seq_len=64)
    model = GPT(cfg, device="cpu", seed=1)
    return model if device == "cpu" else model.to(device)


def test_fused_chunk_cuda_matches_cpu(cuda):
    k, bs, nb = 8, 8, 32
    cpu_model = _tiny_model("cpu")
    geom = cpu_model.cfg.geom
    L, H, D, S = geom
    mb = S // bs
    rng = np.random.RandomState(2)
    packed = np.zeros((4, PACK_COLS + k + mb), np.int32)
    rows = [(5, 13, 1, 20), (9, 20, 2, 6), (3, 7, 1, 40)]  # tok pos cnt max
    for i, (tok, pos, cnt, max_out) in enumerate(rows):
        packed[i, :PACK_COLS] = [tok, pos, 1, cnt, max_out, -1,
                                 pack_f32(0.0), 0, pack_f32(1.0), i, 0, 0]
        packed[i, PACK_COLS + k:PACK_COLS + k + 4] = np.arange(4) + 4 * i
    pools = [(rng.randn(nb, bs, H, D).astype(np.float32),
              rng.randn(nb, bs, H, D).astype(np.float32)) for _ in range(L)]
    outs = []
    for dev, model in (("cpu", cpu_model), (cuda, _tiny_model(cuda))):
        p = tuple((torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
                  for a, b in pools)
        out, p = fused_decode_chunk(gen.extract_params(model), p,
                                    torch.from_numpy(packed).to(dev), geom,
                                    k, "ragged")
        outs.append((out.cpu(), [(a.cpu(), b.cpu()) for a, b in p]))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for (ga, gb), (wa, wb) in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(ga, wa, rtol=0, atol=1e-5)
        torch.testing.assert_close(gb, wb, rtol=0, atol=1e-5)


def test_engine_ragged_matches_bucketed_and_counts_launches(cuda):
    model = _tiny_model(cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32)
               for n in (5, 20, 11, 33)]
    res = {}
    for kernel in ("ragged", "bucketed"):
        eng = LLMEngine.from_model(model, EngineConfig(
            block_size=8, num_blocks=40, max_num_seqs=4,
            decode_chunk_size=8, kernel=kernel,
            prefill_chunk_threshold=16), device=cuda)
        for i, p in enumerate(prompts):
            eng.add_request(p, SamplingParams(max_tokens=12),
                            request_id=f"r{i}")
        before = ragged_decode_attention.launches
        res[kernel] = eng.run(max_steps=200)
        launched = ragged_decode_attention.launches - before
        chunks = eng.stats.host_syncs("decode")
        assert launched == (2 * 8 * chunks if kernel == "ragged" else 0)
        eng.cache.check_integrity()
    for rid in res["ragged"]:
        np.testing.assert_array_equal(res["ragged"][rid],
                                      res["bucketed"][rid])


def _templated_arrivals(seed, n_tpl, tpl_len, n, gap, mt, suffix=(2, 6)):
    rng = np.random.RandomState(seed)
    tpls = [rng.randint(1, 97, (tpl_len,)).astype(np.int32)
            for _ in range(n_tpl)]
    return [(gap * i, np.concatenate([tpls[i % n_tpl], rng.randint(
        1, 97, (int(rng.randint(*suffix)),)).astype(np.int32)]), mt)
        for i in range(n)]


def _serve(device, arrivals, **kw):
    """The tiny model's engine on `device` over `arrivals`: (tokens per
    request, engine, K3 launches)."""
    from paddle_tpu_torch.tools.serving_traffic import drive_arrivals
    cfg = dict(dict(block_size=8, num_blocks=40, max_num_seqs=4,
                    decode_chunk_size=8, enable_prefix_cache=True), **kw)
    before = ragged_decode_attention.launches
    eng, rids = drive_arrivals(_tiny_model(device), EngineConfig(**cfg),
                               arrivals, device)
    launched = ragged_decode_attention.launches - before
    eng.cache.check_integrity()
    return [eng.get_request(r).output_ids for r in rids], eng, launched


@pytest.mark.parametrize("kw", [{}, dict(kv_cache_dtype="int8"),
                                dict(prefill_chunk_threshold=0)],
                         ids=["prefix", "prefix_int8", "prefix_chunked"])
def test_prefix_engine_cuda_matches_cpu(cuda, kw):
    """Templated traffic (hits on shared blocks and copy-on-write forks)
    through K3 on the card: the port's CPU tokens exactly, the audit
    clean, K3 launched layers x k x chunks times."""
    arrivals = _templated_arrivals(4, 2, 21, 8, 2, 10)
    want, _, _ = _serve("cpu", arrivals, **kw)
    got, eng, launched = _serve(cuda, arrivals, **kw)
    assert got == want
    ps = eng.cache.prefix_stats()
    assert ps["hits"] > 0 and ps["cow_forks"] > 0, ps
    assert launched == 2 * 8 * eng.stats.host_syncs("decode") > 0
    if kw.get("kv_cache_dtype") == "int8":
        assert all(q.dtype == torch.int8 and q.is_cuda
                   for (qk, qv), _ in eng.cache.stored_pools()
                   for q in (qk, qv))


def test_tiered_engine_cuda_matches_cpu(cuda):
    """More templates than the pool holds, revisited: demotions to host
    RAM and promotions back onto the card, tokens equal to the CPU's."""
    arrivals = _templated_arrivals(5, 4, 32, 6, 12, 6)
    arrivals += [(80 + i, p, mt) for i, (_, p, mt) in
                 enumerate(_templated_arrivals(5, 4, 32, 4, 0, 6))]
    kw = dict(num_blocks=16, host_tier_blocks=32, max_num_seqs=2)
    want, cpu_eng, _ = _serve("cpu", arrivals, **kw)
    got, eng, launched = _serve(cuda, arrivals, **kw)
    assert got == want
    ps = eng.cache.prefix_stats()
    assert ps == cpu_eng.cache.prefix_stats()
    assert ps["tier_demotions"] > 0 and ps["promote_hit"] > 0, ps
    assert launched == 2 * 8 * eng.stats.host_syncs("decode") > 0


def _tenant_run(device):
    """Three tenants (latency, batch-class bulk, a quota-bound burst) on
    the tiny model through drive_tenants: (admission order read from the
    trace, tokens per admitted request, quota refusals, engine)."""
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.tools.serving_traffic import (
        drive_tenants, make_tenant_registry, tenant_traffic)
    arrivals = tenant_traffic(97, 3, n=12, b_lo=20, b_hi=30, l_lo=3,
                              l_hi=6, template_len=12, s_lo=2, s_hi=4,
                              t_lo=3, t_hi=6)
    tenants = (dict(name="latency", priority="latency"),
               dict(name="bulk", priority="batch"),
               dict(name="burst", quota_tokens=25, quota_window_s=300.0))
    cfg = EngineConfig(block_size=8, num_blocks=40, max_num_seqs=4,
                       decode_chunk_size=8, prefill_chunk_threshold=16,
                       max_prefill_tokens=64, prefill_cost_model="auto",
                       obs_label=f"cuda-tenants-{torch.device(device).type}",
                       tenants=make_tenant_registry(serving, tenants))
    eng, by_tenant, quota, _ = drive_tenants(_tiny_model(device), cfg,
                                             arrivals, device)
    eng.cache.check_integrity()
    order = [e.request_id for e in obs.reqtrace.events(
        prefix=f"tr-{eng.stats.label}-") if e.kind == "scheduled"]
    tokens = {r: eng.get_request(r).output_ids
              for rids in by_tenant.values() for r in rids}
    return order, tokens, quota, eng


def test_tenant_engine_cuda_matches_cpu(cuda):
    """WFQ admission across three tenants, priced by the committed cost
    model, with a quota refusal: the same admission order, refusals and
    greedy tokens on the card (through K3) as on the CPU."""
    want = _tenant_run("cpu")
    before = ragged_decode_attention.launches
    got = _tenant_run(cuda)
    launched = ragged_decode_attention.launches - before
    assert got[:3] == want[:3]
    assert got[2], "no quota refusal: vacuous test"
    assert launched == 2 * 8 * got[3].stats.host_syncs("decode") > 0


def test_facade_cuda_matches_cpu(cuda):
    """Config.enable_llm_engine -> create_predictor -> run on the card
    (the default device) gives the CPU predictor's sequences."""
    from paddle_tpu_torch import inference
    rng = np.random.RandomState(8)
    lens = np.array([5, 9, 3])
    ids = np.zeros((3, 9), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(1, 97, n)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = inference.Config()
        if dev == "cpu":
            cfg.disable_gpu()
        cfg.enable_llm_engine(model=_tiny_model(dev), block_size=8,
                              num_blocks=40, max_num_seqs=4, max_tokens=7)
        pred = inference.create_predictor(cfg)
        assert pred.engine.device.type == dev
        [out[dev]] = pred.run([ids, lens])
    assert out["cuda"].dtype == np.int64
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


def test_sampling_generate_cuda_matches_cpu(cuda):
    """generate() with temperature, top-k and top-p draws the same
    tokens on the card as on the CPU (counter-based noise)."""
    ids = np.random.RandomState(6).randint(0, 97, (3, 5)).astype(np.int32)
    want = gen.generate(_tiny_model("cpu"), ids, 12, 0.9, 20, 0.9, None, 5)
    got = gen.generate(_tiny_model(cuda), ids, 12, 0.9, 20, 0.9, None, 5)
    np.testing.assert_array_equal(got, want)
    seqs, scores = gen.beam_search_generate(_tiny_model(cuda), ids, 3, 8)
    cseqs, cscores = gen.beam_search_generate(_tiny_model("cpu"), ids, 3, 8)
    np.testing.assert_array_equal(seqs, cseqs)
    np.testing.assert_allclose(scores, cscores, rtol=0, atol=1e-4)


# ------------------------------------------------------------- K1 and K2
def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _flash_inputs(kernel, cuda, T, dtype, seed=0, b=2, h=2, tk=None):
    d = 64 if kernel == "k1_d64" else 128
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=g).to(cuda, dtype)
            for n in (T, tk or T, tk or T, T)]


def _flash_case(kernel, cuda, T, causal, dtype, seed=0, b=2, h=2, tk=None):
    """(kernel outputs, plain outputs) for out, lse, dq, dk, dv."""
    q, k, v, do = _flash_inputs(kernel, cuda, T, dtype, seed, b, h, tk)
    d = q.shape[-1]
    if kernel.startswith("k1"):
        fwd, bwd, ref = (k1.flash_attention_fwd, k1.flash_attention_bwd,
                         k1.flash_attention_reference)
        scale = 1.0 / d ** 0.5
    else:
        fwd, bwd, ref = (k2.packed_flash_fwd, k2.packed_flash_bwd,
                         k2.packed_flash_reference)
        scale = 0.125
    before = (fwd.launches, bwd.launches)
    o, lse = fwd(q, k, v, causal, scale)
    grads = bwd(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    ro, rlse = ref(qr, kr, vr, causal, scale, return_lse=True)
    rgrads = torch.autograd.grad(ro, (qr, kr, vr), do)
    return (o, lse, *grads), (ro, rlse, *rgrads)


@pytest.mark.parametrize("kernel", ["k1", "k1_d64", "k2"])
@pytest.mark.parametrize("T", [128, 512, 640, 1024, 2176])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2.5e-3)])
def test_flash_kernels_match_plain(cuda, kernel, T, causal, dtype, tol):
    got, want = _flash_case(kernel, cuda, T, causal, dtype)
    _assert_flash_close(got, want, tol)


def _assert_flash_close(got, want, tol):
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2.5e-3)])
@pytest.mark.parametrize("tq,tk", [(256, 640), (640, 256)])
def test_flash_k1_query_and_key_lengths_differ(cuda, tq, tk, dtype, tol):
    """Non-causal K1 with Tq != Tk, which `supported` admits."""
    got, want = _flash_case("k1", cuda, tq, False, dtype, tk=tk)
    _assert_flash_close(got, want, tol)


@pytest.mark.parametrize("kernel", ["k1", "k1_d64", "k2"])
def test_flash_kernels_with_fewer_ctas_than_sms(cuda, kernel):
    """B * H * (T / 128) = 8 CTAs a kernel (16 for K2's two packed
    heads), far under the H100's 132 SMs: the tile loops and rings do
    not depend on a full grid."""
    got, want = _flash_case(kernel, cuda, 1024, True, torch.bfloat16, b=1,
                            h=1)
    _assert_flash_close(got, want, 2e-2)


@pytest.mark.parametrize("kernel", ["k1", "k1_d64", "k2"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_gradients_are_deterministic(cuda, kernel, causal):
    """dq and dk/dv come from separate kernels that each write their
    outputs once (no atomics): the same inputs give bitwise-equal
    gradients."""
    q, k, v, do = _flash_inputs(kernel, cuda, 640, torch.bfloat16, seed=3)
    if kernel.startswith("k1"):
        fwd, bwd, scale = (k1.flash_attention_fwd, k1.flash_attention_bwd,
                           1.0 / q.shape[-1] ** 0.5)
    else:
        fwd, bwd, scale = k2.packed_flash_fwd, k2.packed_flash_bwd, 0.125
    o, lse = fwd(q, k, v, causal, scale)
    first = bwd(q, k, v, o, lse, do, causal, scale)
    second = bwd(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_kernel_reads_strided_views(cuda):
    """sliced_qkv's views ([B, T, H, D] storage read as [B, H, T, D])
    go to the kernel without a copy and give the contiguous result."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 256, 3, 4, 64, generator=g).to(cuda)   # B T 3 H D
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    got = k1.flash_attention(q, k, v, causal=True, heads_major=True)
    want = k1.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True, heads_major=True)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        k1.launch_fwd(q[:, :, :100], k[:, :, :100], v[:, :, :100], True,
                      0.125)
    with pytest.raises(TypeError):      # no float64 instance
        k1.launch_fwd(q.double(), k.double(), v.double(), True, 0.125)


@pytest.mark.parametrize("heads", [1, 2])
def test_train_step_cuda_matches_cpu(cuda, heads):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import attention as A
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=heads, max_seq_len=128)
    rng = np.random.RandomState(4)
    x = rng.randint(0, 256, (2, 128)).astype(np.int32)
    y = rng.randint(0, 256, (2, 128)).astype(np.int32)
    prev = flags.flag("flash_attention_min_seq")
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        losses = {}
        for dev in ("cpu", cuda):
            model = GPT(cfg, device="cpu", seed=3).to(dev)
            step = jit.TrainStep(model, gpt_loss_fn, AdamW(
                1e-3, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0)))
            before = k1.flash_attention_bwd.launches + \
                k2.packed_flash_bwd.launches
            losses[str(dev)] = [step(x, y).item() for _ in range(3)]
            assert A.LAST_PATH == "flash"
            after = k1.flash_attention_bwd.launches + \
                k2.packed_flash_bwd.launches
            assert after - before == (0 if dev == "cpu" else 3 * 2)
    finally:
        flags.set_flags({"FLAGS_flash_attention_min_seq": prev})
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _eager_losses(device, dtype, steps):
    """The eager loop (train_bench: AdamW over LinearWarmup, GradScaler,
    auto_cast O1 at `dtype`) on a tiny GPT with one head of 128 at T
    128, and its K1 launches."""
    import dataclasses
    from paddle_tpu_torch.tools import train_bench
    cfg = dataclasses.replace(train_bench.bench_config(1), vocab_size=256,
                              hidden_size=128, num_layers=2, max_seq_len=128)
    st = train_bench.build_eager(cfg, 3, device, dtype, batch=2)
    before = (k1.flash_attention_fwd.launches,
              k1.flash_attention_bwd.launches)
    losses = [train_bench.eager_step(st).item() for _ in range(steps)]
    return losses, (k1.flash_attention_fwd.launches - before[0],
                    k1.flash_attention_bwd.launches - before[1])


@pytest.fixture
def min_seq_128():
    from paddle_tpu_torch.core import flags
    prev = flags.flag("flash_attention_min_seq")
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    yield
    flags.set_flags({"FLAGS_flash_attention_min_seq": prev})


def test_eager_o1_loop_cuda_matches_cpu_f32(cuda, min_seq_128):
    """The eager O1 loop in bf16 on the card (K1 in bf16, one forward and
    one backward launch a layer and step) against the same loop in f32
    on the CPU: losses within 2e-2 relative over 4 steps (bf16 rounds
    every linear's inputs to 8 significant bits, 2**-8 relative, and the
    loss sums those errors over the sequence)."""
    from paddle_tpu_torch.nn.functional import attention as A
    got, launches = _eager_losses(cuda, "bfloat16", 4)
    assert A.LAST_PATH == "flash" and A.LAST_DTYPE == torch.bfloat16
    assert launches == (2 * 4, 2 * 4)
    want, cpu_launches = _eager_losses("cpu", "float32", 4)
    assert cpu_launches == (0, 0)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]


def test_eager_float16_runs_k1_on_card(cuda, min_seq_128):
    """auto_cast(dtype="float16"): attention runs K1's float16 instance
    (one forward and one backward launch a layer and step), and the
    losses follow the CPU's f32 loop within 2.5e-3 relative over 4 steps
    (the bf16 test's 2e-2 over the ratio of the unit roundoffs, 8)."""
    from paddle_tpu_torch.nn.functional import attention as A
    got, launches = _eager_losses(cuda, "float16", 4)
    assert A.LAST_PATH == "flash" and A.LAST_DTYPE == torch.float16
    assert launches == (2 * 4, 2 * 4)
    want, _ = _eager_losses("cpu", "float32", 4)
    np.testing.assert_allclose(got, want, rtol=2.5e-3)


def test_bare_layer_parameters_default_to_the_card(cuda):
    """Without set_device, `paddle.nn.Linear(3, 1)` makes its parameters
    on the card, where to_tensor puts its input, so the reference program
    `lin(paddle.to_tensor(x))` runs; a BatchNorm2D's statistics go there
    too."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place
    prev, place._default = place._default, None
    try:
        lin = paddle.nn.Linear(3, 1)
        x = paddle.to_tensor(np.ones((2, 3), np.float32))
        y = lin(x)
        bn = paddle.nn.BatchNorm2D(4, weight_attr=False, bias_attr=False)
    finally:
        place._default = prev
    assert lin.weight.device.type == "cuda" and x.device.type == "cuda"
    assert y.shape == [2, 1] and y.device.type == "cuda"
    np.testing.assert_allclose(
        y.numpy(), (np.ones((2, 3), np.float32) @ lin.weight.numpy()
                    + lin.bias.numpy()), rtol=1e-6)
    assert bn._mean.device.type == "cuda"


def test_bert_train_step_cuda_matches_cpu(cuda):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              bert_pretrain_loss_fn,
                                              make_bert_pretrain_batch)
    from paddle_tpu_torch.nn.functional import attention as A
    from paddle_tpu_torch.optimizer import AdamW
    cfg = BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=2, max_position=128)
    batch = make_bert_pretrain_batch(np.random.RandomState(4), 512, 2, 128)
    prev = flags.flag("flash_attention_min_seq")
    flags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        losses = {}
        for dev in ("cpu", cuda):
            model = BertForPretraining(cfg, device=dev, seed=3)
            step = jit.TrainStep(model, bert_pretrain_loss_fn, AdamW(
                1e-3, parameters=model.parameters()))
            before = (k2.packed_flash_fwd.launches,
                      k2.packed_flash_bwd.launches)
            losses[str(dev)] = [step(*batch).item() for _ in range(3)]
            assert A.LAST_PATH == "flash"
            n = 0 if dev == "cpu" else 3 * cfg.num_layers
            assert (k2.packed_flash_fwd.launches - before[0],
                    k2.packed_flash_bwd.launches - before[1]) == (n, n)
    finally:
        flags.set_flags({"FLAGS_flash_attention_min_seq": prev})
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_lenet_train_steps_cuda_match_cpu(cuda):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.tools.train_bench import ce_loss_fn
    from paddle_tpu_torch.vision.models import LeNet
    rng = np.random.RandomState(5)
    xs = rng.randn(3, 8, 1, 28, 28).astype(np.float32)
    ys = rng.randint(0, 10, (3, 8, 1)).astype(np.int64)
    losses = {}
    for dev in ("cpu", cuda):
        model = LeNet(device=dev, seed=3)
        step = jit.TrainStep(model, ce_loss_fn, Adam(
            1e-3, parameters=model.parameters()))
        losses[str(dev)] = [step(xs[i], ys[i]).item() for i in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    model = LeNet(device=cuda, seed=3)
    multi = jit.MultiStepTrainStep(model, ce_loss_fn, Adam(
        1e-3, parameters=model.parameters()), 3)
    np.testing.assert_allclose(multi(xs, ys).cpu().numpy(),
                               losses["cuda"], rtol=1e-5)


# ------------------------------------------------------------------- K4
def _k4_args(device, m, k, n, res, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    z = torch.randn(m, k, generator=g) if res else None
    w = torch.randn(k, n, generator=g) / k ** 0.5
    scale = torch.rand(k, generator=g) + 0.5
    shift = torch.randn(k, generator=g) * 0.1
    bf = [None if t is None else t.to(device, torch.bfloat16)
          for t in (x, z, w)]
    return (*bf, scale.to(device), shift.to(device))


def _within_bf16_ulp(got, want, rms_frac=1e-3):
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    rms = want.square().mean().sqrt()
    excess = ((got - want).abs() - ulp).clamp_min(0).max()
    return excess.item() <= rms_frac * rms.item()


@pytest.mark.parametrize("m,k,n,res", [
    (1, 16, 16, True), (97, 64, 256, False), (300, 48, 80, True),
    (512, 256, 128, True), (6272, 2048, 512, True), (1000, 64, 256, False)])
def test_k4_matches_plain(cuda, m, k, n, res):
    args = _k4_args(cuda, m, k, n, res)
    before = fused_scale_relu_matmul.launches
    got = fused_scale_relu_matmul(*args)
    torch.cuda.synchronize()
    assert fused_scale_relu_matmul.launches == before + 1
    want = fused_scale_relu_matmul_reference(*args)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _within_bf16_ulp(got, want)


@pytest.mark.parametrize("block_n", [64, 128, 256])
@pytest.mark.parametrize("m,k,n,res", [
    (300, 16, 16, True), (300, 48, 80, False), (1000, 80, 320, True),
    (257, 128, 320, False)])
def test_k4_each_tile_width_matches_plain(cuda, block_n, m, k, n, res):
    args = _k4_args(cuda, m, k, n, res, seed=block_n)
    got = fused_scale_relu_matmul(*args, block_n=block_n)
    torch.cuda.synchronize()
    assert _within_bf16_ulp(got, fused_scale_relu_matmul_reference(*args))


@pytest.mark.parametrize("m,k,n,block_n", [
    (20000, 192, 256, 64),        # 628 tiles on 132 SMs: the ring runs on
    (40000, 512, 128, 128),       # across 2-3 tiles a CTA
    (97, 48, 16, 64),             # one tile: fewer tiles than SMs
    (640, 1024, 512, 256)])
def test_k4_grids_with_more_and_fewer_tiles_than_ctas(cuda, m, k, n,
                                                       block_n):
    args = _k4_args(cuda, m, k, n, True, seed=m)
    got = fused_scale_relu_matmul(*args, block_n=block_n)
    torch.cuda.synchronize()
    assert _within_bf16_ulp(got, fused_scale_relu_matmul_reference(*args))


@pytest.mark.parametrize("k,res", [(16, True), (48, False), (80, True)])
def test_k4_reads_no_scale_or_shift_past_k(cuda, k, res):
    x, z, w, scale, shift = _k4_args(cuda, 300, k, 80, res)
    sbuf = torch.full((k + 64,), float("nan"), device=cuda)
    bbuf = torch.full((k + 64,), float("nan"), device=cuda)
    sbuf[:k] = scale
    bbuf[:k] = shift
    for block_n in (64, 128):
        got = fused_scale_relu_matmul(x, z, w, sbuf[:k], bbuf[:k],
                                      block_n=block_n)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert _within_bf16_ulp(got, fused_scale_relu_matmul_reference(
            x, z, w, scale, shift))


def test_k4_is_bitwise_repeatable(cuda):
    args = _k4_args(cuda, 6272, 2048, 512, True)
    first = fused_scale_relu_matmul(*args)
    for _ in range(2):
        assert torch.equal(fused_scale_relu_matmul(*args), first)


def test_k4_refuses_what_it_cannot_take(cuda):
    x, z, w, scale, shift = _k4_args(cuda, 64, 64, 64, True)
    with pytest.raises(ValueError):
        fused_scale_relu_matmul(x.t(), z, w, scale, shift)   # not contiguous
    with pytest.raises(ValueError):
        fused_scale_relu_matmul(x, z.cpu(), w, scale, shift)
    with pytest.raises(ValueError):
        fused_scale_relu_matmul(x[:, :56].contiguous(), None,
                                w[:56].contiguous(), scale[:56], shift[:56])
    buf = torch.empty(64 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    odd = buf[1:1 + 64 * 64].view(64, 64)                   # 2-byte offset
    odd.copy_(x)
    with pytest.raises(ValueError):                         # misaligned
        fused_scale_relu_matmul(odd, z, w, scale, shift)
    with pytest.raises(ValueError):
        fused_scale_relu_matmul(x, z, w, scale, shift, block_n=96)
    big = _k4_args(cuda, 16, 32768, 64, True)               # ring too big
    with pytest.raises(ValueError):
        fused_scale_relu_matmul(*big)


# ------------------------------------------------------------ batch norm
def _bn_formula(x, z, weight, bias, eps):
    """relu(bn(x) (+ z)) written as plain differentiable ops."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    out = ((x - mean) * torch.rsqrt(var + eps) * weight[None, :, None, None]
           + bias[None, :, None, None])
    return out if z is False else torch.relu(out if z is None else out + z)


@pytest.mark.parametrize("fused,z_shape", [
    (False, None), (True, None), (True, (8, 16, 6, 5)), (True, (1, 16, 1, 1))])
def test_bn_functions_on_card(cuda, fused, z_shape):
    from paddle_tpu_torch.nn.functional.norm import _BNActCore, _BNCore
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 16, 6, 5, generator=g) * 2 + 0.5
    w = torch.rand(16, generator=g) + 0.5
    b = torch.randn(16, generator=g)
    gy = torch.randn(8, 16, 6, 5, generator=g)
    z = None if z_shape is None else torch.randn(*z_shape, generator=g)
    results = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (x, w, b) + (() if z is None else (z,))]
        lx, lw, lb = leaves[:3]
        lz = leaves[3] if z is not None else None
        if fused:
            out = _BNActCore.apply(lx, lz, lw, lb, 1e-5, 1)[0]
        else:
            out = _BNCore.apply(lx, lw, lb, 1e-5, 1)[0]
        grads = torch.autograd.grad(out, leaves, gy.to(dev))
        results[str(dev)] = [out.detach().cpu()] + [t.cpu() for t in grads]
        if dev == cuda:
            want_out = _bn_formula(lx, lz if fused else False, lw, lb, 1e-5)
            want = [want_out] + list(torch.autograd.grad(
                want_out, leaves, gy.to(dev)))
            for a, e in zip(results[str(dev)], want):
                e = e.detach().cpu()
                assert (a - e).abs().max() <= 1e-4 * e.abs().max()
    for a, e in zip(results[str(cuda)], results["cpu"]):
        assert (a - e).abs().max() <= 1e-5 * e.abs().max()


# ------------------------------------------------------- ResNet TrainStep
def test_resnet_train_step_cuda_matches_cpu(cuda):
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    def loss_fn(m, x, y):
        return cross_entropy(m(x), y)

    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, (4, 1)).astype(np.int64)
    runs = {}
    for dev in ("cpu", cuda):
        model = resnet18(num_classes=10, device=dev, seed=3)
        step = jit.TrainStep(model, loss_fn, Momentum(
            0.01, parameters=model.parameters()))
        losses = [step(x, y).item() for _ in range(3)]
        runs[str(dev)] = (losses, {k: b.cpu() for k, b in
                                   model.named_buffers()})
    np.testing.assert_allclose(runs[str(cuda)][0], runs["cpu"][0],
                               rtol=1e-4, atol=0)
    for k, b in runs["cpu"][1].items():
        got = runs[str(cuda)][1][k]
        assert (got - b).abs().max() <= 1e-4 * b.abs().max(), k

    model = resnet18(num_classes=10, device=cuda, seed=3)
    optim = Momentum(0.1, parameters=model.parameters())
    model, optim = amp.decorate(model, optim, level="O2", dtype="bfloat16")
    step = jit.TrainStep(model, loss_fn, optim)
    loss = step(torch.from_numpy(x).to(cuda, torch.bfloat16), y).item()
    assert np.isfinite(loss)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())


# ------------------------------------------------ slice 6b: nn, optimizers
def _tiny_transformer(device, dtype="float32", steps=3):
    """seq2seq_bench's Transformer loop at d_model 128 (2 heads of 64),
    2 + 2 layers, vocabulary 97, 2 rows of 128 tokens, dropout 0 (so the
    two devices draw nothing), f32 or O1 bf16: its losses and K1's
    launches."""
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    cfg = dict(vocab=97, d_model=128, nhead=2, layers=2, d_ff=64,
               dropout=0.0)
    st = sb.build_transformer(0, device, cfg=cfg, batch=(2, 128))
    before = (k1.flash_attention_fwd.launches,
              k1.flash_attention_bwd.launches)
    losses = []
    for _ in range(steps):
        if dtype == "float32":
            loss = sb.transformer_loss(st["model"], st["src"], st["tgt_in"],
                                       st["tgt_out"], st["tgt_mask"])
            loss.backward()
            st["opt"].step()
            st["opt"].clear_grad()
            st["sched"].step()
            losses.append(float(loss.item()))
        else:
            losses.append(sb.transformer_step(st))
    return losses, (k1.flash_attention_fwd.launches - before[0],
                    k1.flash_attention_bwd.launches - before[1])


def test_transformer_cuda_matches_cpu(cuda, min_seq_128):
    """The Transformer loop in f32 on the card (encoder self-attention
    and decoder cross-attention through K1's f32 kernel at head dim 64,
    non-causal: 2 forward and 2 backward launches a layer pair and step)
    against the same loop on the CPU (K1's plain version): losses within
    1e-4 relative over 3 steps (blocked sums in another order); the O1
    bf16 loop on the card falls and follows within 2e-2."""
    got, launches = _tiny_transformer(cuda)
    assert launches == (2 * 2 * 3, 2 * 2 * 3)
    want, cpu_launches = _tiny_transformer("cpu")
    assert cpu_launches == (0, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    bf16, _ = _tiny_transformer(cuda, "bfloat16")
    np.testing.assert_allclose(bf16, want, rtol=2e-2)
    assert bf16[-1] < bf16[0]


def test_lstm_lm_and_beam_search_cuda_match_cpu(cuda):
    """The LSTM language model's SGD loop (dropout 0) on the card against
    the CPU: losses within 1e-5 relative over 3 steps; then beam search
    (beam 3, 6 steps) from 4 rows of a fresh model with weights in
    U(-0.5, 0.5) (distinct scores: a few steps of SGD on one batch make
    the tiny model emit one token, and beams whose scores tie to
    rounding may swap between devices): ids and parents equal, scores
    within 1e-5."""
    from paddle_tpu_torch.tools import seq2seq_bench as sb
    cfg = dict(vocab=50, hidden=32, num_steps=9, batch=6, dropout=0.0)
    runs = {}
    for dev in (cuda, "cpu"):
        st = sb.build_lstm(0, dev, cfg=cfg)
        losses = [sb.lstm_step(st) for _ in range(3)]
        fresh = sb.build_lstm(1, dev, cfg=dict(cfg, init_scale=0.5))
        out = sb.beam_search(fresh["model"], fresh["x"][:4], 3, 6)
        runs[str(dev)] = (losses, {k: v.cpu().numpy() for k, v in
                                   out.items()})
    (gl, go), (wl, wo) = runs[str(cuda)], runs["cpu"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    for k in ("predicted_ids", "parent_ids"):
        np.testing.assert_array_equal(go[k], wo[k])
    np.testing.assert_allclose(go["scores"], wo["scores"], rtol=1e-5)


@pytest.mark.parametrize("name", ["SGD", "Adamax", "Adadelta", "Adagrad",
                                  "RMSProp", "Lamb", "Lars"])
def test_new_optimizers_cuda_match_cpu(cuda, name):
    """5 steps on a Linear from the same weights and batch on the card
    and on the CPU: parameters within 1e-5 relative L2."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.place import default_device
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    params = {}
    for dev in (cuda, "cpu"):
        paddle.seed(0)
        with default_device(dev):
            layer = paddle.nn.Linear(8, 4)
            xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
        o = getattr(paddle.optimizer, name)(0.05,
                                            parameters=layer.parameters())
        for _ in range(5):
            ((layer(xt) - yt) ** 2).mean().backward()
            o.step()
            o.clear_grad()
        params[str(dev)] = [p.detach().cpu() for p in layer.parameters()]
    for a, w in zip(params[str(cuda)], params["cpu"]):
        assert ((a - w).norm() / w.norm()).item() < 1e-5


def test_save_load_moves_card_tensors(cuda, tmp_path):
    """paddle.save of tensors on the card (f32, int64, bf16) and load:
    the same values, loaded onto the default device (the card)."""
    import paddle_tpu_torch as paddle
    pytest.importorskip("ml_dtypes")
    obj = {"w": torch.randn(3, 4, device=cuda),
           "ids": torch.arange(5, device=cuda),
           "h": torch.randn(2, 3, device=cuda).to(torch.bfloat16)}
    paddle.save(obj, str(tmp_path / "x.pdparams"))
    got = paddle.load(str(tmp_path / "x.pdparams"))
    for k, v in obj.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v)


# ------------------------------------------------- slice 6c: vision nn
def _vision_family(name):
    """(fn(*tensors) -> tensor, input shapes) of each family."""
    from paddle_tpu_torch.nn import functional as F
    cases = {
        "conv": ([(2, 9, 10, 8), (6, 4, 3, 3), (6,), (2, 8, 11), (8, 8, 3),
                  (2, 4, 5, 6, 7), (3, 4, 2, 2, 2)],
                 lambda x, w, b, x1, w1, x3, w3: torch.cat([
                     F.conv2d(x, w, b, 2, [1, 0, 2, 1], groups=2,
                              data_format="NHWC").flatten(),
                     F.conv1d(x1, w1, None, 1, "SAME", 2).flatten(),
                     F.conv3d(x3, w3, None, 1, 1).flatten(),
                     F.conv2d_transpose(x.permute(0, 3, 1, 2), w.transpose(
                         0, 1).contiguous().repeat(2, 1, 1, 1)[:8], None,
                         2, 1, 1).flatten(),
                     F.conv1d_transpose(x1, w1, None, 3, "SAME").flatten(),
                     F.conv3d_transpose(x3, w3.transpose(0, 1).contiguous(),
                                        None, 2, [0, 1, 1]).flatten()])),
        "pool": ([(2, 3, 9, 8), (2, 3, 11), (2, 3, 5, 6, 7)],
                 lambda x, x1, x3: torch.cat([
                     F.max_pool2d(x, 3, 2, 1, ceil_mode=True).flatten(),
                     F.max_pool2d(x, 2, 2, 1, return_mask=True,
                                  ceil_mode=True)[1].float().flatten(),
                     F.avg_pool2d(x.permute(0, 2, 3, 1), 3, 2, "SAME",
                                  data_format="NHWC").flatten(),
                     F.avg_pool1d(x1, 4, 3, 1, ceil_mode=True).flatten(),
                     F.max_pool3d(x3, 2, 2, 1).flatten(),
                     F.avg_pool3d(x3, 3, 2, 0, divisor_override=5).flatten(),
                     F.adaptive_max_pool2d(x, [3, 5]).flatten(),
                     F.adaptive_avg_pool3d(x3, [2, 3, 4]).flatten()])),
        "norm": ([(2, 6, 5, 4), (6,), (6,), (4, 6, 7)],
                 lambda x, w, b, x1: torch.cat([
                     F.group_norm(x, 3, 1e-5, w, b).flatten(),
                     F.group_norm(x.permute(0, 2, 3, 1), 2, 1e-5, w, b,
                                  "NHWC").flatten(),
                     F.instance_norm(x, weight=w, bias=b).flatten(),
                     F.local_response_norm(x, 3).flatten(),
                     F.batch_norm(x1, torch.zeros(6, device=x.device),
                                  torch.ones(6, device=x.device), w, b,
                                  True).flatten()])),
        "resize": ([(2, 3, 5, 7), (2, 3, 8, 6), (2, 3, 4, 2)],
                   lambda x, z, g: torch.cat([
                       F.interpolate(x, [9, 4]).flatten(),
                       F.interpolate(x, [11, 13], mode="bilinear").flatten(),
                       F.interpolate(x, [3, 4], mode="bicubic").flatten(),
                       F.interpolate(x, [8, 9], mode="bilinear",
                                     align_corners=True).flatten(),
                       F.unfold(x, 2, 1, [1, 0, 0, 1]).flatten(),
                       F.pixel_shuffle(z[:, :2].repeat(1, 2, 1, 1), 2)
                       .flatten(),
                       F.pixel_unshuffle(z, 2).flatten(),
                       F.grid_sample(x, g.tanh()).flatten(),
                       F.pad(x, [1, 2, 2, 0], "reflect").flatten(),
                       F.temporal_shift(z, 2).flatten()])),
    }
    shapes, fn = cases[name]
    return fn, shapes


@pytest.mark.parametrize("family", ["conv", "pool", "norm", "resize"])
def test_vision_functionals_cuda_match_cpu(cuda, family):
    fn, shapes = _vision_family(family)
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(s, generator=g) for s in shapes]
    outs, grads = {}, {}
    for dev in (cuda, "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in xs]
        out = fn(*leaves)
        gy = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            1)).to(dev)
        outs[str(dev)] = out.detach().cpu()
        grads[str(dev)] = [None if t is None else t.cpu() for t in
                           torch.autograd.grad(out, leaves, gy,
                                               allow_unused=True)]
    a, w = outs[str(cuda)], outs["cpu"]
    assert (a - w).abs().max() <= 1e-5 * w.abs().max()
    for u, v in zip(grads[str(cuda)], grads["cpu"]):
        if v is not None:
            assert ((u - v).norm() / v.norm().clamp_min(1e-30)) <= 1e-4


def test_vision_layers_cuda_match_cpu(cuda):
    """Every new layer, built on the CPU and copied to the card: outputs
    within 1e-5 of the CPU's largest entry (training mode)."""
    import copy
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core.place import default_device
    with default_device("cpu"):
        layers = [
            (nn.Conv1D(4, 6, 3, padding=1, padding_mode="circular"),
             (2, 4, 9)),
            (nn.Conv2D(4, 6, 3, 2, 1, padding_mode="reflect",
                       data_format="NHWC"), (2, 7, 7, 4)),
            (nn.Conv3D(4, 6, 2), (2, 4, 3, 4, 5)),
            (nn.Conv1DTranspose(4, 6, 3, 2), (2, 4, 7)),
            (nn.Conv2DTranspose(4, 6, 3, 2, 1, groups=2), (2, 4, 5, 5)),
            (nn.Conv3DTranspose(4, 2, 2, 2), (2, 4, 2, 3, 3)),
            (nn.MaxPool1D(3, 2, 1), (2, 4, 9)),
            (nn.MaxPool3D(2, ceil_mode=True), (2, 4, 3, 5, 5)),
            (nn.AvgPool1D(3, 2, 1), (2, 4, 9)),
            (nn.AvgPool2D(3, 2, 1, ceil_mode=True), (2, 4, 7, 7)),
            (nn.AvgPool3D(2, 2), (2, 4, 4, 4, 4)),
            (nn.AdaptiveAvgPool1D(3), (2, 4, 9)),
            (nn.AdaptiveAvgPool3D(2), (2, 4, 3, 5, 5)),
            (nn.AdaptiveMaxPool1D(4), (2, 4, 9)),
            (nn.AdaptiveMaxPool2D(3), (2, 4, 7, 7)),
            (nn.AdaptiveMaxPool3D(2), (2, 4, 3, 5, 5)),
            (nn.BatchNorm(4, act="relu"), (4, 4, 3, 3)),
            (nn.BatchNorm1D(4), (4, 4, 9)),
            (nn.BatchNorm3D(4), (2, 4, 2, 3, 3)),
            (nn.GroupNorm(2, 4), (2, 4, 5, 5)),
            (nn.InstanceNorm1D(4), (2, 4, 9)),
            (nn.InstanceNorm2D(4), (2, 4, 5, 5)),
            (nn.InstanceNorm3D(4), (2, 4, 2, 3, 3)),
            (nn.LocalResponseNorm(3), (2, 5, 3, 3)),
            (nn.Upsample(scale_factor=2, mode="bilinear"), (2, 4, 3, 5)),
            (nn.UpsamplingNearest2D(size=[7, 4]), (2, 4, 3, 5)),
            (nn.UpsamplingBilinear2D(size=[7, 4]), (2, 4, 3, 5)),
            (nn.Pad1D([1, 2], mode="reflect"), (2, 4, 6)),
            (nn.Pad2D(1, mode="replicate"), (2, 4, 3, 5)),
            (nn.Pad3D([1, 0, 0, 1, 2, 1], value=0.5), (2, 4, 3, 3, 3)),
            (nn.ZeroPad2D([1, 2, 0, 1]), (2, 4, 3, 5)),
            (nn.PixelShuffle(2), (2, 8, 3, 4))]
    g = torch.Generator().manual_seed(0)
    for layer, shape in layers:
        x = torch.randn(shape, generator=g)
        on_card = copy.deepcopy(layer).to(cuda)
        want = layer(x)
        got = on_card(x.to(cuda)).cpu()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), layer


def _vision_steps(build, x, y, device, loss_fn, steps=3):
    from paddle_tpu_torch import jit
    model, opt = build(device)
    for m in model.modules():
        if type(m).__name__ == "Dropout":
            m.eval()
    step = jit.TrainStep(model, loss_fn, opt)
    return [step(x, y).item() for _ in range(steps)]


@pytest.mark.parametrize("model", ["mobilenet_v2", "vgg11", "resnet18"])
def test_vision_model_train_steps_cuda_match_cpu(cuda, model):
    """MobileNetV2 (scale 0.25, RMSProp + L2Decay, batch 4 at 64x64),
    VGG-11 with BN (features only, Momentum, batch 4 at 32x32) and
    ResNet-18 channel-last with the space-to-depth stem (Momentum, batch
    4 at 64x64): losses within 1e-4 relative over 3 steps in f32, and
    MobileNetV2's in float64 within 1e-9 (in f32 its RMSProp steps carry
    the ~1e-2 rounding of a BN network's gradients at init into the next
    loss: the card read 3.61 against the CPU's 5.58 at step 2)."""
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum, RMSProp
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision import models
    rng = np.random.RandomState(3)
    side = 32 if model == "vgg11" else 64
    x = rng.randn(4, 3, side, side).astype(np.float32)
    y = rng.randint(0, 10, (4, 1)).astype(np.int64)
    if model == "resnet18":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))

    def build(dev):
        if model == "mobilenet_v2":
            m = models.mobilenet_v2(scale=0.25, num_classes=10, device=dev,
                                    seed=2)
            return m, RMSProp(0.01, rho=0.9, momentum=0.9,
                              parameters=m.parameters(),
                              weight_decay=L2Decay(4e-5))
        if model == "vgg11":
            m = models.vgg11(batch_norm=True, with_pool=False,
                             num_classes=0, device=dev, seed=2)
        else:
            m = models.resnet18(num_classes=10, data_format="NHWC",
                                stem_space_to_depth=True, device=dev,
                                seed=2)
        return m, Momentum(0.01, 0.9, parameters=m.parameters())

    if model == "vgg11":
        def loss_fn(m, a, b):
            return (m(a) ** 2).mean()
    else:
        def loss_fn(m, a, b):
            return cross_entropy(m(a), b)
    if model == "mobilenet_v2":
        def build64(dev, _build=build):
            m, o = _build(dev)
            return m.to(dtype="float64"), o
        x64 = x.astype(np.float64)
        got = _vision_steps(build64, x64, y, cuda, loss_fn)
        want = _vision_steps(build64, x64, y, "cpu", loss_fn)
        np.testing.assert_allclose(got, want, rtol=1e-9)
        return
    got = _vision_steps(build, x, y, cuda, loss_fn)
    want = _vision_steps(build, x, y, "cpu", loss_fn)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_optimizer_wrappers_cuda_match_cpu(cuda):
    """EMA(0.9), ModelAverage and Lookahead(k=2) over 4 Momentum steps on
    a Linear: the applied and final weights within 1e-5 relative L2, the
    shadows on the parameters' device."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.place import default_device
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    out = {}
    for dev in (cuda, "cpu"):
        paddle.seed(0)
        with default_device(dev):
            layer = paddle.nn.Linear(8, 4)
            xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
        if dev != "cpu":
            state = {k: v.detach().cpu().numpy()
                     for k, v in layer.state_dict().items()}
        else:
            layer.set_state_dict(state)
        params = layer.parameters()
        la = paddle.optimizer.Lookahead(paddle.optimizer.Momentum(
            0.05, 0.9, parameters=params), k=2)
        ema = paddle.optimizer.ExponentialMovingAverage(0.9,
                                                        parameters=params)
        ma = paddle.optimizer.ModelAverage(0.15, parameters=params,
                                           min_average_window=2,
                                           max_average_window=4)
        assert all(s.device == params[0].device
                   for s in ema._shadow.values())
        for _ in range(4):
            ((layer(xt) - yt) ** 2).mean().backward()
            la.step()
            la.clear_grad()
            ema.update()
            ma.update()
        res = [p.detach().cpu().clone() for p in params]
        for w in (ema, ma):
            with w.apply():
                res += [p.detach().cpu().clone() for p in params]
        out[str(dev)] = res
    for a, w in zip(out[str(cuda)], out["cpu"]):
        assert ((a - w).norm() / w.norm()).item() < 1e-5


# --------------------------------------------------- slice 7: the fleet
def _ab_specs(n=6):
    rng = np.random.RandomState(11)
    specs = []
    for i in range(n):
        kw = dict(max_tokens=40)
        if i % 2:
            kw.update(temperature=0.8, top_k=50, seed=1000 + i)
        specs.append((rng.randint(1, 97, (int(rng.randint(5, 24)),))
                      .astype(np.int32), kw))
    return specs


@pytest.mark.parametrize("kvdt", ["float32", "int8"])
def test_migration_ab_is_bitwise_on_card(cuda, kvdt):
    """Greedy and sampled requests moved mid-decode by drain(0,
    recompute=False) continue token for token as they do left in place,
    on the card as on the CPU, and K3 runs every chunk of both arms."""
    from paddle_tpu_torch.tools.serving_traffic import migration_ab
    ecfg = EngineConfig(block_size=8, num_blocks=64, max_num_seqs=8,
                        decode_chunk_size=2, kv_cache_dtype=kvdt)
    specs = _ab_specs()
    before = ragged_decode_attention.launches
    got = migration_ab(_tiny_model(cuda), ecfg, specs, 3, 8)
    assert ragged_decode_attention.launches > before
    want = migration_ab(_tiny_model("cpu"), ecfg, specs, 3, 8)
    assert got["live"] == got["migrated"] == len(specs)
    assert got["failovers"] == got["aborted"] == 0
    assert got["homes"] == [1] * len(specs)
    assert got["a"] == got["b"]
    assert got["a"] == want["a"] and got["b"] == want["b"]


def test_fleet_kill_restart_on_card_matches_cpu(cuda):
    """A replica killed mid-traffic on a tiny 3-replica fleet on the
    card: nothing lost, the killed replica rejoins and serves, every
    report entry equal to the CPU run's, and the dead incarnation's pool
    freed: allocated memory after the restart within one pool of its
    value before the kill."""
    from paddle_tpu_torch.inference.serving import ReplicaSet, RouterConfig
    from paddle_tpu_torch.testing.faults import ServingFaultInjector
    from paddle_tpu_torch.tools.chaos_serve import run_chaos_replicas
    reports = {}
    for dev in ("cpu", cuda):
        reports[str(dev)] = run_chaos_replicas(
            seed=0, n_requests=12, faults="kill_replica@6:1",
            model=_tiny_model(dev))
    got, want = reports["cuda"], reports["cpu"]
    for key in ("fired", "requeues", "finish_reasons", "replica_states",
                "untouched_survivors", "canaries_served", "integrity"):
        assert got[key] == want[key], key
    assert got["requeues"] >= 1 and got["canaries_served"] == 1
    # the pool of the dead incarnation is freed
    ecfg = EngineConfig(block_size=8, num_blocks=256, max_num_seqs=4,
                        decode_chunk_size=2)
    rs = ReplicaSet.from_model(
        _tiny_model(cuda), RouterConfig(num_replicas=2, backoff_base=0.01,
                                        backoff_max=0.02,
                                        backoff_jitter=0.0),
        engine_config=ecfg, faults=ServingFaultInjector("kill_replica@2:1"))
    rng = np.random.RandomState(2)
    for _ in range(6):
        rs.add_request(rng.randint(1, 97, (12,)).astype(np.int32),
                       SamplingParams(max_tokens=24))
    pool = rs.replicas[1].engine.cache.stored_pools()
    pool_bytes = sum(t.numel() * t.element_size() for pair in pool
                     for t in pair)
    del pool
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    while str(rs.states()[1]) == "up":
        rs.step()
    while str(rs.states()[1]) != "up":
        rs.step()
    after = torch.cuda.memory_allocated()
    assert abs(after - before) < pool_bytes
    rs.run(max_steps=2000)
    assert rs.router_stats()["unfinished"] == 0


# ------------------------------------------- slice 8a: training runtime
def _seq_dataset(n=10):
    import paddle_tpu_torch as paddle

    class DS(paddle.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return (rng.randn(3, 4).astype(np.float32),
                    np.asarray(i, np.int64))
    return DS()


def test_device_loader_pins_and_delivers_in_order(cuda, monkeypatch):
    import paddle_tpu_torch as paddle
    pins = []
    real_pin = torch.Tensor.pin_memory

    def pin(t, *a, **kw):
        out = real_pin(t, *a, **kw)
        pins.append(out.is_pinned())
        return out
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    dl = paddle.io.DataLoader(_seq_dataset(), batch_size=3, num_workers=2)
    want = [(x.numpy(), y.numpy()) for x, y in dl]
    got = []
    for x, y in paddle.io.DeviceLoader(dl, size=2, device=cuda):
        assert x.device.type == "cuda" and y.device.type == "cuda"
        got.append((x.cpu().numpy(), y.cpu().numpy()))
    assert len(pins) == 2 * len(want) and all(pins)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_skip_step_leaves_parameters_bitwise_on_card(cuda):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.anomaly import AnomalyGuard
    with paddle.core.place.default_device(cuda):
        net = paddle.nn.Linear(4, 3)
    opt = paddle.optimizer.Adam(1e-2, parameters=net.parameters())
    guard = AnomalyGuard("skip_step")
    step = paddle.jit.TrainStep(
        net, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt,
        anomaly_guard=guard)
    x = torch.randn(5, 4, device=cuda)
    y = torch.randn(5, 3, device=cuda)
    step(x, y)
    before = [t.clone() for t in net.parameters()] + [
        t.clone() for st in step._opt_state.values() for t in st.values()]
    bad = x.clone()
    bad[1, 2] = float("nan")
    step(bad, y)
    after = list(net.parameters()) + [
        t for st in step._opt_state.values() for t in st.values()]
    assert guard.skipped_steps == 1
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    step(x, y)
    assert not torch.equal(before[0], net.weight)


def test_checkpoint_kill_and_resume_on_card(cuda, tmp_path):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpointManager
    X = torch.from_numpy(np.random.RandomState(0).randn(8, 4).astype(
        np.float32)).to(cuda)
    Y = torch.from_numpy(np.random.RandomState(1).randn(8, 2).astype(
        np.float32)).to(cuda)

    def build(seed):
        paddle.seed(seed)
        with paddle.core.place.default_device(cuda):
            m = paddle.nn.Linear(4, 2, weight_attr=paddle.ParamAttr(
                name="w"), bias_attr=paddle.ParamAttr(name="b"))
        o = paddle.optimizer.Adam(1e-2, parameters=m.parameters())
        return m, o, paddle.jit.TrainStep(
            m, lambda mm, a, b: ((mm(a) - b) ** 2).mean(), o)

    _, _, st = build(7)
    ref = [float(st(X, Y).numpy()) for _ in range(4)]
    m1, o1, st1 = build(7)
    run = []
    for epoch in AutoCheckpointManager(str(tmp_path), [m1], [o1]) \
            .train_epoch_range(4):
        run.append(float(st1(X, Y).numpy()))
        if epoch == 2:
            break
    m2, o2, st2 = build(999)
    mgr = AutoCheckpointManager(str(tmp_path), [m2], [o2])
    for _ in mgr.train_epoch_range(4):
        run.append(float(st2(X, Y).numpy()))
    assert mgr.restored_index == 1
    assert run[:2] + run[3:] == ref


def test_model_fit_on_card_matches_cpu(cuda):
    import paddle_tpu_torch as paddle
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x @ rng.randn(8, 4)).argmax(-1).astype(np.int64)[:, None]
    ds = paddle.io.TensorDataset([x, y])
    state = None
    out = {}
    for dev in ("cpu", cuda):
        with paddle.core.place.default_device(dev):
            net = paddle.nn.Sequential(paddle.nn.Linear(8, 32),
                                       paddle.nn.ReLU(),
                                       paddle.nn.Linear(32, 4))
        if state is None:
            state = {k: v.detach().cpu().numpy().copy()
                     for k, v in net.state_dict().items()}
        net.set_state_dict(state)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(0.01,
                                            parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        losses = []

        class Log(paddle.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"][0])
        np.random.seed(3)
        model.fit(ds, epochs=3, batch_size=16, verbose=0,
                  callbacks=[Log()])
        out[str(dev)] = (losses, model.evaluate(ds, batch_size=16,
                                                verbose=0))
    (gl, gev), (wl, wev) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    np.testing.assert_allclose(gev["loss"], wev["loss"], rtol=1e-5)
    assert gev["acc"] == wev["acc"]


# ------------------------------------------------ slice 8b: the op corpus
from paddle_tpu_torch.testing import op_cases  # noqa: E402

OP_CASES = op_cases.load_cases()


@pytest.mark.parametrize("case", OP_CASES, ids=[c.name for c in OP_CASES])
def test_op_case_cuda_matches_cpu(cuda, case):
    want, want_grads, _ = op_cases.run(case, "cpu")
    got, grads, devices = op_cases.run(case, "cuda")
    assert devices <= {"cuda:0"}, (case.name, devices)
    assert op_cases.compare(got, want, case) is None, \
        (case.name, op_cases.compare(got, want, case))
    if case.grad:
        msg = op_cases.compare(grads, want_grads, case, grads=True)
        assert msg is None, (case.name, msg)


# ------------------------------------------ slice 8c: recompute through K1
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "dropout", "O1"])
def test_k1_under_recompute_matches_k1_without(cuda, min_seq_128, mode):
    """A 2-layer GPT with 2 heads of 128 at T 128 (K1) under each
    use_recompute value against no recompute on the card: the loss and
    every gradient bitwise equal (the rerun launches the same kernels on
    the same values, and K1's backward has no atomics), K1 launched once
    a layer forward, again in backward for each recomputed layer, and
    once a layer backward. The rerun runs inside backward, on autograd's
    device thread: at dropout 0.1 it must draw the first run's masks
    from the port's CUDA generator (the same paddle.seed before each
    run; attention dropout takes the composed path, so K1 is not
    launched), and under auto_cast O1 it must run under the first run's
    casts, which the backward outside the context no longer has."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.nn.functional import attention as A
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randint(0, 256, (2, 128))).to(cuda)
    y = torch.from_numpy(rng.randint(0, 256, (2, 128))).to(cuda)
    dropout = 0.1 if mode == "dropout" else 0.0

    def run(policy, seed=11):
        cfg = GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                        num_heads=2, max_seq_len=128, dropout=dropout,
                        use_recompute=policy)
        model = GPT(cfg, device=cuda, seed=3)
        if mode == "bfloat16":
            model = amp.decorate(model, level="O2", dtype="bfloat16")
        fns = (k1.flash_attention_fwd, k1.flash_attention_bwd)
        before = [f.launches for f in fns]
        paddle.seed(seed)
        with amp.auto_cast(enable=mode == "O1", level="O1",
                           dtype="bfloat16"):
            loss = gpt_loss_fn(model, x, y)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        # the last attention call is the rerun's where there is one
        assert A.LAST_PATH == ("composed" if dropout else "flash")
        assert A.LAST_DTYPE == (torch.float32 if mode in ("float32",
                                                          "dropout")
                                else torch.bfloat16), policy
        return (loss.detach(), grads,
                [f.launches - b for f, b in zip(fns, before)])

    got = {policy: run(policy)
           for policy in (False, True, "full", "group:2", "auto")}
    base_loss, base_grads, base_counts = got[False]
    if mode == "dropout":
        assert not torch.equal(run(False, seed=12)[0], base_loss)  # masks
    assert base_counts == ([0, 0] if dropout else [2, 2])
    for policy, (loss, grads, counts) in got.items():
        assert torch.equal(loss, base_loss), policy
        for g, w in zip(grads, base_grads):
            assert torch.equal(g, w), policy
        rerun = 0 if policy in (False, "auto") else 2
        assert counts == ([0, 0] if dropout else [2 + rerun, 2]), \
            (policy, counts)


# ------------------------------------------------------------ slice 9a
@pytest.fixture
def nccl_world(cuda):
    """An NCCL process group of one rank on the card, torn down after."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.parallel import set_global_mesh
    init_parallel_env()
    assert dist.get_backend() == "nccl"
    yield cuda
    set_global_mesh(None)
    dist.destroy_process_group()


def test_zero2_step_on_nccl_world_of_one_matches_trainstep(nccl_world):
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.parallel import ShardedTrainStep, ShardingStage
    cfg = GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=128)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(0, 256, (4, 128))).to(nccl_world)
    y = torch.from_numpy(rng.randint(0, 256, (4, 128))).to(nccl_world)
    runs = {}
    for name in ("trainstep", "zero2"):
        model = GPT(cfg, device=nccl_world, seed=5)
        opt = optimizer.AdamW(1e-3, parameters=model.parameters())
        step = jit.TrainStep(model, gpt_loss_fn, opt) \
            if name == "trainstep" else ShardedTrainStep(
                model, gpt_loss_fn, opt,
                sharding_stage=ShardingStage.GRADIENT)
        C.reset_collective_calls()
        runs[name] = ([step(x, y).item() for _ in range(3)],
                      [p.detach().clone() for p in model.parameters()],
                      C.collective_calls())
    assert runs["zero2"][0] == runs["trainstep"][0]
    for a, b in zip(runs["zero2"][1], runs["trainstep"][1]):
        assert torch.equal(a, b)
    calls = runs["zero2"][2]
    assert calls["reduce_scatter"] >= 3 and calls["all_gather"] >= 3


def test_indexed_moe_matches_dense_twin_on_card(cuda):
    """At capacity factor 0.5 half the pairs drop, so the spare slot and
    the zero weights run on the card; outputs, aux, the dropped count
    and every gradient within 1e-5 of the dense twin's largest entry."""
    from paddle_tpu_torch.distributed import moe
    torch.manual_seed(0)
    m = moe.MoEMLP(64, 8, ffn_hidden_size=128, top_k=2,
                   capacity_factor=0.5)
    m.to(cuda)
    x = torch.randn(2, 256, 64, device=cuda, requires_grad=True)
    r = torch.randn(2, 256, 64, device=cuda)
    args = (m.router, m.w_up, m.b_up, m.w_down, m.b_down, 2, 0.5, 4)
    got = []
    for fn in (moe._moe_indexed, moe._moe_dense):
        out, aux, dropped = fn(x, *args)
        g = torch.autograd.grad((out * r).sum() + aux,
                                [x] + list(m.parameters()))
        got.append([out.detach(), aux.detach(), dropped.float()] + list(g))
    assert int(got[0][2]) == int(got[1][2]) > 0
    for a, b in zip(*got):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_sync_batch_norm_matches_batch_norm_on_card(nccl_world):
    from paddle_tpu_torch.nn import BatchNorm2D, SyncBatchNorm
    torch.manual_seed(0)
    x = torch.randn(8, 16, 10, 10, device=nccl_world)
    w = torch.randn(8, 16, 10, 10, device=nccl_world)
    outs = []
    for sync in (False, True):
        bn = BatchNorm2D(16)
        if sync:
            bn = SyncBatchNorm.convert_sync_batchnorm(bn)
        xi = x.clone().requires_grad_(True)
        y = bn(xi)
        (y * w).sum().backward()
        outs.append([y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                     bn._mean.clone(), bn._variance.clone()])
    for a, b in zip(*outs):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    # one rank's backward runs BatchNorm's arithmetic: bitwise
    for a, b in zip(outs[0][1:4], outs[1][1:4]):
        assert torch.equal(a, b)


# ---------------------------------------------------------- slice 9b
def test_ring_hop_k1_with_a_longer_rows_lse_matches_plain(cuda):
    """One ring hop on the card: K1's forward on a block of the keys
    gives the block's (o, lse), which merge into the whole row's; K1's
    backward on that block, given the merged o and the row's lse, gives
    the block's share of the row's gradients. Held against the plain
    versions (the forward's and the backward's, which read the same o
    and lse) on the CPU: bf16 within 2e-2 (each rounds f32 results to
    bf16, 2**-8 relative, and the gradients' products take those)."""
    import importlib
    R = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    g = torch.Generator().manual_seed(9)
    q, k, v, do = (torch.randn(1, 2, 256, 128, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    halves = (slice(0, 128), slice(128, 256))

    def run(dev):
        qd, kd, vd, dod = (t.to(dev) for t in (q, k, v, do))
        acc = None
        for s in halves:   # query rows 128-255 see keys 0-127 in full,
            acc = R.merge(acc, *k1.flash_attention_fwd(   # 128-255 causally
                qd[:, :, 128:], kd[:, :, s], vd[:, :, s], s.start == 128))
        o, lse = acc[0].to(torch.bfloat16), acc[1].contiguous()
        grads = [k1.flash_attention_bwd(qd[:, :, 128:], kd[:, :, s],
                                        vd[:, :, s], o, lse,
                                        dod[:, :, 128:], s.start == 128)
                 for s in halves]
        return [o, lse] + [t for gr in grads for t in gr]

    before = (k1.flash_attention_fwd.launches,
              k1.flash_attention_bwd.launches)
    got = run(cuda)
    assert (k1.flash_attention_fwd.launches - before[0],
            k1.flash_attention_bwd.launches - before[1]) == (2, 2)
    want = run(torch.device("cpu"))
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float()
        assert (a - b).abs().max() <= 2e-2 * b.abs().max(), \
            float((a - b).abs().max())


def test_device_cache_on_card_matches_cpu_cache(cuda):
    """DeviceEmbeddingCache on the card against the same cache on the CPU
    over two PS servers with the same table, for sgd and adagrad, with
    cold ids: every pulled row and the flushed table bitwise equal (the
    indexed updates are IEEE single operations on both; the square root
    goes through f64 on both)."""
    from paddle_tpu_torch.distributed.ps import (DeviceEmbeddingCache,
                                                 ParameterServer, PsClient)
    for optimizer in ("sgd", "adagrad"):
        clients, servers, caches = [], [], []
        for dev in (cuda, torch.device("cpu")):
            rng = np.random.RandomState(5)
            srv = ParameterServer(port=0)
            srv.add_sparse_table(0, dim=16, optimizer=optimizer, lr=0.1,
                                 initializer=lambda r=rng: r.normal(
                                     0, 0.01, 16).astype(np.float32))
            srv.start()
            c = PsClient([srv.endpoint])
            c.pull_sparse(0, np.arange(256, dtype=np.int64))
            servers.append(srv)
            clients.append(c)
            caches.append(DeviceEmbeddingCache(c, 0, 192, 16, optimizer,
                                               0.1, device=dev))
        try:
            rng = np.random.RandomState(1)
            for _ in range(8):
                ids = rng.randint(-4, 256, 512)
                uniq, counts = np.unique(ids, return_counts=True)
                rows = [cache.pull(uniq) for cache in caches]
                assert torch.equal(rows[0].cpu(), rows[1])
                scale = torch.from_numpy((counts / 512.0).astype(np.float32))
                for cache, r in zip(caches, rows):
                    cache.push(uniq, r * scale.to(r.device)[:, None])
            for cache in caches:
                cache.flush()
            ids = np.arange(-4, 256, dtype=np.int64)
            np.testing.assert_array_equal(clients[0].pull_sparse(0, ids),
                                          clients[1].pull_sparse(0, ids))
        finally:
            for srv in servers:
                srv.stop()


def _static_gpt(T, amp=False, for_test=False):
    """A 2-layer GPT (one head of 128, K1's head dim) as a static
    Program with AdamW (under static.amp when amp), from seed 0."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=1, max_seq_len=T)
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(main, startup):
            ids = static.data("ids", [2, T], "int64")
            lab = static.data("lab", [2, T], "int64")
            logits = GPT(cfg, seed=0)(ids)
            loss = paddle.nn.functional.cross_entropy(
                logits.reshape([-1, 256]), lab.reshape([-1, 1]))
            test_prog = main.clone(for_test=True) if for_test else None
            opt = paddle.optimizer.AdamW(1e-3)
            (static.amp.decorate(opt) if amp else opt).minimize(loss)
    finally:
        paddle.disable_static()
    rs = np.random.RandomState(0)
    feed = {"ids": rs.randint(0, 256, (2, T)).astype(np.int64),
            "lab": rs.randint(0, 256, (2, T)).astype(np.int64)}
    return main, startup, loss, logits, ids, test_prog, feed


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp_bf16"])
def test_static_executor_on_card_matches_cpu(cuda, min_seq_128, amp):
    """The static Executor on the card (K1 forward and backward, once
    per layer a step: the backward is autograd over the forward it ran)
    against the same program on the CPU (K1's plain version): 3 AdamW
    steps within 1e-4 relative in f32; under static.amp (bf16 q/k/v
    into K1's bf16 kernels on the card, bf16 on the CPU too) within
    2e-2."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    main, startup, loss, _, _, _, feed = _static_gpt(128, amp)
    losses = {}
    for dev in ("cuda", "cpu"):
        scope = static.Scope()
        place = paddle.CUDAPlace(0) if dev == "cuda" else paddle.CPUPlace()
        exe = static.Executor(place)
        exe.run(startup, scope=scope)
        before = (k1.flash_attention_fwd.launches,
                  k1.flash_attention_bwd.launches)
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
        if dev == "cuda":
            assert (k1.flash_attention_fwd.launches - before[0],
                    k1.flash_attention_bwd.launches - before[1]) == (6, 6)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                               rtol=2e-2 if amp else 1e-4)


def test_static_inference_artifact_launches_k1_on_card(cuda, min_seq_128,
                                                       tmp_path):
    """clone(for_test) of a trained static GPT, save_inference_model of
    its logits and load_inference_model: the artifact on the card gives
    the Executor's logits (within 1e-5: both launch the same kernels in
    the same order) and launches K1's forward once per layer."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    main, startup, loss, logits, ids, test_prog, feed = _static_gpt(
        128, for_test=True)
    scope = static.Scope()
    exe = static.Executor(paddle.CUDAPlace(0))
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    (want,) = exe.run(test_prog, feed=feed, fetch_list=[logits.name],
                      scope=scope)
    with static.scope_guard(scope):
        static.save_inference_model(str(tmp_path / "gpt"), [ids], [logits],
                                    exe, program=test_prog)
    prog, feeds, fetches = static.load_inference_model(str(tmp_path / "gpt"))
    before = k1.flash_attention_fwd.launches
    (got,) = prog(feed["ids"])
    torch.cuda.synchronize()
    assert k1.flash_attention_fwd.launches - before == 2
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ slice 10b
def test_k2_custom_ops_fake_and_card(cuda):
    """K2's registered custom ops: on meta tensors the fake versions give
    the kernels' output shapes and dtypes and launch nothing; on the card
    the ops hold to the plain version (f32, within 1e-4 of each tensor's
    largest entry), each call counted once."""
    q, k, v, do = _flash_inputs("k2", cuda, 256, torch.float32)
    ops = torch.ops.paddle_tpu_torch
    before = (k2.packed_flash_fwd.launches, k2.packed_flash_bwd.launches)
    meta = [t.to("meta") for t in (q, k, v, do)]
    o, lse = ops.packed_flash_fwd(*meta[:3], True, 0.125)
    grads = ops.packed_flash_bwd(*meta[:3], o, lse, meta[3], True, 0.125)
    assert o.device.type == "meta" and o.shape == q.shape
    assert lse.shape == (2, 2, 2, 256) and lse.dtype == torch.float32
    assert [g.shape for g in grads] == [q.shape] * 3
    assert (k2.packed_flash_fwd.launches,
            k2.packed_flash_bwd.launches) == before
    got = ops.packed_flash_fwd(q, k, v, True, 0.125)
    got_g = ops.packed_flash_bwd(q, k, v, *got, do, True, 0.125)
    torch.cuda.synchronize()
    assert (k2.packed_flash_fwd.launches,
            k2.packed_flash_bwd.launches) == (before[0] + 1, before[1] + 1)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    ro, rlse = k2.packed_flash_reference(qr, kr, vr, True, 0.125,
                                         return_lse=True)
    rg = torch.autograd.grad(ro, (qr, kr, vr), do)
    _assert_flash_close((*got, *got_g), (ro, rlse, *rg), 1e-4)


def _k2_static_losses(place, device):
    """Three SGD steps of a 2-layer GPT with 2 heads of 64 (K2's route at
    T 128) as a static Program; (losses, K2 [forward, backward]
    launches)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(main, startup):
            ids = static.data("ids", [2, 128], "int64")
            lab = static.data("lab", [2, 128], "int64")
            loss = paddle.nn.functional.cross_entropy(
                GPT(cfg, seed=0)(ids).reshape([-1, 256]), lab.reshape([-1, 1]))
            paddle.optimizer.SGD(0.1).minimize(loss)
    finally:
        paddle.disable_static()
    rs = np.random.RandomState(0)
    feed = {n: rs.randint(0, 256, (2, 128)).astype(np.int64)
            for n in ("ids", "lab")}
    scope = static.Scope()
    exe = static.Executor(place)
    exe.run(startup, scope=scope)
    before = (k2.packed_flash_fwd.launches, k2.packed_flash_bwd.launches)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(3)]
    return losses, [k2.packed_flash_fwd.launches - before[0],
                    k2.packed_flash_bwd.launches - before[1]]


def test_k2_static_program_on_card_matches_cpu(cuda, min_seq_128):
    """A head-dim-64 GPT captured as a static Program (K2's fake versions
    give the shapes) and run by the Executor on the card: K2 forward and
    backward once per layer a step, losses within 1e-4 relative of the
    same program on the CPU (K2's plain version), in f32."""
    import paddle_tpu_torch as paddle
    card, counts = _k2_static_losses(paddle.CUDAPlace(0), cuda)
    cpu, _ = _k2_static_losses(paddle.CPUPlace(), "cpu")
    assert counts == [6, 6]
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


@pytest.mark.parametrize("heads,kernel", [(1, "k1"), (2, "k2")])
def test_jit_save_artifact_holds_the_kernel_on_card(cuda, min_seq_128,
                                                    tmp_path, heads, kernel):
    """paddle.jit.save of a 2-layer GPT on the card with a [None, 128]
    spec: the exported graph holds the heads' kernel (K1 at one head of
    128, K2 at two of 64) as one forward node a layer; jit.load and the
    Predictor serve batch 1 and 3 from it with the eager model's logits
    (within 1e-5: the same kernels in the same order), launching that
    forward once a layer a run and no backward."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=heads, max_seq_len=128)
    model = GPT(cfg, device=cuda, seed=0)
    prefix = str(tmp_path / "gpt")
    paddle.jit.save(model, prefix,
                    input_spec=[paddle.jit.InputSpec([None, 128], "int64")])
    op = {"k1": "flash_attention_fwd", "k2": "packed_flash_fwd"}[kernel]
    layer = paddle.jit.load(prefix)
    nodes = [n for n in layer._exported.graph.nodes
             if f"paddle_tpu_torch.{op}" in str(n.target)]
    assert len(nodes) == 2
    pred = inference.create_predictor(inference.Config(prefix + ".pdmodel"))
    fwd, bwd = ((k1.flash_attention_fwd, k1.flash_attention_bwd)
                if kernel == "k1" else
                (k2.packed_flash_fwd, k2.packed_flash_bwd))
    ids = np.random.RandomState(1).randint(0, 256, (3, 128))
    for b in (1, 3):
        x = torch.from_numpy(ids[:b]).to(cuda)
        with torch.no_grad():
            want = model(x).cpu().numpy()
        before = (fwd.launches, bwd.launches)
        got = layer(x).cpu().numpy()
        torch.cuda.synchronize()
        assert (fwd.launches - before[0], bwd.launches - before[1]) == (2, 0)
        got_p = pred.run([ids[:b]])[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_p, want, rtol=1e-5, atol=1e-5)


def _branchy(x):
    if x.mean() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    i = x.sum() * 0.0
    while i < 3:
        y = y + x * i
        i = i + 1
    return y.sum()


def test_to_static_on_card_equals_eager(cuda, min_seq_128):
    """jit.to_static on card tensors: a converted data-dependent if and
    while equal to the eager function, and a to_static GPT (one head of
    128, K1) with the undecorated GPT's logits and three AdamW losses
    bitwise, its gradients reaching the parameters."""
    import paddle_tpu_torch as paddle
    fn = paddle.jit.to_static(_branchy)
    for sign in (1.0, -1.0):
        x = sign * torch.rand(8, 8, device=cuda) + 0.01 * sign
        assert torch.equal(fn(x), _branchy(x))
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=1, max_seq_len=128)
    rs = np.random.RandomState(0)
    x, y = (torch.from_numpy(rs.randint(0, 256, (2, 128))).to(cuda)
            for _ in range(2))
    runs = []
    for decorate in (False, True):
        model = GPT(cfg, device=cuda, seed=0)
        if decorate:
            model = paddle.jit.to_static(model)
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        with torch.no_grad():
            logits = model(x)
        losses = []
        for _ in range(3):
            loss = model.loss(x, y)
            loss.backward()
            assert model.wte.weight.grad is not None
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs.append((logits, losses))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


def test_export_decoder_on_card(cuda, tmp_path):
    """export_decoder of a tiny GPT on the card and DecoderPredictor:
    greedy tokens equal to generate() on the card."""
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=32)
    model = GPT(cfg, device=cuda, seed=0)
    model.eval()
    gen.export_decoder(model, str(tmp_path / "dec"))
    pred = gen.DecoderPredictor(str(tmp_path / "dec"))
    ids = np.random.RandomState(6).randint(1, 97, (3, pred.prefill_len))
    np.testing.assert_array_equal(pred.generate(ids, 5),
                                  gen.generate(model, ids, 5))

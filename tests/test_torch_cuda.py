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

"""The port's CUDA kernels on the card (marker `cuda`; every test skips
on a machine without an NVIDIA GPU).

This file imports neither jax nor paddle_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

- K3 (ops/kernels/ragged_paged_attention) against its plain version:
  f32 within 1e-5 (the two sum their dot products in different orders),
  bf16 pools within 1e-2 (bf16 output rounding, 2**-8 relative on
  values of magnitude < 2); its launch counter and input checks;
- fused_decode_chunk on CUDA (through K3) against the same chunk on the
  CPU (through the plain version): tokens and flags exactly, pools
  within 1e-5;
- the engine on CUDA: ragged (K3) and bucketed (gather) routes give the
  same greedy tokens, and K3 launches layers x k x chunks times.

float32 matmuls run in full float32 (TF32 off, set by the fixture).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import (PACK_COLS, EngineConfig,
                                                LLMEngine, SamplingParams,
                                                fused_decode_chunk, pack_f32)
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_attention_reference, ragged_decode_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k3_inputs(device, dtype, n=8, h=6, d=128, bs=32, nb=512, mb=32,
               lengths=(0, 1, 31, 32, 33, 300, 1023, 1024)):
    rng = np.random.RandomState(0)
    tables = rng.permutation(nb)[:n * mb].reshape(n, mb).astype(np.int32)
    tables[3, 0] = nb                     # out of range inside the length
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
    assert torch.all(got[0] == 0)         # dead row


def test_kernel_small_head_dim_and_block(cuda):
    args = _k3_inputs(cuda, torch.float32, n=5, h=3, d=16, bs=4, nb=300,
                      mb=4, lengths=(0, 1, 6, 15, 16))
    got = ragged_decode_attention(*args)
    torch.testing.assert_close(got, ragged_attention_reference(*args),
                               rtol=0, atol=1e-5)


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
        chunks = eng.stats.host_syncs["decode"]
        assert launched == (2 * 8 * chunks if kernel == "ragged" else 0)
        eng.cache.check_integrity()
    for rid in res["ragged"]:
        np.testing.assert_array_equal(res["ragged"][rid],
                                      res["bucketed"][rid])

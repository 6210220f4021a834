// Ragged paged attention for decode: one query token per row attends over
// exactly lengths[row] KV positions read through the row's block table.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_paged_attention.py:60-173
// (`_kernel`, `_kv_index_map`, `ragged_decode_attention`). Its math is
// defined by `ragged_attention_reference` (same file, :177) and by the plain
// PyTorch version beside this kernel's wrapper
// (paddle_tpu_torch/ops/kernels/ragged_paged_attention.py):
//   out[i,h,:] = softmax_s(scale * q[i,h] . k[s,h]) . v[s,h],  s < lengths[i]
// with position s read from pool block tables[i, s / bs], slot s % bs; masked
// scores are -1e30; a table entry outside [0, num_blocks) skips its whole
// block (the carry is left as it was); a row whose every block is skipped,
// or whose length is 0, returns exact zeros. Accumulation is f32 for both the
// f32 and the bf16 instantiation.
//
// What bounds it on the H100: bytes. Each call must read the live KV once,
// sum_i lengths[i] * H * D * 2 pool elements (K and V), and does 4 flops per
// element pair, far below the f32 ridge point. At the serving slice's shapes
// (8 rows, 6 heads, head_dim 128, f32 pools, mean live length ~300) that is
// ~14.7 MB, ~4.4 us at 3.35 TB/s.
//
// Design (simple and right first): one CTA of 128 threads per (row, head);
// q staged in shared memory as f32; a loop over the row's live table blocks,
// each block scored by the four warps (one warp per position, lanes over D,
// shuffle reduction), then the streaming-softmax update of the TPU kernel
// (m, l and the [D] accumulator in registers, one thread per d).
// What it leaves on the table, for the PR that redesigns it:
// - parallelism: N*H CTAs only (48 at N=8, H=6, of 132 SMs), and the whole
//   context of a row is walked by one CTA; splitting the block axis across
//   CTAs with a second combine pass (flash-decoding) would fill the card;
// - memory pipelining: loads are plain and synchronous per block; staging
//   K/V tiles through cp.async or TMA would overlap them with the math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxBlockSize = 128;
constexpr int kAccPerThread = kMaxHeadDim / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, T* __restrict__ out, int num_heads,
    int head_dim, int num_blocks, int block_size, int max_blocks,
    float scale) {
  __shared__ float q_s[kMaxHeadDim];
  __shared__ float p_s[kMaxBlockSize];

  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = head_dim;
  const int bs = block_size;
  const size_t qo = ((size_t)row * num_heads + h) * D;

  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f32(q[qo + d]);
  __syncthreads();

  const int len = lengths[row];
  int nblk = len > 0 ? (len + bs - 1) / bs : 0;
  nblk = nblk < max_blocks ? nblk : max_blocks;
  // stride between consecutive positions of one head inside a pool block
  const size_t pos_stride = (size_t)num_heads * D;

  float m = kNegInf;
  float l = 0.f;
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const int blk = tables[(size_t)row * max_blocks + j];
    if (blk < 0 || blk >= num_blocks) continue;  // same for the whole CTA
    // element (blk, 0, h, 0) of the [num_blocks, bs, H, D] pool
    const size_t base = ((size_t)blk * bs * num_heads + h) * D;

    // scores: one warp per position, lanes across D
    for (int s = warp; s < bs; s += kWarps) {
      const T* kr = k_pool + base + (size_t)s * pos_stride;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[d] * to_f32(kr[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) p_s[s] = (j * bs + s < len) ? dot * scale : kNegInf;
    }
    __syncthreads();

    float m_cur = kNegInf;
    for (int s = 0; s < bs; ++s) m_cur = fmaxf(m_cur, p_s[s]);
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    __syncthreads();  // every thread has read the scores

    for (int s = tid; s < bs; s += kThreads) p_s[s] = expf(p_s[s] - m_new);
    __syncthreads();

    float psum = 0.f;
    for (int s = 0; s < bs; ++s) psum += p_s[s];
    l = alpha * l + psum;
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < D) {
        const T* vr = v_pool + base + d;
        float pv = 0.f;
#pragma unroll 8
        for (int s = 0; s < bs; ++s)
          pv += p_s[s] * to_f32(vr[(size_t)s * pos_stride]);
        acc[i] = acc[i] * alpha + pv;
      }
    }
    m = m_new;
    __syncthreads();  // p_s is rewritten by the next block
  }

  const float denom = (l == 0.f) ? 1.f : l;  // dead row -> exact zeros
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < D) store(out + qo + d, acc[i] / denom);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Shapes:
// q/out [n, h, d], pools [num_blocks, block_size, h, d], tables
// [n, max_blocks] int32, lengths [n] int32, all contiguous on one device.
// Launches on `stream` and returns the launch's error (cudaSuccess when
// it was accepted); does not synchronise.
extern "C" cudaError_t ragged_paged_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, int n, int h, int d,
    int num_blocks, int block_size, int max_blocks, float scale,
    void* stream) {
  if (d < 1 || d > kMaxHeadDim || block_size < 1 ||
      block_size > kMaxBlockSize || max_blocks < 1)
    return cudaErrorInvalidValue;
  if (n == 0 || h == 0) return cudaSuccess;
  const dim3 grid((unsigned)n, (unsigned)h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  if (dtype == 0) {
    ragged_paged_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), t, len, static_cast<float*>(out),
        h, d, num_blocks, block_size, max_blocks, scale);
  } else if (dtype == 1) {
    ragged_paged_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), t, len,
        static_cast<__nv_bfloat16*>(out), h, d, num_blocks, block_size,
        max_blocks, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

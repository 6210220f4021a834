// Fused BN-apply + ReLU (+ residual) feeding a 1x1 convolution as a matmul:
//   out[M, N] = bf16( bf16( relu(x * scale + shift (+ z)) ) @ w )
// x, z [M, K] bf16 (rows = N*H*W positions, columns = channels); w [K, N]
// bf16; scale, shift [K] f32; out [M, N] bf16. The transform is f32 (each
// step rounded as a separate f32 operation, no FMA contraction), rounded once
// to bf16, then multiplied with f32 accumulation and rounded to bf16.
//
// Replaces the TPU kernel tools/fused_conv_proto.py:75-106
// (`fused_scale_relu_matmul`, bodies `_fused_kernel:45` and `_fused_nores:109`).
// Its plain version is `fused_scale_relu_matmul_reference` beside this
// kernel's wrapper (paddle_tpu_torch/ops/kernels/fused_conv.py).
//
// What bounds it on the H100: bytes. At ResNet-50's block boundaries (batch
// 128) each call is ~13 GFLOP, 0.013 ms at the 989 TFLOP/s bf16 tensor peak,
// against 60-462 MB of x, z, w and out, 0.018-0.138 ms at 3.35 TB/s. The
// point of the fusion is that the relu output is never written to memory.
//
// Design (simple and right first): one CTA of 256 threads (8 warps) per
// 128 x 64 output tile, walking K in steps of 32. Each step loads the x (and
// z) rows as 16-byte vectors, applies the transform in f32, rounds to bf16
// into shared memory, stages the 32 x 64 w tile beside it, and the warps
// multiply with nvcuda::wmma bf16 16x16x16 fragments (each warp a 32 x 32
// sub-tile, 2 x 2 fragments) accumulating in f32. The next step's global
// loads are issued into registers before the current step's products, so
// they overlap the math. Output tiles of one row block are adjacent in the
// launch order, so the N / 64 CTAs that read the same x rows run together
// and find them in L2. Rows past M are computed and dropped; columns of K
// past its end read zero weights.
// What it leaves on the table, for the PR that makes it fast:
// - the tensor-core path is mma.sync-class wmma, not wgmma: the bound is
//   bytes, so that costs little; the loads are what matter;
// - staging is one register stage: a cp.async or TMA ring of several stages
//   would keep more bytes in flight per SM;
// - for N = 256 (the bn2 -> conv3 site) x is read 4 times (from L2): a wider
//   N tile would read it once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;  // shared-memory row pitch in bf16 (skews banks)
constexpr int kLdB = kBN + 8;

__device__ __forceinline__ uint4 zero4() { return make_uint4(0, 0, 0, 0); }

template <bool kRes>
__global__ void __launch_bounds__(kThreads) fused_scale_relu_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ z,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ out, int M,
    int K, int N, int n_tiles) {
  __shared__ __align__(128) __nv_bfloat16 a_s[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 b_s[kBK * kLdB];
  __shared__ __align__(128) float c_s[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int wm = (warp >> 1) * 32;  // warps 4 (M) x 2 (N), 32 x 32 each
  const int wn = (warp & 1) * 32;

  // this thread's 16-byte slots: A rows a_row and a_row + 64 at column
  // a_col of the K step; one B vector at (b_row, b_col)
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 8;
  const int b_row = tid >> 3;
  const int b_col = (tid & 7) * 8;

  uint4 xr[2], zr[2], wr;
  auto load = [&](int k0) {
    const int col = k0 + a_col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + a_row + 64 * i;
      const bool in = row < M && col < K;
      const size_t off = (size_t)row * K + col;
      xr[i] = in ? *reinterpret_cast<const uint4*>(x + off) : zero4();
      if (kRes) zr[i] = in ? *reinterpret_cast<const uint4*>(z + off) : zero4();
    }
    const int brow = k0 + b_row;
    const int bcol = n0 + b_col;
    wr = (brow < K && bcol < N)
             ? *reinterpret_cast<const uint4*>(w + (size_t)brow * N + bcol)
             : zero4();
  };

  auto stage = [&](int k0) {
    const int col = k0 + a_col;
    float s[8], b[8];
    if (col < K) {
      const float4* sp = reinterpret_cast<const float4*>(scale + col);
      const float4* bp = reinterpret_cast<const float4*>(shift + col);
      const float4 s0 = sp[0], s1 = sp[1], b0 = bp[0], b1 = bp[1];
      s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
      s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 t = zero4();
      if (col < K) {
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xr[i]);
        const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&zr[i]);
        __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xv = __bfloat1622float2(xp[q]);
          float lo = __fadd_rn(__fmul_rn(xv.x, s[2 * q]), b[2 * q]);
          float hi = __fadd_rn(__fmul_rn(xv.y, s[2 * q + 1]), b[2 * q + 1]);
          if (kRes) {
            const float2 zv = __bfloat1622float2(zp[q]);
            lo = __fadd_rn(lo, zv.x);
            hi = __fadd_rn(hi, zv.y);
          }
          tp[q] = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
        }
      }
      *reinterpret_cast<uint4*>(a_s + (a_row + 64 * i) * kLdA + a_col) = t;
    }
    *reinterpret_cast<uint4*>(b_s + b_row * kLdB + b_col) = wr;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_steps = (K + kBK - 1) / kBK;
  load(0);
  for (int ks = 0; ks < k_steps; ++ks) {
    stage(ks * kBK);
    __syncthreads();
    if (ks + 1 < k_steps) load((ks + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], a_s + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], b_s + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment through the warp's own 16 x 16 f32 buffer, then
  // 8 bf16 (one 16-byte store) per lane, rows past M dropped
  float* cw = c_s[warp];
  const int r = lane >> 1;
  const int c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm + 16 * i + r;
      const int col = n0 + wn + 16 * j + c;
      if (row < M && col < N) {
        uint4 o;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          op[q] = __floats2bfloat162_rn(cw[r * 16 + c + 2 * q],
                                        cw[r * 16 + c + 2 * q + 1]);
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = o;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// z may be null (no residual). M >= 1; K and N multiples of 16; every pointer
// 16-byte aligned (the wrapper checks). Returns a cudaError_t code.
extern "C" int fused_scale_relu_matmul(const void* x, const void* z,
                                       const void* w, const void* scale,
                                       const void* shift, void* out, int M,
                                       int K, int N, void* stream) {
  const int n_tiles = (N + kBN - 1) / kBN;
  const long long blocks = (long long)((M + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (z != nullptr)
    fused_scale_relu_matmul_kernel<true><<<grid, kThreads, 0, s>>>(
        xb, zb, wb, sc, sh, ob, M, K, N, n_tiles);
  else
    fused_scale_relu_matmul_kernel<false><<<grid, kThreads, 0, s>>>(
        xb, zb, wb, sc, sh, ob, M, K, N, n_tiles);
  return (int)cudaGetLastError();
}

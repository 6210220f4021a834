// Flash attention, forward and backward, for the port's training path.
//
// Replaces two TPU kernels:
// - K1, paddle_tpu/ops/pallas/flash_attention.py `_fa_core:176`, `_fa_fwd:186`
//   and `_fa_bwd:203` (jax's upstream Pallas TPU flash kernel), heads-major
//   [B, H, T, D] at any head_dim this file is instantiated for (64, 128);
// - K2, paddle_tpu/ops/pallas/packed_flash.py `_fwd_call:212`,
//   `_bwd_call:241` and `_bwd_call_fa2:368`: the same attention at head_dim
//   64 on head pairs packed in 128 lanes, [B, H/2, T, 128], head 2i in lanes
//   0:64 and head 2i+1 in lanes 64:128. Here it is the D=64 instance of the
//   same kernels, addressing the packed layout through strides (batch, pair,
//   half, seq): no unpack copy, and the outputs stay packed.
//
// Math (both): out = softmax(scale * q k^T, top-left causal mask row >= col)
// v, with f32 scores, f32 softmax and f32 accumulation. The forward also
// writes lse = m + log(l) per row (f32, [B, H, T]; for K2 that is
// [B, H/2, 2, T]). The backward is FA2's: delta = rowsum(do * o);
// p = exp(scale s - lse); ds = p (do v^T - delta) * scale; dq = ds k;
// dk = ds^T q; dv = p^T do. The 16-bit instances (bf16, f16) round p and ds
// to the inputs' type before the products that take them, at the points
// where the TPU kernels do
// (upstream flash_attention.py `p.astype(v.dtype)` and `ds.astype(...)`;
// packed_flash.py:111,158,166,277); the row sum l is taken from the f32 p.
// The TPU package has two backwards for K2 (one program holding the whole
// [T, T] rectangle for T <= 1024, the FA2 kernels above that); they compute
// the same function, and here one FA2 algorithm serves every T.
//
// Layout: every tensor is addressed as
//   offset(b, h, t, d) = b*sb + (h / hsplit)*sh + (h % hsplit)*shalf + t*st + d
// so K1 passes hsplit 1 and K2 passes hsplit 2, shalf 64. d is contiguous,
// every other stride is a multiple of 8 elements and the base is 16-byte
// aligned (the wrapper checks).
//
// What bounds it on the H100: operations. At the bench shape (B 32, H 6,
// T 1024, D 128, causal) the forward is ~5e10 FLOP and the backward ~1.3e11
// (counted as 4 and 10 B*H*D per causal pair) per layer against ~3e8 bytes;
// at the bf16 tensor-core peak (989 TFLOP/s) that is ~0.05 ms and ~0.13 ms.
//
// 16-bit design (Hopper, sm_90a), one template over the element type T with
// a bf16 and an f16 instance (wgmma takes both with the same fragments and
// descriptors; the instruction's type, the tensor maps' type and the
// rounding of P and dS follow T): every CTA has three warpgroups. Warpgroup 0
// is the producer: it gives its registers away (setmaxnreg 24) and one of
// its threads issues TMA loads into shared memory, signalled through
// mbarriers (a "full" and an "empty" barrier per stage of a 2-stage ring).
// Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 rows each, and run
// every product as wgmma on 16-bit operands with f32 accumulators:
// - forward: one CTA per 128 query rows of one (batch, head), heaviest
//   causal tiles launched first. Q is loaded once; K and V tiles of 128
//   rows stream through the ring. S = Q K^T (m64n128k16, both operands
//   K-major in shared memory); the online softmax runs on the accumulator
//   fragment (row max and sum over the 4 lanes of a quad); P, rounded to
//   T, is the register A operand of O += P V, where V is the MN-major B
//   operand (the transpose bit). kv tiles past the diagonal are skipped and
//   only diagonal tiles are masked. Shared memory at D 128: Q 32 KB +
//   2 x (K 32 KB + V 32 KB).
// - dk/dv: one CTA per 128 kv rows; K and V are loaded once, Q and dO tiles
//   of 64 rows with their lse and delta slices stream through the ring,
//   from the diagonal on when causal. S^T = K Q^T and dP^T = V dO^T (m64n64);
//   P^T and dS^T are formed in registers, rounded to T and are the A
//   operands of dV += P^T dO and dK += dS^T Q (dO and Q MN-major).
// - dq: one CTA per 128 query rows; Q and dO are loaded once, K and V tiles
//   of 64 rows stream through the ring. S and dP are recomputed, and
//   dQ += dS K with K the MN-major B operand from the same shared copy that
//   served Q K^T.
//   The two backward kernels each write their outputs once, with no atomics,
//   so the gradients are deterministic; the price is 7 products where an
//   atomic dq would need 5.
// - delta: rowsum(do * o) over the 16-bit output, one warp per row (the
//   SIMT kernel below serves every dtype).
// Operands reach shared memory only through TMA: one 5-D tensor map per
// operand, dims (d, half, t, pair, b) with the wrapper's strides, so K1's
// strided views and K2's packed halves load with no copy; 64-column boxes
// under the 128-byte swizzle that the wgmma descriptors read. The tensor
// maps are encoded on the host, with cuTensorMapEncodeTiled looked up at
// run time (the build links no libcuda), and passed as __grid_constant__
// parameters. Products whose B operand is MN-major run as one m64n64
// instruction per 64 columns of d.
//
// f32 design (kept: no tensor-core product has f32 accuracy, and TF32 would
// break the f32 limits): 64 x 64 tiles, 256 threads, each thread holding a
// 4 x 4 block of scores in registers, operands staged in shared memory as
// f32, FMA on the SIMT cores; the same forward / dq / dk-dv split.
//
// What the 16-bit design still leaves: FA3's intra-warpgroup ping-pong of the
// softmax with the next tile's wgmma (here a consumer waits for each product
// before the elementwise work that follows it), a persistent tile scheduler,
// fp8, and a TMA store of the outputs (they leave the accumulators as 4-byte
// stores).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // q tile rows == kv tile rows

struct Layout {
  long long sb, sh, shalf, st;
  int hsplit;
  __device__ __forceinline__ long long off(int b, int h, int t) const {
    return b * sb + (long long)(h / hsplit) * sh +
           (long long)(h % hsplit) * shalf + (long long)t * st;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// 8 consecutive f32 elements (two float4)
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 4 consecutive f32 elements
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// tile rows t0..t0+63 of one (b, h) into shared memory transposed, dst[d][r]
// (rows fastest across lanes, so the scattered stores are conflict-free)
template <int D>
__device__ __forceinline__ void load_tile_t(float* dst, const float* src,
                                            const Layout& L, int b, int h,
                                            int t0) {
  for (int idx = threadIdx.x; idx < kTile * (D / 8); idx += kThreads) {
    const int r = idx % kTile, c8 = idx / kTile;
    float v[8];
    load8(src + L.off(b, h, t0 + r) + c8 * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c8 * 8 + i) * kTile + r] = v[i];
  }
}

// the same rows row-major, dst[r][d]
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const Layout& L, int b, int h,
                                          int t0) {
  for (int idx = threadIdx.x; idx < kTile * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c8 = idx % (D / 8);
    float v[8];
    load8(src + L.off(b, h, t0 + r) + c8 * 8, v);
    store4(dst + r * D + c8 * 8, v);
    store4(dst + r * D + c8 * 8 + 4, v + 4);
  }
}

// acc[i][j] += sum_d xt[d][ty*4+i] * yt[d][tx*4+j]
template <int D>
__device__ __forceinline__ void rowdot(float (&acc)[4][4], const float* xt,
                                       const float* yt, int tx, int ty) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = ld4(xt + d * kTile + ty * 4);
    const float4 b = ld4(yt + d * kTile + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][jj][e] += sum_c wt[c][ty*4+i] * y[c][jj*64 + tx*4 + e]
template <int D>
__device__ __forceinline__ void accum(float (&acc)[4][D / 64][4],
                                      const float* wt, const float* y,
                                      int tx, int ty) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    const float4 w = ld4(wt + c * kTile + ty * 4);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const float4 u = ld4(y + c * D + jj * 64 + tx * 4);
      const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] += wv[i] * uv[e];
    }
  }
}

// store the register block v[i][j] (rows ty*4+i, cols tx*4+j) as wt[col][row]
__device__ __forceinline__ void store_t(float* wt, const float (&v)[4][4],
                                        int tx, int ty) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(wt + (tx * 4 + j) * kTile + ty * 4) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
  }
}

// reductions over the 16 lanes that share a row (same ty, tx = 0..15)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__device__ __forceinline__ void write_rows(float* dst, const Layout& L, int b,
                                           int h, int t0,
                                           const float (&acc)[4][D / 64][4],
                                           const float* rscale, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dst + L.off(b, h, t0 + ty * 4 + i);
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][jj][e] * rscale[i];
      store4(row + jj * 64 + tx * 4, v);
    }
  }
}

// ------------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Layout lq, Layout lk,
                      Layout lv, Layout lo, int H, int Tq, int Tk,
                      float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][64]
  float* kt = qt + D * kTile;                   // [D][64]
  float* vs = kt + D * kTile;                   // [64][D]
  float* pt = vs + kTile * D;                   // [64 kv][64 q]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_t<D>(qt, q, lq, b, h, q0);
  float acc[4][D / 64][4] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int nkv = Tk / kTile;
  if (causal) nkv = min(nkv, (q0 + kTile - 1) / kTile + 1);
  for (int kj = 0; kj < nkv; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();  // the previous tile's reads of kt/vs/pt are done
    load_tile_t<D>(kt, k, lk, b, h, k0);
    load_tile<D>(vs, v, lv, b, h, k0);
    __syncthreads();
    float s[4][4] = {};
    rowdot<D>(s, qt, kt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx * 4 + j > row) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mnew = fmaxf(m[i], row_max(mx));
      const float mref = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = expf(m[i] - mref);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mref);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mnew;
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    store_t(pt, s, tx, ty);
    __syncthreads();
    accum<D>(acc, pt, vs, tx, ty);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  write_rows<D>(o, lo, b, h, q0, acc, inv, tx, ty);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lse[((long long)b * H + h) * Tq + q0 + ty * 4 + i] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------------ delta
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, Layout lo, Layout ldo, int H,
                    int Tq, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int t = (int)(row % Tq);
  const int h = (int)((row / Tq) % H);
  const int b = (int)(row / ((long long)Tq * H));
  const T* orow = o + lo.off(b, h, t);
  const T* drow = dout + ldo.off(b, h, t);
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ------------------------------------------------------------------ dq
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, Layout lq, Layout lk,
                         Layout lv, Layout ldo, int H, int Tq, int Tk,
                         float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][64]
  float* dot = qt + D * kTile;                  // [D][64]
  float* kt = dot + D * kTile;                  // [D][64]
  float* vt = kt + D * kTile;                   // [D][64]
  float* ks = vt + D * kTile;                   // [64][D]
  float* dst = ks + kTile * D;                  // [64 kv][64 q]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_t<D>(qt, q, lq, b, h, q0);
  load_tile_t<D>(dot, dout, ldo, b, h, q0);
  float lse_r[4], del_r[4];
  const long long rbase = ((long long)b * H + h) * Tq + q0 + ty * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[rbase + i];
    del_r[i] = delta[rbase + i];
  }
  float acc[4][D / 64][4] = {};
  int nkv = Tk / kTile;
  if (causal) nkv = min(nkv, (q0 + kTile - 1) / kTile + 1);
  for (int kj = 0; kj < nkv; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();
    load_tile_t<D>(kt, k, lk, b, h, k0);
    load_tile_t<D>(vt, v, lv, b, h, k0);
    load_tile<D>(ks, k, lk, b, h, k0);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    rowdot<D>(s, qt, kt, tx, ty);
    rowdot<D>(dp, dot, vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = causal && k0 + tx * 4 + j > row;
        const float p = masked ? 0.f : expf(s[i][j] * scale - lse_r[i]);
        s[i][j] = p * (dp[i][j] - del_r[i]) * scale;
      }
    }
    store_t(dst, s, tx, ty);
    __syncthreads();
    accum<D>(acc, dst, ks, tx, ty);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  write_rows<D>(dq, lq, b, h, q0, acc, one, tx, ty);
}

// ------------------------------------------------------------------ dk, dv
template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Layout lq, Layout lk, Layout lv, Layout ldo, int H,
                          int Tq, int Tk, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][64]
  float* vt = kt + D * kTile;                   // [D][64]
  float* qt = vt + D * kTile;                   // [D][64]
  float* dot = qt + D * kTile;                  // [D][64]
  float* qs = dot + D * kTile;                  // [64][D]
  float* dos = qs + kTile * D;                  // [64][D]
  float* w = dos + kTile * D;                   // [64 q][64 kv]
  float* lse_s = w + kTile * kTile;             // [64]
  float* del_s = lse_s + kTile;                 // [64]
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_t<D>(kt, k, lk, b, h, k0);
  load_tile_t<D>(vt, v, lv, b, h, k0);
  float dk_acc[4][D / 64][4] = {}, dv_acc[4][D / 64][4] = {};
  const int nq = Tq / kTile;
  // causal: q tile qi is live iff its last row reaches this tile's first col
  const int qstart = causal ? k0 / kTile : 0;
  for (int qi = qstart; qi < nq; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_tile_t<D>(qt, q, lq, b, h, q0);
    load_tile_t<D>(dot, dout, ldo, b, h, q0);
    load_tile<D>(qs, q, lq, b, h, q0);
    load_tile<D>(dos, dout, ldo, b, h, q0);
    if (threadIdx.x < kTile) {
      const long long r = ((long long)b * H + h) * Tq + q0 + threadIdx.x;
      lse_s[threadIdx.x] = lse[r];
      del_s[threadIdx.x] = delta[r];
    }
    __syncthreads();
    // transposed scores: rows are kv positions (ty), cols q positions (tx)
    float st[4][4] = {}, dpt[4][4] = {};
    rowdot<D>(st, kt, qt, tx, ty);
    rowdot<D>(dpt, vt, dot, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx * 4 + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool masked = causal && k0 + ty * 4 + i > q0 + rl;
        const float p =
            masked ? 0.f : expf(st[i][j] * scale - lse_s[rl]);
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - del_s[rl]) * scale;
      }
    }
    store_t(w, st, tx, ty);  // w[q][kv] = p
    __syncthreads();
    accum<D>(dv_acc, w, dos, tx, ty);
    __syncthreads();
    store_t(w, dpt, tx, ty);  // w[q][kv] = ds
    __syncthreads();
    accum<D>(dk_acc, w, qs, tx, ty);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  write_rows<D>(dk, lk, b, h, k0, dk_acc, one, tx, ty);
  write_rows<D>(dv, lv, b, h, k0, dv_acc, one, tx, ty);
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * D * kTile + kTile * kTile);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (5 * D * kTile + kTile * kTile);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (6 * D * kTile + kTile * kTile + 2 * kTile);
}


// ================================================================ Hopper
// 16-bit kernels (bf16 and f16 instances, T): TMA rings in shared memory
// feeding wgmma (see the header)

constexpr int kHThreads = 3 * kWG;       // producer + two consumer warpgroups
constexpr int kConsumerThreads = 2 * kWG;
constexpr int kStages = 2;               // depth of each streamed ring
constexpr int kColBlock = 64;            // d columns per TMA box (128 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// rows t0 .. t0+rows-1 of head h, all D columns, as D/64 column blocks of
// [rows][64] (128-byte rows under the 128-byte swizzle), block c at
// dst + c * rows * 128
template <int D>
__device__ __forceinline__ void tma_rows(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int b, int h,
                                         int hsplit, int t0) {
#pragma unroll
  for (int c = 0; c < D / kColBlock; ++c)
    tma_load(dst + c * rows * 128, map, bar, c * kColBlock, h % hsplit, t0,
             h / hsplit, b);
}


__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a consumer's 64 x D accumulator (D/64 blocks of m64n64) to T rows
// row0 and row0 + 8 of the thread, each scaled by rscale[r]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const Layout& L,
                                           int b, int h, int row0,
                                           const float (&acc)[D / 64][32],
                                           const float (&rscale)[2],
                                           const Frag& f) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* p = dst + L.off(b, h, row0 + 8 * r);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
        *reinterpret_cast<uint32_t*>(p + 64 * cb + 8 * jb + f.cl) =
            pack2<T>(acc[cb][4 * jb + 2 * r] * rscale[r],
                      acc[cb][4 * jb + 2 * r + 1] * rscale[r]);
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], kConsumerThreads);
  }
}


// ------------------------------------------------------- forward (16-bit)
template <int D>
struct FwdTiles {
  static constexpr int kRows = 128;                // q and kv tile rows
  static constexpr int kBlock = kRows * 128;       // one 64-column block
  static constexpr int kTile = kRows * D * 2;      // bytes of a tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBytes = kV + kStages * kTile;
};

template <typename T, int D>
__global__ void __launch_bounds__(kHThreads, 1)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        T* __restrict__ o, float* __restrict__ lse,
                        Layout lo, int H, int hsplit, int Tq, int Tk,
                        float scale, int causal) {
  using S = FwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  uint8_t* sm = align1024(smem_raw);
  const int qt = Tq / S::kRows - 1 - (int)blockIdx.y;  // heaviest first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = qt * S::kRows;
  const int nkv = causal ? min(Tk / S::kRows, qt + 1) : Tk / S::kRows;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    init_ring(full, empty);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&q_full, S::kTile);
      tma_rows<D>(sm + S::kQ, &tq, &q_full, S::kRows, b, h, hsplit, q0);
      for (int j = 0; j < nkv; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kTile);
        tma_rows<D>(sm + S::kK + s * S::kTile, &tk, &full[s], S::kRows, b, h,
                    hsplit, j * S::kRows);
        tma_rows<D>(sm + S::kV + s * S::kTile, &tv, &full[s], S::kRows, b, h,
                    hsplit, j * S::kRows);
      }
    }
  } else {
    consumer_regs();
    const int c = wg - 1;  // rows 64c .. 64c+63 of the query tile
    const Frag f(threadIdx.x - wg * kWG);
    const int row0 = q0 + 64 * c + f.rl;
    const float sl2 = scale * kLog2e;  // scores in log2 units
    const uint8_t* qs = sm + S::kQ + c * 64 * 128;
    float acc[D / 64][32], sc[64];
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) zero(acc[cb]);
    zero(sc);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(&q_full, 0);
    for (int j = 0; j < nkv; ++j) {
      const int s = j % kStages;
      const uint8_t* ks = sm + S::kK + s * S::kTile;
      const uint8_t* vs = sm + S::kV + s * S::kTile;
      mbar_wait(&full[s], (j / kStages) & 1);
      // S = Q K^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * S::kBlock + (kk % 4) * 32;
        wgmma_ss_n128<T>(sc, sw128_desc(qs + off), sw128_desc(ks + off),
                         kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);
      // online softmax on the fragment; only diagonal tiles are masked
      const int k0 = j * S::kRows;
      const bool diag = causal && k0 + S::kRows - 1 > q0 + 64 * c;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * sl2;
        if (diag && k0 + f.col(i) > row0 + Frag::row(i)) x = -INFINITY;
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2], mref[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        mref[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = exp2f(m[r] - mref[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = exp2f(sc[i] - mref[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[cb][i] *= alpha[(i >> 1) & 1];
        pin(acc[cb]);
      }
      pin(pa);
      // O += P V, one m64n64 product per 64 columns of d
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S::kRows / 16; ++kk)
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          wgmma_rs_n64<T>(acc[cb], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3],
                       sw128_desc(vs + cb * S::kBlock + kk * 16 * 128));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) pin(acc[cb]);
      mbar_arrive(&empty[s]);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
    store_rows<T, D>(o, lo, b, h, row0, acc, inv, f);
    if (f.lane % 4 == 0) {
      float* lrow = lse + ((long long)b * H + h) * Tq + row0;
#pragma unroll
      for (int r = 0; r < 2; ++r) lrow[8 * r] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ------------------------------------------------------- dk, dv (16-bit)
template <int D>
struct DkvTiles {
  static constexpr int kKvRows = 128, kQRows = 64;
  static constexpr int kKvBlock = kKvRows * 128, kQBlock = kQRows * 128;
  static constexpr int kKvTile = kKvRows * D * 2, kQTile = kQRows * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvTile;
  static constexpr int kQ = kV + kKvTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kRowBytes = kQRows * 4;  // a tile's lse or delta
  static constexpr int kLse = kDo + kStages * kQTile;
  static constexpr int kDelta = kLse + kStages * kRowBytes;
  static constexpr int kBytes = kDelta + kStages * kRowBytes;
};

template <typename T, int D>
__global__ void __launch_bounds__(kHThreads, 1)
    fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv,
                            Layout lk, Layout lv, int H, int hsplit, int Tq,
                            int Tk, float scale, int causal) {
  using S = DkvTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[kStages], empty[kStages];
  uint8_t* sm = align1024(smem_raw);
  // causal: the first kv tiles meet the most query tiles; they go first
  const int k0 = (int)blockIdx.y * S::kKvRows;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qfirst = causal ? k0 / S::kQRows : 0;  // first live query tile
  const int n = Tq / S::kQRows - qfirst;
  const long long rbase = ((long long)b * H + h) * Tq;
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    init_ring(full, empty);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&kv_full, 2 * S::kKvTile);
      tma_rows<D>(sm + S::kK, &tk, &kv_full, S::kKvRows, b, h, hsplit, k0);
      tma_rows<D>(sm + S::kV, &tv, &kv_full, S::kKvRows, b, h, hsplit, k0);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int q0 = (qfirst + i) * S::kQRows;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kQTile + 2 * S::kRowBytes);
        tma_rows<D>(sm + S::kQ + s * S::kQTile, &tq, &full[s], S::kQRows, b,
                    h, hsplit, q0);
        tma_rows<D>(sm + S::kDo + s * S::kQTile, &tdo, &full[s], S::kQRows,
                    b, h, hsplit, q0);
        bulk_load(sm + S::kLse + s * S::kRowBytes, lse + rbase + q0,
                  S::kRowBytes, &full[s]);
        bulk_load(sm + S::kDelta + s * S::kRowBytes, delta + rbase + q0,
                  S::kRowBytes, &full[s]);
      }
    }
  } else {
    consumer_regs();
    const int c = wg - 1;  // kv rows 64c .. 64c+63 of the tile
    const Frag f(threadIdx.x - wg * kWG);
    const int row0 = k0 + 64 * c + f.rl;
    const float sl2 = scale * kLog2e;
    const uint8_t* ka = sm + S::kK + c * 64 * 128;
    const uint8_t* va = sm + S::kV + c * 64 * 128;
    float dka[D / 64][32], dva[D / 64][32], st[32], dpt[32];
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      zero(dka[cb]);
      zero(dva[cb]);
    }
    zero(st);
    zero(dpt);
    mbar_wait(&kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int q0 = (qfirst + i) * S::kQRows;
      mbar_wait(&full[s], (i / kStages) & 1);
      if (causal && k0 + 64 * c > q0 + S::kQRows - 1) {
        mbar_arrive(&empty[s]);  // every kv row past every query: P^T = 0
        continue;
      }
      const uint8_t* qs = sm + S::kQ + s * S::kQTile;
      const uint8_t* dos = sm + S::kDo + s * S::kQTile;
      // S^T = K Q^T, dP^T = V dO^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a = (kk / 4) * S::kKvBlock + (kk % 4) * 32;
        const int bq = (kk / 4) * S::kQBlock + (kk % 4) * 32;
        wgmma_ss_n64<T>(st, sw128_desc(ka + a), sw128_desc(qs + bq), kk > 0);
        wgmma_ss_n64<T>(dpt, sw128_desc(va + a), sw128_desc(dos + bq), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(st);
      pin(dpt);
      // P^T and dS^T in registers; columns are query rows
      const float* ls = reinterpret_cast<const float*>(sm + S::kLse +
                                                       s * S::kRowBytes);
      const float* dl = reinterpret_cast<const float*>(sm + S::kDelta +
                                                       s * S::kRowBytes);
      const bool diag = causal && k0 + 64 * c + 63 > q0;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qc = f.col(e);
        float p = exp2f(st[e] * sl2 - ls[qc] * kLog2e);
        if (diag && row0 + Frag::row(e) > q0 + qc) p = 0.f;
        dpt[e] = p * (dpt[e] - dl[qc]) * scale;
        st[e] = p;
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        pa[e] = pack2<T>(st[2 * e], st[2 * e + 1]);
        da[e] = pack2<T>(dpt[2 * e], dpt[2 * e + 1]);
      }
      pin(pa);
      pin(da);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        pin(dka[cb]);
        pin(dva[cb]);
      }
      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S::kQRows / 16; ++kk)
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          const int bo = cb * S::kQBlock + kk * 16 * 128;
          wgmma_rs_n64<T>(dva[cb], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                       pa[4 * kk + 3], sw128_desc(dos + bo));
          wgmma_rs_n64<T>(dka[cb], da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                       da[4 * kk + 3], sw128_desc(qs + bo));
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        pin(dka[cb]);
        pin(dva[cb]);
      }
      mbar_arrive(&empty[s]);
    }
    const float one[2] = {1.f, 1.f};
    store_rows<T, D>(dk, lk, b, h, row0, dka, one, f);
    store_rows<T, D>(dv, lv, b, h, row0, dva, one, f);
  }
}

// ------------------------------------------------------- dq (16-bit)
template <int D>
struct DqTiles {
  static constexpr int kQRows = 128, kKvRows = 64;
  static constexpr int kQBlock = kQRows * 128, kKvBlock = kKvRows * 128;
  static constexpr int kQTile = kQRows * D * 2, kKvTile = kKvRows * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQTile;
  static constexpr int kK = kDo + kQTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBytes = kV + kStages * kKvTile;
};

template <typename T, int D>
__global__ void __launch_bounds__(kHThreads, 1)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, Layout lq, int H, int hsplit,
                           int Tq, int Tk, float scale, int causal) {
  using S = DqTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  uint8_t* sm = align1024(smem_raw);
  const int qt = Tq / S::kQRows - 1 - (int)blockIdx.y;  // heaviest first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = qt * S::kQRows;
  int nkv = Tk / S::kKvRows;
  if (causal) nkv = min(nkv, (q0 + S::kQRows) / S::kKvRows);
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    init_ring(full, empty);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&q_full, 2 * S::kQTile);
      tma_rows<D>(sm + S::kQ, &tq, &q_full, S::kQRows, b, h, hsplit, q0);
      tma_rows<D>(sm + S::kDo, &tdo, &q_full, S::kQRows, b, h, hsplit, q0);
      for (int j = 0; j < nkv; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kKvTile);
        tma_rows<D>(sm + S::kK + s * S::kKvTile, &tk, &full[s], S::kKvRows,
                    b, h, hsplit, j * S::kKvRows);
        tma_rows<D>(sm + S::kV + s * S::kKvTile, &tv, &full[s], S::kKvRows,
                    b, h, hsplit, j * S::kKvRows);
      }
    }
  } else {
    consumer_regs();
    const int c = wg - 1;  // query rows 64c .. 64c+63 of the tile
    const Frag f(threadIdx.x - wg * kWG);
    const int row0 = q0 + 64 * c + f.rl;
    const float sl2 = scale * kLog2e;
    const long long rbase = ((long long)b * H + h) * Tq + row0;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = lse[rbase + 8 * r] * kLog2e;
      dl[r] = delta[rbase + 8 * r];
    }
    const uint8_t* qa = sm + S::kQ + c * 64 * 128;
    const uint8_t* doa = sm + S::kDo + c * 64 * 128;
    float dqa[D / 64][32], sc[32], dp[32];
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) zero(dqa[cb]);
    zero(sc);
    zero(dp);
    mbar_wait(&q_full, 0);
    for (int j = 0; j < nkv; ++j) {
      const int s = j % kStages;
      const int k0 = j * S::kKvRows;
      mbar_wait(&full[s], (j / kStages) & 1);
      if (causal && k0 > q0 + 64 * c + 63) {
        mbar_arrive(&empty[s]);  // every key past every query row: dS = 0
        continue;
      }
      const uint8_t* ks = sm + S::kK + s * S::kKvTile;
      const uint8_t* vs = sm + S::kV + s * S::kKvTile;
      // S = Q K^T, dP = dO V^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a = (kk / 4) * S::kQBlock + (kk % 4) * 32;
        const int bk = (kk / 4) * S::kKvBlock + (kk % 4) * 32;
        wgmma_ss_n64<T>(sc, sw128_desc(qa + a), sw128_desc(ks + bk), kk > 0);
        wgmma_ss_n64<T>(dp, sw128_desc(doa + a), sw128_desc(vs + bk), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);
      const bool diag = causal && k0 + S::kKvRows - 1 > q0 + 64 * c;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        float p = exp2f(sc[e] * sl2 - lse2[r]);
        if (diag && k0 + f.col(e) > row0 + 8 * r) p = 0.f;
        dp[e] = p * (dp[e] - dl[r]) * scale;
      }
      uint32_t da[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) da[e] = pack2<T>(dp[2 * e], dp[2 * e + 1]);
      pin(da);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) pin(dqa[cb]);
      // dQ += dS K (K MN-major)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S::kKvRows / 16; ++kk)
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          wgmma_rs_n64<T>(dqa[cb], da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                       da[4 * kk + 3],
                       sw128_desc(ks + cb * S::kKvBlock + kk * 16 * 128));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) pin(dqa[cb]);
      mbar_arrive(&empty[s]);
    }
    const float one[2] = {1.f, 1.f};
    store_rows<T, D>(dq, lq, b, h, row0, dqa, one, f);
  }
}

Layout unpack(const long long* p) {
  Layout L;
  L.sb = p[0];
  L.sh = p[1];
  L.shalf = p[2];
  L.st = p[3];
  L.hsplit = (int)p[4];
  return L;
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, Layout lo,
                 Layout ldo, int B, int H, int Tq, cudaStream_t stream) {
  const long long rows = (long long)B * H * Tq;
  const int per = kThreads / 32;
  fa_delta_kernel<T, D><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                          stream>>>(static_cast<const T*>(o),
                                    static_cast<const T*>(dout), delta, lo,
                                    ldo, H, Tq, rows);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- f32 (SIMT)
template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const long long* lay, int B, int H, int Tq,
               int Tk, float scale, int causal, cudaStream_t stream) {
  auto kern = fa_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem(D));
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tq / kTile, H, B);
  kern<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, unpack(lay),
      unpack(lay + 5), unpack(lay + 10), unpack(lay + 15), H, Tq, Tk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const long long* lay, int B, int H,
               int Tq, int Tk, float scale, int causal,
               cudaStream_t stream) {
  const Layout lq = unpack(lay), lk = unpack(lay + 5), lv = unpack(lay + 10),
               lo = unpack(lay + 15), ldo = unpack(lay + 20);
  int e = launch_delta<float, D>(o, dout, delta, lo, ldo, B, H, Tq, stream);
  if (e != 0) return e;

  auto dq_kern = fa_bwd_dq_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(D));
  if (err != cudaSuccess) return (int)err;
  dq_kern<<<dim3(Tq / kTile, H, B), kThreads, dq_smem(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), lq, lk, lv, ldo, H, Tq, Tk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkv_kern = fa_bwd_dkv_f32_kernel<D>;
  err = cudaFuncSetAttribute(dkv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem(D));
  if (err != cudaSuccess) return (int)err;
  dkv_kern<<<dim3(Tk / kTile, H, B), kThreads, dkv_smem(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), lq, lk, lv, ldo, H,
      Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16, f16 (Hopper)
// one operand's tensor map: dims (d, half, t, pair, b) with the layout's
// strides, boxes of 64 d columns x `rows` rows, 128-byte swizzle; Elem is
// the operand's 16-bit type
template <typename Elem>
int tensor_map(CUtensorMap* map, const void* base, const Layout& L, int D,
               int H, int T, int B, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const long long ext[4] = {L.hsplit, T, H / L.hsplit, B};
  const long long str[4] = {L.shalf, L.st, L.sh, L.sb};
  cuuint64_t dims[5] = {(cuuint64_t)D}, strides[4];
  for (int i = 0; i < 4; ++i) {
    dims[i + 1] = (cuuint64_t)ext[i];
    // a dimension of extent 1 is never stepped: any valid stride will do
    strides[i] = ext[i] == 1 ? 16 : (cuuint64_t)str[i] * 2;
  }
  const cuuint32_t box[5] = {kColBlock, 1, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map,
      kIsHalf<Elem> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      5, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <typename Kernel>
int launch_hopper(Kernel kern, int bytes, dim3 grid, cudaStream_t stream,
                  void** args) {
  // + 1024: the kernels align their tiles to the swizzle's 1024 bytes
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes + 1024);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel((const void*)kern, grid, dim3(kHThreads), args,
                         bytes + 1024, stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                    float* lse, const long long* lay, int B, int H, int Tq,
                    int Tk, float scale, int causal, cudaStream_t stream) {
  using S = FwdTiles<D>;
  Layout lq = unpack(lay), lo = unpack(lay + 15);
  CUtensorMap tq, tk, tv;
  int e;
  if ((e = tensor_map<T>(&tq, q, lq, D, H, Tq, B, S::kRows)) ||
      (e = tensor_map<T>(&tk, k, unpack(lay + 5), D, H, Tk, B, S::kRows)) ||
      (e = tensor_map<T>(&tv, v, unpack(lay + 10), D, H, Tk, B, S::kRows)))
    return e;
  auto* out = static_cast<T*>(o);
  int hsplit = lq.hsplit;
  void* args[] = {&tq, &tk, &tv, &out, &lse, &lo, &H, &hsplit,
                  &Tq, &Tk, &scale, &causal};
  return launch_hopper(fa_fwd_wgmma_kernel<T, D>, S::kBytes,
                       dim3(B * H, Tq / S::kRows), stream, args);
}

template <typename T, int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv,
                    const long long* lay, int B, int H, int Tq, int Tk,
                    float scale, int causal, cudaStream_t stream) {
  Layout lq = unpack(lay), lk = unpack(lay + 5), lv = unpack(lay + 10);
  const Layout lo = unpack(lay + 15), ldo = unpack(lay + 20);
  int e = launch_delta<T, D>(o, dout, delta, lo, ldo, B, H, Tq, stream);
  if (e != 0) return e;
  int hsplit = lq.hsplit;
  const float* delta_in = delta;

  using Q = DqTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  if ((e = tensor_map<T>(&tq, q, lq, D, H, Tq, B, Q::kQRows)) ||
      (e = tensor_map<T>(&tdo, dout, ldo, D, H, Tq, B, Q::kQRows)) ||
      (e = tensor_map<T>(&tk, k, lk, D, H, Tk, B, Q::kKvRows)) ||
      (e = tensor_map<T>(&tv, v, lv, D, H, Tk, B, Q::kKvRows)))
    return e;
  auto* dq_out = static_cast<T*>(dq);
  void* dq_args[] = {&tq,     &tk, &tv,     &tdo, &lse, &delta_in,
                     &dq_out, &lq, &H,      &hsplit, &Tq,  &Tk,
                     &scale,  &causal};
  e = launch_hopper(fa_bwd_dq_wgmma_kernel<T, D>, Q::kBytes,
                    dim3(B * H, Tq / Q::kQRows), stream, dq_args);
  if (e != 0) return e;

  using KV = DkvTiles<D>;
  if ((e = tensor_map<T>(&tq, q, lq, D, H, Tq, B, KV::kQRows)) ||
      (e = tensor_map<T>(&tdo, dout, ldo, D, H, Tq, B, KV::kQRows)) ||
      (e = tensor_map<T>(&tk, k, lk, D, H, Tk, B, KV::kKvRows)) ||
      (e = tensor_map<T>(&tv, v, lv, D, H, Tk, B, KV::kKvRows)))
    return e;
  auto* dk_out = static_cast<T*>(dk);
  auto* dv_out = static_cast<T*>(dv);
  void* dkv_args[] = {&tq, &tk,     &tv,    &tdo, &lse, &delta_in,
                      &dk_out, &dv_out, &lk, &lv, &H, &hsplit,
                      &Tq, &Tk, &scale, &causal};
  return launch_hopper(fa_bwd_dkv_wgmma_kernel<T, D>, KV::kBytes,
                       dim3(B * H, Tk / KV::kKvRows), stream, dkv_args);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. head_dim: 64 or 128. layouts:
// 5 int64 per tensor (sb, sh, shalf, st, hsplit) for q, k, v, o. Tq, Tk
// multiples of 64 for float32 and of 128 for bfloat16 and float16. Returns
// a cudaError_t (0 on success); -1 for an unsupported instance, -2 / -3
// when a tensor map cannot be made (no cuTensorMapEncodeTiled / an operand
// it refuses).
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, const long long* layouts,
                                   int B, int H, int Tq, int Tk, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_FWD(LAUNCH) \
  LAUNCH(q, k, v, o, lse, layouts, B, H, Tq, Tk, scale, causal, s)
  if (dtype == 0 && head_dim == 64) return FA_FWD(launch_fwd<64>);
  if (dtype == 0 && head_dim == 128) return FA_FWD(launch_fwd<128>);
  if (dtype == 1 && head_dim == 64)
    return FA_FWD((launch_fwd_wgmma<__nv_bfloat16, 64>));
  if (dtype == 1 && head_dim == 128)
    return FA_FWD((launch_fwd_wgmma<__nv_bfloat16, 128>));
  if (dtype == 2 && head_dim == 64)
    return FA_FWD((launch_fwd_wgmma<__half, 64>));
  if (dtype == 2 && head_dim == 128)
    return FA_FWD((launch_fwd_wgmma<__half, 128>));
#undef FA_FWD
  return -1;
}

// layouts: q, k, v, o, do (5 int64 each); dq, dk, dv share q's, k's and
// v's layouts. delta is f32 scratch of B*H*Tq.
extern "C" int flash_attention_bwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv,
                                   const long long* layouts, int B, int H,
                                   int Tq, int Tk, float scale, int causal,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_BWD(LAUNCH)                                                   \
  LAUNCH(q, k, v, o, dout, lse, delta, dq, dk, dv, layouts, B, H, Tq, Tk, \
         scale, causal, s)
  if (dtype == 0 && head_dim == 64) return FA_BWD(launch_bwd<64>);
  if (dtype == 0 && head_dim == 128) return FA_BWD(launch_bwd<128>);
  if (dtype == 1 && head_dim == 64)
    return FA_BWD((launch_bwd_wgmma<__nv_bfloat16, 64>));
  if (dtype == 1 && head_dim == 128)
    return FA_BWD((launch_bwd_wgmma<__nv_bfloat16, 128>));
  if (dtype == 2 && head_dim == 64)
    return FA_BWD((launch_bwd_wgmma<__half, 64>));
  if (dtype == 2 && head_dim == 128)
    return FA_BWD((launch_bwd_wgmma<__half, 128>));
#undef FA_BWD
  return -1;
}

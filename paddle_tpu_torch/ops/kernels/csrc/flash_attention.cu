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
// v, with f32 scores, f32 softmax and f32 accumulation for the f32 and the
// bf16 instantiation. The forward also writes lse = m + log(l) per row (f32,
// [B, H, T]; for K2 that is [B, H/2, 2, T]). The backward is FA2's:
// delta = rowsum(do * o); p = exp(scale s - lse); ds = p (do v^T - delta) *
// scale; dq = ds k; dk = ds^T q; dv = p^T do. The TPU package has two
// backwards for K2 (one program holding the whole [T, T] rectangle for
// T <= 1024, the FA2 kernels above that); they compute the same function,
// and on Hopper this one FA2 algorithm serves every T <= 8192.
//
// Layout: every tensor is addressed as
//   offset(b, h, t, d) = b*sb + (h / hsplit)*sh + (h % hsplit)*shalf + t*st + d
// so K1 passes hsplit 1 and K2 passes hsplit 2, shalf 64. d is contiguous,
// every other stride is a multiple of 8 elements and the base is 16-byte
// aligned (the wrapper checks), so a thread moves 16 bytes at a time.
//
// What bounds it on the H100: operations. At the bench shape (B 32, H 6,
// T 1024, D 128, causal) the forward is ~5e10 FLOP and the backward ~1.3e11
// per layer against ~3e8 bytes; at the bf16 tensor-core peak that is
// ~0.05 ms and ~0.13 ms. This first design does not reach the tensor cores:
//
// Design (simple and right first): 64 x 64 tiles, 256 threads, each thread
// holding a 4 x 4 block of scores in registers (rows ty*4.., cols tx*4..),
// operands staged in shared memory as f32 (transposed [D][64] for the score
// products, so both operands are read as float4), FMA on the SIMT cores.
// - forward: one CTA per (q tile, head, batch); a loop over kv tiles with
//   the online softmax; causal kv tiles past the diagonal are skipped whole;
// - dq: one CTA per q tile looping over the live kv tiles;
// - dk/dv: one CTA per kv tile looping over the live q tiles; no atomics,
//   every output element is written once by one CTA;
// - delta: one warp per row.
// What it leaves for the PR that makes it fast: mma/wgmma on bf16 operands
// (the SIMT FMA peak is 67 TFLOP/s against 989 on the tensor cores), TMA or
// cp.async staging overlapped with the math, and split scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// 8 consecutive elements (16-byte aligned for bf16, two float4 for f32)
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 consecutive elements
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// tile rows t0..t0+63 of one (b, h) into shared memory transposed, dst[d][r]
// (rows fastest across lanes, so the scattered stores are conflict-free)
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src,
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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
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

template <typename T, int D>
__device__ __forceinline__ void write_rows(T* dst, const Layout& L, int b,
                                           int h, int t0,
                                           const float (&acc)[4][D / 64][4],
                                           const float* rscale, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dst + L.off(b, h, t0 + ty * 4 + i);
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
                  Layout lo, int H, int Tq, int Tk, float scale,
                  int causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][64]
  float* kt = qt + D * kTile;                   // [D][64]
  float* vs = kt + D * kTile;                   // [64][D]
  float* pt = vs + kTile * D;                   // [64 kv][64 q]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_t<T, D>(qt, q, lq, b, h, q0);
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
    load_tile_t<T, D>(kt, k, lk, b, h, k0);
    load_tile<T, D>(vs, v, lv, b, h, k0);
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
  write_rows<T, D>(o, lo, b, h, q0, acc, inv, tx, ty);
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     Layout lq, Layout lk, Layout lv, Layout ldo, int H,
                     int Tq, int Tk, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][64]
  float* dot = qt + D * kTile;                  // [D][64]
  float* kt = dot + D * kTile;                  // [D][64]
  float* vt = kt + D * kTile;                   // [D][64]
  float* ks = vt + D * kTile;                   // [64][D]
  float* dst = ks + kTile * D;                  // [64 kv][64 q]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_t<T, D>(qt, q, lq, b, h, q0);
  load_tile_t<T, D>(dot, dout, ldo, b, h, q0);
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
    load_tile_t<T, D>(kt, k, lk, b, h, k0);
    load_tile_t<T, D>(vt, v, lv, b, h, k0);
    load_tile<T, D>(ks, k, lk, b, h, k0);
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
  write_rows<T, D>(dq, lq, b, h, q0, acc, one, tx, ty);
}

// ------------------------------------------------------------------ dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                      Layout ldo, int H, int Tq, int Tk, float scale,
                      int causal) {
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

  load_tile_t<T, D>(kt, k, lk, b, h, k0);
  load_tile_t<T, D>(vt, v, lv, b, h, k0);
  float dk_acc[4][D / 64][4] = {}, dv_acc[4][D / 64][4] = {};
  const int nq = Tq / kTile;
  // causal: q tile qi is live iff its last row reaches this tile's first col
  const int qstart = causal ? k0 / kTile : 0;
  for (int qi = qstart; qi < nq; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_tile_t<T, D>(qt, q, lq, b, h, q0);
    load_tile_t<T, D>(dot, dout, ldo, b, h, q0);
    load_tile<T, D>(qs, q, lq, b, h, q0);
    load_tile<T, D>(dos, dout, ldo, b, h, q0);
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
  write_rows<T, D>(dk, lk, b, h, k0, dk_acc, one, tx, ty);
  write_rows<T, D>(dv, lv, b, h, k0, dv_acc, one, tx, ty);
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
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const long long* lay, int B, int H, int Tq,
               int Tk, float scale, int causal, cudaStream_t stream) {
  auto kern = fa_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem(D));
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tq / kTile, H, B);
  kern<<<grid, kThreads, fwd_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, unpack(lay),
      unpack(lay + 5), unpack(lay + 10), unpack(lay + 15), H, Tq, Tk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const long long* lay, int B, int H,
               int Tq, int Tk, float scale, int causal,
               cudaStream_t stream) {
  const Layout lq = unpack(lay), lk = unpack(lay + 5), lv = unpack(lay + 10),
               lo = unpack(lay + 15), ldo = unpack(lay + 20);
  const long long rows = (long long)B * H * Tq;
  const int per = kThreads / 32;
  fa_delta_kernel<T, D><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                          stream>>>(static_cast<const T*>(o),
                                    static_cast<const T*>(dout), delta, lo,
                                    ldo, H, Tq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dq_kern = fa_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dq_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem(D));
  if (err != cudaSuccess) return (int)err;
  dq_kern<<<dim3(Tq / kTile, H, B), kThreads, dq_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), lq, lk, lv, ldo, H, Tq, Tk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkv_kern = fa_bwd_dkv_kernel<T, D>;
  err = cudaFuncSetAttribute(dkv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem(D));
  if (err != cudaSuccess) return (int)err;
  dkv_kern<<<dim3(Tk / kTile, H, B), kThreads, dkv_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, lv, ldo, H, Tq, Tk,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. head_dim: 64 or 128. layouts: 5 int64 per
// tensor (sb, sh, shalf, st, hsplit) for q, k, v, o. Tq, Tk multiples of 64.
// Returns a cudaError_t (0 on success); -1 for an unsupported instance.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, const long long* layouts,
                                   int B, int H, int Tq, int Tk, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_fwd<float, 64>(q, k, v, o, lse, layouts, B, H, Tq, Tk,
                                 scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_fwd<float, 128>(q, k, v, o, lse, layouts, B, H, Tq, Tk,
                                  scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, layouts, B, H, Tq,
                                         Tk, scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, layouts, B, H,
                                          Tq, Tk, scale, causal, s);
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
  if (dtype == 0 && head_dim == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 layouts, B, H, Tq, Tk, scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  layouts, B, H, Tq, Tk, scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, layouts, B, H, Tq, Tk,
                                         scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, layouts, B, H, Tq, Tk,
                                          scale, causal, s);
  return -1;
}

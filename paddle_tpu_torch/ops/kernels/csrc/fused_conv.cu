// Fused BN-apply + ReLU (+ residual) feeding a 1x1 convolution as a matmul:
//   out[M, N] = bf16( bf16( relu(x * scale + shift (+ z)) ) @ w )
// x, z [M, K] bf16 (rows = N*H*W positions, columns = channels); w [K, N]
// bf16; scale, shift [K] f32; out [M, N] bf16. The transform is f32 (each
// step rounded as a separate f32 operation, no FMA contraction), rounded once
// to bf16, then multiplied with f32 accumulation and rounded to bf16.
//
// Replaces the TPU kernel tools/fused_conv_proto.py:75
// (`fused_scale_relu_matmul`, `pallas_call:97`, bodies `_fused_kernel:45`
// and `_fused_nores:109`). Its plain version is
// `fused_scale_relu_matmul_reference` beside this kernel's wrapper
// (paddle_tpu_torch/ops/kernels/fused_conv.py).
//
// What bounds it on the H100: bytes, at all five of ResNet-50's block
// boundaries (batch 128), once the product runs on wgmma. Each call is 13.15
// GFLOP, 0.013 ms at the 989 TFLOP/s bf16 tensor peak, against 60-462 MB of
// x, z, w and out, 0.018-0.138 ms at 3.35 TB/s. The fusion's point is that
// the relu output never reaches memory.
//
// Design (sm_90a): a persistent, warp-specialised kernel of three
// warpgroups, at most one CTA per SM, each CTA walking 128 x BN output tiles
// t = blockIdx.x, blockIdx.x + gridDim.x, ... with the N tiles of one row
// block adjacent, so the CTAs that read the same x rows run together.
// - Warpgroup 0 is the producer (setmaxnreg 24): one thread issues TMA loads
//   into a ring of `stages` stages with full/empty mbarriers. A stage is one
//   64-column K step: x [128][64] and z [128][64] (128-byte rows under the
//   128-byte swizzle) and w [64][BN] as BN/64 boxes of 64 columns. The ring
//   runs on from one tile into the next, so the next tile's loads overlap
//   this tile's last products and its epilogue.
// - Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 rows each. For
//   each 16-column slab a consumer reads its raw x (and z) with ldmatrix,
//   which gives exactly wgmma's A-operand fragment from the swizzled tile,
//   applies relu(x*s + b (+ z)) in f32 with scale and shift from shared
//   memory (all of K, loaded once per CTA), packs to bf16 and issues
//   wgmma m64nBNk16 with A from registers and w as the MN-major B operand
//   (the transpose bit). The transformed activation never touches shared or
//   global memory. The accumulators (f32) are rounded to bf16 into a
//   swizzled staging buffer per consumer and leave by TMA store, which clips
//   rows past M and columns past N; the store drains while the next tile
//   computes.
// - Columns past K: TMA zero-fills x, z and w there, but relu(0*s + b) is
//   not 0, and scale/shift read past K could hold anything (NaN * 0 is NaN).
//   Shared scale and shift are 0 past K and scale/shift are never read past
//   K, so the transform is exactly 0 there. Rows past M are computed and
//   dropped by the store.
// - BN (64, 128 or 256) and the grid come from the wrapper's `k4_tile`, a
//   function of the shapes and the SM count (it narrows BN where there
//   would be fewer tiles than SMs or fewer than 3 stages); the ring takes
//   as many stages (at most kMaxStages) as fit beside the staging buffers
//   and scale/shift in 227 KB, and a shape with fewer than 2 is refused.
//   No atomics: every output element is written once by one CTA, so
//   results are bitwise-repeatable.
// What it leaves for later: on the H100 (kernel time under the profiler)
// layer1, layer2 and bn2 run at 80-86 % of their byte bounds, layer3 at
// 67 % and layer4 at 35 %. There every N tile re-reads
// its x and z rows and every row block re-reads w, from L2; the
// transform's scheduling is not what holds them (prefetching the next
// stage's fragments under the products, and the two consumers taking
// turns, measured no faster). Next: a cluster that multicasts x and z to
// the CTAs of one row block (and w to those of one N tile), a split of K
// for layer4's 196 tiles on 132 SMs, and fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                 // output rows a tile
constexpr int kBK = 64;                  // K columns a stage: 128-byte rows
constexpr int kThreads = 3 * kWG;        // producer + two consumer warpgroups
constexpr int kConsumers = 2 * kWG;
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;       // a block's shared memory on sm_90
constexpr int kAtom = kBK * 128;         // a w box: 64 K rows x 64 columns
constexpr int kSlack = 1024;             // aligning the base to the swizzle
constexpr int kErrBlockN = -1;           // BN not 64, 128 or 256
constexpr int kErrRing = -4;             // fewer than 2 stages fit

// a ring stage: x (and z) [128][64], w [64][BN]
__host__ __device__ constexpr int x_bytes(bool res) {
  return kBM * kBK * 2 * (res ? 2 : 1);
}
__host__ __device__ constexpr int stage_bytes(int bn, bool res) {
  return x_bytes(res) + kBK * bn * 2;
}
__host__ __device__ constexpr int k_pad(int K) {
  return (K + kBK - 1) / kBK * kBK;
}
// everything but the ring: alignment slack, the two consumers' staging of a
// 128 x BN bf16 tile, scale and shift over the padded K, the barriers
int fixed_bytes(int K, int bn) {
  return kSlack + kBM * bn * 2 + 8 * k_pad(K) + 16 * kMaxStages;
}
// stages of the ring that fit (the wrapper's k4_ring mirrors this)
int ring_stages(int K, int bn, bool res) {
  const int n = (kSmemLimit - fixed_bytes(K, bn)) / stage_bytes(bn, res);
  return n < kMaxStages ? n : kMaxStages;
}

// relu(lo), relu(hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4],
                                    uint64_t b) {
  if constexpr (BN == 64)
    wgmma_rs_n64(d, a[0], a[1], a[2], a[3], b);
  else if constexpr (BN == 128)
    wgmma_rs_n128(d, a[0], a[1], a[2], a[3], b);
  else
    wgmma_rs_n256(d, a[0], a[1], a[2], a[3], b);
}

template <int BN, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    fused_scale_relu_matmul_kernel(const __grid_constant__ CUtensorMap tx,
                                   const __grid_constant__ CUtensorMap tz,
                                   const __grid_constant__ CUtensorMap tw,
                                   const __grid_constant__ CUtensorMap tout,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift, int M,
                                   int K, int N, int stages) {
  constexpr int kStage = stage_bytes(BN, kRes);
  constexpr int kW = x_bytes(kRes);      // w's offset in a stage
  constexpr int kAtoms = BN / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int kpad = k_pad(K);
  const int k_steps = kpad / kBK;
  uint8_t* staging = sm + stages * kStage;
  float* ss = reinterpret_cast<float*>(staging + kBM * BN * 2);
  float* sb = ss + kpad;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kpad);
  uint64_t* empty = full + kMaxStages;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M - 1) / kBM + 1) * n_tiles;  // < 2^31: the host checks

  for (int i = threadIdx.x; i < kpad; i += kThreads) {
    ss[i] = i < K ? scale[i] : 0.f;
    sb[i] = i < K ? shift[i] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    producer_regs();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * kBM, n0 = t % n_tiles * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          uint8_t* st = sm + s * kStage;
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(st, &tx, &full[s], ks * kBK, m0);
          if (kRes) tma_load_2d(st + kBM * kBK * 2, &tz, &full[s], ks * kBK, m0);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load_2d(st + kW + a * kAtom, &tw, &full[s], n0 + 64 * a,
                        ks * kBK);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  consumer_regs();
  const int c = wg - 1;                  // rows 64c .. 64c+63 of a tile
  const int tid = threadIdx.x - wg * kWG;
  const int lane = tid % 32;
  const Frag f(tid);
  // ldmatrix: this lane gives the address of row (lane & 15) of a 16-row
  // slab, 16-byte chunk (lane >> 4) of the 16 columns; under the swizzle the
  // chunk's place in its 128-byte row is XORed with the row's index mod 8
  const int a_row = (64 * c + 16 * (tid / 32) + (lane & 15)) * 128;
  const int a_hi = lane >> 4, a_sw = lane & 7;
  // the staging buffer of this consumer: kAtoms boxes of [64 rows][128 B]
  uint8_t* stg = staging + c * (64 * BN * 2);
  const int st_row = f.rl * 128, st_sw = (lane / 4) & 7;
  float acc[BN / 2];
  int s = 0;
  uint32_t phase = 0;
  bool stored = false;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * kBM, n0 = t % n_tiles * BN;
    zero(acc);
    for (int ks = 0; ks < k_steps; ++ks) {
      const uint8_t* st = sm + s * kStage;
      mbar_wait(&full[s], phase);
      // one A fragment a slab: each slab's transform overlaps the previous
      // slab's product; A registers are written only while no product that
      // reads them is in flight (else ptxas serialises the products)
      uint32_t a[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int off = a_row + (((2 * kk + a_hi) ^ a_sw) << 4);
        uint32_t xr[4], zr[4];
        ldmatrix_x4(xr, st + off);
        if (kRes) ldmatrix_x4(zr, st + kBM * kBK * 2 + off);
        const int k0 = ks * kBK + 16 * kk + f.cl;
        const float2 sv[2] = {*reinterpret_cast<const float2*>(ss + k0),
                              *reinterpret_cast<const float2*>(ss + k0 + 8)};
        const float2 bv[2] = {*reinterpret_cast<const float2*>(sb + k0),
                              *reinterpret_cast<const float2*>(sb + k0 + 8)};
        // register j: rows +8*(j&1), columns +8*(j>>1) of the slab
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 s2 = sv[j >> 1], b2 = bv[j >> 1];
          float lo = __fadd_rn(__fmul_rn(lo_f32(xr[j]), s2.x), b2.x);
          float hi = __fadd_rn(__fmul_rn(hi_f32(xr[j]), s2.y), b2.y);
          if (kRes) {
            lo = __fadd_rn(lo, lo_f32(zr[j]));
            hi = __fadd_rn(hi, hi_f32(zr[j]));
          }
          a[kk][j] = pack_bf16_relu(lo, hi);
        }
        pin(a[kk]);
        pin(acc);
        wg_fence();
        mma<BN>(acc, a[kk], sw128_desc_mn(st + kW + kk * 16 * 128, kAtom));
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) pin(a[kk]);
      pin(acc);
      mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    // epilogue: bf16 into the swizzled staging boxes once the previous
    // tile's store has read them, then one TMA store per box
    if (stored && tid == 0) bulk_wait_read();
    named_sync(1 + c, kWG);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int col = 8 * (i / 4);       // + f.cl; entries i, i+1 adjacent
      uint8_t* p = stg + (col / 64) * kAtom + st_row + 8 * 128 * ((i >> 1) & 1) +
                   ((((col % 64) / 8) ^ st_sw) << 4) + 2 * f.cl;
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[i], acc[i + 1]);
    }
    fence_async_smem();
    named_sync(1 + c, kWG);
    if (tid == 0 && m0 + 64 * c < M) {
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        if (n0 + 64 * a < N)
          tma_store_2d(&tout, stg + a * kAtom, n0 + 64 * a, m0 + 64 * c);
      bulk_commit();
      stored = true;
    }
  }
  if (tid == 0) bulk_wait();
}

// a 2-D bf16 tensor [outer][inner] (inner contiguous) in boxes of
// box_inner x box_outer under the 128-byte swizzle; zero fill past its edges
int tensor_map(CUtensorMap* map, const void* base, int inner, int outer,
               int box_inner, int box_outer) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int BN, bool kRes>
int launch(const CUtensorMap* maps, const float* scale, const float* shift,
           int M, int K, int N, int grid, cudaStream_t stream) {
  auto kern = fused_scale_relu_matmul_kernel<BN, kRes>;
  static bool configured = false;        // the attribute is set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int stages = ring_stages(K, BN, kRes);
  const int bytes = fixed_bytes(K, BN) + stages * stage_bytes(BN, kRes);
  void* args[] = {(void*)&maps[0], (void*)&maps[1], (void*)&maps[2],
                  (void*)&maps[3], &scale, &shift, &M, &K, &N, &stages};
  const cudaError_t err = cudaLaunchKernel(
      (const void*)kern, dim3(grid), dim3(kThreads), args, bytes, stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// z may be null (no residual). M >= 1; K and N multiples of 16; every pointer
// 16-byte aligned (the wrapper checks). block_n (64, 128 or 256) and grid (at
// least 1; CTAs past the tile count do nothing) come from the wrapper's tile
// rule. Returns a cudaError_t code (0 on success), or -1 for another
// block_n, -2 / -3 when a tensor map cannot be made (no
// cuTensorMapEncodeTiled / an operand it refuses), -4 when fewer than 2
// stages of the ring fit in shared memory beside the rest.
extern "C" int fused_scale_relu_matmul(const void* x, const void* z,
                                       const void* w, const void* scale,
                                       const void* shift, void* out, int M,
                                       int K, int N, int block_n, int grid,
                                       void* stream) {
  if (block_n != 64 && block_n != 128 && block_n != 256) return kErrBlockN;
  const bool res = z != nullptr;
  if (ring_stages(K, block_n, res) < 2) return kErrRing;
  const long long tiles =
      (long long)((M - 1) / kBM + 1) * ((N - 1) / block_n + 1);
  if (grid < 1 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap maps[4];                   // x, z, w, out
  int e;
  if ((e = tensor_map(&maps[0], x, K, M, kBK, kBM)) ||
      (e = tensor_map(&maps[1], res ? z : x, K, M, kBK, kBM)) ||
      (e = tensor_map(&maps[2], w, N, K, 64, kBK)) ||
      (e = tensor_map(&maps[3], out, N, M, 64, 64)))
    return e;
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n * 2 + (res ? 1 : 0)) {
    case 128: return launch<64, false>(maps, sc, sh, M, K, N, grid, s);
    case 129: return launch<64, true>(maps, sc, sh, M, K, N, grid, s);
    case 256: return launch<128, false>(maps, sc, sh, M, K, N, grid, s);
    case 257: return launch<128, true>(maps, sc, sh, M, K, N, grid, s);
    case 512: return launch<256, false>(maps, sc, sh, M, K, N, grid, s);
    default: return launch<256, true>(maps, sc, sh, M, K, N, grid, s);
  }
}

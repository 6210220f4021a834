// Ragged paged attention for decode: one query token per row attends over
// exactly lengths[row] KV positions read through the row's block table.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_paged_attention.py
// `ragged_decode_attention` (:127, `pl.pallas_call` at :165, body `_kernel`
// :60). Its math is defined by `ragged_attention_reference` (same file,
// :177) and by the plain PyTorch versions beside this kernel's wrapper
// (paddle_tpu_torch/ops/kernels/ragged_paged_attention.py):
//   out[i,h,:] = softmax_s(scale * q[i,h] . k[s,h]) . v[s,h],  s < lengths[i]
// with position s read from pool block tables[i, s / bs], slot s % bs; masked
// scores are -1e30; a table entry outside [0, num_blocks) skips its whole
// block; a row whose every block is skipped, or whose length is 0, returns
// exact zeros. Accumulation is f32 for both the f32 and the bf16 instance.
//
// What bounds it on the H100: bytes. Each call must read the live KV once,
// sum_i lengths[i] * H * D * 2 pool elements (K and V), and does 4 flops per
// element pair (~0.5 flop per byte in f32), far below the ridge point, and a
// single query row gives tensor cores nothing to do. At the serving slice's
// shapes (8 rows, 6 heads, head_dim 128, f32 pools, 32-position blocks) the
// live KV is 15 MB at the smoke shape and 50 MB at full context: 4.5 us and
// 15 us at 3.35 TB/s. The work is to keep enough loads in flight on every SM.
//
// Design (flash-decoding in one launch):
// - Grid (row, head, split). Split z covers table blocks [z*bps, (z+1)*bps);
//   the wrapper picks bps from (N, H, max_blocks) alone (no read of lengths
//   on the host) so that full-length rows give ~4 CTAs per SM. A CTA whose
//   split starts at or past its row's live blocks exits at once; split 0
//   always runs, so a dead row still writes its zeros.
// - Each CTA (256 threads) first reads its row's length, q and its split's
//   table entries together, then streams its blocks through a 2-stage ring
//   of cp.async (16 bytes a thread, .cg: L2 only) in shared memory: a stage
//   is one tile of up to 16 KB of K and 16 KB of V for this head (a whole
//   32-position block at D 128 in f32), holding only positions < length.
//   The next tile's loads are in flight while this tile's math runs; with
//   ~65 KB of shared memory a CTA, 3 CTAs share an SM, so up to ~96 KB is
//   in flight per SM. One __syncthreads per tile: the tile has landed,
//   which also frees the other stage.
// - The math keeps no thread on a long serial chain: each of the 8 warps
//   runs its own online softmax over positions w, w + 8, ... of the tile,
//   scoring 4 of them at once (lanes over D, q read once per CTA into
//   shared memory and from there into registers, 4 independent
//   shuffle reductions), then one update (one exp per position) of its
//   (m, l, acc[D]) with V read from shared memory. At the end of the split
//   the warps' states are combined in warp order through shared memory.
// - Merge in the same launch. A row with one split writes its output
//   directly. Otherwise each CTA writes its partial (m, l, acc[D]) to a
//   scratch buffer, __threadfence(), and bumps the (row, head) arrival
//   counter with atomicAdd; the CTA that arrives last (the count of live
//   splits comes from lengths on the device) reads the partials through L2
//   (__ldcg) in split order, so the result is deterministic, merges them
//   (a partial with l = 0, every block skipped, gets weight 0) and resets
//   the counter to 0 for the next launch. The wrapper owns the scratch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;  // one d per thread in the combines
constexpr int kMaxBlockSize = 128;
// positions one warp scores before one online-softmax update
constexpr int kGroup = 4;
// the ring: stages of K and V tiles of up to kHalfStageBytes each (deeper
// rings of smaller tiles were no faster at the serving shapes, PERF.md)
constexpr int kStages = 2;
constexpr int kHalfStageBytes = 16384;
constexpr int kMaxSplitBlocks = 128;  // table entries read up front
constexpr int kMaxSplits = 128;       // partials merged per (row, head)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  float* partials;    // [n, h, num_splits, 2 + d]: m, l, acc
  int32_t* counters;  // [n, h], zero between launches
  int num_heads, head_dim, num_blocks, block_size, max_blocks;
  int blocks_per_split, num_splits, tile_pos;
  float scale;
};

// One tile: positions [slot0, slot0 + npos) of pool block `blk`.
struct Tile {
  int blk, slot0, npos;
};

// The first live tile at or after t of this CTA's tile sequence (t ==
// ntiles when none is left). Tile t is sub-tile t % tpb of block
// j0 + t / tpb, whose table entry is blk_s[t / tpb]; it is live when that
// entry is in range and the tile holds positions below the row's length.
__device__ __forceinline__ int next_live(const Params& p, const int* blk_s,
                                         int len, int j0, int tpb,
                                         int ntiles, int t, Tile* tile) {
  for (; t < ntiles; ++t) {
    const int j = j0 + t / tpb;
    const int slot0 = (t % tpb) * p.tile_pos;
    const int blk = blk_s[t / tpb];
    int npos = p.block_size - slot0;
    npos = npos < p.tile_pos ? npos : p.tile_pos;
    const int left = len - (j * p.block_size + slot0);
    npos = npos < left ? npos : left;
    if (blk >= 0 && blk < p.num_blocks && npos > 0) {
      *tile = Tile{blk, slot0, npos};
      return t;
    }
  }
  return t;
}

// Issue the cp.async copies of one tile's K and V for head h into a stage
// ([tile_pos, D] each, dense rows).
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, int h,
                                          const Tile& tile, T* k_dst,
                                          T* v_dst) {
  const int D = p.head_dim;
  const int row_chunks = D * (int)sizeof(T) / 16;
  const size_t pos_stride = (size_t)p.num_heads * D;
  const size_t first = ((size_t)tile.blk * p.block_size + tile.slot0) *
                           pos_stride + (size_t)h * D;
  const T* kb = static_cast<const T*>(p.k_pool) + first;
  const T* vb = static_cast<const T*>(p.v_pool) + first;
  for (int c = threadIdx.x; c < tile.npos * row_chunks; c += kThreads) {
    const int s = c / row_chunks;
    const int o = (c - s * row_chunks) * 16;
    cp_async16(reinterpret_cast<char*>(k_dst + s * D) + o,
               reinterpret_cast<const char*>(kb + s * pos_stride) + o);
    cp_async16(reinterpret_cast<char*>(v_dst + s * D) + o,
               reinterpret_cast<const char*>(vb + s * pos_stride) + o);
  }
}

// The kernel. Each lane of a warp owns d = lane + 32 k, k < kPerLane.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads) ragged_split_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  __shared__ int blk_s[kMaxSplitBlocks];  // this split's table entries
  __shared__ float wm_s[kWarps], wl_s[kWarps];
  __shared__ float m_s[kMaxSplits], l_s[kMaxSplits];
  __shared__ float q_s[kMaxHeadDim];
  const int D = p.head_dim;
  const int stage_elems = p.tile_pos * D;
  T* kv = reinterpret_cast<T*>(smem);  // ring [kStages][K, V][tile_pos][D]
  // the warps' accumulators [kWarps][D], once the ring has drained
  float* wacc_s = reinterpret_cast<float*>(smem);

  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = p.num_heads;
  const size_t qo = ((size_t)row * H + h) * D;

  // the row's length, q and this split's table entries are read together,
  // before any of them is used, so their latencies overlap (an entry past
  // the length is read but never used)
  const int j0 = split * p.blocks_per_split;
  const int len = p.lengths[row];
  // q once per CTA: thread d reads q[d] (D <= kThreads)
  const float q_d = tid < D ? to_f32(static_cast<const T*>(p.q)[qo + tid])
                            : 0.f;
  const int jt = j0 + tid;
  const int my_blk = (tid < p.blocks_per_split && jt < p.max_blocks)
                         ? p.tables[(size_t)row * p.max_blocks + jt]
                         : -1;

  int nblk = len > 0 ? (len + p.block_size - 1) / p.block_size : 0;
  nblk = nblk < p.max_blocks ? nblk : p.max_blocks;
  int nsplit = (nblk + p.blocks_per_split - 1) / p.blocks_per_split;
  nsplit = nsplit > 1 ? nsplit : 1;
  if (split >= nsplit) return;  // past the row's live blocks

  int j1 = j0 + p.blocks_per_split;
  j1 = j1 < nblk ? j1 : nblk;
  const int tpb = (p.block_size + p.tile_pos - 1) / p.tile_pos;
  const int ntiles = j1 > j0 ? (j1 - j0) * tpb : 0;
  if (tid < p.blocks_per_split) blk_s[tid] = my_blk;
  if (tid < D) q_s[tid] = q_d;
  __syncthreads();
  float qv[kPerLane];  // each lane's q[d], d = lane + 32 k
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int d = lane + 32 * k;
    qv[k] = d < D ? q_s[d] : 0.f;
  }

  // this warp's online-softmax state over the positions it scores
  float m = kNegInf;
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;

  // ring: the k-th live tile goes to stage k % kStages
  Tile issue_tile, use_tile;
  int issue = next_live(p, blk_s, len, j0, tpb, ntiles, 0, &issue_tile);
  int use = issue;
  use_tile = issue_tile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (issue < ntiles) {
      T* kd = kv + (size_t)st * 2 * stage_elems;
      load_tile(p, h, issue_tile, kd, kd + stage_elems);
      issue = next_live(p, blk_s, len, j0, tpb, ntiles, issue + 1,
                        &issue_tile);
    }
    cp_async_commit();
  }
  for (int k = 0; use < ntiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k landed; stage (k - 1) % kStages is free
    if (issue < ntiles) {
      T* kd = kv + (size_t)((k + kStages - 1) % kStages) * 2 * stage_elems;
      load_tile(p, h, issue_tile, kd, kd + stage_elems);
      issue = next_live(p, blk_s, len, j0, tpb, ntiles, issue + 1,
                        &issue_tile);
    }
    cp_async_commit();

    const T* ks = kv + (size_t)(k % kStages) * 2 * stage_elems;
    const T* vs = ks + stage_elems;
    const int npos = use_tile.npos;
    // warp w takes positions w, w + kWarps, ...: kGroup of them scored
    // together (independent shuffle chains), then one update
    for (int g = warp; g < npos; g += kWarps * kGroup) {
      float sc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int s = g + kWarps * u;
        float dot = 0.f;
        if (s < npos) {
#pragma unroll
          for (int k2 = 0; k2 < kPerLane; ++k2) {
            const int d = lane + 32 * k2;
            if (d < D) dot += qv[k2] * to_f32(ks[s * D + d]);
          }
        }
        sc[u] = dot;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
      }
      float m_grp = kNegInf;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        sc[u] *= p.scale;
        if (g + kWarps * u < npos) m_grp = fmaxf(m_grp, sc[u]);
      }
      const float m_new = fmaxf(m, m_grp);
      const float alpha = expf(m - m_new);
      float e[kGroup];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        e[u] = g + kWarps * u < npos ? expf(sc[u] - m_new) : 0.f;
        psum += e[u];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int k2 = 0; k2 < kPerLane; ++k2) acc[k2] *= alpha;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int s = g + kWarps * u;
        if (s < npos) {
#pragma unroll
          for (int k2 = 0; k2 < kPerLane; ++k2) {
            const int d = lane + 32 * k2;
            if (d < D) acc[k2] += e[u] * to_f32(vs[s * D + d]);
          }
        }
      }
      m = m_new;
    }
    use = next_live(p, blk_s, len, j0, tpb, ntiles, use + 1, &use_tile);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring has drained: it holds the warps' partials

  // combine the warps in warp order (a warp that scored nothing has l 0)
  if (lane == 0) {
    wm_s[warp] = m;
    wl_s[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int d = lane + 32 * k;
    if (d < D) wacc_s[warp * D + d] = acc[k];
  }
  __syncthreads();
  const int d = tid;  // D <= kThreads: one d per thread from here on
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (wl_s[w] > 0.f) mx = fmaxf(mx, wm_s[w]);
  float lsum = 0.f;
  float o = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float wt = wl_s[w] > 0.f ? expf(wm_s[w] - mx) : 0.f;
    lsum += wt * wl_s[w];
    if (d < D) o += wt * wacc_s[w * D + d];
  }

  T* out = static_cast<T*>(p.out) + qo;
  if (nsplit == 1) {
    // a dead row, or one whose blocks were all skipped -> exact zeros
    if (d < D) store(out + d, o / (lsum == 0.f ? 1.f : lsum));
    return;
  }

  const size_t pitch = 2 + (size_t)D;
  float* mine = p.partials +
                (((size_t)row * H + h) * p.num_splits + split) * pitch;
  if (tid == 0) {
    mine[0] = mx;
    mine[1] = lsum;
  }
  if (d < D) mine[2 + d] = o;
  __threadfence();  // the partial is visible device-wide before arrival
  __syncthreads();
  int32_t* counter = p.counters + (size_t)row * H + h;
  if (tid == 0) is_last = (atomicAdd(counter, 1) == nsplit - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge the live splits' partials in split order: their m and l in one
  // round of loads, then each thread's acc[d] loads, independent of each
  // other, so they are in flight together
  const float* base =
      p.partials + ((size_t)row * H + h) * p.num_splits * pitch;
  if (tid < nsplit) {
    m_s[tid] = __ldcg(base + tid * pitch);
    l_s[tid] = __ldcg(base + tid * pitch + 1);
  }
  __syncthreads();
  mx = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    if (l_s[s] > 0.f) mx = fmaxf(mx, m_s[s]);
  lsum = 0.f;
  o = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    // weight 0 for a split whose every block was skipped (its acc is 0)
    const float wt = l_s[s] > 0.f ? expf(m_s[s] - mx) : 0.f;
    lsum += wt * l_s[s];
    if (d < D) o += wt * __ldcg(base + s * pitch + 2 + d);
  }
  if (d < D) store(out + d, o / (lsum == 0.f ? 1.f : lsum));
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int kPerLane>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const size_t ring =
      (size_t)kStages * 2 * p.tile_pos * p.head_dim * sizeof(T);
  const size_t warps = (size_t)kWarps * p.head_dim * sizeof(float);
  const size_t smem = ring > warps ? ring : warps;
  // the largest ring any shape needs, allowed once per device
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    const int most = kStages * 2 * kHalfStageBytes >
                             kWarps * kMaxHeadDim * (int)sizeof(float)
                         ? kStages * 2 * kHalfStageBytes
                         : kWarps * kMaxHeadDim * (int)sizeof(float);
    err = cudaFuncSetAttribute(ragged_split_kernel<T, kPerLane>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return err;
    // all of the SM's unified memory as shared memory, so as many CTAs
    // fit as their rings allow
    err = cudaFuncSetAttribute(ragged_split_kernel<T, kPerLane>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const dim3 grid((unsigned)n, (unsigned)p.num_heads,
                  (unsigned)p.num_splits);
  ragged_split_kernel<T, kPerLane><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the instance whose lanes cover d: 32, 64, 128 or 256 values a warp
template <typename T>
cudaError_t launch_for_dim(const Params& p, int n, cudaStream_t stream) {
  if (p.head_dim <= 32) return launch<T, 1>(p, n, stream);
  if (p.head_dim <= 64) return launch<T, 2>(p, n, stream);
  if (p.head_dim <= 128) return launch<T, 4>(p, n, stream);
  return launch<T, 8>(p, n, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Shapes:
// q/out [n, h, d], pools [num_blocks, block_size, h, d], tables
// [n, max_blocks] int32, lengths [n] int32, all contiguous on one device
// with 16-byte aligned rows (d * element size a multiple of 16).
// blocks_per_split: table blocks per CTA along the KV axis (1..128, and at
// most 128 splits: ceil(max_blocks / blocks_per_split) <= 128). When
// ceil(max_blocks / blocks_per_split) > 1, `partials` must hold
// n * h * ceil(max_blocks / blocks_per_split) * (d + 2) floats and
// `counters` n * h int32 zeros (left zero again by the launch); calls
// sharing them must be ordered on one stream. Launches on `stream` and
// returns the launch's error (cudaSuccess when it was accepted); does not
// synchronise.
extern "C" cudaError_t ragged_paged_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, void* partials,
    void* counters, int n, int h, int d, int num_blocks, int block_size,
    int max_blocks, int blocks_per_split, float scale, void* stream) {
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (elem == 0 || d < 1 || d > kMaxHeadDim || (d * elem) % 16 != 0 ||
      block_size < 1 || block_size > kMaxBlockSize || max_blocks < 1 ||
      blocks_per_split < 1 || blocks_per_split > kMaxSplitBlocks ||
      (max_blocks + blocks_per_split - 1) / blocks_per_split > kMaxSplits)
    return cudaErrorInvalidValue;
  if (n == 0 || h == 0) return cudaSuccess;
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.tables = static_cast<const int32_t*>(tables);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
  p.partials = static_cast<float*>(partials);
  p.counters = static_cast<int32_t*>(counters);
  p.num_heads = h;
  p.head_dim = d;
  p.num_blocks = num_blocks;
  p.block_size = block_size;
  p.max_blocks = max_blocks;
  p.blocks_per_split = blocks_per_split;
  p.num_splits = (max_blocks + blocks_per_split - 1) / blocks_per_split;
  const int fit = kHalfStageBytes / (d * elem);
  p.tile_pos = block_size < fit ? block_size : fit;
  p.scale = scale;
  if (p.num_splits > 1 && (partials == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_for_dim<float>(p, n, s)
                    : launch_for_dim<__nv_bfloat16>(p, n, s);
}

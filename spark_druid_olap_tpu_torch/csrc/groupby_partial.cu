// Group-by partial aggregation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel spark_druid_olap_tpu/ops/pallas_groupby.py:_kernel
// (launched by pallas_partial_aggregate): the fused one-hot group-by.  Same
// contract, same argument order, same output layout:
//
//   in : gid int32[R], mask bool[R], sum_values f32[R, Ms] (pre-masked),
//        minmax_values f32[R, Mn+Mx], minmax_masks bool[R, Mn+Mx]
//   out: sums f32[G, Ms], mins f32[G, Mn], maxs f32[G, Mx]
//        (empty groups: 0 / +inf / -inf), G <= 4096
//
// Bound on an H100 SXM: the function must read R * (4 + 1 + 4*Ms + 5*(Mn+Mx))
// bytes and write G * (Ms+Mn+Mx) * 4; its arithmetic is one add or compare
// per row and column, so it is bound by memory at 3.35 TB/s.  Per 512K-row
// segment: 2.0 us at Ms = 2 (every SSB query of the main path), 5.8 us at
// Ms = 8 (TPC-H Q1), 4.9 us at Ms = 4, Mn = Mx = 1.
//
// Tensor cores do not serve here: the sums must stay exact float32 (no TF32,
// no bf16), the product would have N = Ms <= 8 columns, and the function is
// bound by bytes, not by arithmetic.  The design uses shared memory, warp
// primitives and asynchronous copies instead:
//
// * One pass over HBM per segment, whatever G.  partial_pass has one block
//   per (row chunk, column block); the chunk's rows are staged through a ring
//   of two shared-memory tiles by cp.async (16-byte transfers), so one tile
//   loads while the previous one is reduced.  Columns split across grid y
//   only when a block's accumulators cannot hold them all.
// * No float atomics, and one writer per accumulator slot at any time.
//   Where the accumulators live depends on G * cols (the "regime", chosen in
//   ops/cuda_groupby.geometry; partial_pass is instantiated once for each):
//   - lane (G * cols <= 96, e.g. q1.x, TopN, TPC-H Q1): every thread owns a
//     copy and folds its own rows t, t+256, ... into it in row order; at the
//     end of the chunk, per slot, lane l folds threads l, l+32, ..., l+224
//     and a 5-level __shfl_xor_sync butterfly joins the 32 lanes.
//   - warp (8 * G * cols * 4 B <= 64 KB, e.g. Timeseries, q4.1): every warp
//     owns a copy and a fixed slice of each tile's rows, and the copies join
//     in warp order at the end of the chunk.
//   - block (up to G = 4096): one copy for the block; warp w owns the groups
//     g % 8 == w.  A stable counting sort buckets each tile's kept rows by
//     owner (ballots per 32-row step, a block scan), and each warp walks only
//     its own bucket.
//   In the warp and block regimes a warp folds 32 rows a step.  If every
//   kept row of the step is in one group (time-sorted segments), a 5-level
//   __shfl_xor_sync butterfly folds them and one lane adds the result.
//   Otherwise the step runs rounds: per slot of a small table, an integer
//   atomicMin elects the lowest pending lane, which adds its row; so a
//   group's rows are added in lane (= row) order.
// * fold_pass folds the chunk partials: for each output, 32 threads fold
//   chunks j, j+32, j+64, ... in order, and a fixed tree over j joins them.
// The geometry depends on the shapes alone, so the order of every add is
// fixed by the data and the shapes, and two launches give the same bits.
// Min/max use the NaN-propagating fold below, with the masks folded in as
// +-inf, so they equal the plain version exactly.
//
// Measured (chip_smoke.py: device time per launch under torch.profiler,
// inputs rotated through four times the L2; NVIDIA H100 80GB HBM3, 700.00 W),
// per 512K-row segment, with the same launch on L2-resident inputs
// (l2) and on inputs with every row masked (floor: staging, set-up, the
// chunk combine and fold_pass only):
//
//   G, Ms, Mn, Mx   gids         regime   us    l2 us  floor us  bound us  index_add_ us
//   1, 2, 0, 0      random       lane      9.3    9.0      7.8       2.0          740.3
//   12, 8, 0, 0     random       lane     22.8   22.2     16.9       5.8          244.1
//   26, 2, 0, 0     random       lane     13.1   12.8     11.6       2.0          272.1
//   84, 2, 0, 0     random       warp     18.7   18.5     10.1       2.0          265.5
//   208, 2, 0, 0    random       warp     19.0   18.4     10.9       2.0          206.4
//   208, 4, 1, 1    random       warp     34.8   32.9     18.9       4.9          185.3
//   4096, 4, 1, 1   random       block    56.9   52.4     24.0       4.9          188.6
//   84, 2, 0, 0     sorted runs  warp     19.2   19.0     10.0       2.0          740.0
//
// Not HBM but fixed costs hold it back: l2 is within 8% of the time, and the
// floor alone is 3-6x the bound (fold_pass is 2.4-9.6 us of it).  In the warp
// and block regimes the per-step warp work is most of the rest.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (ops/cuda_groupby.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;    // aggregate columns per block at most
constexpr int kRing = 2;       // staged tiles in flight per block
constexpr int kSmemMax = 232448;  // shared memory one block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTagBits = 7;  // election slots per warp: 1 << kTagBits
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// bytes of one staged tile of T rows: gid, mask, sum values, min/max values
// and masks, each region 16-byte aligned
__host__ __device__ __forceinline__ int tile_bytes(int T, int Ms, int Mnx) {
  return 4 * T + round16(T) + 4 * T * Ms + 4 * T * Mnx + round16(T * Mnx);
}

// where the accumulators live: one [cols, G] for the block (groups owned by
// warps), one per warp, or one per thread
enum Regime { kBlock = 0, kWarp = 1, kLane = 2 };

__host__ __device__ __forceinline__ int acc_copies(int regime) {
  return regime == kLane ? kThreads : (regime == kWarp ? kWarps : 1);
}

__host__ __device__ __forceinline__ int acc_bytes(int G, int cols, int regime) {
  return round16(acc_copies(regime) * G * cols * 4);
}

// block regime: per (owner warp, 32-row step) counts, then offsets (T/4
// ints), the tile's row indices bucketed by owner (T int16) and the scan's
// warp totals
__host__ __device__ __forceinline__ int bucket_bytes(int T, int regime) {
  return regime == kBlock ? round16(4 * (T / 4) + 2 * T + 4 * kWarps) : 0;
}

// the warp and block regimes: a table of election slots per warp
__host__ __device__ __forceinline__ int tag_bytes(int regime) {
  return regime == kLane ? 0 : kWarps * (1 << kTagBits) * 4;
}

__host__ __device__ __forceinline__ int smem_bytes(int G, int Ms, int Mnx, int T,
                                                   int cols, int regime) {
  return acc_bytes(G, cols, regime) + bucket_bytes(T, regime) + tag_bytes(regime) +
         kRing * tile_bytes(T, Ms, Mnx);
}

// kind of unified column j in [sums | mins | maxs]: 0 sum, 1 min, 2 max
__device__ __forceinline__ int col_kind(int j, int Ms, int Mn) {
  return j < Ms ? 0 : (j < Ms + Mn ? 1 : 2);
}

__device__ __forceinline__ float identity(int kind) {
  return kind == 0 ? 0.0f : (kind == 1 ? INFINITY : -INFINITY);
}

// NaN-propagating fold, like torch.minimum / torch.maximum
__device__ __forceinline__ float fold(float a, float v, int kind) {
  if (kind == 0) return a + v;
  if (kind == 1) return (v < a || isnan(v)) ? v : a;
  return (v > a || isnan(v)) ? v : a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// Copy nbytes from global to shared memory: 16-byte cp.async transfers for
// the aligned body, plain loads for a ragged tail (or a misaligned source).
__device__ __forceinline__ void stage_copy(unsigned char* dst,
                                           const unsigned char* src,
                                           int nbytes) {
  const int body =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? (nbytes & ~15) : 0;
  for (int i = threadIdx.x * 16; i < body; i += kThreads * 16) {
    cp_async16(dst + i, src + i);
  }
  for (int i = body + threadIdx.x; i < nbytes; i += kThreads) dst[i] = src[i];
}

struct Tile {
  int32_t* gid;
  uint8_t* mask;
  float* sumv;
  float* mmv;
  uint8_t* mmm;
};

__device__ __forceinline__ Tile tile_at(unsigned char* base, int T, int Ms,
                                        int Mnx) {
  Tile t;
  t.gid = reinterpret_cast<int32_t*>(base);
  base += 4 * T;
  t.mask = base;
  base += round16(T);
  t.sumv = reinterpret_cast<float*>(base);
  base += 4 * T * Ms;
  t.mmv = reinterpret_cast<float*>(base);
  base += 4 * T * Mnx;
  t.mmm = base;
  return t;
}

struct Params {
  const int32_t* gid;
  const uint8_t* mask;
  const float* sumv;
  const float* mmv;
  const uint8_t* mmm;
  float* scratch;  // [n_chunks, M, G] chunk partials
  int R, G, Ms, Mn, Mx, chunk_rows, tile_rows, cols, regime;
};

// staged value of column j of tile row r (a dropped row gives the identity)
__device__ __forceinline__ float tile_value(const Tile& t, int r, int j,
                                            int kind, int Ms, int Mnx,
                                            bool keep) {
  if (!keep) return identity(kind);
  if (kind == 0) return t.sumv[r * Ms + j];
  const int idx = r * Mnx + (j - Ms);
  return t.mmm[idx] ? t.mmv[idx] : identity(kind);
}

// Fold one 32-row warp step into `acc` ([nc, G]).  Lane l's row is tile row
// r0 + l, or idx[r0 + l] when the step walks a bucket of row indices.
// `key` is this lane's group, or -1 for a row the step drops.
__device__ __forceinline__ void fold_step(const Tile& t, const int16_t* idx,
                                          int r0, int key, float* acc,
                                          const Params& p, int c0, int nc,
                                          const int* kind, int* tags) {
  const int lane = threadIdx.x & 31;
  const int Mnx = p.Mn + p.Mx;
  __syncwarp();  // the previous step's accumulator writes are visible
  const unsigned kept = __ballot_sync(kFull, key >= 0);
  if (!kept) return;
  const int k0 = __shfl_sync(kFull, key, __ffs(kept) - 1);
  if (__all_sync(kFull, key < 0 || key == k0)) {
    // one group: a fixed butterfly over the 32 lanes (dropped rows add
    // the identity), then lane 0 adds the step to the accumulator
    const int r = key < 0 ? 0 : (idx ? idx[r0 + lane] : r0 + lane);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k >= nc) break;
      float v = tile_value(t, r, c0 + k, kind[k], p.Ms, Mnx, key >= 0);
#pragma unroll
      for (int o = 16; o; o >>= 1) v = fold(v, __shfl_xor_sync(kFull, v, o), kind[k]);
      if (lane == 0) acc[k * p.G + k0] = fold(acc[k * p.G + k0], v, kind[k]);
    }
    return;
  }
  // several groups: rounds in which, per tag slot, the lowest lane still
  // pending wins an integer atomicMin election and adds its own row; a
  // group's rows are added in lane (= row) order, one writer per group
  const int h = (int)(((unsigned)key * 2654435761u) >> (32 - kTagBits));
  for (unsigned rest = kept; rest;) {
    const bool mine = (rest >> lane) & 1;
    if (mine) tags[h] = 32;
    __syncwarp();
    if (mine) atomicMin(&tags[h], lane);
    __syncwarp();
    const bool go = mine && tags[h] == lane;
    if (go) {
      const int r = idx ? idx[r0 + lane] : r0 + lane;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        if (k < nc) {
          acc[k * p.G + key] = fold(acc[k * p.G + key],
                                    tile_value(t, r, c0 + k, kind[k], p.Ms, Mnx, true), kind[k]);
        }
      }
    }
    rest &= ~__ballot_sync(kFull, go);
  }
}

struct Buckets {
  int* off;       // [owner, step] counts, then exclusive offsets
  int16_t* rows;  // tile rows bucketed by owner warp, row order within
  int* wsum;      // the scan's per-warp totals
  int total;      // kept rows of the tile
};

// Counting sort of the tile's kept rows by owner warp (g % 8), stable in row
// order.  Warp w classifies the 32-row steps w*S .. w*S+S-1 (S = T/256);
// counts per (owner, step) scan to offsets in (owner, step) order.  Returns
// the start of this warp's bucket; call from every thread of the block.
__device__ __forceinline__ int bucket_rows(const Tile& t, int n, int T, int G,
                                           Buckets& b) {
  constexpr int kMaxSteps = 1024 / kThreads;  // steps per warp at T = 1024
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Q = T / 32;  // steps of the tile
  const int S = T / kThreads;
  int own[kMaxSteps], rank[kMaxSteps];
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) {
    own[i] = kWarps;
    if (i >= S) break;
    const int q = warp * S + i;
    const int r = q * 32 + lane;
    if (r < n) {
      const int g = t.gid[r];
      if (t.mask[r] && (unsigned)g < (unsigned)G) own[i] = g & (kWarps - 1);
    }
    unsigned mine = 0;
#pragma unroll
    for (int o = 0; o < kWarps; ++o) {
      const unsigned bal = __ballot_sync(kFull, own[i] == o);
      if (lane == o) b.off[o * Q + q] = __popc(bal);
      if (own[i] == o) mine = bal;
    }
    rank[i] = __popc(mine & ((1u << lane) - 1));
  }
  __syncthreads();
  // exclusive scan of the T/4 counts in (owner, step) order
  const int E = kWarps * Q;
  const int c = threadIdx.x < E ? b.off[threadIdx.x] : 0;
  int v = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) b.wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? b.wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += u;
    }
    if (lane < kWarps) b.wsum[lane] = w;
  }
  __syncthreads();
  if (threadIdx.x < E) b.off[threadIdx.x] = v - c + (warp ? b.wsum[warp - 1] : 0);
  b.total = b.wsum[kWarps - 1];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) {
    if (i >= S) break;
    if (own[i] < kWarps) {
      b.rows[b.off[own[i] * Q + warp * S + i] + rank[i]] = (int16_t)((warp * S + i) * 32 + lane);
    }
  }
  __syncthreads();
  return b.off[warp * Q];
}

// One instance per regime, so each gets its own registers.
template <int kRegime>
__global__ void __launch_bounds__(kThreads) partial_pass(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.Ms + p.Mn + p.Mx;
  const int Mnx = p.Mn + p.Mx;
  const int G = p.G;
  const int T = p.tile_rows;
  const int chunk = blockIdx.x;
  const int c0 = blockIdx.y * p.cols;
  const int nc = min(p.cols, M - c0);
  const long long row0 = (long long)chunk * p.chunk_rows;
  const int rows = (int)min((long long)p.chunk_rows, (long long)p.R - row0);
  const int n_tiles = (rows + T - 1) / T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float* acc_all = reinterpret_cast<float*>(smem);
  unsigned char* bucket_base = smem + acc_bytes(G, p.cols, kRegime);
  Buckets bucket;
  bucket.off = reinterpret_cast<int*>(bucket_base);
  bucket.rows = reinterpret_cast<int16_t*>(bucket_base + 4 * (T / 4));
  bucket.wsum = reinterpret_cast<int*>(bucket_base + 4 * (T / 4) + 2 * T);
  int* tags = reinterpret_cast<int*>(bucket_base + bucket_bytes(T, kRegime)) +
             warp * (1 << kTagBits);
  unsigned char* ring = bucket_base + bucket_bytes(T, kRegime) + tag_bytes(kRegime);
  const int tb = tile_bytes(T, p.Ms, Mnx);

  int kind[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) kind[k] = col_kind(c0 + min(k, nc - 1), p.Ms, p.Mn);

  // layout: [warp][col][G] (kWarp), [col][G] (kBlock), [col][G][thread] (kLane)
  if constexpr (kRegime == kLane) {
    for (int k = 0; k < nc; ++k) {
      const float id = identity(col_kind(c0 + k, p.Ms, p.Mn));
      for (int g = 0; g < G; ++g) acc_all[(k * G + g) * kThreads + threadIdx.x] = id;
    }
  } else {
    for (int w = 0; w < acc_copies(kRegime); ++w) {
      for (int k = 0; k < nc; ++k) {
        const float id = identity(col_kind(c0 + k, p.Ms, p.Mn));
        for (int g = threadIdx.x; g < G; g += kThreads) acc_all[(w * nc + k) * G + g] = id;
      }
    }
  }

  auto issue = [&](int s) {
    if (s < n_tiles) {
      const long long base = row0 + (long long)s * T;
      const int n = min(T, rows - s * T);
      unsigned char* b = ring + (s % kRing) * tb;
      const Tile t = tile_at(b, T, p.Ms, Mnx);
      stage_copy(reinterpret_cast<unsigned char*>(t.gid),
                 reinterpret_cast<const unsigned char*>(p.gid + base), 4 * n);
      stage_copy(t.mask, p.mask + base, n);
      stage_copy(reinterpret_cast<unsigned char*>(t.sumv),
                 reinterpret_cast<const unsigned char*>(p.sumv + base * p.Ms),
                 4 * n * p.Ms);
      stage_copy(reinterpret_cast<unsigned char*>(t.mmv),
                 reinterpret_cast<const unsigned char*>(p.mmv + base * Mnx),
                 4 * n * Mnx);
      stage_copy(t.mmm, p.mmm + base * Mnx, n * Mnx);
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  };

#pragma unroll
  for (int s = 0; s < kRing; ++s) issue(s);

  float* acc = acc_all + (kRegime == kWarp ? warp * nc * G : 0);
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait_prev();
    __syncthreads();  // tile s landed for every thread; accumulators ready
    const Tile t = tile_at(ring + (s % kRing) * tb, T, p.Ms, Mnx);
    const int n = min(T, rows - s * T);
    if constexpr (kRegime == kLane) {
      // thread t folds rows t, t+256, ... into its own slots: no two
      // threads ever write one slot
      for (int r = threadIdx.x; r < n; r += kThreads) {
        const int g = t.gid[r];
        if (!t.mask[r] || (unsigned)g >= (unsigned)G) continue;
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          if (k < nc) {
            float* a = acc_all + (k * G + g) * kThreads + threadIdx.x;
            *a = fold(*a, tile_value(t, r, c0 + k, kind[k], p.Ms, Mnx, true), kind[k]);
          }
        }
      }
    } else if constexpr (kRegime == kWarp) {
      // warp w reduces rows [w * T/8, (w+1) * T/8) of the tile
      const int per = T / kWarps;
      for (int r0 = warp * per; r0 < (warp + 1) * per; r0 += 32) {
        const int r = r0 + lane;
        int key = -1;
        if (r < n) {
          const int g = t.gid[r];
          if (t.mask[r] && (unsigned)g < (unsigned)G) key = g;
        }
        fold_step(t, nullptr, r0, key, acc, p, c0, nc, kind, tags);
      }
    } else {
      // warp w owns the groups g % 8 == w: bucket the tile's kept rows by
      // owner, in row order, then each warp walks its own bucket
      const int b0 = bucket_rows(t, n, T, G, bucket);
      const int b1 = warp + 1 < kWarps ? bucket.off[(warp + 1) * (T / 32)] : bucket.total;
      for (int r0 = b0; r0 < b1; r0 += 32) {
        const int key = r0 + lane < b1 ? t.gid[bucket.rows[r0 + lane]] : -1;
        fold_step(t, bucket.rows, r0, key, acc, p, c0, nc, kind, tags);
      }
    }
    __syncthreads();  // every warp is done with this ring slot
    issue(s + kRing);
  }

  // combine the copies of each slot in a fixed order; write the chunk partial
  float* out = p.scratch + ((long long)chunk * M + c0) * G;
  if constexpr (kRegime == kLane) {
    // per slot: lane l folds threads l, l+32, ..., l+224, then a butterfly
#pragma unroll 4
    for (int i = warp; i < nc * G; i += kWarps) {
      const int knd = col_kind(c0 + i / G, p.Ms, p.Mn);
      const float* a_i = acc_all + i * kThreads;
      float a = a_i[lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a = fold(a, a_i[w * 32 + lane], knd);
#pragma unroll
      for (int o = 16; o; o >>= 1) a = fold(a, __shfl_xor_sync(kFull, a, o), knd);
      if (lane == 0) out[i] = a;
    }
  } else {
    for (int i = threadIdx.x; i < nc * G; i += kThreads) {
      const int knd = col_kind(c0 + i / G, p.Ms, p.Mn);
      float a = acc_all[i];
      if constexpr (kRegime == kWarp) {
        for (int w = 1; w < kWarps; ++w) a = fold(a, acc_all[w * nc * G + i], knd);
      }
      out[i] = a;
    }
  }
}

// One block per 8 outputs (column-major over [M, G]); thread (j, o) folds
// chunks j, j+32, j+64, ... of output o in chunk order, then the 32 results
// of each output combine by a fixed tree over j.
constexpr int kFoldOut = 8;
constexpr int kFoldSplit = kThreads / kFoldOut;

__global__ void __launch_bounds__(kThreads)
fold_pass(const float* __restrict__ scratch, int n_chunks, int G, int Ms,
          int Mn, int Mx, float* __restrict__ sums, float* __restrict__ mins,
          float* __restrict__ maxs) {
  __shared__ float part[kFoldSplit][kFoldOut];
  const int M = Ms + Mn + Mx;
  const int ol = threadIdx.x % kFoldOut;
  const int j = threadIdx.x / kFoldOut;
  const long long o = (long long)blockIdx.x * kFoldOut + ol;
  const bool live = o < (long long)M * G;
  const int col = live ? (int)(o / G) : 0;
  const int knd = col_kind(col, Ms, Mn);
  float a = identity(knd);
  if (live) {
    const long long stride = (long long)M * G;
#pragma unroll 8
    for (int c = j; c < n_chunks; c += kFoldSplit) a = fold(a, scratch[c * stride + o], knd);
  }
  part[j][ol] = a;
  __syncthreads();
#pragma unroll
  for (int h = kFoldSplit / 2; h; h >>= 1) {
    if (j < h) part[j][ol] = fold(part[j][ol], part[j + h][ol], knd);
    __syncthreads();
  }
  if (j != 0 || !live) return;
  a = part[0][ol];
  const int g = (int)(o - (long long)col * G);
  if (knd == 0) {
    sums[(long long)g * Ms + col] = a;
  } else if (knd == 1) {
    mins[(long long)g * Mn + (col - Ms)] = a;
  } else {
    maxs[(long long)g * Mx + (col - Ms - Mn)] = a;
  }
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and returns the CUDA error of the first
// launch that failed (0 when both were accepted).  `scratch` holds
// ceil(R / chunk_rows) * (Ms+Mn+Mx) * G floats.  The geometry comes from
// ops/cuda_groupby.geometry, which sizes shared memory as this file does; a
// geometry outside this kernel's limits is refused (cudaErrorInvalidValue).
int sdol_groupby_partial(const void* gid, const void* mask, const void* sumv,
                         const void* mmv, const void* mmm, void* sums,
                         void* mins, void* maxs, void* scratch, int R, int G,
                         int Ms, int Mn, int Mx, int chunk_rows, int tile_rows,
                         int cols, int regime, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = Ms + Mn + Mx;
  if (M == 0 || G <= 0) return 0;
  if (tile_rows <= 0 || tile_rows > 1024 || tile_rows % kThreads || chunk_rows % tile_rows ||
      cols < 1 || cols > kMaxCols) {
    return (int)cudaErrorInvalidValue;
  }
  if (regime < kBlock || regime > kLane) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(G, Ms, Mn + Mx, tile_rows, cols, regime);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int n_chunks = (R + chunk_rows - 1) / chunk_rows;
  if (n_chunks > 0) {
    // allow the largest block once per device: a host call per launch
    // costs more than the launch itself
    static int allowed[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev]) {
      void (*const kernels[])(Params) = {partial_pass<kBlock>, partial_pass<kWarp>,
                                         partial_pass<kLane>};
      for (auto f : kernels) {
        e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e != cudaSuccess) return (int)e;
      }
      allowed[dev] = 1;
    }
    Params p{static_cast<const int32_t*>(gid), static_cast<const uint8_t*>(mask),
             static_cast<const float*>(sumv),  static_cast<const float*>(mmv),
             static_cast<const uint8_t*>(mmm), static_cast<float*>(scratch),
             R, G, Ms, Mn, Mx, chunk_rows, tile_rows, cols, regime};
    dim3 grid(n_chunks, (M + cols - 1) / cols);
    if (regime == kLane) {
      partial_pass<kLane><<<grid, kThreads, smem, s>>>(p);
    } else if (regime == kWarp) {
      partial_pass<kWarp><<<grid, kThreads, smem, s>>>(p);
    } else {
      partial_pass<kBlock><<<grid, kThreads, smem, s>>>(p);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long outputs = (long long)M * G;
  fold_pass<<<(unsigned)((outputs + kFoldOut - 1) / kFoldOut), kThreads, 0, s>>>(
      static_cast<const float*>(scratch), n_chunks, G, Ms, Mn, Mx,
      static_cast<float*>(sums), static_cast<float*>(mins),
      static_cast<float*>(maxs));
  return (int)cudaGetLastError();
}

const char* sdol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

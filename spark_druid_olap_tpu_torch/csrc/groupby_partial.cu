// Group-by partial aggregation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel spark_druid_olap_tpu/ops/pallas_groupby.py:_kernel
// (launched by pallas_partial_aggregate): the fused one-hot group-by.  Same
// contract, same argument order, same output layout:
//
//   in : gid int32[R], mask bool[R], sum_values f32[R, Ms] (pre-masked),
//        minmax_values f32[R, Mn+Mx], minmax_masks bool[R, Mn+Mx]
//   out: sums f32[G, Ms], mins f32[G, Mn], maxs f32[G, Mx]
//        (empty groups: 0 / +inf / -inf)
//
// Bound on an H100 SXM: the function must read R * (4 + 1 + 4*Ms + 5*(Mn+Mx))
// bytes (gid, mask, the sum columns, the min/max values and their masks) and
// write G * (Ms+Mn+Mx) * 4 bytes; its arithmetic is one add or compare per
// row and column.  So it is bound by memory: bytes / 3.35 TB/s.  At one SSB
// segment (R = 524288) with Ms = 4, Mn = Mx = 1 that is 16.3 MB, 4.9 us.
//
// What this design does about that bound: each block stages a contiguous
// run of rows once, with coalesced loads, into shared memory (gid with the
// row mask folded in, and the block's value columns with min/max masks
// folded in as +-inf), so HBM sees every input byte once per (group tile,
// column block).  For G <= 256 there is one group tile and the kernel is a
// single streaming pass.  It does not yet reach the bound: every thread owns
// one group and sweeps the staged rows, so the work is O(R * G / lanes)
// compares, the same shape as the one-hot product it replaces; for large G
// that sweep, not HBM, sets the time.  For small G the second pass sets it:
// each (column, group) thread folds up to 512 chunk partials one after
// another.  Measured on an H100 SXM (chip_smoke.py) one 512K-row segment
// takes 0.2-1.3 ms against the 5 us bound.  Fewer, longer chunks for small
// G, warp-private accumulators keyed by __match_any_sync and TMA staging
// are the known next steps.
//
// Determinism contract (no float atomics anywhere):
//   pass 1, grid (row chunk x group tile x column block): thread (lane, g)
//     folds rows lane, lane + L, lane + 2L, ... of its chunk in row order;
//     the L lane partials combine in lane order; the result goes to
//     scratch[chunk][col][g].
//   pass 2: each (col, g) folds the chunk partials in chunk order.
// The order depends on the shapes alone, so sums are bit-identical from run
// to run.  Sums are plain float32 adds (no tensor cores, no TF32, no bf16).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (ops/cuda_groupby.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 8;       // aggregate columns per block (grid z)
constexpr int kStage = 1024;   // rows staged in shared memory at a time

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

__global__ void __launch_bounds__(kThreads)
partial_pass(const int32_t* __restrict__ gid, const uint8_t* __restrict__ mask,
             const float* __restrict__ sumv, const float* __restrict__ mmv,
             const uint8_t* __restrict__ mmm, float* __restrict__ scratch,
             int R, int G, int Ms, int Mn, int Mx, int chunk_rows, int gt) {
  __shared__ int s_gid[kStage];
  __shared__ float s_val[kStage * kCols];  // [row][col]; reused to reduce

  const int M = Ms + Mn + Mx;
  const int Mnx = Mn + Mx;
  const int chunk = blockIdx.x;
  const int g0 = blockIdx.y * gt;
  const int c0 = blockIdx.z * kCols;
  const int nc = min(kCols, M - c0);
  const long long row0 = (long long)chunk * chunk_rows;
  const int rows = (int)min((long long)chunk_rows, (long long)R - row0);

  const int lanes = kThreads / gt;
  const int gl = threadIdx.x % gt;  // group within the tile
  const int lane = threadIdx.x / gt;

  int kind[kCols];
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    kind[k] = col_kind(c0 + k, Ms, Mn);
    acc[k] = identity(kind[k]);
  }

  for (int s0 = 0; s0 < rows; s0 += kStage) {
    const int n = min(kStage, rows - s0);
    const long long base = row0 + s0;
    // gid relative to this group tile; masked rows never match (-1 - G)
    for (int r = threadIdx.x; r < n; r += kThreads) {
      s_gid[r] = mask[base + r] ? gid[base + r] - g0 : -1 - G;
    }
    // value columns of this block, min/max masks folded in as +-inf
    for (int i = threadIdx.x; i < n * nc; i += kThreads) {
      const int r = i / nc;
      const int k = i - r * nc;
      const int j = c0 + k;
      float v;
      if (j < Ms) {
        v = sumv[(base + r) * Ms + j];
      } else {
        const long long idx = (base + r) * Mnx + (j - Ms);
        v = (mask[base + r] && mmm[idx]) ? mmv[idx]
                                         : identity(col_kind(j, Ms, Mn));
      }
      s_val[r * kCols + k] = v;
    }
    __syncthreads();
    for (int r = lane; r < n; r += lanes) {
      if (s_gid[r] == gl) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (k < nc) acc[k] = fold(acc[k], s_val[r * kCols + k], kind[k]);
        }
      }
    }
    __syncthreads();
  }

  // combine the lanes of each (group, column) in lane order
  float* red = s_val;  // [lane][gl][k], kThreads * kCols floats
#pragma unroll
  for (int k = 0; k < kCols; ++k) red[(lane * gt + gl) * kCols + k] = acc[k];
  __syncthreads();
  for (int p = threadIdx.x; p < gt * nc; p += kThreads) {
    const int k = p / gt;
    const int g = p - k * gt;
    if (g0 + g >= G) continue;
    const int knd = col_kind(c0 + k, Ms, Mn);
    float a = red[g * kCols + k];
    for (int l = 1; l < lanes; ++l) a = fold(a, red[(l * gt + g) * kCols + k], knd);
    scratch[((long long)chunk * M + c0 + k) * G + g0 + g] = a;
  }
}

__global__ void finish_pass(const float* __restrict__ scratch, int n_chunks,
                            int G, int Ms, int Mn, int Mx,
                            float* __restrict__ sums, float* __restrict__ mins,
                            float* __restrict__ maxs) {
  const int M = Ms + Mn + Mx;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * G) return;
  const int j = (int)(idx / G);
  const int g = (int)(idx - (long long)j * G);
  const int knd = col_kind(j, Ms, Mn);
  float a = identity(knd);
  // chunk order; the loads are independent, so unrolling overlaps them
#pragma unroll 16
  for (int c = 0; c < n_chunks; ++c) {
    a = fold(a, scratch[((long long)c * M + j) * G + g], knd);
  }
  if (knd == 0) {
    sums[(long long)g * Ms + j] = a;
  } else if (knd == 1) {
    mins[(long long)g * Mn + (j - Ms)] = a;
  } else {
    maxs[(long long)g * Mx + (j - Ms - Mn)] = a;
  }
}

}  // namespace

extern "C" {

// Rows each pass-1 block folds must be a multiple of this.
int sdol_groupby_stage_rows() { return kStage; }

// Launches both passes on `stream` and returns the CUDA error of the first
// launch that failed (0 when both were accepted).  `scratch` holds
// ceil(R / chunk_rows) * (Ms+Mn+Mx) * G floats.
int sdol_groupby_partial(const void* gid, const void* mask, const void* sumv,
                         const void* mmv, const void* mmm, void* sums,
                         void* mins, void* maxs, void* scratch, int R, int G,
                         int Ms, int Mn, int Mx, int chunk_rows,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = Ms + Mn + Mx;
  if (M == 0 || G <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kStage) return (int)cudaErrorInvalidValue;
  const int n_chunks = (R + chunk_rows - 1) / chunk_rows;
  int gt = 1;
  while (gt < G && gt < kThreads) gt <<= 1;
  if (n_chunks > 0) {
    dim3 grid(n_chunks, (G + gt - 1) / gt, (M + kCols - 1) / kCols);
    partial_pass<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(gid), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(sumv), static_cast<const float*>(mmv),
        static_cast<const uint8_t*>(mmm), static_cast<float*>(scratch), R, G,
        Ms, Mn, Mx, chunk_rows, gt);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (long long)M * G;
  finish_pass<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(scratch), n_chunks, G, Ms, Mn, Mx,
      static_cast<float*>(sums), static_cast<float*>(mins),
      static_cast<float*>(maxs));
  return (int)cudaGetLastError();
}

const char* sdol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Greedy bipartite GT -> anchor matching for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_batched_match`
// (jpeg_detection_resnet_ssd_tpu/ops/pallas_match.py, kernel
// `_match_kernel_batched`, reached through `pallas_bipartite_match`).  Same
// function as that file's `_batched_match_xla` loop: for each image of a
// (B, M, N) similarity batch, repeatedly take the global best (row, anchor)
// pair with similarity >= 0, record it, and consume its row and its column;
// ties go to the lower row, then to the lower anchor.  Output (B, M) int32:
// the matched anchor of each row, or -1.
//
// Design.  The TPU kernel put images on lanes and pre-reduced each row to
// its top-M candidates.  Here one block of 256 threads owns one image; its
// (M, N) matrix (64 x 8732 floats, 2.2 MB) stays in device memory and L2.
// Shared memory holds each row's current best (value, first anchor), a dead
// flag per row, a dead-column bitmask (N bits) and the result row.
//   Init: each warp reduces whole rows (max and first argmax).
//   Loop: one warp picks the alive row with the largest best value (lower
//   row on ties).  Below 0 the image is done (the XLA loop's `valid`).
//   Else the pair is recorded, the row and the column die, and only the
//   alive rows whose best anchor was that column are rescanned, one warp a
//   row.  A rescan reads a dead column as -1e30, exactly what the XLA loop
//   writes there, so the result equals it for any finite input (sims are
//   IoUs in [0, 1] or -1 for invalid rows on the training path).
//
// Bound.  The kernel must read the similarities once: B*M*N*4 bytes,
// 71.5 MB at B = 32, ~21 us at 3.35 TB/s; the operations (a compare per
// element) are far below that.  It is latency-bound instead: up to M serial
// steps per image, each with block-wide barriers and, on a hit, a 35 KB row
// rescan from L2.  Real batches carry a few valid rows per image, so most
// images stop after a few steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kDead = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

struct Best {
  float v;
  int i;
};

// The better of two (value, index) pairs: larger value, lower index on ties.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, x.i, off);
    x = better(x, o);
  }
  return x;
}

// Max and first argmax of one row, dead columns reading kDead; one warp.
__device__ __forceinline__ Best scan_row(const float* __restrict__ row, int n,
                                         const uint32_t* col_dead) {
  const int lane = threadIdx.x % 32;
  Best b{__int_as_float(0xff800000), kNoIndex};  // -inf
  for (int j = lane; j < n; j += 32) {
    const bool dead = (col_dead[j >> 5] >> (j & 31)) & 1u;
    const float v = dead ? kDead : row[j];
    if (v > b.v) b = Best{v, j};  // j grows per lane: keeps the first
  }
  return warp_best(b);
}

__global__ void __launch_bounds__(kThreads)
bipartite_match_kernel(const float* __restrict__ sims,  // (B, M, N)
                       int32_t* __restrict__ out,       // (B, M)
                       int m, int n) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) / 32;
  uint32_t* col_dead = smem;
  float* best_v = reinterpret_cast<float*>(col_dead + words);
  int* best_i = reinterpret_cast<int*>(best_v + m);
  int* result = best_i + m;
  int* row_dead = result + m;
  __shared__ int pick_col, done;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const float* s = sims + static_cast<size_t>(blockIdx.x) * m * n;

  for (int j = t; j < words; j += kThreads) col_dead[j] = 0u;
  for (int r = t; r < m; r += kThreads) {
    result[r] = -1;
    row_dead[r] = 0;
  }
  __syncthreads();
  for (int r = warp; r < m; r += kWarps) {
    const Best b = scan_row(s + static_cast<size_t>(r) * n, n, col_dead);
    if (lane == 0) {
      best_v[r] = b.v;
      best_i[r] = b.i;
    }
  }
  __syncthreads();

  for (int step = 0; step < m; ++step) {
    if (warp == 0) {
      Best b{__int_as_float(0xff800000), kNoIndex};  // -inf
      for (int r = lane; r < m; r += 32) {
        if (!row_dead[r]) b = better(b, Best{best_v[r], r});
      }
      b = warp_best(b);
      if (lane == 0) {
        done = !(b.v >= 0.0f);
        if (!done) {
          const int a = best_i[b.i];
          pick_col = a;
          result[b.i] = a;
          row_dead[b.i] = 1;
          col_dead[a >> 5] |= 1u << (a & 31);
        }
      }
    }
    __syncthreads();
    if (done) break;  // uniform: read after the barrier
    const int a = pick_col;
    for (int r = warp; r < m; r += kWarps) {
      if (row_dead[r] || best_i[r] != a) continue;  // uniform within the warp
      const Best b = scan_row(s + static_cast<size_t>(r) * n, n, col_dead);
      if (lane == 0) {
        best_v[r] = b.v;
        best_i[r] = b.i;
      }
    }
    __syncthreads();
  }

  for (int r = t; r < m; r += kThreads) out[static_cast<size_t>(blockIdx.x) * m + r] = result[r];
}

}  // namespace

// Bytes of shared memory one block needs for an (M, N) image.
extern "C" int bipartite_match_smem_bytes(int m, int n) {
  return ((n + 31) / 32) * 4 + m * 16;
}

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int bipartite_match(const void* sims, void* out, int b, int m, int n,
                               void* stream) {
  if (b == 0 || m == 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(bipartite_match_smem_bytes(m, n));
  bipartite_match_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sims), static_cast<int32_t*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

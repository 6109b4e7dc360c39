// Greedy bipartite GT -> anchor matching for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_batched_match`
// (jpeg_detection_resnet_ssd_tpu/ops/pallas_match.py, kernel
// `_match_kernel_batched`, reached through `pallas_bipartite_match`).  Same
// function as that file's `_batched_match_xla` loop: for each image of a
// (B, M, N) similarity batch, repeatedly take the global best (row, anchor)
// pair with similarity >= 0, record it, and consume its row and its column;
// ties go to the lower row, then to the lower anchor.  Output (B, M) int32:
// the matched anchor of each row, or -1.  An optional (B, M) row mask drops
// rows before the loop: a masked row is never matched and never read, as if
// its similarities were -1e30.
//
// Design.  One block of 512 threads owns one image; the similarities stay
// in device memory.  Shared memory holds, per live row, its current best as
// one 64-bit key (the float's bits mapped to an unsigned order, then the
// complement of the column: the larger key is the larger value, then the
// lower column), the live rows' indices, a rescan list and a dead-column
// bitmask (N bits).
//   Compact: warp 0 lists the rows the mask keeps (all rows without one),
//   in row order, by ballots.  Padding GT rows are masked on the training
//   path, so an image with 2 GT reads 2 of its 64 rows.
//   Init: the block reduces the live rows.  The work is cut into segments
//   of 8 16-byte loads per lane (4 KB a warp); warps take segments of any
//   row, keep their 8 loads in flight, reduce their keys by shuffles and
//   fold them into the row's key with a shared-memory atomicMax, so rows
//   of any count share the block without a barrier between them.  A row's
//   unaligned head and its tail (N % 4, views) are read as scalars.
//   Loop: warp 0 picks the live unmatched row with the largest value (lower
//   row on ties); below 0 the image is done (the XLA loop's `valid`).  Else
//   it records the pair, kills the row and the column, and lists the rows
//   whose best column that was; only those are rescanned, by the whole
//   block in segments as in the init, reading a dead column as -1e30,
//   exactly what the XLA loop writes there.  So the result equals the plain
//   version index for index for any finite input.
//
// Bound.  The function must read the live rows once: B * V * N * 4 bytes
// for V live rows an image, plus the mask and the output (2.24 MB at B = 32,
// V = 2, N = 8732: 0.7 us at 3.35 TB/s); the operations (a compare per
// element) are below that.  At that size a launch and a few dependent
// shared-memory steps set the pace.  Without a mask every row is live.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;                // 16-byte loads in flight per lane
constexpr int kSegVec = 32 * kSeg;     // float4s one warp reads per segment
constexpr float kDead = -1e30f;
constexpr unsigned long long kMatched = 0ull;  // the key of a matched row
constexpr unsigned long long kEmpty = 1ull;    // below every real key
constexpr unsigned kFull = 0xffffffffu;

// Larger key: larger value, then lower column.  -0 keys as +0, as a float
// compare ties them.
__device__ __forceinline__ unsigned long long key_of(float v, int j) {
  uint32_t u = (v == 0.0f) ? 0u : __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xffffffffu - static_cast<uint32_t>(j));
}

__device__ __forceinline__ int key_column(unsigned long long k) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(k));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

template <bool kCheckDead>
__device__ __forceinline__ unsigned long long key_at(float v, int j, const uint32_t* col_dead) {
  if (kCheckDead && ((col_dead[j >> 5] >> (j & 31)) & 1u)) v = kDead;
  return key_of(v, j);
}

// Folds into key[slot] the best (value, column) of the rows of `count`
// slots (`list[i]`, or slot i when `list` is null), `segs` segments a row.
template <bool kCheckDead>
__device__ void reduce_rows(const float* __restrict__ img, int n, const int* list, int count,
                            const int* slot_row, unsigned long long* key,
                            const uint32_t* col_dead, int segs) {
  const int lane = threadIdx.x % 32;
  for (int w = threadIdx.x / 32; w < count * segs; w += kWarps) {
    const int slot = list ? list[w / segs] : w / segs;
    const int seg = w % segs;
    const float* row = img + static_cast<size_t>(slot_row[slot]) * n;
    const int head = min(n, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) >> 2));
    const int n4 = (n - head) >> 2;
    const float4* body = reinterpret_cast<const float4*>(row + head);
    float4 v[kSeg];
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int q = seg * kSegVec + u * 32 + lane;
      if (q < n4) v[u] = __ldg(body + q);
    }
    unsigned long long best = 0ull;
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int q = seg * kSegVec + u * 32 + lane;
      if (q < n4) {
        const int j = head + 4 * q;
        best = umax64(best, key_at<kCheckDead>(v[u].x, j, col_dead));
        best = umax64(best, key_at<kCheckDead>(v[u].y, j + 1, col_dead));
        best = umax64(best, key_at<kCheckDead>(v[u].z, j + 2, col_dead));
        best = umax64(best, key_at<kCheckDead>(v[u].w, j + 3, col_dead));
      }
    }
    if (seg == 0) {  // the scalar head (< 4 columns) and tail (< 4 columns)
      const int tail = n - head - 4 * n4;
      int j = -1;
      if (lane < head) j = lane;
      else if (lane >= 4 && lane - 4 < tail) j = head + 4 * n4 + (lane - 4);
      if (j >= 0) best = umax64(best, key_at<kCheckDead>(__ldg(row + j), j, col_dead));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) best = umax64(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) atomicMax(key + slot, best);
  }
}

__global__ void __launch_bounds__(kThreads)
bipartite_match_kernel(const float* __restrict__ sims,        // (B, M, N)
                       const uint8_t* __restrict__ row_mask,  // (B, M) or null
                       int32_t* __restrict__ out,             // (B, M)
                       int m, int n) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;                             // m
  int* slot_row = reinterpret_cast<int*>(key + m);            // m
  int* rescan = slot_row + m;                                 // m
  uint32_t* col_dead = reinterpret_cast<uint32_t*>(rescan + m);  // ceil(n / 32)
  // Written by warp 0 at step s, read by all after the barrier; two
  // copies, so step s + 1's write cannot overtake a slow warp's read.
  __shared__ int s_live, s_done[2], s_rescans[2];

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const size_t image = blockIdx.x;
  const float* img = sims + image * m * n;
  int32_t* o = out + image * m;
  const int words = (n + 31) / 32;
  const int segs = max(1, (n / 4 + kSegVec - 1) / kSegVec);

  for (int j = t; j < words; j += kThreads) col_dead[j] = 0u;
  for (int r = t; r < m; r += kThreads) {
    o[r] = -1;
    key[r] = kEmpty;
  }
  if (warp == 0) {
    int live = 0;
    for (int base = 0; base < m; base += 32) {
      const int r = base + lane;
      const bool on = r < m && (row_mask == nullptr || row_mask[image * m + r]);
      const unsigned bal = __ballot_sync(kFull, on);
      if (on) slot_row[live + __popc(bal & ((1u << lane) - 1u))] = r;
      live += __popc(bal);
    }
    if (lane == 0) s_live = live;
  }
  __syncthreads();
  const int live = s_live;
  reduce_rows<false>(img, n, nullptr, live, slot_row, key, col_dead, segs);
  __syncthreads();

  for (int step = 0;; ++step) {
    const int par = step & 1;
    if (warp == 0) {
      uint32_t bv = 0u;
      int bk = INT_MAX;
      for (int k = lane; k < live; k += 32) {
        const unsigned long long kk = key[k];
        const uint32_t v = static_cast<uint32_t>(kk >> 32);
        if (kk != kMatched && v > bv) {  // k grows per lane: keeps the lower slot
          bv = v;
          bk = k;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const uint32_t ov = __shfl_xor_sync(kFull, bv, off);
        const int ok = __shfl_xor_sync(kFull, bk, off);
        if (ov > bv || (ov == bv && ok < bk)) {
          bv = ov;
          bk = ok;
        }
      }
      const bool done = bk == INT_MAX || !(bv & 0x80000000u);  // no live row reaches 0
      int n_rescan = 0;
      if (!done) {
        const int a = key_column(key[bk]);
        __syncwarp();
        if (lane == 0) {
          o[slot_row[bk]] = a;
          key[bk] = kMatched;
          col_dead[a >> 5] |= 1u << (a & 31);
        }
        __syncwarp();
        for (int base = 0; base < live; base += 32) {
          const int k = base + lane;
          bool hit = false;
          if (k < live) {
            const unsigned long long kk = key[k];
            hit = kk != kMatched && key_column(kk) == a;
          }
          const unsigned bal = __ballot_sync(kFull, hit);
          if (hit) {
            rescan[n_rescan + __popc(bal & ((1u << lane) - 1u))] = k;
            key[k] = kEmpty;
          }
          n_rescan += __popc(bal);
        }
      }
      if (lane == 0) {
        s_done[par] = done;
        s_rescans[par] = n_rescan;
      }
    }
    __syncthreads();
    if (s_done[par]) break;  // uniform: read after the barrier
    const int n_rescan = s_rescans[par];
    if (n_rescan > 0) {
      reduce_rows<true>(img, n, rescan, n_rescan, slot_row, key, col_dead, segs);
      __syncthreads();
    }
  }
}

}  // namespace

// Bytes of shared memory one block needs for an (M, N) image.
extern "C" int bipartite_match_smem_bytes(int m, int n) {
  return m * 16 + ((n + 31) / 32) * 4;
}

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// `row_mask` is a (B, M) array of 0/1 bytes, or null for all rows.
extern "C" int bipartite_match(const void* sims, const void* row_mask, void* out, int b, int m,
                               int n, void* stream) {
  if (b == 0 || m == 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bipartite_match_smem_bytes(m, n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bipartite_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bipartite_match_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sims), static_cast<const uint8_t*>(row_mask),
      static_cast<int32_t*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

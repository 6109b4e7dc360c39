// Batched greedy-NMS keep mask for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_batched_nms_mask`
// (jpeg_detection_resnet_ssd_tpu/ops/pallas_nms.py, kernels `_nms_kernel` and
// `_nms_kernel_chunked`).  Same function: N stacked problems, each with K
// candidates sorted by descending score.  Candidate i, if still kept and with
// score > 0, suppresses every later j with IoU(i, j) > iou_threshold, where
//     iw    = max(0, min(x1_j, x1_i) - max(x0_j, x0_i) + d)   (ih likewise)
//     inter = iw * ih
//     union = (area_j + area_i) - inter
//     iou   = inter / max(union, 1e-12)
// and d is the border delta (0, +1 or -1).  The result is ANDed with
// score > 0.
//
// Design: two launches, so that the K dependent steps of the greedy loop do
// not each wait on a block-wide barrier.
//   1. `nms_bitmask_kernel` computes, for every pair j > i, the bit
//      IoU(i, j) > threshold, as 64-bit words: mask (N, K, ceil(K / 64)),
//      in device memory (14 MB at N = 640, K = 400; it stays in the L2).
//      Persistent warps walk the 64 x 64 tiles on and above the diagonal of
//      every problem: lane l holds rows l and l + 32 in registers and tests
//      them against the tile's columns, read from shared memory, 32 columns
//      at a time, without a branch.  A tile whose rows all have score <= 0
//      (never read) or whose columns all do (their bits change nothing) is
//      skipped and its words are left unwritten.
//   2. `nms_scan_kernel` runs the greedy scan, one warp a problem: cp.async
//      copies the blocks of 64 candidates' mask rows into a ring in shared
//      memory, up to 7 blocks ahead; for each block the warp runs the 64
//      dependent steps on the diagonal words, every lane alike, then ORs the
//      kept rows' later words into the removed set with warp reductions.
//
// Bound.  The function needs, for each kept candidate i, the test against
// the K - 1 - i later ones: 16 f32 operations a pair, ~40M pairs at the
// serving shape (N = B*C = 640, K = 400), ~10 us at 67 TFLOP/s; it moves
// ~5 MB.  The bitmask tests every pair j > i (~25% more at that shape, and
// the tiles' padding) and writes and reads the mask once each; it is bound
// by instruction issue (~16 a pair in a plain tile).
//
// Bit-exactness.  Every operation is an IEEE round-to-nearest intrinsic, in
// the reference's order, and the library is built with -fmad=false, so no
// a*b+c is contracted.  min/max propagate NaN like torch.minimum/maximum
// (`min.NaN`, `max.NaN`); the sign of a zero never changes a decision.  The
// comparison is strict: iou > iou_threshold.  In a tile of plain boxes
// (`is_plain`) and for thresholds t in [2^-40, 2^40] the division is not
// needed: RN(inter / union) > t exactly when inter / union lies above the
// midpoint m = t + h between t and the next float up (h = half its ulp); it
// never lies on m, since m needs 25 significant bits and so does m * union
// for any float union.  e = fma(-h, union, fma(-t, union, inter))
// has the sign of inter - m * union: the inner fma is exact whenever
// |inter - t * union| < 2 h union (its exact value then has at most 24
// significant bits), and otherwise off by 2^-24 of itself, too little to
// change the sign of the outer one.  Other tiles divide with __fdiv_rn and
// compare, as the reference does.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileWarps = 4;  // bitmask kernel: warps a block
constexpr int kMaxRing = 8;    // scan kernel: blocks of mask rows in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Box {
  float x0, y0, x1, y1, area;
};

__device__ __forceinline__ Box load_box(const float* b, int i, int k, float d) {
  Box r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < k) {
    r.x0 = b[4 * i + 0];
    r.y0 = b[4 * i + 1];
    r.x1 = b[4 * i + 2];
    r.y1 = b[4 * i + 3];
    r.area = __fmul_rn(__fadd_rn(__fsub_rn(r.x1, r.x0), d), __fadd_rn(__fsub_rn(r.y1, r.y0), d));
  }
  return r;
}

// inter and max(union, 1e-12) of row i and column j (x0, y0, x1, y1 and
// its area), in the reference's order.  Without kDelta the + d is left out:
// adding 0 changes only the sign of a zero.
template <bool kDelta>
__device__ __forceinline__ void overlap(const Box& i, float4 j, float j_area, float d, float& inter,
                                        float& uni) {
  float w = __fsub_rn(min_nan(j.z, i.x1), max_nan(j.x, i.x0));
  float h = __fsub_rn(min_nan(j.w, i.y1), max_nan(j.y, i.y0));
  if (kDelta) {
    w = __fadd_rn(w, d);
    h = __fadd_rn(h, d);
  }
  inter = __fmul_rn(max_nan(w, 0.0f), max_nan(h, 0.0f));
  uni = max_nan(__fsub_rn(__fadd_rn(j_area, i.area), inter), 1e-12f);
}

// The same for a tile of plain boxes (`is_plain`), scaled by 4 and with
// fewer min/max, which share the half-rate pipe with the compares: max(w, 0)
// is (w + |w|) / 2, so 4 * inter = (w + |w|) * (h + |h|), exactly, for
// products in the normal range; max(union, 1e-12) is union itself.  Both
// areas come scaled by 4.
template <bool kDelta>
__device__ __forceinline__ void overlap4(const Box& i, float4 j, float j_area4, float d,
                                         float& inter4, float& uni4) {
  float w = __fsub_rn(fminf(j.z, i.x1), fmaxf(j.x, i.x0));
  float h = __fsub_rn(fminf(j.w, i.y1), fmaxf(j.y, i.y0));
  if (kDelta) {
    w = __fadd_rn(w, d);
    h = __fadd_rn(h, d);
  }
  inter4 = __fmul_rn(__fadd_rn(w, fabsf(w)), __fadd_rn(h, fabsf(h)));
  uni4 = __fsub_rn(__fadd_rn(j_area4, i.area), inter4);
}

// A box of a plain tile: finite, every coordinate 0 or of magnitude in
// [2^-20, 2^30] (so a nonzero width is >= 2^-43 and every product is a
// normal float), width and height >= 0 (so inter <= either area) and area
// >= 2^-38 (so union > 1e-12 and max(union, 1e-12) is union).
__device__ __forceinline__ bool plain_coordinate(float c) {
  const float m = fabsf(c);
  return m <= 0x1p30f && (m == 0.0f || m >= 0x1p-20f);
}

__device__ __forceinline__ bool is_plain(const Box& b, float d) {
  const bool ok = plain_coordinate(b.x0) && plain_coordinate(b.y0) && plain_coordinate(b.x1) &&
                  plain_coordinate(b.y1);
  return ok && __fadd_rn(__fsub_rn(b.x1, b.x0), d) >= 0.0f &&
         __fadd_rn(__fsub_rn(b.y1, b.y0), d) >= 0.0f && b.area >= 0x1p-38f;
}

// word |= bit where e > 0.  A predicated OR spares the select a C++ `if`
// compiles to.
__device__ __forceinline__ void or_if_positive(uint32_t& word, float e, uint32_t bit) {
  asm("{.reg .pred p; setp.gt.f32 p, %1, 0f00000000; @p or.b32 %0, %0, %2;}"
      : "+r"(word) : "f"(e), "r"(bit));
}

// Row r0 (and r1) against 32 columns.  A plain tile keeps areas scaled by 4.
template <bool kDelta, bool kPlain, bool kTwoRows>
__device__ __forceinline__ void half_tile(const Box& r0, const Box& r1, const float4* col,
                                          const float* col_area, float d, float thr, float half_ulp,
                                          uint32_t* a) {
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float4 q = col[c];
    const float qa = col_area[c];
#pragma unroll
    for (int row = 0; row < (kTwoRows ? 2 : 1); ++row) {
      const Box& r = row == 0 ? r0 : r1;
      float inter, uni;
      if (kPlain) {
        overlap4<kDelta>(r, q, qa, d, inter, uni);
        or_if_positive(a[row], __fmaf_rn(-half_ulp, uni, __fmaf_rn(-thr, uni, inter)), 1u << c);
      } else {
        overlap<kDelta>(r, q, qa, d, inter, uni);
        if (__fdiv_rn(inter, uni) > thr) a[row] |= 1u << c;
      }
    }
  }
}

template <bool kDelta, bool kPlain>
__device__ __forceinline__ void tile(const Box& r0, const Box& r1, const float4* col,
                                     const float* col_area, float d, float thr, float half_ulp,
                                     bool two_first, bool two_second, bool second,
                                     uint32_t (*a)[2]) {
  if (two_first) {
    half_tile<kDelta, kPlain, true>(r0, r1, col, col_area, d, thr, half_ulp, a[0]);
  } else {
    half_tile<kDelta, kPlain, false>(r0, r1, col, col_area, d, thr, half_ulp, a[0]);
  }
  if (!second) return;
  if (two_second) {
    half_tile<kDelta, kPlain, true>(r0, r1, col + 32, col_area + 32, d, thr, half_ulp, a[1]);
  } else {
    half_tile<kDelta, kPlain, false>(r0, r1, col + 32, col_area + 32, d, thr, half_ulp, a[1]);
  }
}

template <bool kDelta>
__global__ void __launch_bounds__(32 * kTileWarps)
nms_bitmask_kernel(const float* __restrict__ boxes,   // (N, K, 4)
                   const float* __restrict__ scores,  // (N, K)
                   uint64_t* __restrict__ mask,       // (N, K, W)
                   int n, int k, int words, float thr, float d, float half_ulp,
                   int fast) {
  __shared__ float4 s_col[kTileWarps][64];
  __shared__ float s_area[kTileWarps][64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* col = s_col[warp];
  float* col_area = s_area[warp];
  const int tiles = words * (words + 1) / 2;
  const long long items = static_cast<long long>(n) * tiles;
  // Whole warps take tiles; no block barrier below.
  for (long long item = static_cast<long long>(blockIdx.x) * kTileWarps + warp; item < items;
       item += static_cast<long long>(gridDim.x) * kTileWarps) {
    const size_t problem = static_cast<size_t>(item / tiles);
    int t = static_cast<int>(item % tiles), rb = 0;
    while (t >= words - rb) {  // tile t -> row block rb, column block cb >= rb
      t -= words - rb;
      ++rb;
    }
    const int cb = rb + t;
    const float* b = boxes + problem * k * 4;
    const float* s = scores + problem * k;
    const int i0 = rb * 64 + lane, i1 = i0 + 32, j0 = cb * 64 + lane, j1 = j0 + 32;
    // Scores and boxes in one round trip; a skipped tile wastes its loads.
    const float s0 = i0 < k ? s[i0] : 0.0f, s1 = i1 < k ? s[i1] : 0.0f;
    const float s2 = j0 < k ? s[j0] : 0.0f, s3 = j1 < k ? s[j1] : 0.0f;
    Box r0 = load_box(b, i0, k, d), r1 = load_box(b, i1, k, d);
    const Box q0 = load_box(b, j0, k, d), q1 = load_box(b, j1, k, d);
    const bool rows_live = __any_sync(kFull, s0 > 0.0f || s1 > 0.0f);
    const bool cols_live = __any_sync(kFull, s2 > 0.0f || s3 > 0.0f);
    if (!rows_live || !cols_live) continue;

    __syncwarp();  // the previous tile's reads of `col` are done
    const bool plain = __all_sync(
        kFull, fast && (i0 >= k || is_plain(r0, d)) && (i1 >= k || is_plain(r1, d)) &&
                   (j0 >= k || is_plain(q0, d)) && (j1 >= k || is_plain(q1, d)));
    const float scale = plain ? 4.0f : 1.0f;
    col[lane] = make_float4(q0.x0, q0.y0, q0.x1, q0.y1);
    col[lane + 32] = make_float4(q1.x0, q1.y0, q1.x1, q1.y1);
    col_area[lane] = __fmul_rn(scale, q0.area);
    col_area[lane + 32] = __fmul_rn(scale, q1.area);
    r0.area = __fmul_rn(scale, r0.area);
    r1.area = __fmul_rn(scale, r1.area);
    __syncwarp();

    // Halves of 32 columns; the second rows skip the diagonal tile's first
    // half (j <= i there) and the last row block's missing rows.
    const bool diag = cb == rb, two_rows = rb * 64 + 32 < k;
    const int j_end = min(64, k - cb * 64);
    uint32_t a[2][2] = {{0u, 0u}, {0u, 0u}};  // [half][row]
    if (plain) {
      tile<kDelta, true>(r0, r1, col, col_area, d, thr, half_ulp, two_rows && !diag, two_rows,
                         j_end > 32, a);
    } else {
      tile<kDelta, false>(r0, r1, col, col_area, d, thr, half_ulp, two_rows && !diag,
                          two_rows, j_end > 32, a);
    }
    // Keep only the bits of j < K and, on the diagonal, j > i.
    const uint64_t in_range = j_end >= 64 ? ~0ull : (1ull << j_end) - 1ull;
    uint64_t keep0 = in_range, keep1 = two_rows ? in_range : 0ull;
    if (diag) {
      keep0 &= ~0ull << (lane + 1);
      keep1 &= lane + 33 < 64 ? ~0ull << (lane + 33) : 0ull;
    }
    uint64_t* out = mask + problem * k * words;
    if (i0 < k) {
      out[static_cast<size_t>(i0) * words + cb] = ((static_cast<uint64_t>(a[1][0]) << 32) | a[0][0]) & keep0;
    }
    if (i1 < k) {
      out[static_cast<size_t>(i1) * words + cb] = ((static_cast<uint64_t>(a[1][1]) << 32) | a[0][1]) & keep1;
    }
  }
}

// Waits until at most `pending` cp.async groups are in flight (the
// instruction takes a constant).
__device__ __forceinline__ void wait_copies(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// Shared memory of the scan: `ring` blocks of 64 mask rows, then the
// removed set and the valid (score > 0) bits, W words each.
int scan_smem_bytes(int words, int ring) {
  return (ring * 64 * words + 2 * words) * static_cast<int>(sizeof(uint64_t));
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const float* __restrict__ scores,   // (N, K)
                const uint64_t* __restrict__ mask,  // (N, K, W)
                uint8_t* __restrict__ keep_out,     // (N, K)
                int k, int words, int ring) {
  extern __shared__ uint64_t smem[];
  const int lane = threadIdx.x;
  const size_t problem = blockIdx.x;
  uint64_t* removed = smem + static_cast<size_t>(ring) * 64 * words;
  uint64_t* valid = removed + words;
  const uint64_t* rows = mask + problem * k * words;
  const float* s = scores + problem * k;
  uint8_t* out = keep_out + problem * k;

  // Block w's mask rows into slot w % ring, 8 bytes a copy, one group each.
  auto fetch = [&](int w) {
    if (w < words) {
      const int count = min(64, k - 64 * w) * words;
      const uint64_t* src = rows + static_cast<size_t>(64) * w * words;
      uint64_t* dst = smem + static_cast<size_t>(w % ring) * 64 * words;
      for (int q = lane; q < count; q += 32) __pipeline_memcpy_async(dst + q, src + q, sizeof(uint64_t));
    }
    __pipeline_commit();
  };
  for (int w = 0; w < ring - 1; ++w) fetch(w);
  for (int w0 = 0; w0 < words; w0 += 4) {  // the scores of 4 blocks in one round trip
    float sc[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 64 * (w0 + u) + lane;
      sc[u][0] = i < k ? s[i] : 0.0f;
      sc[u][1] = i + 32 < k ? s[i + 32] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned v0 = __ballot_sync(kFull, sc[u][0] > 0.0f);
      const unsigned v1 = __ballot_sync(kFull, sc[u][1] > 0.0f);
      if (lane == 0 && w0 + u < words) {
        valid[w0 + u] = (static_cast<uint64_t>(v1) << 32) | v0;
        removed[w0 + u] = 0ull;
      }
    }
  }

  for (int w = 0; w < words; ++w) {
    fetch(w + ring - 1);
    wait_copies(ring - 1);  // block w has landed
    __syncwarp();
    const uint64_t* c = smem + static_cast<size_t>(w % ring) * 64 * words;

    // The serial part, in 32-bit halves: candidate 64w + b is kept if no
    // kept candidate removed it and its score is > 0; then its diagonal word
    // removes the later ones of this block.  The first 32 rows' words reach
    // both halves of cur, the last 32 rows' only the upper one.  The words
    // are read into registers first, so that the dependent steps wait on
    // nothing else.  Rows past K or with score <= 0 are never kept, so their
    // (stale or unwritten) words are never used.
    const uint64_t v = valid[w], start = removed[w];
    uint32_t cur_lo = static_cast<uint32_t>(start), cur_hi = static_cast<uint32_t>(start >> 32);
    const uint32_t v_lo = static_cast<uint32_t>(v), v_hi = static_cast<uint32_t>(v >> 32);
    uint32_t kept_lo = 0u, kept_hi = 0u, d_lo[32], d_hi[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint64_t diag = c[b * words + w];
      d_lo[b] = static_cast<uint32_t>(diag);
      d_hi[b] = static_cast<uint32_t>(diag >> 32);
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (v_lo & ~cur_lo & (1u << b)) {
        kept_lo |= 1u << b;
        cur_lo |= d_lo[b];
        cur_hi |= d_hi[b];
      }
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) d_hi[b] = static_cast<uint32_t>(c[(32 + b) * words + w] >> 32);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (v_hi & ~cur_hi & (1u << b)) {
        kept_hi |= 1u << b;
        cur_hi |= d_hi[b];
      }
    }
    const uint64_t kept = (static_cast<uint64_t>(kept_hi) << 32) | kept_lo;
    // The kept rows' later words into the removed set: lane l holds rows l
    // and l + 32, the warp ORs them together.
    const bool keep0 = (kept >> lane) & 1ull, keep1 = (kept >> (32 + lane)) & 1ull;
#pragma unroll 4
    for (int x = w + 1; x < words; ++x) {
      const uint64_t r = (keep0 ? c[lane * words + x] : 0ull) | (keep1 ? c[(32 + lane) * words + x] : 0ull);
      const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(r));
      const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(r >> 32));
      if (lane == 0) removed[x] |= (static_cast<uint64_t>(hi) << 32) | lo;
    }
    const int i0 = 64 * w + lane, i1 = i0 + 32;
    if (i0 < k) out[i0] = (kept >> lane) & 1ull;
    if (i1 < k) out[i1] = (kept >> (32 + lane)) & 1ull;
    __syncwarp();  // a later fetch refills this slot
  }
}

int words_of(int k) { return (k + 63) / 64; }

// The ring the scan can hold within `limit` bytes, at most kMaxRing blocks
// and no more than there are; 0 if not even two fit.
int ring_for(int words, int limit) {
  int ring = words < kMaxRing ? words : kMaxRing;
  while (ring > 1 && scan_smem_bytes(words, ring) > limit) --ring;
  return (ring >= 2 || words == 1) && scan_smem_bytes(words, ring) <= limit ? ring : 0;
}

constexpr int kSmemLimit = 232448;  // a block's shared memory with the opt-in attribute

}  // namespace

// Bytes of shared memory the scan needs at the least (two blocks of mask
// rows in flight; one when K <= 64).
extern "C" int batched_nms_mask_smem_bytes(int k) {
  const int words = words_of(k);
  return scan_smem_bytes(words, words == 1 ? 1 : 2);
}

// Bytes of the (N, K, W) bitmask workspace the caller allocates.
extern "C" long long batched_nms_mask_workspace_bytes(int n, int k) {
  return static_cast<long long>(n) * k * words_of(k) * static_cast<long long>(sizeof(uint64_t));
}

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): a refused launch never runs and a later synchronise
// would not report it.  `workspace` holds batched_nms_mask_workspace_bytes.
extern "C" int batched_nms_mask(const void* boxes, const void* scores, void* keep, void* workspace,
                                int n, int k, float iou_threshold, float border_delta,
                                void* stream) {
  if (n == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = words_of(k);
  const long long items = static_cast<long long>(n) * (words * (words + 1) / 2);
  const float thr_next = nextafterf(iou_threshold, INFINITY);
  const float half_ulp = 0.5f * (thr_next - iou_threshold);
  const int fast = iou_threshold >= 0x1p-40f && iou_threshold <= 0x1p40f;
  const float* b = static_cast<const float*>(boxes);
  const float* s = static_cast<const float*>(scores);
  uint64_t* mask = static_cast<uint64_t*>(workspace);

  // Enough blocks to fill the card once; their warps stride over the tiles.
  // The card's size is read once (the package runs on one kind of card).
  static int resident_blocks[2] = {0, 0};  // [border_delta != 0]
  int& cached = resident_blocks[border_delta != 0.0f];
  if (cached == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) {
      e = border_delta != 0.0f
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nms_bitmask_kernel<true>,
                                                              32 * kTileWarps, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nms_bitmask_kernel<false>,
                                                              32 * kTileWarps, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long wanted = (items + kTileWarps - 1) / kTileWarps;
  const int grid = static_cast<int>(wanted < cached ? wanted : cached);
  if (border_delta != 0.0f) {
    nms_bitmask_kernel<true><<<grid, 32 * kTileWarps, 0, st>>>(
        b, s, mask, n, k, words, iou_threshold, border_delta, half_ulp, fast);
  } else {
    nms_bitmask_kernel<false><<<grid, 32 * kTileWarps, 0, st>>>(
        b, s, mask, n, k, words, iou_threshold, border_delta, half_ulp, fast);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ring = ring_for(words, kSmemLimit);
  if (ring == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = scan_smem_bytes(words, ring);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<n, 32, smem, st>>>(s, mask, static_cast<uint8_t*>(keep), k, words, ring);
  return static_cast<int>(cudaGetLastError());
}

// Filter gradient of a 3x3 stride-1 SAME convolution, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `conv3x3_filter_grad`
// (jpeg_detection_resnet_ssd_tpu/ops/pallas_conv_grad.py, kernel
// `_filter_grad_kernel`).  Same function:
//
//     dW[kh, kw, c, k] = sum_{b,y,x} Xpad[b, y+kh, x+kw, c] * dY[b, y, x, k]
//
// for NHWC x (B, H, W, C) and dy (B, H, W, K), both float32 or both bf16,
// into a (3, 3, C, K) float32 result accumulated in float32.  The work is
// nine GEMMs D[c, k] = sum_p A[c, p] B[p, k] with P = B*H*W, A = X_tap^T and
// B = dY.  With more than one chunk of P ("split-P": a 128 -> 128 conv has
// only 9 output tiles of 128 x 128 for the card's 132 SMs), each block writes its partial
// tile to a float32 workspace (splits, 9, C, K) and a second kernel adds the
// splits in a fixed order, so the result does not change from run to run
// (no atomics).
//
// Bound.  2*9*P*C*K operations; the largest conv of the SSD train step at
// batch 32 (38x38, 256 -> 256) is 54.5 GFLOP, 55 us at the bf16 dense
// tensor-core rate of 989 TFLOP/s, while its bytes (x and dy once, dW once)
// take ~14 us at 3.35 TB/s: the bf16 case is bound by operations.  The
// float32 case runs on the CUDA cores (67 TFLOP/s), ~0.8 ms there.
//
// bf16: TMA + wgmma (`wgrad_bf16_kernel`).
//   * Both operands are read as they lie in memory, channel-contiguous
//     (MN-major for wgmma, trans-a = trans-b = 1): no transposing copy.
//   * The SAME padding and the tap shift come from TMA.  A 4-D tensor map
//     over x (C, W, H, B) with the 128-byte swizzle is loaded with a box of
//     (64 channels, w_box columns, rows, images) at (c0, kw-1, y0+kh-1, b0);
//     TMA fills every element outside the tensor, negative coordinates
//     included, with zero.  A map over dy loads the same box at (k0, 0, y0,
//     b0), its columns W..w_box-1 and rows past H zero too.  Both land in
//     shared memory as 128-byte rows in the same (image, y, x) order, so row
//     r of the x tile meets row r of the dy tile: a stage is S = w_box *
//     rows * images rows of P (a multiple of 16, wgmma's bf16 depth).  The
//     wrapper's plan (ops/conv_grad.py, `tiling_plan`) picks the box that
//     wastes the fewest rows: 38x38 maps take 2 images x 1 row x 40
//     columns, 10x10 maps 8 images of one row, so small maps are not
//     mostly zeros.
//   * A block owns a 128 x N (c, k) tile of one tap over one chunk of P.
//     One producer warp keeps a ring of 2-6 stages of TMA loads in flight
//     (mbarrier full/empty pairs); two consumer warpgroups each issue
//     wgmma.m64nNk16 on their 64 channels against the shared dy tile and
//     hand a stage back as soon as its products are done.  (Keeping one
//     stage's products in flight while the next is awaited holds a buffer
//     one stage longer: at N = 256 only three stages fit, and the ring then
//     runs one stage ahead instead of two, which measured slower.)
//     N follows K (K = 100 -> 104, 150 -> 152, 256 -> 256): a dy tile of N
//     columns is ceil(N / 64) boxes of 64 channels, LBO apart.
//   * Split-P is sized to one wave of 132 blocks (one block per SM: the
//     ring takes up to ~200 KB of shared memory).
//   * Accumulators go from registers to global memory; each thread stores
//     pairs of adjacent k.
// Left for later: a persistent grid (wave quantization at 72-108 blocks
// on some shapes) and a shared-memory epilogue.  (The three kw taps of one
// kh load the same dy boxes; TMA multicast of them across a cluster of the
// three was tried: faster where dy is narrow, K = 100 and 150, slower at
// K = 128 and 256, where clusters of three leave SMs idle.)
//
// float32: each block of 256 threads owns a 64 x 64 (c, k) tile of one tap
// over one chunk of P, stages 32 rows of P of x and dy in shared memory
// (scalar loads; the SAME padding is index arithmetic), and each thread
// accumulates a 4 x 4 block with explicit __fmaf_rn (the library is built
// with -fmad=false for the NMS kernel's bit-exactness, so nothing else would
// be fused; TF32 would round the inputs and change the result).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;
constexpr int kTileK = 64;
constexpr int kTileP = 32;
constexpr int kLdF = kTileC + 4;   // float rows: 272 bytes, float4-aligned
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMinRowsPerSplit = 1024;
constexpr int kMaxSplits = 64;

struct Problem {
  int B, H, W, C, K;
  long long P;
  long long chunk;  // rows of P per split, a multiple of kTileP
};

// Offsets of the x row and the dy row of each of the step's kTileP rows of
// P (-1: outside the image or past the chunk, reads as 0).
__device__ __forceinline__ void row_offsets(const Problem& pb, long long p0,
                                            long long p_end, int kh, int kw,
                                            long long* row_x, long long* row_d) {
  const int t = threadIdx.x;
  if (t < kTileP) {
    const long long p = p0 + t;
    long long ox = -1, od = -1;
    if (p < p_end) {
      const long long hw = static_cast<long long>(pb.H) * pb.W;
      const long long b = p / hw;
      const int r = static_cast<int>(p - b * hw);
      const int y = r / pb.W + kh - 1;
      const int x = r % pb.W + kw - 1;
      od = p * pb.K;
      if (y >= 0 && y < pb.H && x >= 0 && x < pb.W) {
        ox = ((b * pb.H + y) * pb.W + x) * pb.C;
      }
    }
    row_x[t] = ox;
    row_d[t] = od;
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ out, Problem pb) {
  __shared__ __align__(16) float xs[kTileP][kLdF];
  __shared__ __align__(16) float ds[kTileP][kLdF];
  __shared__ long long row_x[kTileP];
  __shared__ long long row_d[kTileP];

  const int tiles_c = (pb.C + kTileC - 1) / kTileC;
  const int c0 = (blockIdx.x % tiles_c) * kTileC;
  const int k0 = (blockIdx.x / tiles_c) * kTileK;
  const int tap = blockIdx.y;
  const int kh = tap / 3, kw = tap % 3;
  const long long p_begin = blockIdx.z * pb.chunk;
  const long long p_end = min(pb.P, p_begin + pb.chunk);

  const int t = threadIdx.x;
  const int tc = (t % 16) * 4;  // this thread's 4 c columns of the tile
  const int tk = (t / 16) * 4;  // and its 4 k columns
  float acc[4][4] = {};

  for (long long p0 = p_begin; p0 < p_end; p0 += kTileP) {
    row_offsets(pb, p0, p_end, kh, kw, row_x, row_d);
    __syncthreads();
    for (int i = t; i < kTileP * kTileC; i += kThreads) {
      const int r = i / kTileC, j = i % kTileC;
      const long long ox = row_x[r], od = row_d[r];
      xs[r][j] = (ox >= 0 && c0 + j < pb.C) ? x[ox + c0 + j] : 0.0f;
      ds[r][j] = (od >= 0 && k0 + j < pb.K) ? dy[od + k0 + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTileP; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][tc]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[r][tk]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* o = out + (static_cast<long long>(blockIdx.z) * 9 + tap) * pb.C * pb.K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tc + i;
    if (c >= pb.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tk + j;
      if (k < pb.K) o[static_cast<long long>(c) * pb.K + k] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.

constexpr int kBoxC = 64;          // channels per TMA box: 128 bytes, the swizzle's width
constexpr int kRowBytes = 128;     // one row of P of one box in shared memory
constexpr int kBlockC = 128;       // c rows per block: two consumer warpgroups of 64
constexpr int kConsumerWarps = 8;
constexpr int kBf16Threads = 32 * kConsumerWarps + 32;  // + one producer warp
constexpr int kMaxRing = 6;
constexpr int kMaxStageRows = 256;
constexpr int kSmemLimit = 227 * 1024;

// The tiling the wrapper's plan chose (ops/conv_grad.py, `tiling_plan`).
struct Bf16Tile {
  int C, K;          // true channel counts: the extent of dW
  int rows, images;  // the TMA box's rows and images (its columns: w_box)
  int h_groups;      // ceil(H / rows)
  int stages;        // stages along P: ceil(B / images) * h_groups
  int per_split;     // stages per chunk of P
  int ring;          // stages in the shared-memory ring
  int stage_rows;    // S = w_box * rows * images, a multiple of 16
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// has not ended after 2^28 tries (seconds; a stage takes microseconds)
// traps, so a fault in the pipeline fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 28)) __trap();
  } while (!done);
}

// One 4-D box of `map` at (c, x, y, b) into shared memory at `dst`; the
// bytes are counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled MN-major operand:
// 64 channels x 8 rows of P make one 1024-byte swizzle atom; `lbo` is the
// byte distance between 64-channel boxes (MN), the atoms of 8 rows of P lie
// 1024 bytes apart (SBO).  Every tile starts 1024-byte aligned (base offset 0).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// D[64 x N] += A[64 x 16] B[16 x N], bf16 in, float32 accumulate, both
// operands MN-major in shared memory (trans-a = trans-b = 1).  D's layout:
// d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<104> {
  static __device__ __forceinline__ void mma(float (&d)[52], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51"
        "}, %52, %53, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<152> {
  static __device__ __forceinline__ void mma(float (&d)[76], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75"
        "}, %76, %77, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int N>
__global__ void __launch_bounds__(kBf16Threads, 1)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
                  float* __restrict__ out, Bf16Tile t) {
  constexpr int kDyBoxes = (N + kBoxC - 1) / kBoxC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxRing];
  __shared__ __align__(8) uint64_t empty_bar[kMaxRing];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t box_bytes = t.stage_rows * kRowBytes;
  const uint32_t stage_bytes = (2 + kDyBoxes) * box_bytes;

  const int tiles_c = (t.C + kBlockC - 1) / kBlockC;
  const int c0 = (blockIdx.x % tiles_c) * kBlockC;
  const int k0 = (blockIdx.x / tiles_c) * N;
  const int tap = blockIdx.y;
  const int kh = tap / 3, kw = tap % 3;
  const int s_begin = blockIdx.z * t.per_split;
  const int n = max(0, min(t.stages, s_begin + t.per_split) - s_begin);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < t.ring; ++i) {
      mbar_init(smem_u32(&full_bar[i]), 1);
      mbar_init(smem_u32(&empty_bar[i]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % t.ring;
        mbar_wait(smem_u32(&empty_bar[s]), ((i / t.ring) & 1) ^ 1);
        const int u = s_begin + i;
        const int b0 = (u / t.h_groups) * t.images;
        const int y0 = (u % t.h_groups) * t.rows;
        const uint32_t dst = base + s * stage_bytes;
        const uint32_t bar = smem_u32(&full_bar[s]);
        mbar_expect_tx(bar, stage_bytes);  // a box counts whole, zero-filled parts too
        tma_load_4d(dst, &tm_x, bar, c0, kw - 1, y0 + kh - 1, b0);
        tma_load_4d(dst + box_bytes, &tm_x, bar, c0 + kBoxC, kw - 1, y0 + kh - 1, b0);
#pragma unroll
        for (int j = 0; j < kDyBoxes; ++j) {
          tma_load_4d(dst + (2 + j) * box_bytes, &tm_dy, bar, k0 + j * kBoxC, 0, y0, b0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;  // this warpgroup's 64 channels: c0 + 64 wg
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const int k16_steps = t.stage_rows / 16;
  for (int i = 0; i < n; ++i) {
    const int s = i % t.ring;
    mbar_wait(smem_u32(&full_bar[s]), (i / t.ring) & 1);
    const uint32_t a = base + s * stage_bytes + wg * box_bytes;
    const uint32_t b = base + s * stage_bytes + 2 * box_bytes;
    wgmma_fence();
    for (int j = 0; j < k16_steps; ++j) {  // 16 rows of P are 2048 bytes of each box
      Wgmma<N>::mma(acc, sw128_desc(a + j * 2048, box_bytes), sw128_desc(b + j * 2048, box_bytes));
    }
    wgmma_commit();
    wgmma_wait_all();  // the stage is read: hand its buffers back at once
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
  }

  float* o = out + (static_cast<size_t>(blockIdx.z) * 9 + tap) * t.C * t.K;
  const int row = c0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const bool pairs = (t.K % 2) == 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int k = k0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = row + 8 * h;
      if (c >= t.C || k >= t.K) continue;
      float* dst = o + static_cast<size_t>(c) * t.K + k;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        dst[0] = acc[4 * j + 2 * h];
        if (k + 1 < t.K) dst[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// out[i] = sum over s in order of work[s][i].
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ work, float* __restrict__ out,
                  long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = work[i];
  for (int z = 1; z < splits; ++z) s = __fadd_rn(s, work[z * n + i]);
  out[i] = s;
}

int sum_splits(const void* work, void* out, int c, int k, int splits, cudaStream_t st) {
  const long long n = 9LL * c * k;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sum_splits_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(work),
                                                 static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime so that
// this library needs no -lcuda; null if libcuda does not have it.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over an NHWC bf16 tensor with `ch` channels a pixel, read in
// boxes of (64 channels, w_box, rows, images) with the 128-byte swizzle;
// elements outside the tensor read as zero.
CUresult encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int ch, int w, int h,
                    int b, int w_box, int rows, int images) {
  const cuuint64_t row = 2ull * ch;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(ch), static_cast<cuuint64_t>(w),
                        static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3] = {row, row * w, row * w * h};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxC), static_cast<cuuint32_t>(w_box),
                       static_cast<cuuint32_t>(rows), static_cast<cuuint32_t>(images)};
  cuuint32_t element_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int N>
int launch_bf16(const CUtensorMap& mx, const CUtensorMap& mdy, float* dst, const Bf16Tile& t,
                dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_bf16_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_bf16_kernel<N><<<grid, kBf16Threads, smem, st>>>(mx, mdy, dst, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32: how many chunks of P the wrapper should split the sum into (the
// size of the workspace's leading axis); 1 means no workspace.
extern "C" int conv3x3_wgrad_splits(int b, int h, int w, int c, int k) {
  const long long p = static_cast<long long>(b) * h * w;
  const long long tiles =
      9LL * ((c + kTileC - 1) / kTileC) * ((k + kTileK - 1) / kTileK);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = p / kMinRowsPerSplit;
  if (splits > most) splits = most;
  if (splits > kMaxSplits) splits = kMaxSplits;
  return splits < 1 ? 1 : static_cast<int>(splits);
}

// float32.  Launches on `stream` and returns cudaGetLastError() (a refused
// launch never runs, and a later synchronise would not report it).  `work`
// is (splits, 3, 3, C, K) float32 when splits > 1, else it is `out`,
// (3, 3, C, K) float32.
extern "C" int conv3x3_wgrad_f32(const void* x, const void* dy, void* work, void* out,
                                 int b, int h, int w, int c, int k, int splits, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Problem pb;
  pb.B = b;
  pb.H = h;
  pb.W = w;
  pb.C = c;
  pb.K = k;
  pb.P = static_cast<long long>(b) * h * w;
  const long long per = (pb.P + splits - 1) / splits;
  pb.chunk = (per + kTileP - 1) / kTileP * kTileP;
  const dim3 grid(((c + kTileC - 1) / kTileC) * ((k + kTileK - 1) / kTileK), 9, splits);
  float* dst = static_cast<float*>(splits > 1 ? work : out);
  wgrad_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), dst, pb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return sum_splits(work, out, c, k, splits, st);
}

// bf16, with the plan of ops/conv_grad.py::tiling_plan.  x is (B, H, W,
// c_ld) and dy (B, H, W, k_ld), contiguous, 16-byte aligned, with c_ld and
// k_ld multiples of 8 (TMA's 16-byte strides); dW covers the first C and K
// channels.  `work` is (splits, 3, 3, C, K) float32 when splits > 1, else
// `out`.  Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a plan the kernel does not take,
// cudaErrorNotSupported when libcuda has no cuTensorMapEncodeTiled, and
// 10000 + the CUresult when it refuses a tensor map.
extern "C" int conv3x3_wgrad_bf16(const void* x, const void* dy, void* work, void* out,
                                  int b, int h, int w, int c, int k, int c_ld, int k_ld,
                                  int w_box, int rows, int images, int n_tile,
                                  int per_split, int splits, int ring, void* stream) {
  Bf16Tile t;
  t.C = c;
  t.K = k;
  t.rows = rows;
  t.images = images;
  t.stage_rows = w_box * rows * images;
  t.ring = ring;
  t.per_split = per_split;
  const int dy_boxes = (n_tile + kBoxC - 1) / kBoxC;
  const size_t smem = static_cast<size_t>(ring) * (2 + dy_boxes) * t.stage_rows * kRowBytes + 1024;
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || c > c_ld || k > k_ld || c_ld % 8 != 0 ||
      k_ld % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 || w_box < w || w_box > 256 || rows < 1 ||
      rows > 256 || images < 1 || images > 256 || t.stage_rows % 16 != 0 ||
      t.stage_rows > kMaxStageRows || ring < 2 || ring > kMaxRing || per_split < 1 ||
      smem > static_cast<size_t>(kSmemLimit) - 2 * kMaxRing * sizeof(uint64_t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.h_groups = (h + rows - 1) / rows;
  t.stages = ((b + images - 1) / images) * t.h_groups;
  if (splits != (t.stages + per_split - 1) / per_split) return static_cast<int>(cudaErrorInvalidValue);

  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mx, mdy;
  CUresult r = encode_map(encode, &mx, x, c_ld, w, h, b, w_box, rows, images);
  if (r == CUDA_SUCCESS) r = encode_map(encode, &mdy, dy, k_ld, w, h, b, w_box, rows, images);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(((c + kBlockC - 1) / kBlockC) * ((k + n_tile - 1) / n_tile), 9, splits);
  float* dst = static_cast<float*>(splits > 1 ? work : out);
  int err;
  switch (n_tile) {
    case 64: err = launch_bf16<64>(mx, mdy, dst, t, grid, smem, st); break;
    case 104: err = launch_bf16<104>(mx, mdy, dst, t, grid, smem, st); break;
    case 128: err = launch_bf16<128>(mx, mdy, dst, t, grid, smem, st); break;
    case 152: err = launch_bf16<152>(mx, mdy, dst, t, grid, smem, st); break;
    case 256: err = launch_bf16<256>(mx, mdy, dst, t, grid, smem, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(work, out, c, k, splits, st);
}

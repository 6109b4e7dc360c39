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
// into a (3, 3, C, K) float32 result accumulated in float32.
//
// Design.  The TPU kernel materialised three kw-shifted padded copies of x
// and walked batch chunks in order, keeping one (9, C, K) accumulator in
// VMEM.  Here the work is nine implicit GEMMs [C, P] x [P, K] with
// P = B*H*W: the SAME padding is index arithmetic on x (an out-of-image tap
// reads 0), nothing is copied.  A block of 256 threads owns one 64 x 64
// (c, k) tile of one tap over one chunk of P ("split-P" across gridDim.z:
// a 128 x 128 conv has only 36 tiles for the card's 132 SMs).  Per step it
// stages 32 rows of P of x and of dy in shared memory, then
//   * bf16: 8 warps multiply them on the tensor cores (WMMA 16x16x16, bf16
//     in, float32 accumulate; a product of two bf16 values is exact in
//     float32), each warp a 16 x 32 slice of the tile;
//   * float32: each thread accumulates a 4 x 4 block with explicit
//     __fmaf_rn (the library is built with -fmad=false for the NMS
//     kernel's bit-exactness, so nothing else would be fused; TF32 would
//     round the inputs and change the result).
// With more than one chunk, each block writes its partial tile to a
// float32 workspace (splits, 9, C, K) and a second kernel adds the splits
// in a fixed order, so the result does not change from run to run (no
// atomics).
//
// Bound.  2*9*P*C*K operations; the largest eligible conv of the SSD train
// step at batch 32 (38x38, 256 -> 256) is 54.5 GFLOP, 55 us at the bf16
// dense tensor-core rate of 989 TFLOP/s, while its bytes (x and dy once,
// dW once) take ~14 us at 3.35 TB/s: the bf16 case is bound by operations.
// The float32 case runs on the CUDA cores (67 TFLOP/s), ~0.8 ms there.
// This first version is simple: scalar global loads, one stage of shared
// memory, no TMA or wgmma; it reaches a fraction of either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;
constexpr int kTileK = 64;
constexpr int kTileP = 32;
constexpr int kLdF = kTileC + 4;   // float rows: 272 bytes, float4-aligned
constexpr int kLdH = kTileC + 8;   // bf16 rows: 144 bytes, WMMA-aligned
constexpr int kLdOut = kTileK + 4; // float32 epilogue rows
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

__global__ void __launch_bounds__(kThreads)
wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ dy,
                  float* __restrict__ out, Problem pb) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 xs[kTileP][kLdH];
  __shared__ __align__(128) __nv_bfloat16 ds[kTileP][kLdH];
  __shared__ __align__(128) float cs[kTileC][kLdOut];
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
  const int warp = t / 32;
  const int wc = (warp % 4) * 16;  // the warp's 16 c rows of the tile
  const int wk = (warp / 4) * 32;  // and its 32 k columns (two fragments)
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (long long p0 = p_begin; p0 < p_end; p0 += kTileP) {
    row_offsets(pb, p0, p_end, kh, kw, row_x, row_d);
    __syncthreads();
    for (int i = t; i < kTileP * kTileC; i += kThreads) {
      const int r = i / kTileC, j = i % kTileC;
      const long long ox = row_x[r], od = row_d[r];
      xs[r][j] = (ox >= 0 && c0 + j < pb.C) ? x[ox + c0 + j] : zero;
      ds[r][j] = (od >= 0 && k0 + j < pb.K) ? dy[od + k0 + j] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTileP; r += 16) {
      // A = X^T (c x p): xs holds it column-major; B = dY (p x k), row-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, &xs[r][wc], kLdH);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &ds[r][wk + 16 * f], kLdH);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(&cs[wc][wk], acc[0], kLdOut, wmma::mem_row_major);
  wmma::store_matrix_sync(&cs[wc][wk + 16], acc[1], kLdOut, wmma::mem_row_major);
  __syncthreads();
  float* o = out + (static_cast<long long>(blockIdx.z) * 9 + tap) * pb.C * pb.K;
  for (int i = t; i < kTileC * kTileK; i += kThreads) {
    const int c = c0 + i / kTileK, k = k0 + i % kTileK;
    if (c < pb.C && k < pb.K) o[static_cast<long long>(c) * pb.K + k] = cs[i / kTileK][i % kTileK];
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

}  // namespace

// How many chunks of P the wrapper should split the sum into (the size of
// the workspace's leading axis); 1 means no workspace.
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

// Launches on `stream` and returns cudaGetLastError() (a refused launch
// never runs, and a later synchronise would not report it).  dtype 0 is
// float32, 1 bf16.  `work` is (splits, 3, 3, C, K) float32 when splits > 1,
// else it is `out`, (3, 3, C, K) float32.
extern "C" int conv3x3_wgrad(const void* x, const void* dy, void* work, void* out,
                             int b, int h, int w, int c, int k, int splits,
                             int dtype, void* stream) {
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
  if (dtype == 0) {
    wgrad_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), dst, pb);
  } else if (dtype == 1) {
    wgrad_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), dst, pb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = 9LL * c * k;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sum_splits_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(work),
                                                 static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

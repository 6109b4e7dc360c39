// Coefficient-space horizontal flip of 8x8 DCT block maps for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_flip_h_pallas`
// (jpeg_detection_resnet_ssd_tpu/ops/dct_augment.py, reached through
// `dct_flip_horizontal(use_pallas=True)`).  Function, on a contiguous
// (N, W8, C) view of a (..., H8, W8, C) block map, C a multiple of 64:
//
//   out[n, w, c] = x[n, W8-1-w, c] * (-1)^(c mod 8 mod 2)
//
// A pixel-domain horizontal flip reverses the block columns and, inside
// each block, negates every odd column frequency v:
// cos((2(7-x)+1) v pi/16) = (-1)^v cos((2x+1) v pi/16).  The sign pattern
// repeats every 64 channels, so stacked components (CbCr as 128 channels)
// flip too; the Pallas kernel broadcasts 64 signs to (1, C) and only takes
// C == 64, this kernel takes any multiple of 64 (the function of the JAX
// package's `_flip_h_jnp`, which the device augmentation chain runs).
//
// Design.  One pass that moves every byte once: each thread copies 16 bytes
// (one uint4) from the mirrored block column, grid-stride over the output.
// A 16-byte vector starts at a channel index that is a multiple of 4
// (float32) or 8 (bfloat16), so its sign pattern is fixed: in float32 the
// 2nd and 4th values are odd frequencies; in bfloat16 every odd value is the
// high half of a 32-bit word.  The negation flips the sign bit, which is
// exact and gives -0.0 for 0.0 as the plain version's multiply by -1 does.
// Reads and writes are 16-byte and coalesced (neighbouring threads on
// neighbouring addresses within a block column).
//
// Bound.  2 * N * W8 * C * itemsize bytes (read once, write once): at the
// chain's float32 shapes 23.66 MB for the luma map (32, 38, 38, 64) and
// 11.83 MB for the chroma map (32, 19, 19, 128), 7.06 us and 3.53 us at
// 3.35 TB/s.  No arithmetic to speak of.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM; the rest strides
constexpr uint32_t kSign = 0x80000000u;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
dct_flip_h_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                  long long rows, int w8, int vecs) {
  const long long per_row = static_cast<long long>(w8) * vecs;
  const long long total = rows * per_row;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * kThreads) {
    const long long n = v / per_row;
    const int rem = static_cast<int>(v - n * per_row);
    const int w = rem / vecs;
    const int cv = rem - w * vecs;
    uint4 q = x[n * per_row + static_cast<long long>(w8 - 1 - w) * vecs + cv];
    if (kBf16) {
      q.x ^= kSign;
      q.y ^= kSign;
      q.z ^= kSign;
      q.w ^= kSign;
    } else {
      q.y ^= kSign;
      q.w ^= kSign;
    }
    out[v] = q;
  }
}

}  // namespace

// x, out: (rows, w8, channels) contiguous, 16-byte aligned; elem_bytes 4
// (float32) or 2 (bfloat16).  Launches on `stream` (a cudaStream_t) and
// returns cudaGetLastError().
extern "C" int dct_flip_h(const void* x, void* out, long long rows, int w8, int channels,
                          int elem_bytes, void* stream) {
  if (rows <= 0 || w8 <= 0) return 0;
  if (channels <= 0 || channels % 64 != 0 || (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs = channels * elem_bytes / 16;
  const long long total = rows * w8 * vecs;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* src = static_cast<const uint4*>(x);
  uint4* dst = static_cast<uint4*>(out);
  if (elem_bytes == 2) {
    dct_flip_h_kernel<true><<<static_cast<int>(blocks), kThreads, 0, s>>>(src, dst, rows, w8, vecs);
  } else {
    dct_flip_h_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(src, dst, rows, w8, vecs);
  }
  return static_cast<int>(cudaGetLastError());
}

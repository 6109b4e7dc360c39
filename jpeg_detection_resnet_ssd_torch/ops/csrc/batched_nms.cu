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
// Design.  The TPU kernel stacked problems along lanes and held (K, N)
// planes in VMEM.  Here one thread block owns one problem: its K boxes,
// areas, scores and keep flags live in shared memory (25 bytes a candidate,
// 10 KB at K = 400), and the block's threads stride over j.  Step i reads
// keep[i] after a barrier, so whether candidate i is alive is uniform across
// the block and the `continue` never splits a barrier.  Nothing touches
// device memory between the load and the final store.
//
// Bound.  At the serving shape (N = B*C = 640 at B = 32, K = 400) the work is
// at most N*K^2/2 = 51M pair tests of 16 f32 operations each, ~0.8 GFLOP on
// the CUDA cores (~12 us at 67 TFLOP/s), and the kernel moves ~5 MB (~1.6 us
// at 3.35 TB/s).  It is neither: it is latency-bound by the K block-wide
// barriers of the serial loop (each step is a handful of shared-memory reads
// per thread).  A later version can compute the IoU > threshold bitmask of
// all pairs in parallel first and leave only a short serial scan over
// 64-bit words per step.
//
// Bit-exactness.  Every operation is an IEEE round-to-nearest intrinsic, in
// the reference's order, and the library is built with -fmad=false, so no
// a*b+c is contracted into an FMA (which would change the last bit of the
// union and flip decisions at the threshold).  min/max propagate NaN like
// torch.minimum/maximum and jnp.minimum/maximum (fminf/fmaxf would not).
// The comparison is strict: iou > iou_threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// x != x holds only for NaN (no fast-math here); a + b is then NaN too.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__global__ void __launch_bounds__(kThreads)
batched_nms_mask_kernel(const float* __restrict__ boxes,   // (N, K, 4)
                        const float* __restrict__ scores,  // (N, K)
                        uint8_t* __restrict__ keep_out,    // (N, K)
                        int K, float iou_threshold, float d) {
  extern __shared__ float smem[];
  float* x0 = smem;
  float* y0 = x0 + K;
  float* x1 = y0 + K;
  float* y1 = x1 + K;
  float* area = y1 + K;
  float* score = area + K;
  uint8_t* keep = reinterpret_cast<uint8_t*>(score + K);

  const size_t problem = blockIdx.x;
  const float* b = boxes + problem * K * 4;
  const float* s = scores + problem * K;

  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float bx0 = b[4 * j + 0], by0 = b[4 * j + 1];
    const float bx1 = b[4 * j + 2], by1 = b[4 * j + 3];
    x0[j] = bx0;
    y0[j] = by0;
    x1[j] = bx1;
    y1[j] = by1;
    area[j] = __fmul_rn(__fadd_rn(__fsub_rn(bx1, bx0), d),
                        __fadd_rn(__fsub_rn(by1, by0), d));
    score[j] = s[j];
    keep[j] = 1;
  }

  for (int i = 0; i < K; ++i) {
    __syncthreads();
    if (!(keep[i] && score[i] > 0.0f)) continue;  // uniform across the block
    const float ix0 = x0[i], iy0 = y0[i], ix1 = x1[i], iy1 = y1[i];
    const float iarea = area[i];
    for (int j = i + 1 + threadIdx.x; j < K; j += blockDim.x) {
      const float iw = nan_max(
          0.0f, __fadd_rn(__fsub_rn(nan_min(x1[j], ix1), nan_max(x0[j], ix0)), d));
      const float ih = nan_max(
          0.0f, __fadd_rn(__fsub_rn(nan_min(y1[j], iy1), nan_max(y0[j], iy0)), d));
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area[j], iarea), inter);
      const float iou = __fdiv_rn(inter, nan_max(uni, 1e-12f));
      if (iou > iou_threshold) keep[j] = 0;
    }
  }
  __syncthreads();

  uint8_t* out = keep_out + problem * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    out[j] = (keep[j] && score[j] > 0.0f) ? 1 : 0;
  }
}

}  // namespace

// Bytes of shared memory one block needs for K candidates.
extern "C" int batched_nms_mask_smem_bytes(int k) {
  return k * (6 * static_cast<int>(sizeof(float)) + 1);
}

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): a
// refused launch never runs and a later synchronise would not report it.
extern "C" int batched_nms_mask(const void* boxes, const void* scores, void* keep,
                                int n, int k, float iou_threshold,
                                float border_delta, void* stream) {
  if (n == 0 || k == 0) return 0;
  const size_t smem = static_cast<size_t>(batched_nms_mask_smem_bytes(k));
  batched_nms_mask_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), k, iou_threshold, border_delta);
  return static_cast<int>(cudaGetLastError());
}

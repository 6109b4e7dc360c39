// Train-mode BatchNorm of NHWC activations for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's
// `BatchNorm(use_running_average=False)` to XLA, which fuses it.  On the
// card the port ran it as plain ops (a float32 copy, two means, a square,
// the variance, a subtract, a multiply, an add and a cast, each a kernel)
// and autograd added one or more kernels for each of their gradients:
// ~16 float32 launches a layer that moved ~140 bytes an element and saved
// two float32 copies of the input for the backward.
//
// Function, on a contiguous (M, C) view of a (B, H, W, C) input x (float32
// or bfloat16), every sum in float32:
//   forward   mean = sum(x) / M,  var = max(sum(x^2) / M - mean^2, 0)  (biased)
//             rstd = rsqrt(var + eps),  scale = rstd * gamma
//             y = (x - mean) * scale + beta, rounded once to x's type
//             running = running * (1 - f) + f * batch (mean, var) unless frozen
//   backward  dbeta = sum(dy),  dgamma = rstd * sum(dy * (x - mean))
//             dx = scale * ((dy - sum(dy) / M)
//                           - (x - mean) * keep * rstd^2 * sum(dy * (x - mean)) / M)
//             keep = 0 where sum(x^2) / M - mean^2 < 0 (the variance was
//             clipped: clamp_min passes no gradient there), else 1;
//             dx rounded once to x's type, dgamma and dbeta float32.
// Built with -fmad=false, so y takes the plain version's rounding at every
// step (subtract, multiply, add), given the same mean and scale.
//
// Design.  Each direction is two passes over the tensor with a small
// finalize launch between them:
//   reduce    a block covers a chunk of rows and a tile of channels; each
//             thread owns V channels (one 16-byte load: 8 bfloat16 or 4
//             float32) and walks its rows R apart, 2-4 loads in flight,
//             summing in float32 registers; lanes of a warp that share
//             channels are added by shuffles, the warps in shared memory,
//             in a fixed order, and the block writes one partial a channel.
//   finalize  sums the partials of a channel in row-block order (no float
//             atomics: two runs give the same bits), writes mean, rstd,
//             scale and keep (forward; with the running statistics and the
//             step counter) or dgamma, dbeta and dx's two coefficients.
//   map       the same tiling: y from x, or dx from x and dy.
// A warp reads whole rows, or 512 contiguous bytes of one, per load.  The
// grid fills the SMs once at the reduce kernel's occupancy, at least 4 row
// steps a block; a C that is no multiple of V, or an unaligned pointer,
// takes the scalar path (V = 1), whose lanes beyond C are masked.
// Saved for the backward: x and the (4, C) statistics.
// Data parallelism: bn_forward_sums / bn_forward_apply and bn_backward_sums
// / bn_backward_apply are the two halves of each direction, split where a
// rank's partials are summed a channel (and, forward, the row count put
// beside them), so the caller can all-reduce those totals over its data
// group before the finalize: every rank then normalises by the global
// batch's statistics.  dgamma and dbeta come from the rank's own totals,
// as autograd gives them through the plain version's all-reduce.
//
// Bound.  Bytes: forward reads x twice and writes y (6 bytes an element in
// bfloat16), backward reads x and dy twice and writes dx (10 bytes): 16
// bytes an element, 2.27 GB at the detector's largest BatchNorm input,
// (256, 38, 38, 384) in bfloat16 (0.254 ms forward, 0.424 ms backward at
// 3.35 TB/s); a few flops an element, far below that.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;      // channels a block's tile holds: 32 lanes x 8
constexpr int kFinalThreads = 256; // finalize: 32 channels x 8 row-block stripes
constexpr int kMinRowSteps = 4;
constexpr unsigned kFull = 0xffffffffu;

// Elements as floats; V values at element offset `off` of `base`.
template <bool kBf16>
struct Elem;

template <>
struct Elem<false> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const void* base, long long off, float* v, int n) {
    const float* p = static_cast<const float*>(base) + off;
    if (n == kVec) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      for (int i = 0; i < n; ++i) v[i] = p[i];
    }
  }
  __device__ __forceinline__ static void store(void* base, long long off, const float* v, int n) {
    float* p = static_cast<float*>(base) + off;
    if (n == kVec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < n; ++i) p[i] = v[i];
    }
  }
};

template <>
struct Elem<true> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static uint32_t bits(float v) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  __device__ __forceinline__ static void load(const void* base, long long off, float* v, int n) {
    const uint16_t* p = static_cast<const uint16_t*>(base) + off;
    if (n == kVec) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // little-endian: the even element is the low half
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
      for (int i = 0; i < n; ++i) v[i] = __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
    }
  }
  __device__ __forceinline__ static void store(void* base, long long off, const float* v, int n) {
    uint16_t* p = static_cast<uint16_t*>(base) + off;
    if (n == kVec) {
      uint4 q;
      q.x = bits(v[0]) | (bits(v[1]) << 16);
      q.y = bits(v[2]) | (bits(v[3]) << 16);
      q.z = bits(v[4]) | (bits(v[5]) << 16);
      q.w = bits(v[6]) | (bits(v[7]) << 16);
      *reinterpret_cast<uint4*>(p) = q;
    } else {
      for (int i = 0; i < n; ++i) p[i] = static_cast<uint16_t>(bits(v[i]));
    }
  }
};

// The rows [r0, r1) and the V channels from c0 that a thread owns.
struct Slice {
  long long r, r1;
  int c0, step;
  bool active;
};

__device__ __forceinline__ Slice slice_of(long long m, int c, int lanes, long long rows_per_block, int vec) {
  Slice s;
  const int lane = threadIdx.x & (lanes - 1);
  s.step = kThreads / lanes;
  s.c0 = (blockIdx.y * lanes + lane) * vec;
  s.active = s.c0 < c;
  const long long r0 = blockIdx.x * rows_per_block;
  s.r = r0 + threadIdx.x / lanes;
  s.r1 = r0 + rows_per_block < m ? r0 + rows_per_block : m;
  return s;
}

// Forward: a = sum x, b = sum x^2.  Backward: a = sum dy, b = sum dy * (x - mean).
// part: (2, rblocks, C) float32.
template <bool kBf16, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads, 2)
bn_reduce_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                 const float* __restrict__ stats, long long m, int c, int lanes,
                 long long rows_per_block, float* __restrict__ part) {
  using E = Elem<kBf16>;
  constexpr int U = kBwd ? 2 : 4;  // rows in flight a thread
  const Slice s = slice_of(m, c, lanes, rows_per_block, V);
  float a[V], b[V], mu[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = mu[i] = 0.0f;
  if (s.active) {
    if (kBwd) {
#pragma unroll
      for (int i = 0; i < V; ++i) mu[i] = stats[s.c0 + i];
    }
    long long r = s.r;
    for (; r + (U - 1) * s.step < s.r1; r += U * s.step) {
      float xv[U][V], gv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long off = (r + u * s.step) * c + s.c0;
        E::load(x, off, xv[u], V);
        if (kBwd) E::load(dy, off, gv[u], V);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (kBwd) {
            a[i] += gv[u][i];
            b[i] += gv[u][i] * (xv[u][i] - mu[i]);
          } else {
            a[i] += xv[u][i];
            b[i] += xv[u][i] * xv[u][i];
          }
        }
      }
    }
    for (; r < s.r1; r += s.step) {
      float xv[V], gv[V];
      const long long off = r * c + s.c0;
      E::load(x, off, xv, V);
      if (kBwd) E::load(dy, off, gv, V);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (kBwd) {
          a[i] += gv[i];
          b[i] += gv[i] * (xv[i] - mu[i]);
        } else {
          a[i] += xv[i];
          b[i] += xv[i] * xv[i];
        }
      }
    }
  }
  // Lanes lane, lane + lanes, ... of a warp own the same channels.
  for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] += __shfl_xor_sync(kFull, a[i], off);
      b[i] += __shfl_xor_sync(kFull, b[i], off);
    }
  }
  __shared__ float sh[2][kWarps][kMaxTile];
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  if (wl < lanes) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sh[0][warp][wl * V + i] = a[i];
      sh[1][warp][wl * V + i] = b[i];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int ch = blockIdx.y * lanes * V + t;
  if (t < lanes * V && ch < c) {
    float sa = sh[0][0][t], sb = sh[1][0][t];
    for (int w = 1; w < kWarps; ++w) {
      sa += sh[0][w][t];
      sb += sh[1][w][t];
    }
    part[blockIdx.x * static_cast<long long>(c) + ch] = sa;
    part[(gridDim.x + blockIdx.x) * static_cast<long long>(c) + ch] = sb;
  }
}

// Sums a channel's partials in row-block order: 8 stripes of 32 channels,
// then the stripes in order.  Returns (a, b) to thread (0, lane).
__device__ __forceinline__ bool sum_partials(const float* __restrict__ part, int rblocks, int c,
                                             float* a_out, float* b_out, int* ch_out) {
  __shared__ float sh[2][kFinalThreads / 32][32];
  const int lane = threadIdx.x & 31, stripe = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + lane;
  float a = 0.0f, b = 0.0f;
  if (ch < c) {
    for (int r = stripe; r < rblocks; r += kFinalThreads / 32) {
      a += part[static_cast<long long>(r) * c + ch];
      b += part[static_cast<long long>(rblocks + r) * c + ch];
    }
  }
  sh[0][stripe][lane] = a;
  sh[1][stripe][lane] = b;
  __syncthreads();
  if (stripe != 0 || ch >= c) return false;
  for (int k = 1; k < kFinalThreads / 32; ++k) {
    a += sh[0][k][lane];
    b += sh[1][k][lane];
  }
  *a_out = a;
  *b_out = b;
  *ch_out = ch;
  return true;
}

// stats: (4, C) mean, rstd, scale, keep.
// rows: the (global) row count as a float, or null for m.
__global__ void __launch_bounds__(kFinalThreads)
bn_finalize_forward_kernel(const float* __restrict__ part, int rblocks, long long m, int c,
                           const float* __restrict__ rows,
                           const float* __restrict__ weight, float eps, float* __restrict__ stats,
                           float* __restrict__ running_mean, float* __restrict__ running_var,
                           long long* __restrict__ num_batches, float factor, float keep_factor,
                           int update, int count) {
  if (count && blockIdx.x == 0 && threadIdx.x == 0) *num_batches += 1;
  float sa, sb;
  int ch;
  if (!sum_partials(part, rblocks, c, &sa, &sb, &ch)) return;
  const float n = rows ? *rows : static_cast<float>(m);
  const float mean = sa / n;
  const float raw = sb / n - mean * mean;
  const float var = raw > 0.0f ? raw : 0.0f;
  const float rstd = rsqrtf(var + eps);
  stats[ch] = mean;
  stats[c + ch] = rstd;
  stats[2 * c + ch] = rstd * weight[ch];
  stats[3 * c + ch] = raw >= 0.0f ? 1.0f : 0.0f;
  if (update) {
    running_mean[ch] = running_mean[ch] * keep_factor + factor * mean;
    running_var[ch] = running_var[ch] * keep_factor + factor * var;
  }
}

// coef: (2, C) sum(dy) / M and keep * rstd^2 * sum(dy * (x - mean)) / M;
// dweight and dbias unless null.
__global__ void __launch_bounds__(kFinalThreads)
bn_finalize_backward_kernel(const float* __restrict__ part, int rblocks, long long m, int c,
                            const float* __restrict__ rows, const float* __restrict__ stats,
                            float* __restrict__ dweight, float* __restrict__ dbias,
                            float* __restrict__ coef) {
  float sa, sb;
  int ch;
  if (!sum_partials(part, rblocks, c, &sa, &sb, &ch)) return;
  const float n = rows ? *rows : static_cast<float>(m);
  const float rstd = stats[c + ch];
  if (dweight) {
    dbias[ch] = sa;
    dweight[ch] = rstd * sb;
  }
  coef[ch] = sa / n;
  coef[c + ch] = stats[3 * c + ch] * (rstd * rstd) * (sb / n);
}

// A rank's totals: sums (2, C) from its partials; forward (stats null)
// sums[2C] = m, backward dbias and dweight from them.
__global__ void __launch_bounds__(kFinalThreads)
bn_sum_kernel(const float* __restrict__ part, int rblocks, long long m, int c,
              const float* __restrict__ stats, float* __restrict__ sums,
              float* __restrict__ dweight, float* __restrict__ dbias) {
  if (!stats && blockIdx.x == 0 && threadIdx.x == 0) sums[2 * c] = static_cast<float>(m);
  float sa, sb;
  int ch;
  if (!sum_partials(part, rblocks, c, &sa, &sb, &ch)) return;
  sums[ch] = sa;
  sums[c + ch] = sb;
  if (stats) {
    dbias[ch] = sa;
    dweight[ch] = stats[c + ch] * sb;
  }
}

// Forward: out = (x - mean) * scale + coef[ch] (beta).
// Backward: out = scale * ((dy - coef[ch]) - (x - mean) * coef[C + ch]).
template <bool kBwd, int V>
__device__ __forceinline__ void map_row(const float* xv, const float* gv, const float* mu,
                                        const float* sc, const float* k1, const float* k2,
                                        float* o) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    o[i] = kBwd ? sc[i] * ((gv[i] - k1[i]) - (xv[i] - mu[i]) * k2[i])
                : (xv[i] - mu[i]) * sc[i] + k1[i];
  }
}

template <bool kBf16, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
bn_map_kernel(const void* __restrict__ x, const void* __restrict__ dy,
              const float* __restrict__ stats, const float* __restrict__ coef,
              void* __restrict__ out, long long m, int c, int lanes, long long rows_per_block) {
  using E = Elem<kBf16>;
  constexpr int U = kBwd ? 2 : 4;
  const Slice s = slice_of(m, c, lanes, rows_per_block, V);
  if (!s.active) return;
  float mu[V], sc[V], k1[V], k2[V], o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = stats[s.c0 + i];
    sc[i] = stats[2 * c + s.c0 + i];
    k1[i] = coef[s.c0 + i];
    k2[i] = kBwd ? coef[c + s.c0 + i] : 0.0f;
  }
  long long r = s.r;
  for (; r + (U - 1) * s.step < s.r1; r += U * s.step) {
    float xv[U][V], gv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = (r + u * s.step) * c + s.c0;
      E::load(x, off, xv[u], V);
      if (kBwd) E::load(dy, off, gv[u], V);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      map_row<kBwd, V>(xv[u], gv[u], mu, sc, k1, k2, o);
      E::store(out, (r + u * s.step) * c + s.c0, o, V);
    }
  }
  for (; r < s.r1; r += s.step) {
    float xv[V], gv[V];
    const long long off = r * c + s.c0;
    E::load(x, off, xv, V);
    if (kBwd) E::load(dy, off, gv, V);
    map_row<kBwd, V>(xv, gv, mu, sc, k1, k2, o);
    E::store(out, off, o, V);
  }
}

struct Plan {
  int lanes, ctiles, rblocks;
  long long rows_per_block;
};

template <bool kBf16, int V>
int reduce_pass(bool bwd, const void* x, const void* dy, const float* stats, float* part,
                long long m, int c, const Plan& p, cudaStream_t s) {
  const dim3 grid(p.rblocks, p.ctiles);
  if (bwd) {
    bn_reduce_kernel<kBf16, V, true><<<grid, kThreads, 0, s>>>(
        x, dy, stats, m, c, p.lanes, p.rows_per_block, part);
  } else {
    bn_reduce_kernel<kBf16, V, false><<<grid, kThreads, 0, s>>>(
        x, nullptr, nullptr, m, c, p.lanes, p.rows_per_block, part);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, int V>
int map_pass(bool bwd, const void* x, const void* dy, const float* stats, const float* coef,
             void* out, long long m, int c, const Plan& p, cudaStream_t s) {
  const dim3 grid(p.rblocks, p.ctiles);
  if (bwd) {
    bn_map_kernel<kBf16, V, true><<<grid, kThreads, 0, s>>>(
        x, dy, stats, coef, out, m, c, p.lanes, p.rows_per_block);
  } else {
    bn_map_kernel<kBf16, V, false><<<grid, kThreads, 0, s>>>(
        x, nullptr, stats, coef, out, m, c, p.lanes, p.rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

// Finalize over `rblocks` partials (1 where part holds a rank's all-reduced
// totals, with the row count at rows), then the apply pass.
template <bool kBf16, int V>
int finish_forward(const void* x, const float* weight, const float* bias, float* running_mean,
                   float* running_var, long long* num_batches, void* y, float* stats,
                   const float* part, int rblocks, const float* rows, long long m, int c,
                   const Plan& p, float eps, float factor, float keep_factor, int update,
                   int count, cudaStream_t s) {
  bn_finalize_forward_kernel<<<(c + 31) / 32, kFinalThreads, 0, s>>>(
      part, rblocks, m, c, rows, weight, eps, stats, running_mean, running_var, num_batches,
      factor, keep_factor, update, count);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return map_pass<kBf16, V>(false, x, nullptr, stats, bias, y, m, c, p, s);
}

template <bool kBf16, int V>
int finish_backward(const void* x, const void* dy, const float* stats, void* dx, float* dweight,
                    float* dbias, float* coef, const float* part, int rblocks, const float* rows,
                    long long m, int c, const Plan& p, cudaStream_t s) {
  bn_finalize_backward_kernel<<<(c + 31) / 32, kFinalThreads, 0, s>>>(
      part, rblocks, m, c, rows, stats, dweight, dbias, coef);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  return map_pass<kBf16, V>(true, x, dy, stats, coef, dx, m, c, p, s);
}

template <bool kBf16, int V>
int launch_forward(const void* x, const float* weight, const float* bias, float* running_mean,
                   float* running_var, long long* num_batches, void* y, float* stats, float* part,
                   long long m, int c, const Plan& p, float eps, float factor, float keep_factor,
                   int update, int count, cudaStream_t s) {
  const int err = reduce_pass<kBf16, V>(false, x, nullptr, nullptr, part, m, c, p, s);
  if (err) return err;
  return finish_forward<kBf16, V>(x, weight, bias, running_mean, running_var, num_batches, y,
                                  stats, part, p.rblocks, nullptr, m, c, p, eps, factor,
                                  keep_factor, update, count, s);
}

template <bool kBf16, int V>
int launch_backward(const void* x, const void* dy, const float* stats, void* dx, float* dweight,
                    float* dbias, float* coef, float* part, long long m, int c, const Plan& p,
                    cudaStream_t s) {
  const int err = reduce_pass<kBf16, V>(true, x, dy, stats, part, m, c, p, s);
  if (err) return err;
  return finish_backward<kBf16, V>(x, dy, stats, dx, dweight, dbias, coef, part, p.rblocks,
                                   nullptr, m, c, p, s);
}

// A rank's totals: the reduce pass, then bn_sum_kernel.
template <bool kBf16, int V>
int launch_sums(const void* x, const void* dy, const float* stats, float* part, float* sums,
                float* dweight, float* dbias, long long m, int c, const Plan& p, cudaStream_t s) {
  const int err = reduce_pass<kBf16, V>(stats != nullptr, x, dy, stats, part, m, c, p, s);
  if (err) return err;
  bn_sum_kernel<<<(c + 31) / 32, kFinalThreads, 0, s>>>(part, p.rblocks, m, c, stats, sums,
                                                         dweight, dbias);
  return static_cast<int>(cudaGetLastError());
}

bool valid(long long m, int c, int elem_bytes, int vec) {
  if (m <= 0 || c <= 0 || (elem_bytes != 2 && elem_bytes != 4)) return false;
  return !vec || c % (16 / elem_bytes) == 0;
}

template <bool kBf16, int V>
cudaError_t occupancy(int* per_sm) {
  int fwd = 0, bwd = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fwd, bn_reduce_kernel<kBf16, V, false>, kThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bwd, bn_reduce_kernel<kBf16, V, true>, kThreads, 0);
  }
  *per_sm = fwd < bwd ? fwd : bwd;
  return err;
}

// F<kBf16, V>(...) for the element size and the load width.
#define BN_DISPATCH(elem_bytes, vec, F, ...)                                      \
  ((elem_bytes) == 2 ? ((vec) ? F<true, 8>(__VA_ARGS__) : F<true, 1>(__VA_ARGS__)) \
                     : ((vec) ? F<false, 4>(__VA_ARGS__) : F<false, 1>(__VA_ARGS__)))

}  // namespace

// The launch plan of an (m, c) problem: plan = {lanes, channel tiles, row
// blocks, rows a block}.  vec: 16-byte loads (c a multiple of 16 /
// elem_bytes, every pointer 16-byte aligned).  Lanes (a power of 2 up to
// 32) own a tile of channels; of 32, 16 and 8 lanes the one that leaves
// the fewest idle is taken where c needs more than 32 lanes.  Row blocks
// fill the SMs once at the reduce kernels' occupancy.
extern "C" int bn_plan(long long m, int c, int elem_bytes, int vec, long long* plan) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const int v = vec ? 16 / elem_bytes : 1;
  const int groups = (c + v - 1) / v;
  int lanes = 1;
  if (groups <= 32) {
    while (lanes < groups) lanes <<= 1;
  } else {
    int best_waste = INT_MAX;
    for (int cand = 32; cand >= 8; cand >>= 1) {
      const int waste = (groups + cand - 1) / cand * cand - groups;
      if (waste < best_waste) {
        best_waste = waste;
        lanes = cand;
      }
    }
  }
  const int ctiles = (groups + lanes - 1) / lanes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = BN_DISPATCH(elem_bytes, vec, occupancy, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int step = kThreads / lanes;
  const long long row_steps = (m + step - 1) / step;
  long long rblocks = (resident + ctiles - 1) / ctiles;
  const long long most = (row_steps + kMinRowSteps - 1) / kMinRowSteps;
  if (rblocks > most) rblocks = most;
  if (rblocks < 1) rblocks = 1;
  const long long rows = ((row_steps + rblocks - 1) / rblocks) * step;
  plan[0] = lanes;
  plan[1] = ctiles;
  plan[2] = (m + rows - 1) / rows;
  plan[3] = rows;
  return 0;
}

// x, y: (m, c) contiguous; weight, bias, running_mean, running_var, stats
// ((4, c)) float32; num_batches int64; part (2, plan[2], c) float32 scratch.
// update: move the running statistics by factor (keep_factor = 1 - factor);
// count: add 1 to num_batches.  Three launches on `stream`; returns the
// first launch error.
extern "C" int bn_forward(const void* x, const float* weight, const float* bias,
                          float* running_mean, float* running_var, long long* num_batches,
                          void* y, float* stats, float* part, long long m, int c, int elem_bytes,
                          int vec, const long long* plan, float eps, float factor,
                          float keep_factor, int update, int count, void* stream) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), static_cast<int>(plan[2]), plan[3]};
  return BN_DISPATCH(elem_bytes, vec, launch_forward, x, weight, bias, running_mean, running_var,
                     num_batches, y, stats, part, m, c, p, eps, factor, keep_factor, update, count,
                     static_cast<cudaStream_t>(stream));
}

// x, dy, dx: (m, c) contiguous (dx null: no input gradient, two launches);
// stats from bn_forward; dweight, dbias (c) and coef (2, c) float32; part
// as in bn_forward.  Returns the first launch error.
extern "C" int bn_backward(const void* x, const void* dy, const float* stats, void* dx,
                           float* dweight, float* dbias, float* coef, float* part, long long m,
                           int c, int elem_bytes, int vec, const long long* plan, void* stream) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), static_cast<int>(plan[2]), plan[3]};
  return BN_DISPATCH(elem_bytes, vec, launch_backward, x, dy, stats, dx, dweight, dbias, coef, part,
                     m, c, p, static_cast<cudaStream_t>(stream));
}

// The halves of bn_forward around an all-reduce of `sums` ((2C + 1) float32:
// sum x, sum x^2, the row count).  bn_forward_sums: the reduce pass and the
// rank's totals (two launches); bn_forward_apply: the finalize from `sums`
// as they stand (the global batch's once all-reduced) and the apply pass
// (two launches).  Arguments as in bn_forward.
extern "C" int bn_forward_sums(const void* x, float* part, float* sums, long long m, int c,
                               int elem_bytes, int vec, const long long* plan, void* stream) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), static_cast<int>(plan[2]), plan[3]};
  return BN_DISPATCH(elem_bytes, vec, launch_sums, x, nullptr, nullptr, part, sums, nullptr, nullptr,
                     m, c, p, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_forward_apply(const void* x, const float* weight, const float* bias,
                                float* running_mean, float* running_var, long long* num_batches,
                                void* y, float* stats, const float* sums, long long m, int c,
                                int elem_bytes, int vec, const long long* plan, float eps,
                                float factor, float keep_factor, int update, int count,
                                void* stream) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), static_cast<int>(plan[2]), plan[3]};
  return BN_DISPATCH(elem_bytes, vec, finish_forward, x, weight, bias, running_mean, running_var,
                     num_batches, y, stats, sums, 1, sums + 2 * static_cast<long long>(c), m, c, p,
                     eps, factor, keep_factor, update, count, static_cast<cudaStream_t>(stream));
}

// The halves of bn_backward around an all-reduce of `sums` ((2C) float32:
// sum dy, sum dy * (x - mean)).  bn_backward_sums: the reduce pass, the
// rank's totals and its dweight and dbias from them (two launches);
// bn_backward_apply: dx's coefficients from `sums` as they stand and
// `rows`, the global row count the forward's sums ended with (a device
// float), then the dx pass (two launches; one where dx is null).
extern "C" int bn_backward_sums(const void* x, const void* dy, const float* stats, float* dweight,
                                float* dbias, float* part, float* sums, long long m, int c,
                                int elem_bytes, int vec, const long long* plan, void* stream) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), static_cast<int>(plan[2]), plan[3]};
  return BN_DISPATCH(elem_bytes, vec, launch_sums, x, dy, stats, part, sums, dweight, dbias, m, c,
                     p, static_cast<cudaStream_t>(stream));
}

extern "C" int bn_backward_apply(const void* x, const void* dy, const float* stats, void* dx,
                                 float* coef, const float* sums, const float* rows, long long m,
                                 int c, int elem_bytes, int vec, const long long* plan,
                                 void* stream) {
  if (!valid(m, c, elem_bytes, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), static_cast<int>(plan[2]), plan[3]};
  return BN_DISPATCH(elem_bytes, vec, finish_backward, x, dy, stats, dx, nullptr, nullptr, coef,
                     sums, 1, rows, m, c, p, static_cast<cudaStream_t>(stream));
}

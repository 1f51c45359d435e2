// The training half of kernel family K1 (sm_90a): the align-corners
// upsample of os4 logits fused with the per-pixel softmax reductions that
// consume it.
//
// C. u2pl_upsample_ce_fwd / u2pl_upsample_ce_bwd replace
//    u2pl_tpu/losses/ce.py:cross_entropy_ignore (:23) applied to
//    u2pl_tpu/train/steps.py:_upsample (:69): the mean (optionally
//    class-weighted) CE over non-ignored pixels of the upsampled logits, and
//    its gradient to the os4 logits.
// D. u2pl_upsample_softmax_stats replaces the pseudo-label reductions of
//    u2pl_tpu/train/steps.py:300-301 (max-prob exp(max - logsumexp) and the
//    first-max argmax) and u2pl_tpu/losses/unsup.py:teacher_entropy (:24),
//    applied to the upsampled teacher logits.
//
// Inputs: os4 logits (B, C, h, w) f32, labels (B, H, W) int32, the tap tables
// of common.cuh.  One thread per output pixel computes its C upsampled
// logits on the fly, exactly as kernel A would write them, and reduces over
// them in registers: the (B, C, H, W) upsampled tensor (88 MB f32 at
// 4 x 21 x 513²) is never written by C's forward or by D.  Each pass over C
// re-evaluates the 4-tap lerps instead of keeping C values per thread (C is
// a runtime size): the re-reads hit L1/L2, and the kernels stay bound by the
// os4 reads and the per-pixel outputs.
//
// C's forward writes the per-pixel logsumexp for the backward and one
// (sum, weight) pair of doubles per block; a single-block kernel adds the
// pairs in a fixed order (two-stage, no float atomics, so the loss is the
// same bit for bit from run to run) and writes [loss, denom] on the device.
// The backward reads the upstream gradient from device memory (no host
// sync), writes the full-resolution gradient (softmax - onehot) * w * g /
// denom, and the wrapper reduces it to the os4 logits with kernel A-bwd.
// That (B, C, H, W) round trip through HBM is the simple route; fusing it
// into A-bwd is later work.

#include <math.h>

#include "common.cuh"

namespace {

using u2pl::blocks_for;
using u2pl::kThreads;

constexpr long long kReduceBlocks = 1024;  // partial sums of C's forward

__global__ void upsample_ce_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ labels,
    const float* __restrict__ cw, float* __restrict__ lse_out,
    double* __restrict__ part, const int* __restrict__ idx_h,
    const float* __restrict__ w_h, const int* __restrict__ idx_w,
    const float* __restrict__ w_w, int B, int C, int H, int W, int OH, int OW,
    int ignore) {
  __shared__ double s_sum[kThreads];
  __shared__ double s_w[kThreads];
  const unsigned total = (unsigned)B * OH * OW;
  const int plane = H * W;
  double acc = 0.0, acc_w = 0.0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ox = (int)(i % OW);
    const unsigned r = i / OW;
    const int oy = (int)(r % OH);
    const float* xp = x + (size_t)(r / OH) * C * plane;
    const u2pl::Taps t =
        u2pl::load_taps(idx_h, w_h, idx_w, w_w, W, OH, OW, oy, ox);
    const int y = labels[i];
    const bool valid = y != ignore && y >= 0 && y < C;
    float m = -INFINITY, vy = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float v = u2pl::upsampled(xp + (size_t)c * plane, t);
      m = fmaxf(m, v);
      if (c == y) vy = v;
    }
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
      s += expf(u2pl::upsampled(xp + (size_t)c * plane, t) - m);
    }
    const float lse = m + logf(s);
    lse_out[i] = lse;
    if (valid) {
      const float w = cw ? cw[y] : 1.0f;
      acc += (double)((lse - vy) * w);
      acc_w += (double)w;
    }
  }
  s_sum[threadIdx.x] = acc;
  s_w[threadIdx.x] = acc_w;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if ((int)threadIdx.x < stride) {
      s_sum[threadIdx.x] += s_sum[threadIdx.x + stride];
      s_w[threadIdx.x] += s_w[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s_sum[0];
    part[gridDim.x + blockIdx.x] = s_w[0];
  }
}

// stats = [loss, denom]: the JAX normalisation, sum / max(denom, floor) where
// denom > 0 and 0 otherwise (floor 1 for the plain count, 1e-12 weighted)
__global__ void upsample_ce_finalize_kernel(const double* __restrict__ part,
                                            int nparts, float floor_,
                                            float* __restrict__ stats) {
  __shared__ double s_sum[kThreads];
  __shared__ double s_w[kThreads];
  double a = 0.0, b = 0.0;
  for (int j = threadIdx.x; j < nparts; j += blockDim.x) {
    a += part[j];
    b += part[nparts + j];
  }
  s_sum[threadIdx.x] = a;
  s_w[threadIdx.x] = b;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if ((int)threadIdx.x < stride) {
      s_sum[threadIdx.x] += s_sum[threadIdx.x + stride];
      s_w[threadIdx.x] += s_w[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float denom = (float)s_w[0];
    const float sum = (float)s_sum[0];
    stats[0] = denom > 0.0f ? sum / fmaxf(denom, floor_) : 0.0f;
    stats[1] = denom;
  }
}

__global__ void upsample_ce_bwd_kernel(
    const float* __restrict__ x, const int* __restrict__ labels,
    const float* __restrict__ cw, const float* __restrict__ lse,
    const float* __restrict__ stats, const float* __restrict__ gout,
    float* __restrict__ gfull, const int* __restrict__ idx_h,
    const float* __restrict__ w_h, const int* __restrict__ idx_w,
    const float* __restrict__ w_w, int B, int C, int H, int W, int OH, int OW,
    int ignore, float floor_) {
  const unsigned total = (unsigned)B * OH * OW;
  const unsigned out_plane = (unsigned)OH * OW;
  const int plane = H * W;
  const float denom = stats[1];
  const float scale = denom > 0.0f ? gout[0] / fmaxf(denom, floor_) : 0.0f;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ox = (int)(i % OW);
    const unsigned r = i / OW;
    const int oy = (int)(r % OH);
    const unsigned b = r / OH;
    const float* xp = x + (size_t)b * C * plane;
    float* gp = gfull + (size_t)b * C * out_plane + (size_t)oy * OW + ox;
    const int y = labels[i];
    const bool valid = y != ignore && y >= 0 && y < C;
    const float coef = valid ? (cw ? cw[y] : 1.0f) * scale : 0.0f;
    if (coef == 0.0f) {
      for (int c = 0; c < C; ++c) gp[(size_t)c * out_plane] = 0.0f;
      continue;
    }
    const u2pl::Taps t =
        u2pl::load_taps(idx_h, w_h, idx_w, w_w, W, OH, OW, oy, ox);
    const float l = lse[i];
    for (int c = 0; c < C; ++c) {
      const float p = expf(u2pl::upsampled(xp + (size_t)c * plane, t) - l);
      gp[(size_t)c * out_plane] = coef * (c == y ? p - 1.0f : p);
    }
  }
}

__global__ void upsample_softmax_stats_kernel(
    const float* __restrict__ x, float* __restrict__ maxprob,
    int* __restrict__ argmax, float* __restrict__ entropy,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w, int B, int C,
    int H, int W, int OH, int OW) {
  const unsigned total = (unsigned)B * OH * OW;
  const int plane = H * W;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ox = (int)(i % OW);
    const unsigned r = i / OW;
    const int oy = (int)(r % OH);
    const float* xp = x + (size_t)(r / OH) * C * plane;
    const u2pl::Taps t =
        u2pl::load_taps(idx_h, w_h, idx_w, w_w, W, OH, OW, oy, ox);
    float m = 0.0f;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      const float v = u2pl::upsampled(xp + (size_t)c * plane, t);
      // first maximum; a NaN counts as the maximum, the first NaN wins
      // (jnp.argmax / torch.argmax, as kernel B)
      if (c == 0 || (m == m && (v > m || v != v))) {
        m = v;
        arg = c;
      }
    }
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
      s += expf(u2pl::upsampled(xp + (size_t)c * plane, t) - m);
    }
    // steps.py:300: exp(max - logsumexp), logsumexp = max + log(sum)
    maxprob[i] = expf(m - (m + logf(s)));
    argmax[i] = arg;
    // unsup.py:24-27: -sum p log(p + 1e-10), p = exp(v - max) / sum
    float e = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float p =
          expf(u2pl::upsampled(xp + (size_t)c * plane, t) - m) / s;
      e += p * logf(p + 1e-10f);
    }
    entropy[i] = -e;
  }
}

}  // namespace

extern "C" {

// part: 2 * u2pl_upsample_ce_parts() doubles; stats: 2 floats [loss, denom]
int u2pl_upsample_ce_parts(void) { return (int)kReduceBlocks; }

int u2pl_upsample_ce_fwd(const void* x, const void* labels, const void* cw,
                         void* lse, void* part, void* stats, const void* idx_h,
                         const void* w_h, const void* idx_w, const void* w_w,
                         int B, int C, int H, int W, int OH, int OW,
                         int ignore, float floor_, void* stream) {
  const long long total = (long long)B * OH * OW;
  // a fixed grid: the per-block partial sums, and so the loss, do not
  // depend on anything but the shapes
  const int blocks = (int)kReduceBlocks;
  if (total > 0) {
    upsample_ce_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)labels, (const float*)cw, (float*)lse,
        (double*)part, (const int*)idx_h, (const float*)w_h,
        (const int*)idx_w, (const float*)w_w, B, C, H, W, OH, OW, ignore);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    upsample_ce_finalize_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)part, blocks, floor_, (float*)stats);
  }
  return (int)cudaGetLastError();
}

int u2pl_upsample_ce_bwd(const void* x, const void* labels, const void* cw,
                         const void* lse, const void* stats, const void* gout,
                         void* gfull, const void* idx_h, const void* w_h,
                         const void* idx_w, const void* w_w, int B, int C,
                         int H, int W, int OH, int OW, int ignore,
                         float floor_, void* stream) {
  const long long total = (long long)B * OH * OW;
  if (total > 0) {
    upsample_ce_bwd_kernel<<<blocks_for(total), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)x, (const int*)labels, (const float*)cw,
        (const float*)lse, (const float*)stats, (const float*)gout,
        (float*)gfull, (const int*)idx_h, (const float*)w_h,
        (const int*)idx_w, (const float*)w_w, B, C, H, W, OH, OW, ignore,
        floor_);
  }
  return (int)cudaGetLastError();
}

int u2pl_upsample_softmax_stats(const void* x, void* maxprob, void* argmax,
                                void* entropy, const void* idx_h,
                                const void* w_h, const void* idx_w,
                                const void* w_w, int B, int C, int H, int W,
                                int OH, int OW, void* stream) {
  const long long total = (long long)B * OH * OW;
  if (total > 0) {
    upsample_softmax_stats_kernel<<<blocks_for(total), kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)x, (float*)maxprob, (int*)argmax, (float*)entropy,
        (const int*)idx_h, (const float*)w_h, (const int*)idx_w,
        (const float*)w_w, B, C, H, W, OH, OW);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

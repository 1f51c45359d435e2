// Kernel family K7 (sm_90a): the hard-example mining of the OHEM
// cross-entropy that every Cityscapes config trains with (criterion.type:
// ohem).  Replaces u2pl_tpu/losses/ohem.py:ohem_cross_entropy (:56) around
// its k-th smallest (:35, kernel E's radix descent in quantile.cu):
//
//   u2pl_ohem_target_prob  ohem.py:66-75: the softmax probability p_y of the
//       target class of each pixel of the upsampled logits, 1.0 at ignored
//       pixels, and the count of valid pixels;
//   u2pl_ohem_keep_labels  ohem.py:76-82: threshold = max(f32 thresh, kth),
//       apply = num_valid > 0 && min_kept <= num_valid, and the labels of
//       the kept pixels (valid and, when applied, p_y <= threshold), every
//       other pixel ignored.
//
// The CE over the kept labels is then kernel C (upsample_ce.cu), whose
// backward is the OHEM backward: no gradient flows through the threshold.
//
// ohem_target_prob is kernel C's forward without the loss: one thread per
// output pixel evaluates its C upsampled logits on the fly from the os4 (or
// os8) logits and the tap tables (common.cuh), so the (B, C, H, W)
// upsampled tensor (90 MB per head at 2 x 19 x 769²) is never written.  It
// is bound by the logits' reads and the labels' read and p_y's write; the
// count of valid pixels is one integer atomic per warp and one per block,
// exact whatever the order.  p_y = exp(x_y - max) / sum_c exp(x_c - max),
// the softmax's own formula (ohem.py:71-72).  A label outside [0, C) that is
// not the ignore label counts as ignored here and in kernel C.
// ohem_keep_labels reads the threshold's inputs (kth, num_valid) from device
// memory, so nothing is read back to the host; it is one pass over the
// labels and p_y.

#include <math.h>

#include "common.cuh"

namespace {

using u2pl::blocks_for;
using u2pl::kThreads;

__global__ void ohem_target_prob_kernel(
    const float* __restrict__ x, const int* __restrict__ labels,
    float* __restrict__ p_out, unsigned* __restrict__ num_valid,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w, int B, int C,
    int H, int W, int OH, int OW, int ignore) {
  __shared__ unsigned block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  const unsigned total = (unsigned)B * OH * OW;
  const int plane = H * W;
  unsigned count = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int y = labels[i];
    float p = 1.0f;
    if (y != ignore && y >= 0 && y < C) {
      const int ox = (int)(i % OW);
      const unsigned r = i / OW;
      const int oy = (int)(r % OH);
      const float* xp = x + (size_t)(r / OH) * C * plane;
      const u2pl::Taps t =
          u2pl::load_taps(idx_h, w_h, idx_w, w_w, W, OH, OW, oy, ox);
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
      p = expf(vy - m) / s;
      ++count;
    }
    p_out[i] = p;
  }
  // every thread of the block reaches here: the grid-stride loop has ended
  count = __reduce_add_sync(0xFFFFFFFFu, count);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(&block_count, count);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(num_valid, block_count);
}

__global__ void ohem_keep_labels_kernel(
    const int* __restrict__ labels, const float* __restrict__ p_y,
    const float* __restrict__ kth, const unsigned* __restrict__ num_valid,
    int* __restrict__ out, unsigned n, float thresh, int min_kept,
    int ignore) {
  // jnp.maximum: a NaN k-th value propagates (and then keeps nothing)
  const float k = kth[0];
  const float threshold = (k > thresh || k != k) ? k : thresh;
  const unsigned nv = num_valid[0];
  const bool apply = nv > 0 && (long long)min_kept <= (long long)nv;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int y = labels[i];
    const bool kept = !apply || p_y[i] <= threshold;
    out[i] = (y != ignore && kept) ? y : ignore;
  }
}

}  // namespace

extern "C" {

// num_valid: one zeroed int32 on the device; p_y (B, OH, OW) f32
int u2pl_ohem_target_prob(const void* x, const void* labels, void* p_y,
                          void* num_valid, const void* idx_h, const void* w_h,
                          const void* idx_w, const void* w_w, int B, int C,
                          int H, int W, int OH, int OW, int ignore,
                          void* stream) {
  const long long total = (long long)B * OH * OW;
  if (total > 0) {
    ohem_target_prob_kernel<<<blocks_for(total), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const float*)x, (const int*)labels, (float*)p_y,
        (unsigned*)num_valid, (const int*)idx_h, (const float*)w_h,
        (const int*)idx_w, (const float*)w_w, B, C, H, W, OH, OW, ignore);
  }
  return (int)cudaGetLastError();
}

// kth: one f32 and num_valid one int32, both on the device
int u2pl_ohem_keep_labels(const void* labels, const void* p_y, const void* kth,
                          const void* num_valid, void* out, int n,
                          float thresh, int min_kept, int ignore,
                          void* stream) {
  if (n > 0) {
    ohem_keep_labels_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const int*)labels, (const float*)p_y, (const float*)kth,
        (const unsigned*)num_valid, (int*)out, (unsigned)n, thresh, min_kept,
        ignore);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

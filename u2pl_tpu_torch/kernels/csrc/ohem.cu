// Kernel family K7 (sm_90a): the hard-example mining of the OHEM
// cross-entropy that every Cityscapes config trains with (criterion.type:
// ohem).  Replaces u2pl_tpu/losses/ohem.py:ohem_cross_entropy (:56) around
// its k-th smallest (:35, kernel E's radix descent in quantile.cu):
//
//   u2pl_ohem_target_prob  ohem.py:66-75: the softmax probability p_y of the
//       target class of each pixel of the upsampled logits, 1.0 at ignored
//       pixels, and the count of valid pixels: a mode of kernel D's staged
//       kernel (upsample_ce.cu, kStatsTargetProb), as C's forward is;
//   u2pl_ohem_keep_labels  ohem.py:76-82: threshold = max(f32 thresh, kth),
//       apply = num_valid > 0 && min_kept <= num_valid, and the labels of
//       the kept pixels (valid and, when applied, p_y <= threshold), every
//       other pixel ignored.
//
// The CE over the kept labels is then kernel C (upsample_ce.cu), whose
// backward is the OHEM backward: no gradient flows through the threshold.
//
// ohem_keep_labels reads the threshold's inputs (kth, num_valid) from device
// memory, so nothing is read back to the host; it is one pass over the
// labels and p_y.

#include <math.h>

#include "common.cuh"

namespace {

using u2pl::blocks_for;
using u2pl::kThreads;

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

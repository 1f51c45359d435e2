// Kernel K3 (sm_90a): the box modes of the unlabeled batch's strong
// augmentation; replaces u2pl_tpu/ops/mixing.py:generate_unsup_data (:62)
// with _cutout_box_mask (:30) for mode 'cutmix' and 'cutout'.
//
// One pass over image (B, 3, H, W) f32, pseudo-label (B, H, W) int32 and
// max-prob (B, H, W) f32, given the (B, 4) int32 box table (y0, x0, h, w)
// drawn beforehand (ops/mixing.py:draw_boxes); one thread per pixel handles
// the three channels, the label and the max-prob.
//   cutmix: inside sample i's box take sample (i+1) % B's pixel, elsewhere
//           keep its own.  A select: for finite inputs it gives the values
//           of JAX's x * m + nxt * (1 - m) blend (mixing.py:98-104), where one
//           of the two products is an exact 0.
//   cutout: inside the box image and max-prob are multiplied by 0 (as JAX's
//           data * mask, so a negative value gives -0.0, as there) and the
//           label becomes `ignore`.
// Bound by bytes: each input element is read once and each output written
// once (~25 MB at 4 x 513²); the partner's pixel is a second read only
// inside the box.

#include "common.cuh"

namespace {

using u2pl::blocks_for;
using u2pl::kThreads;

__global__ void unsup_mix_boxes_kernel(
    const float* __restrict__ img, const int* __restrict__ lab,
    const float* __restrict__ prob, const int* __restrict__ boxes,
    float* __restrict__ img_out, int* __restrict__ lab_out,
    float* __restrict__ prob_out, int B, int CI, int H, int W, int cutout,
    int ignore) {
  const unsigned hw = (unsigned)H * W;
  const unsigned total = (unsigned)B * hw;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned p = i % hw;
    const int b = (int)(i / hw);
    const int y = (int)(p / W), x = (int)(p % W);
    const int* box = boxes + 4 * b;
    const bool inside =
        y >= box[0] && y < box[0] + box[2] && x >= box[1] && x < box[1] + box[3];
    const size_t img_base = (size_t)b * CI * hw + p;
    if (cutout) {
      const float m = inside ? 0.0f : 1.0f;
      for (int c = 0; c < CI; ++c) {
        img_out[img_base + (size_t)c * hw] = img[img_base + (size_t)c * hw] * m;
      }
      lab_out[i] = inside ? ignore : lab[i];
      prob_out[i] = prob[i] * m;
    } else {
      const int src = inside ? (b + 1) % B : b;
      const size_t j = (size_t)src * hw + p;
      const size_t src_base = (size_t)src * CI * hw + p;
      for (int c = 0; c < CI; ++c) {
        img_out[img_base + (size_t)c * hw] = img[src_base + (size_t)c * hw];
      }
      lab_out[i] = lab[j];
      prob_out[i] = prob[j];
    }
  }
}

}  // namespace

extern "C" {

int u2pl_unsup_mix_boxes(const void* img, const void* lab, const void* prob,
                         const void* boxes, void* img_out, void* lab_out,
                         void* prob_out, int B, int CI, int H, int W,
                         int cutout, int ignore, void* stream) {
  const long long total = (long long)B * H * W;
  if (total > 0) {
    unsup_mix_boxes_kernel<<<blocks_for(total), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)img, (const int*)lab, (const float*)prob,
        (const int*)boxes, (float*)img_out, (int*)lab_out, (float*)prob_out, B,
        CI, H, W, cutout, ignore);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// Kernels K3 and K3c (sm_90a): the unlabeled batch's strong augmentation;
// replace u2pl_tpu/ops/mixing.py:generate_unsup_data (:62) with
// _cutout_box_mask (:30) for mode 'cutmix' and 'cutout' (K3), and with
// _class_half_mask (:44) for mode 'classmix' (K3c).
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
//
// K3c, classmix: sample i keeps its pixels whose (clipped) pseudo-label is in
// a random half (n_present // 2) of the classes present in its map, and takes
// sample (i+1) % B's pixel elsewhere.  The (B, C) f32 draws u are inputs (JAX:
// uniform(split(k_mix, B)[i], (C,))).  Two launches:
//   class_presence: per sample a u64 bitmask of the classes of
//     clip(label, 0, C - 1) (JAX clips before marking, so 255 counts as class
//     C - 1): shared-memory flags, one atomicOr per block and sample;
//   unsup_class_mix: each block first ranks every sample's present classes
//     by their draws (rank of c = #{present c': u[c'] < u[c], or u[c'] = u[c]
//     and c' < c}, the stable double argsort of mixing.py:55-57) into a u64
//     selection per sample in shared memory, then blends as K3's cutmix does
//     with `selected[clip(label)]` in place of the box test.
// Bound by bytes as K3, plus one more read of the labels.

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

constexpr int kMaxMixClasses = 64;  // the presence and selection bitmasks are u64
constexpr int kMaxMixBatch = 64;

__device__ __forceinline__ int clip_class(int v, int C) {
  return v < 0 ? 0 : (v > C - 1 ? C - 1 : v);
}

// grid (tiles, B): bit c of present[b] set when some pixel of sample b has
// clip(label, 0, C-1) == c
__global__ void class_presence_kernel(const int* __restrict__ lab, int HW,
                                      int C,
                                      unsigned long long* __restrict__ present) {
  __shared__ unsigned long long s_bits;
  if (threadIdx.x == 0) s_bits = 0ull;
  __syncthreads();
  const int b = blockIdx.y;
  const int* l = lab + (size_t)b * HW;
  unsigned long long mine = 0ull;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < HW;
       p += gridDim.x * blockDim.x) {
    mine |= 1ull << clip_class(l[p], C);
  }
  if (mine) atomicOr(&s_bits, mine);
  __syncthreads();
  if (threadIdx.x == 0 && s_bits) atomicOr(&present[b], s_bits);
}

__global__ void unsup_class_mix_kernel(
    const float* __restrict__ img, const int* __restrict__ lab,
    const float* __restrict__ prob, const float* __restrict__ u,
    const unsigned long long* __restrict__ present,
    float* __restrict__ img_out, int* __restrict__ lab_out,
    float* __restrict__ prob_out, int B, int CI, int H, int W, int C) {
  __shared__ unsigned long long s_sel[kMaxMixBatch];
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_sel[b] = 0ull;
  __syncthreads();
  for (int j = threadIdx.x; j < B * C; j += blockDim.x) {
    const int b = j / C, c = j - b * C;
    const unsigned long long pres = present[b];
    if ((pres >> c) & 1ull) {
      const float uc = u[j];
      int rank = 0;
      for (int d = 0; d < C; ++d) {
        if ((pres >> d) & 1ull) {
          const float ud = u[b * C + d];
          rank += (ud < uc) || (ud == uc && d < c);
        }
      }
      if (rank < __popcll(pres) / 2) atomicOr(&s_sel[b], 1ull << c);
    }
  }
  __syncthreads();
  const unsigned hw = (unsigned)H * W;
  const unsigned total = (unsigned)B * hw;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const unsigned p = i % hw;
    const int b = (int)(i / hw);
    const bool keep = (s_sel[b] >> clip_class(lab[i], C)) & 1ull;
    const int src = keep ? b : (b + 1) % B;
    const size_t j = (size_t)src * hw + p;
    const size_t img_base = (size_t)b * CI * hw + p;
    const size_t src_base = (size_t)src * CI * hw + p;
    for (int c = 0; c < CI; ++c) {
      img_out[img_base + (size_t)c * hw] = img[src_base + (size_t)c * hw];
    }
    lab_out[i] = lab[j];
    prob_out[i] = prob[j];
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

// present: (B,) u64 scratch, zeroed by the caller
int u2pl_unsup_class_mix(const void* img, const void* lab, const void* prob,
                         const void* u, void* present, void* img_out,
                         void* lab_out, void* prob_out, int B, int CI, int H,
                         int W, int C, void* stream) {
  if (B <= 0 || B > kMaxMixBatch || C <= 0 || C > kMaxMixClasses)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)H * W;
  if (hw <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(u2pl::blocks_for(hw, 256), B);
  class_presence_kernel<<<grid, kThreads, 0, s>>>(
      (const int*)lab, (int)hw, C, (unsigned long long*)present);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unsup_class_mix_kernel<<<blocks_for(B * hw), kThreads, 0, s>>>(
      (const float*)img, (const int*)lab, (const float*)prob, (const float*)u,
      (const unsigned long long*)present, (float*)img_out, (int*)lab_out,
      (float*)prob_out, B, CI, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// uniform(split(k_mix, B)[i], (C,))); JAX clips the labels before marking
// them present, so 255 counts as class C - 1.  The first design (a
// torch.zeros of the presence words, a presence pass, and a blend whose
// ~4,100 blocks each ranked every sample's classes again, a % and a / per
// pixel) took 0.0378 / 0.0381 ms at (4, 3, 513²) with 21 classes / (2, 3,
// 769²) with 19 on an NVIDIA H100 80GB HBM3 at 700 W (timing_ab.py).  This
// design is one cooperative launch (below): the labels read once into
// shared memory, one grid barrier, the selection once per block, and a
// position-major blend that reads every input once: 0.0233 / 0.0303 ms on
// that card.  Bound by bytes as K3 (0.0126 / 0.0141 ms); the launch, the
// presence pass, the barrier and the selection take ~0.0097 (a cut-short
// build), the blend ~0.0136 at the flagship's shape, ~93% of its bytes'
// rate (PERF.md).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
constexpr int kMixThreads = 512;
constexpr int kMixMaxShared = 80 * 1024;  // a block's: two blocks an SM

__device__ __forceinline__ int clip_class(int v, int C) {
  return v < 0 ? 0 : (v > C - 1 ? C - 1 : v);
}

// One cooperative launch (the host's plan: ops/mixing.py:_classmix_plan):
// block g owns the positions [g * span, (g + 1) * span) of the H x W plane,
// in every sample, a thread per position (coalesced in every plane).
//   1. presence: the block stages the (B, C) draws in shared memory, reads
//      its labels once (all B samples), keeps those of its first `held`
//      positions in shared memory, ORs 1 << clip(label, 0, C - 1) per sample
//      through warp reductions into shared words, and those into the grid's
//      B u64 words (`present`, in kernels.tickets) with one atomicOr per
//      block and sample;
//   2. grid.sync();
//   3. selection: every block ranks each sample's present classes by their
//      draws, a thread per (b, c): rank of c = #{present c': u[c'] < u[c], or
//      u[c'] = u[c] and c' < c}, the stable double argsort of mixing.py:
//      55-57; c is kept when rank < n_present // 2 (a u64 per sample in
//      shared memory);
//   4. blend, position by position: the thread walks the samples in order,
//      each sample's image, max-prob and label loaded once and held in
//      registers as sample b's own pixel and sample b - 1's partner pixel
//      (sample 0's kept for sample B - 1), so every input element is read
//      once whatever the classes kept (a pixel-major walk, own or partner
//      per lane, fetches both samples' sectors where the kept classes are
//      scattered);
//   the last block to read `present` (a ticket, taken between steps 3 and 4)
//   zeroes it.
// Dynamic shared memory: the (B, C) draws, then the held labels
// ([b][position - first]).
constexpr int kMixBatch = 2;  // positions a thread walks at once

// a pixel's values at one position: its channels, max-prob and label
template <int kCI>  // image channels, or 0: CI at run time
struct MixPixel {
  float v[kCI > 0 ? kCI : 1];
  float p;
  int l;
};

template <int kCI>
__device__ __forceinline__ void mix_load(MixPixel<kCI>& x, const float* __restrict__ img,
                                         const float* __restrict__ prob, int L, int b,
                                         unsigned HW, unsigned pos) {
#pragma unroll
  for (int ch = 0; ch < kCI; ++ch) x.v[ch] = img[((size_t)b * kCI + ch) * HW + pos];
  x.p = prob[(size_t)b * HW + pos];
  x.l = L;
}

template <int kCI>  // image channels, or 0: CI at run time (then read in place)
__global__ void __launch_bounds__(kMixThreads, 2) unsup_class_mix_kernel(
    const float* __restrict__ img, const int* __restrict__ lab,
    const float* __restrict__ prob, const float* __restrict__ u,
    float* __restrict__ img_out, int* __restrict__ lab_out, float* __restrict__ prob_out,
    unsigned long long* __restrict__ present, unsigned* __restrict__ ticket, int B, int CI_rt,
    unsigned HW, int C, unsigned span, unsigned held) {
  extern __shared__ float mix_smem[];
  float* s_u = mix_smem;  // B * C draws
  int* s_lab = reinterpret_cast<int*>(mix_smem + B * C);  // B x held labels
  __shared__ unsigned long long s_pres[kMaxMixBatch], s_sel[kMaxMixBatch];
  cg::grid_group grid = cg::this_grid();
  const int CI = kCI > 0 ? kCI : CI_rt;
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned p0 = (unsigned)min((unsigned long long)blockIdx.x * span,
                                    (unsigned long long)HW);
  const unsigned p1 = HW - p0 < span ? HW : p0 + span;
  const unsigned h1 = min(p1, p0 + held);
  // label of sample b at position p of the block
  auto label = [&](int b, unsigned p) {
    return p - p0 < held ? s_lab[b * held + (p - p0)] : lab[(size_t)b * HW + p];
  };
  if (tid < B) {
    s_pres[tid] = 0ull;
    s_sel[tid] = 0ull;
  }
  for (int j = tid; j < B * C; j += kMixThreads) s_u[j] = u[j];
  for (unsigned p = p0 + tid; p < h1; p += kMixThreads) {
#pragma unroll 4
    for (int b = 0; b < B; ++b) s_lab[b * held + (p - p0)] = lab[(size_t)b * HW + p];
  }
  __syncthreads();
  for (int b = 0; b < B; ++b) {  // block-uniform
    unsigned long long acc = 0ull;
    for (unsigned p = p0 + tid; p < p1; p += kMixThreads) acc |= 1ull << clip_class(label(b, p), C);
    const unsigned lo = __reduce_or_sync(0xFFFFFFFFu, (unsigned)acc);
    const unsigned hi = __reduce_or_sync(0xFFFFFFFFu, (unsigned)(acc >> 32));
    if (lane == 0 && (lo | hi)) atomicOr(&s_pres[b], ((unsigned long long)hi << 32) | lo);
  }
  __syncthreads();
  if (tid < B && s_pres[tid]) atomicOr(present + tid, s_pres[tid]);
  grid.sync();

  if (tid < B) s_pres[tid] = __ldcg(present + tid);
  __syncthreads();
  for (int j = tid; j < B * C; j += kMixThreads) {
    const int sb = j / C, c = j - sb * C;
    const unsigned long long pres = s_pres[sb];
    if ((pres >> c) & 1ull) {
      const float uc = s_u[j];
      int rank = 0;
      for (int d = 0; d < C; ++d) {
        const float ud = s_u[sb * C + d];
        rank += ((pres >> d) & 1ull) && ((ud < uc) || (ud == uc && d < c));
      }
      if (rank < __popcll(pres) / 2) atomicOr(&s_sel[sb], 1ull << c);
    }
  }
  __syncthreads();
  // every thread of the block has read `present`; the last block to get
  // here zeroes it (its warp 0 waits on the ticket, the others blend)
  if (tid == 0 && atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1) {
    for (int i = 0; i < B; ++i) present[i] = 0ull;
  }

  for (unsigned q0 = p0 + tid; q0 < p1; q0 += kMixBatch * kMixThreads) {
    if constexpr (kCI > 0) {
      MixPixel<kCI> first[kMixBatch], cur[kMixBatch];
#pragma unroll
      for (int i = 0; i < kMixBatch; ++i) {
        const unsigned q = q0 + i * kMixThreads;
        if (q < p1) mix_load(first[i], img, prob, label(0, q), 0, HW, q);
        cur[i] = first[i];
      }
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        const int bn = b + 1 == B ? 0 : b + 1;
        const unsigned long long sel = s_sel[b];
#pragma unroll
        for (int i = 0; i < kMixBatch; ++i) {
          const unsigned q = q0 + i * kMixThreads;
          if (q >= p1) continue;
          MixPixel<kCI> nxt = first[i];
          if (bn != 0) mix_load(nxt, img, prob, label(bn, q), bn, HW, q);
          const bool keep = (sel >> clip_class(cur[i].l, C)) & 1ull;
#pragma unroll
          for (int ch = 0; ch < kCI; ++ch) {
            img_out[((size_t)b * kCI + ch) * HW + q] = keep ? cur[i].v[ch] : nxt.v[ch];
          }
          prob_out[(size_t)b * HW + q] = keep ? cur[i].p : nxt.p;
          lab_out[(size_t)b * HW + q] = keep ? cur[i].l : nxt.l;
          cur[i] = nxt;
        }
      }
    } else {  // any channel count: the chosen sample's pixel read in place
      for (unsigned q = q0; q < min(p1, q0 + kMixBatch * kMixThreads); q += kMixThreads) {
        int L = label(0, q);
        const int L0 = L;
        for (int b = 0; b < B; ++b) {
          const int bn = b + 1 == B ? 0 : b + 1;
          const int Ln = bn == 0 ? L0 : label(bn, q);
          const bool keep = (s_sel[b] >> clip_class(L, C)) & 1ull;
          const int src = keep ? b : bn;
          for (int ch = 0; ch < CI; ++ch) {
            img_out[((size_t)b * CI + ch) * HW + q] = img[((size_t)src * CI + ch) * HW + q];
          }
          prob_out[(size_t)b * HW + q] = prob[(size_t)src * HW + q];
          lab_out[(size_t)b * HW + q] = keep ? L : Ln;
          L = Ln;
        }
      }
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

// the plan (ops/mixing.py:_classmix_plan): `grid` co-resident blocks of
// kMixThreads threads, `span` positions each; in smem bytes of shared memory
// the (B, C) draws and the labels of the first `held` positions (every
// sample's); ticket: 1 + 2 * kMaxMixBatch zeroed u32 words of
// kernels.tickets (a ticket, then the u64 presence words, 8-aligned), left
// zero.  A grid that cannot be co-resident is refused with an error before
// the launch.
int u2pl_unsup_class_mix(const void* img, const void* lab, const void* prob, const void* u,
                         void* ticket, void* img_out, void* lab_out, void* prob_out, int B,
                         int CI, int H, int W, int C, int grid, int span, int held, int smem,
                         void* stream) {
  const long long hw = (long long)H * W;
  if (B <= 0 || B > kMaxMixBatch || C <= 0 || C > kMaxMixClasses || CI <= 0 || H <= 0 ||
      W <= 0 || hw * B >= (1ll << 32) || grid <= 0 || span <= 0 || held < 0 || held > span ||
      (long long)grid * span < hw || smem != 4 * B * (C + held) || smem > kMixMaxShared ||
      ((uintptr_t)ticket + 4) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // the image's 3 channels at compile time: each sample's pixel loaded once
  // into registers; other counts read the chosen pixel in place
  const auto kernel = CI == 3 ? unsup_class_mix_kernel<3> : unsup_class_mix_kernel<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMixThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float *pi = (const float*)img, *pp = (const float*)prob, *pu = (const float*)u;
  const int* pl = (const int*)lab;
  float *oi = (float*)img_out, *op = (float*)prob_out;
  int* ol = (int*)lab_out;
  unsigned* tk = (unsigned*)ticket;
  unsigned long long* pres = (unsigned long long*)(tk + 1);
  unsigned uhw = (unsigned)hw, us = (unsigned)span, uh = (unsigned)held;
  void* args[] = {&pi, &pl, &pp, &pu, &oi, &ol, &op, &pres, &tk, &B, &CI, &uhw, &C, &us, &uh};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kMixThreads), args,
                                          (size_t)smem, (cudaStream_t)stream);
}

}  // extern "C"

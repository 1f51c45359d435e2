// Align-corners bilinear resize kernels (sm_90a).
//
// A. u2pl_resize_bilinear_ac replaces u2pl_tpu/ops/resize.py:resize_bilinear
//    (kernel family K1): (B, C, H, W) f32 -> (B, C, OH, OW) f32.  On the TPU
//    it was two dense interpolation matmuls on the MXU; here each output
//    element is a 4-tap gather.
// A-bwd. u2pl_resize_bilinear_ac_bwd is its adjoint (the VJP XLA derives
//    from the two einsums): (B, C, OH, OW) f32 -> (B, C, H, W) f32.
// B. u2pl_resize_argmax_ac replaces the host-side resize + argmax of
//    u2pl_tpu/serving.py:InferEngine.to_mask (resize_bilinear_numpy, then
//    argmax(-1)): one image's (C, H, W) f32 logits -> (OH, OW) uint8 labels.
//
// All three are bound by device-memory bytes, not arithmetic (4 taps and 3
// lerps per output value).  The simple design: one thread per output pixel
// in a grid-stride loop, the fastest thread index along the output row, so a
// warp's stores are contiguous and its loads fall on a few neighbouring
// input rows that L1/L2 serve after the first touch.  Kernel B keeps the
// per-class values in registers: it reads the logits once and writes one
// byte per pixel, where the unfused path writes and re-reads an
// (OH, OW, C) f32 intermediate.
//
// A-bwd is in gather form: one thread per INPUT element sums the output rows
// and columns whose taps reach it, so no two threads write one address and
// no float atomics are needed; the gradient is the same bit for bit from run
// to run.  The rows reaching input row i are those with lo[o] in {i-1, i},
// contiguous because lo is non-decreasing; the host passes them as
// [start[0..H), end[0..H)] per axis.  The W reduction runs before the H one,
// as in the einsum VJP.  For a 4x upsample each input element reads ~7x7
// output values, which L1 mostly serves.
//
// Taps and index widths: see common.cuh.  Index arithmetic is 32-bit
// unsigned (the wrappers refuse tensors of 2^31 elements or more, and a
// grid-stride step is below 2^25): 64-bit division is a long instruction
// sequence on the GPU, and the first version of kernel A, with 64-bit
// indices, ran at 0.159 ms for (4, 21, 129, 129) -> 513² on an H100 80GB
// HBM3 at 700 W.

#include "common.cuh"

namespace {

using u2pl::blocks_for;
using u2pl::kThreads;
using u2pl::lerp2;

__global__ void resize_bilinear_ac_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w,
    int planes, int H, int W, int OH, int OW) {
  const unsigned total = (unsigned)planes * OH * OW;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ox = (int)(i % OW);
    const unsigned r = i / OW;
    const int oy = (int)(r % OH);
    const float* xp = x + (size_t)(r / OH) * H * W;
    const u2pl::Taps t =
        u2pl::load_taps(idx_h, w_h, idx_w, w_w, W, OH, OW, oy, ox);
    y[i] = u2pl::upsampled(xp, t);
  }
}

// weight of output index o on input index i: the dense matrix entry
// (lo == hi only at a clamped edge, where frac == 0)
__device__ __forceinline__ float tap_weight(const int* __restrict__ idx,
                                            const float* __restrict__ w, int n,
                                            int o, int i) {
  float v = 0.0f;
  if (idx[o] == i) v = w[o];
  if (idx[n + o] == i) v = __fadd_rn(v, w[n + o]);
  return v;
}

__global__ void resize_bilinear_ac_bwd_kernel(
    const float* __restrict__ gy, float* __restrict__ gx,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ rng_h, const int* __restrict__ idx_w,
    const float* __restrict__ w_w, const int* __restrict__ rng_w, int planes,
    int H, int W, int OH, int OW) {
  const unsigned total = (unsigned)planes * H * W;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ix = (int)(i % W);
    const unsigned r = i / W;
    const int iy = (int)(r % H);
    const float* g = gy + (size_t)(r / H) * OH * OW;
    const int oy0 = rng_h[iy], oy1 = rng_h[H + iy];
    const int ox0 = rng_w[ix], ox1 = rng_w[W + ix];
    float acc = 0.0f;
    for (int oy = oy0; oy < oy1; ++oy) {
      const float wy = tap_weight(idx_h, w_h, OH, oy, iy);
      const float* row = g + (size_t)oy * OW;
      float s = 0.0f;
      for (int ox = ox0; ox < ox1; ++ox) {
        s = __fadd_rn(s, __fmul_rn(tap_weight(idx_w, w_w, OW, ox, ix), row[ox]));
      }
      acc = __fadd_rn(acc, __fmul_rn(wy, s));
    }
    gx[i] = acc;
  }
}

__global__ void resize_argmax_ac_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ out,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w,
    int C, int H, int W, int OH, int OW) {
  const unsigned total = (unsigned)OH * OW;
  const int plane = H * W;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ox = (int)(i % OW);
    const int oy = (int)(i / OW);
    const u2pl::Taps t =
        u2pl::load_taps(idx_h, w_h, idx_w, w_w, W, OH, OW, oy, ox);
    float best = 0.0f;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      const float v = u2pl::upsampled(x + (size_t)c * plane, t);
      // strict '>' keeps the first maximum (np.argmax / torch.argmax); a
      // NaN counts as the maximum and the first NaN wins, as in both.
      if (c == 0 || (best == best && (v > best || v != v))) {
        best = v;
        arg = c;
      }
    }
    out[i] = (uint8_t)arg;
  }
}

}  // namespace

extern "C" {

int u2pl_resize_bilinear_ac(const void* x, void* y, const void* idx_h,
                            const void* w_h, const void* idx_w, const void* w_w,
                            int planes, int H, int W, int OH, int OW,
                            void* stream) {
  const long long total = (long long)planes * OH * OW;
  if (total > 0) {
    resize_bilinear_ac_kernel<<<blocks_for(total), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, (const int*)idx_h, (const float*)w_h,
        (const int*)idx_w, (const float*)w_w, planes, H, W, OH, OW);
  }
  return (int)cudaGetLastError();
}

int u2pl_resize_bilinear_ac_bwd(const void* gy, void* gx, const void* idx_h,
                                const void* w_h, const void* rng_h,
                                const void* idx_w, const void* w_w,
                                const void* rng_w, int planes, int H, int W,
                                int OH, int OW, void* stream) {
  const long long total = (long long)planes * H * W;
  if (total > 0) {
    resize_bilinear_ac_bwd_kernel<<<blocks_for(total), kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)gy, (float*)gx, (const int*)idx_h, (const float*)w_h,
        (const int*)rng_h, (const int*)idx_w, (const float*)w_w,
        (const int*)rng_w, planes, H, W, OH, OW);
  }
  return (int)cudaGetLastError();
}

int u2pl_resize_argmax_ac(const void* x, void* out, const void* idx_h,
                          const void* w_h, const void* idx_w, const void* w_w,
                          int C, int H, int W, int OH, int OW, void* stream) {
  const long long total = (long long)OH * OW;
  if (total > 0) {
    resize_argmax_ac_kernel<<<blocks_for(total), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const float*)x, (uint8_t*)out, (const int*)idx_h, (const float*)w_h,
        (const int*)idx_w, (const float*)w_w, C, H, W, OH, OW);
  }
  return (int)cudaGetLastError();
}

const char* u2pl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

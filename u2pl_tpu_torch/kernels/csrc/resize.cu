// Align-corners bilinear resize kernels of the serving path (sm_90a).
//
// A. u2pl_resize_bilinear_ac replaces u2pl_tpu/ops/resize.py:resize_bilinear
//    (kernel family K1): (B, C, H, W) f32 -> (B, C, OH, OW) f32.  On the TPU
//    it was two dense interpolation matmuls on the MXU; here each output
//    element is a 4-tap gather.
// B. u2pl_resize_argmax_ac replaces the host-side resize + argmax of
//    u2pl_tpu/serving.py:InferEngine.to_mask (resize_bilinear_numpy, then
//    argmax(-1)): one image's (C, H, W) f32 logits -> (OH, OW) uint8 labels.
//
// Both are bound by device-memory bytes, not arithmetic (4 taps and 3 lerps
// per output value).  The simple design: one thread per output pixel in a
// grid-stride loop, the fastest thread index along the output row, so a
// warp's stores are contiguous and its loads fall on a few neighbouring
// input rows that L1/L2 serve after the first touch.  Kernel B keeps the
// per-class values in registers: it reads the logits once and writes one
// byte per pixel, where the unfused path writes and re-reads an
// (OH, OW, C) f32 intermediate.
//
// The per-axis taps (lo, hi indices; w_lo = 1 - frac, w_hi = frac, both
// f32) come from the host, built with the f64 source-coordinate formula of
// u2pl_tpu/ops/resize.py:_interp_matrix_np; layout idx = [lo[0..n), hi[0..n)],
// w = [w_lo[0..n), w_hi[0..n)].  The H pass runs before the W pass, as in
// the JAX einsum order, and every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), like the separate products
// and adds of the dense matmul.  Index arithmetic is 32-bit unsigned (the
// wrappers refuse tensors of 2^31 elements or more, and a grid-stride step
// is below 2^25): 64-bit division is a long instruction sequence on the
// GPU, and the first version of kernel A, with 64-bit indices, ran at 0.159
// ms for (4, 21, 129, 129) -> 513² on an H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

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
    const int h0 = idx_h[oy] * W, h1 = idx_h[OH + oy] * W;
    const int c0 = idx_w[ox], c1 = idx_w[OW + ox];
    const float a = w_h[oy], b = w_h[OH + oy];
    const float t0 = lerp2(a, xp[h0 + c0], b, xp[h1 + c0]);
    const float t1 = lerp2(a, xp[h0 + c1], b, xp[h1 + c1]);
    y[i] = lerp2(w_w[ox], t0, w_w[OW + ox], t1);
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
    const int h0 = idx_h[oy] * W, h1 = idx_h[OH + oy] * W;
    const int c0 = idx_w[ox], c1 = idx_w[OW + ox];
    const float a = w_h[oy], b = w_h[OH + oy];
    const float p = w_w[ox], q = w_w[OW + ox];
    float best = 0.0f;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      const float* xp = x + (size_t)c * plane;
      const float t0 = lerp2(a, xp[h0 + c0], b, xp[h1 + c0]);
      const float t1 = lerp2(a, xp[h0 + c1], b, xp[h1 + c1]);
      const float v = lerp2(p, t0, q, t1);
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

int blocks_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)(blocks < 1 ? 1 : blocks);
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

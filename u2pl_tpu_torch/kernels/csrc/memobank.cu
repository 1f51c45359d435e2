// Kernel K5 (sm_90a): the memory bank's ring write, fused with the gather of
// the selected keys; replaces u2pl_tpu/memobank.py: enqueue_segments (:92),
// enqueue (:78) and _enqueue_one (:50), together with the key gather
// `new_keys = rep_t_f[sel_idx]` of u2pl_tpu/losses/contrastive.py:259.
//
// The JAX step writes a (C, K, F) slab of gathered keys, then scatters its
// valid rows into the ring.  Here one warp takes one selected row: it reads
// the pixel's F features straight from the teacher's NCHW representation
// (8 per lane, stride h*w), rounds them to the storage type (round to
// nearest even, as astype does), and writes them as one contiguous row of
// the ring, a 16-byte store per lane, at (ptr + rank) % size.  A class's
// write is at most two contiguous segments of the ring (the wrap) with
// lengths known only on the device, which a TPU DMA could not express.
// Only the newest `size` ranks are written when a call brings more, so every
// ring row is written at most once.  A one-warp launch then moves ptr and
// occupancy.  Nothing syncs with the host.
//
// Bound: memory.  At the flagship cap (21 classes x 8192 keys x 256 f32
// features read, bf16 written): <= 176 MB read, 88 MB written, ~79 us at
// 3.35 TB/s; the read is a strided gather of whole 32-byte sectors.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

__global__ void mb_write_kernel(const float* __restrict__ rep,
                                const int* __restrict__ sel_idx,
                                const int* __restrict__ n_sel,
                                void* __restrict__ keys,
                                const int* __restrict__ ptr,
                                const int* __restrict__ sizes, int F, int HW,
                                int K, int cap, int dtype) {
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_new = min(n_sel[c], K);
  const int size = sizes[c];
  const int p0 = ptr[c];
  for (int r = blockIdx.x * kWarps + warp; r < n_new; r += gridDim.x * kWarps) {
    if (r < n_new - size) continue;  // overwritten within this call
    const int pix = sel_idx[(size_t)c * K + r];
    const int b = pix / HW;
    const float* src = rep + (size_t)b * F * HW + (pix - b * HW);
    const size_t row = (size_t)c * cap + (p0 + r) % size;
    for (int f0 = lane * 8; f0 < F; f0 += 256) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = src[(size_t)(f0 + i) * HW];
      if (dtype == 1) {
        uint4 o;
        o.x = pack_bf16x2(v[0], v[1]);
        o.y = pack_bf16x2(v[2], v[3]);
        o.z = pack_bf16x2(v[4], v[5]);
        o.w = pack_bf16x2(v[6], v[7]);
        reinterpret_cast<uint4*>((__nv_bfloat16*)keys + row * F + f0)[0] = o;
      } else {
        float4* dst = reinterpret_cast<float4*>((float*)keys + row * F + f0);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

__global__ void mb_update_kernel(const int* __restrict__ n_sel, int* __restrict__ ptr,
                                 int* __restrict__ occ,
                                 const int* __restrict__ sizes, int C, int K) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int n_new = min(n_sel[c], K);
    ptr[c] = (ptr[c] + n_new) % sizes[c];
    occ[c] = min(occ[c] + n_new, sizes[c]);
  }
}

}  // namespace

extern "C" {

int u2pl_memobank_enqueue(const void* rep, const void* sel_idx,
                          const void* n_sel, void* keys, void* ptr, void* occ,
                          const void* sizes, int B, int F, int HW, int C, int K,
                          int cap, int dtype, void* stream) {
  if (B <= 0 || F <= 0 || F % 8 || HW <= 0 || C <= 0 || K <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((K + kWarps - 1) / kWarps, C);
  mb_write_kernel<<<grid, kWarps * 32, 0, s>>>(
      (const float*)rep, (const int*)sel_idx, (const int*)n_sel, keys,
      (const int*)ptr, (const int*)sizes, F, HW, K, cap, dtype);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mb_update_kernel<<<1, 32, 0, s>>>((const int*)n_sel, (int*)ptr, (int*)occ,
                                    (const int*)sizes, C, K);
  return (int)cudaGetLastError();
}

}  // extern "C"

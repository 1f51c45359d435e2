// Kernel K5 (sm_90a): the memory bank's ring write, fused with the gather of
// the selected keys; replaces u2pl_tpu/memobank.py: enqueue_segments (:92),
// enqueue (:78) and _enqueue_one (:50), together with the key gather
// `new_keys = rep_t_f[sel_idx]` of u2pl_tpu/losses/contrastive.py:259.
//
// The JAX step writes a (C, K, F) slab of gathered keys, then scatters its
// valid rows into the ring.  Here each selected row is read straight from
// the teacher's NCHW representation (stride h*w between features), rounded
// to the storage type (round to nearest even, as astype does) and written as
// one contiguous row of the ring, 16 bytes per 8 features, at (ptr + rank) %
// size.  A class's write is at most two contiguous segments of the ring (the
// wrap) with lengths known only on the device, which a TPU DMA could not
// express.  Only the newest `size` ranks are written when a call brings
// more, so every ring row is written at most once.  Nothing syncs with the
// host.
//
// Bound: memory, and not the row bytes.  sel_idx is in (priority, pixel)
// order, random in pixel space, and the rep is NCHW, so every 4-byte feature
// read costs a 32-byte sector: at the flagship (18,051 keys from the
// (8, 256, 129²) f32 rep) ~72 MB of distinct sectors, ~22 us at 3.35 TB/s
// (chip_smoke.py's sector bound), against ~13 MB of row bytes.  The first
// design ran one warp per row in selection order, so its sector reads fell
// at random over the 136 MB rep, each a DRAM access of its own: 0.103 ms on
// an NVIDIA H100 80GB HBM3 at 700 W, and as much with 4 rows (32 loads) in
// flight per lane from a grid-stride over the written rows (0.105 ms,
// chip_smoke.py): more requests in flight did not help, so the random
// sector reads bound it.
// This design reads in pixel order:
// - a block owns a tile of consecutive pixels (the host plan,
//   memobank.py:_enqueue_tile, two tiles per SM); it scans each class's
//   written rows' pixels (L2-resident, kScan loads a thread at once) and
//   lists the rows in its tile, with their ring rows, in shared memory;
// - its threads take (row, 8-feature chunk) items, rows fastest, so a warp
//   reads one plane's window of the tile for 32 rows, and a block walks the
//   planes in order: the sectors of a DRAM page are read together;
// - each item's 8 loads, 4 items a thread, are issued before the first
//   store; a row past the list's kMaxTileRows is written by the thread that
//   found it;
// - the last block to finish (a ticket word per device, atomicInc wrapping
//   at the grid size) moves ptr and occupancy: every block read ptr before
//   it took its ticket, so no write is placed from a moved ptr.
// 0.064-0.068 ms at the flagship, ~3x the sector bound: a scattered 32-byte
// sector seems to cost about a 64-byte DRAM access.  One scan over the
// flattened rows (a class search per row) instead of one per class was
// slower (PERF.md, section 6).
//
// bfloat16 rep (the teacher's representation under a bf16 model): JAX
// gathers the keys in the rep's dtype (contrastive.py:259) and the bank
// casts them on write, so a bf16 bank takes an exact copy and an f32 bank
// the widened values.  The kernel reads the rep as R = __nv_bfloat16
// (half the sector bytes), widens each value to f32 exactly and stores it
// as above: the same rows, bit for bit.  One kernel: R is a template
// parameter, picked by the host's `rep_dtype` code.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 1024;  // rows a tile lists in shared memory
constexpr int kItems = 4;  // (row, 8-feature chunk) items a thread has in flight
constexpr int kScan = 8;  // selected pixels a thread loads at once while it scans

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

// 8 features f0 .. f0 + 7 of one pixel, rounded to the storage type, into
// its ring row
__device__ __forceinline__ void store8(void* keys, long long row, int F, int f0,
                                       const float (&v)[8], int dtype) {
  if (dtype == 1) {
    uint4 o;
    o.x = pack_bf16x2(v[0], v[1]);
    o.y = pack_bf16x2(v[2], v[3]);
    o.z = pack_bf16x2(v[4], v[5]);
    o.w = pack_bf16x2(v[6], v[7]);
    reinterpret_cast<uint4*>((__nv_bfloat16*)keys + row * F + f0)[0] = o;
  } else {
    float4* d = reinterpret_cast<float4*>((float*)keys + row * F + f0);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads) mb_enqueue_kernel(
    const R* __restrict__ rep, const int* __restrict__ sel_idx,
    const int* __restrict__ n_sel, void* __restrict__ keys, int* __restrict__ ptr,
    int* __restrict__ occ, const int* __restrict__ sizes, unsigned* ticket, int F, int HW,
    int C, int K, int cap, int dtype, int tile, int pixels) {
  // per class: its written ranks [first, n_new) (the newest `size`), ptr, size
  extern __shared__ int cls[];
  int* first = cls;
  int* n_new = first + C;
  int* p0 = n_new + C;
  int* size = p0 + C;
  __shared__ int tile_pix[kMaxTileRows];
  __shared__ long long tile_row[kMaxTileRows];
  __shared__ int listed;
  __shared__ bool last;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, pixels);
  if (threadIdx.x == 0) listed = 0;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    n_new[c] = min(n_sel[c], K);
    size[c] = sizes[c];
    first[c] = max(n_new[c] - size[c], 0);
    p0[c] = ptr[c];
  }
  __syncthreads();
  // the written rows whose pixel lies in this block's tile, kScan pixels a
  // thread loaded at once
  for (int c = 0; c < C; ++c) {
    const int end = n_new[c];
    for (int r0 = first[c] + threadIdx.x; r0 < end; r0 += kThreads * kScan) {
      int pix[kScan];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int r = r0 + u * kThreads;
        pix[u] = r < end ? sel_idx[(size_t)c * K + r] : -1;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        if (pix[u] < t0 || pix[u] >= t1) continue;
        const int r = r0 + u * kThreads;
        const long long row = (long long)c * cap + (p0[c] + r) % size[c];
        const int slot = atomicAdd(&listed, 1);
        if (slot < kMaxTileRows) {
          tile_pix[slot] = pix[u];
          tile_row[slot] = row;
        } else {  // a tile denser than the list: this thread writes the row alone
          const int b = pix[u] / HW;
          const R* src = rep + (size_t)b * F * HW + (pix[u] - b * HW);
          for (int f0 = 0; f0 < F; f0 += 8) {
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = u2pl::to_f32(src[(size_t)(f0 + i) * HW]);
            store8(keys, row, F, f0, v, dtype);
          }
        }
      }
    }
  }
  __syncthreads();
  // items (row s, chunk k), s fastest: a warp reads one plane's window of
  // the tile for up to 32 rows at a time
  const int n = min(listed, kMaxTileRows);
  const int items = n * (F / 8);
  for (int base = threadIdx.x; base < items; base += kThreads * kItems) {
    float v[kItems][8];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = base + u * kThreads;
      if (it < items) {
        const int s = it % n, f0 = (it / n) * 8;
        const int pix = tile_pix[s];
        const int b = pix / HW;
        const R* src = rep + (size_t)b * F * HW + (pix - b * HW) + (size_t)f0 * HW;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = u2pl::to_f32(src[(size_t)i * HW]);
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = base + u * kThreads;
      if (it < items) store8(keys, tile_row[it % n], F, (it / n) * 8, v[u], dtype);
    }
  }
  // the last block to finish moves ptr and occupancy: every block read ptr
  // before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    ptr[c] = (p0[c] + n_new[c]) % size[c];
    occ[c] = min(occ[c] + n_new[c], size[c]);
  }
}

}  // namespace

extern "C" {

int u2pl_memobank_enqueue(const void* rep, const void* sel_idx,
                          const void* n_sel, void* keys, void* ptr, void* occ,
                          const void* sizes, void* ticket, int B, int F, int HW, int C,
                          int K, int cap, int dtype, int rep_dtype, int tile, void* stream) {
  // dtype: the bank's, rep_dtype: the rep's (0 float32, 1 bfloat16)
  if (B <= 0 || F <= 0 || F % 8 || HW <= 0 || C <= 0 || K <= 0 || cap <= 0 ||
      tile <= 0 || (dtype != 0 && dtype != 1) || (rep_dtype != 0 && rep_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int pixels = B * HW;
  const int blocks = (pixels + tile - 1) / tile;
  const int smem = 4 * C * (int)sizeof(int);
  if (smem > 32 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rep_dtype == 1) {
    mb_enqueue_kernel<__nv_bfloat16><<<blocks, kThreads, smem, st>>>(
        (const __nv_bfloat16*)rep, (const int*)sel_idx, (const int*)n_sel, keys, (int*)ptr,
        (int*)occ, (const int*)sizes, (unsigned*)ticket, F, HW, C, K, cap, dtype, tile,
        pixels);
  } else {
    mb_enqueue_kernel<float><<<blocks, kThreads, smem, st>>>(
        (const float*)rep, (const int*)sel_idx, (const int*)n_sel, keys, (int*)ptr,
        (int*)occ, (const int*)sizes, (unsigned*)ticket, F, HW, C, K, cap, dtype, tile,
        pixels);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//
// Several ranks (data-parallel training, u2pl_tpu/losses/contrastive.py:
// 259-273): each rank's keys cross to every other rank, so the fused read of
// the rep cannot serve them.  Two more kernels, the (C, K, F) slab between:
// - the gather (mode a): each rank writes its own slab from the NCHW rep at
//   sel_idx, in the rep's dtype, as JAX's `rep_t_f[sel_idx]`; rows past
//   n_sel[c] are never read downstream, so they are not written.  Its first
//   design (PR 20) read in selection order, a warp a row, each lane 8
//   features at stride HW: every 2-byte load a 32-byte sector at a random
//   place in the 68 MB bf16 rep, 0.0643-0.0651 ms at the flagship (f32 rep
//   0.1241-0.1243) on an NVIDIA H100 80GB HBM3 at 700 W, ten times its
//   rows' bytes.  At the flagship 13.6% of the pixels are selected, so ~90%
//   of the rep's bf16 sectors (16 pixels each) are read anyway; this design
//   reads the rep in pixel order, as the fused mode does: a block owns a
//   tile of pixels, lists its rows and reads the planes of the tile in
//   order, 16-byte stores into the slab rows: 0.0416-0.0443 ms (f32
//   0.0667-0.0732) there, 3.4x the 0.0129 ms sector bound.  Staging
//   64-pixel sub-tiles whole through shared memory was slower (0.0733):
//   the flagship's keys come from the unlabeled half of the batch, so half
//   the tiles have nothing to stage;
// - the slab enqueue (mode b): the all-gathered (W, C, K, F) slabs and the
//   (W, C) counts ring-written per class in (rank, row) order, keeping the
//   newest `size` when W * K rows exceed the queue (u2pl_tpu/memobank.py:
//   50-89; at 8 ranks, 8 x 8192 > 50,000).  A block owns (a tile of
//   kSlabRows rows, rank w, class c): the rows before it in the class's
//   order are the counts of the ranks below w, so each block places its own
//   rows with no pass over the others; 16-byte loads and stores, cast to
//   the bank's type as above; the last block moves ptr and occupancy.
// Both are plain copies: the bytes bound is the kept rows' bytes, read and
// written; the gather's reads cost the NCHW sectors its rows touch
// (chip_smoke.py's sector bound, 16 pixels a bf16 sector).

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

constexpr int kSlabRows = 32;  // slab rows a slab-enqueue block writes

// 8 consecutive values of type R at p (16-byte aligned) widened to f32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// one 16-byte chunk of a pixel's row: the 16 / sizeof(R) features from
// src (the first of them) at stride HW, as their raw bits
__device__ __forceinline__ uint4 load_chunk(const float* __restrict__ src, size_t HW) {
  return make_uint4(__float_as_uint(src[0]), __float_as_uint(src[HW]),
                    __float_as_uint(src[2 * HW]), __float_as_uint(src[3 * HW]));
}

__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* __restrict__ src, size_t HW) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = h[2 * i * HW] | ((unsigned)h[(2 * i + 1) * HW] << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int kGatherMaxTile = 4096;  // pixels a gather tile holds at most (memobank.py)

// mode a: slab[c, r] = rep row at sel_idx[c, r], r < min(n_sel[c], K), read
// in pixel order.  A block owns a tile of consecutive pixels and lists the
// rows whose pixel lies in it with their slab rows (the fused mode's scan;
// a row past the list is copied by the thread that found it).  Its threads
// then take (row, 16-byte chunk) items, rows fastest, so a warp reads one
// plane's window of the tile for up to 32 rows, and the block walks the
// planes in order; each item's 16 / sizeof(R) loads, kItems items a thread,
// are issued before the first store.  The rows are copied as raw bits (the
// slab is in the rep's dtype).
template <typename R>
__global__ void __launch_bounds__(kThreads) mb_gather_kernel(
    const R* __restrict__ rep, const int* __restrict__ sel_idx, const int* __restrict__ n_sel,
    R* __restrict__ slab, int F, int HW, int C, int K, int tile, int pixels) {
  __shared__ int tile_pix[kMaxTileRows];
  __shared__ int tile_row[kMaxTileRows];  // its slab row c * K + r
  __shared__ int listed;
  constexpr int E = 16 / sizeof(R);  // features a chunk
  const int chunks = F / E;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, pixels);
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    const int end = min(n_sel[c], K);
    for (int r0 = threadIdx.x; r0 < end; r0 += kThreads * kScan) {
      int pix[kScan];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int r = r0 + u * kThreads;
        pix[u] = r < end ? sel_idx[(size_t)c * K + r] : -1;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        if (pix[u] < t0 || pix[u] >= t1) continue;
        const int row = c * K + r0 + u * kThreads;
        const int slot = atomicAdd(&listed, 1);
        if (slot < kMaxTileRows) {
          tile_pix[slot] = pix[u];
          tile_row[slot] = row;
        } else {  // a tile denser than the list: this thread copies the row alone
          const int b = pix[u] / HW;
          const R* src = rep + (size_t)b * F * HW + (pix[u] - b * HW);
          uint4* dst = reinterpret_cast<uint4*>(slab + (size_t)row * F);
          for (int j = 0; j < chunks; ++j) dst[j] = load_chunk(src + (size_t)j * E * HW, HW);
        }
      }
    }
  }
  __syncthreads();
  const int n = min(listed, kMaxTileRows);
  const int items = n * chunks;
  for (int base = threadIdx.x; base < items; base += kThreads * kItems) {
    uint4 v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = base + u * kThreads;
      if (it < items) {
        const int pix = tile_pix[it % n], j = it / n;
        const int b = pix / HW;
        v[u] = load_chunk(rep + ((size_t)b * F + (size_t)j * E) * HW + (pix - b * HW), HW);
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = base + u * kThreads;
      if (it < items) reinterpret_cast<uint4*>(slab + (size_t)tile_row[it % n] * F)[it / n] = v[u];
    }
  }
}

// mode b: the (W, C, K, F) slabs' kept rows into the ring, (rank, row) order
template <typename R>
__global__ void __launch_bounds__(kThreads) mb_enqueue_slabs_kernel(
    const R* __restrict__ slabs, const int* __restrict__ counts, void* __restrict__ keys,
    int* __restrict__ ptr, int* __restrict__ occ, const int* __restrict__ sizes,
    unsigned* ticket, int F, int W, int C, int K, int cap, int dtype) {
  const int w = blockIdx.y, c = blockIdx.z;
  __shared__ int before, total, p0, size;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    int lo = 0, all = 0;
    for (int v = 0; v < W; ++v) {
      const int n = min(counts[v * C + c], K);
      lo += v < w ? n : 0;
      all += n;
    }
    before = lo;
    total = all;
    p0 = ptr[c];
    size = sizes[c];
  }
  __syncthreads();
  // this block's rows [r0, r1) of slab (w, c); rank before + r in the
  // class's order, kept from rank total - size on
  const int t0 = (int)blockIdx.x * kSlabRows;
  const int r0 = max(t0, total - size - before);
  const int r1 = min(t0 + kSlabRows, min(counts[w * C + c], K));
  const int chunks = F / 8;
  for (int it = threadIdx.x; it < (r1 - r0) * chunks; it += kThreads) {
    const int r = r0 + it / chunks, f0 = (it % chunks) * 8;
    float v[8];
    load8(slabs + (((size_t)w * C + c) * K + r) * F + f0, v);
    store8(keys, (long long)c * cap + (p0 + before + r) % size, F, f0, v, dtype);
  }
  // the last block to finish moves ptr and occupancy: every block read ptr
  // before its ticket
  __syncthreads();
  const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
  if (threadIdx.x == 0) last = atomicInc(ticket, blocks - 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  for (int k = threadIdx.x; k < C; k += kThreads) {
    int all = 0;
    for (int v = 0; v < W; ++v) all += min(counts[v * C + k], K);
    ptr[k] = (ptr[k] + all) % sizes[k];
    occ[k] = min(occ[k] + all, sizes[k]);
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

// tile from memobank.py:_gather_tile
int u2pl_memobank_gather(const void* rep, const void* sel_idx, const void* n_sel, void* slab,
                         int B, int F, int HW, int C, int K, int rep_dtype, int tile,
                         void* stream) {
  // slab: (C, K, F) in the rep's dtype (0 float32, 1 bfloat16)
  if (B <= 0 || F <= 0 || F % 8 || HW <= 0 || C <= 0 || K <= 0 ||
      (long long)C * K * F >= (1LL << 31) || tile <= 0 || tile > kGatherMaxTile ||
      (rep_dtype != 0 && rep_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int pixels = B * HW;
  const int blocks = (pixels + tile - 1) / tile;
  cudaStream_t st = (cudaStream_t)stream;
  if (rep_dtype == 1) {
    mb_gather_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)rep, (const int*)sel_idx, (const int*)n_sel,
        (__nv_bfloat16*)slab, F, HW, C, K, tile, pixels);
  } else {
    mb_gather_kernel<float><<<blocks, kThreads, 0, st>>>(
        (const float*)rep, (const int*)sel_idx, (const int*)n_sel, (float*)slab, F, HW, C, K,
        tile, pixels);
  }
  return (int)cudaGetLastError();
}

int u2pl_memobank_enqueue_slabs(const void* slabs, const void* counts, void* keys, void* ptr,
                                void* occ, const void* sizes, void* ticket, int W, int F, int C,
                                int K, int cap, int dtype, int slab_dtype, void* stream) {
  // slabs (W, C, K, F) in slab_dtype, counts (W, C); dtype: the bank's
  if (W <= 0 || W > 65535 || F <= 0 || F % 8 || C <= 0 || C > 65535 || K <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1) || (slab_dtype != 0 && slab_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((K + kSlabRows - 1) / kSlabRows, W, C);
  cudaStream_t st = (cudaStream_t)stream;
  if (slab_dtype == 1) {
    mb_enqueue_slabs_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)slabs, (const int*)counts, keys, (int*)ptr, (int*)occ,
        (const int*)sizes, (unsigned*)ticket, F, W, C, K, cap, dtype);
  } else {
    mb_enqueue_slabs_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)slabs, (const int*)counts, keys, (int*)ptr, (int*)occ, (const int*)sizes,
        (unsigned*)ticket, F, W, C, K, cap, dtype);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// Kernel family K4 (sm_90a): the per-pixel masks, the negative-key selection
// and the anchor draws of the contrastive loss; replaces
// u2pl_tpu/losses/contrastive.py: _ranks_desc (:50) with the mask algebra of
// compute_contra_memobank_loss (:201-238), _select_keys_argsort (:89),
// _select_keys_radix (:106; K4r) and _sample_with_replacement (:73).
//
// Flagship shapes: N = 8 x 129 x 129 = 133,128 os4 pixels, C = 21 classes,
// K = 8192 keys per class, Q = 256 draws per position.
//
// contra_pixel_masks: one thread per pixel holds its C probabilities in
//   registers, counts each class's stable descending rank (the compare-count
//   of _ranks_desc), and writes the (C, N) anchor, negative and low-valid
//   masks; the per-class counts go through shared-memory integer atomics, so
//   they are exact in any block order.  Bound: memory, ~11 MB read and
//   ~17 MB written (~9 us at 3.35 TB/s); the rank is C^2 compares per pixel.
// select_keys: JAX sorts each class's priorities (masked-out pixels at +inf)
//   and slices k.  Here the 64-bit key (order bits of the f32 priority << 32
//   | pixel) is unique per pixel, so the k-th smallest masked key is found by
//   an 8-bit radix descent over its 8 bytes (histograms as in kernel E,
//   quantile.cu), every masked key at or under it is compacted (warp-
//   aggregated atomics; the order does not matter), and one block per class
//   sorts the <= k survivors in shared memory (bitonic, k <= 16384: 128 KB).
//   Ascending (priority, pixel) is the stable argsort's order, so the slab is
//   the argsort's, ties included.  Bound: memory, 9 passes over the mask and
//   the priorities (~14 MB each).
// select_keys_radix (K4r): per class, kk = min(k, N) and cnt = #mask; the
//   (kk-1)-th smallest masked u32 key t by the same radix descent at 32 bits
//   (4 levels of 8 bits, no sort); sel = cnt > kk ? mask & key <= t : mask;
//   then one block per class scans its row in pixel order, chunk by chunk
//   (a block-wide exclusive scan of the chunk's selected pixels), and writes
//   the first k selected positions, padding with N - 1 (JAX's clipped
//   searchsorted miss).  A tie at t admits the lower-indexed tied pixels, as
//   in JAX.  Bound: memory, 5 passes over the mask and the keys (~3.5 MB
//   each at the flagship's (21, 133128)).
// sample_anchors: one block per position counts its anchor row, then scans
//   it once in chunks of 4096 pixels, compacting each chunk's set pixels into
//   shared memory, where the draws r = floor(u * n) that fall in the chunk
//   read their pixel (searchsorted(cumsum, r + 1) of JAX, with N - 1 where it
//   finds none).  Bound: memory, one read of a (C, N) byte mask.

#include <math.h>

#include "common.cuh"

namespace {

using u2pl::kThreads;

constexpr int kMaxClasses = 32;
constexpr int kBins = 256;
constexpr int kMaxKeys = 16384;
constexpr int kSortThreads = 1024;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;  // pixels per thread per chunk
constexpr int kChunk = kScanThreads * kScanItems;
constexpr int kStateWords = 8;  // per class: prefix (2 words), remaining, count, fill, all

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pixel_key(float pri, int n) {
  return ((unsigned long long)order_key(pri) << 32) | (unsigned)n;
}

// ---- contra_pixel_masks ----------------------------------------------------

__global__ void pixel_masks_kernel(
    const float* __restrict__ prob, const int* __restrict__ labels,
    const uint8_t* __restrict__ low, const uint8_t* __restrict__ high,
    uint8_t* __restrict__ anchor, uint8_t* __restrict__ negative,
    float* __restrict__ low_valid, int* __restrict__ counts, int B, int B_l,
    int C, int HW, int ignore, float delta_p, float delta_n, int low_rank,
    int high_rank) {
  __shared__ int s_lv[kMaxClasses];
  __shared__ int s_neg[kMaxClasses];
  if (threadIdx.x < kMaxClasses) {
    s_lv[threadIdx.x] = 0;
    s_neg[threadIdx.x] = 0;
  }
  __syncthreads();
  const int N = B * HW;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    const int b = n / HW;
    const int p = n - b * HW;
    const float* pr = prob + (size_t)b * C * HW + p;
    float v[kMaxClasses];
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) v[c] = c < C ? pr[(size_t)c * HW] : 0.f;
    const int lab = labels[n];
    const bool lo = low[n] != 0, hi = high[n] != 0;
    const bool labeled = b < B_l;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < C) {
        // stable descending rank: #{d: p_d > p_c} + #{d < c: p_d == p_c}
        int rank = 0;
#pragma unroll
        for (int d = 0; d < kMaxClasses; ++d) {
          if (d < C) rank += (v[d] > v[c]) || (d < c && v[d] == v[c]);
        }
        const bool is_c = lab == c && lab != ignore;  // the one-hot of the label
        const bool lv = is_c && lo;
        const bool hv = is_c && hi;
        const bool anc = v[c] > delta_p && lv;
        const bool cls = labeled ? (rank < low_rank && !is_c)
                                 : (rank >= low_rank && rank < high_rank);
        const bool neg = v[c] < delta_n && hv && cls;
        const size_t o = (size_t)c * N + n;
        anchor[o] = anc;
        negative[o] = neg;
        low_valid[o] = lv ? 1.f : 0.f;
        if (lv) atomicAdd(&s_lv[c], 1);
        if (neg) atomicAdd(&s_neg[c], 1);
      }
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < C) {
    if (s_lv[threadIdx.x]) atomicAdd(&counts[threadIdx.x], s_lv[threadIdx.x]);
    if (s_neg[threadIdx.x]) atomicAdd(&counts[C + threadIdx.x], s_neg[threadIdx.x]);
  }
}

// ---- select_keys -------------------------------------------------------------
// state (u32 words, zeroed by the caller): histograms C x 256; per class
// kStateWords words; then the (C, K) u64 compaction buffer.

struct SelState {
  unsigned* hist;
  unsigned* cls;
  unsigned long long* buf;
};

__device__ __forceinline__ SelState sel_state(unsigned* st, int C) {
  SelState s;
  s.hist = st;
  s.cls = st + C * kBins;
  s.buf = reinterpret_cast<unsigned long long*>(st + C * kBins + C * kStateWords);
  return s;
}

__device__ __forceinline__ unsigned long long cls_prefix(const unsigned* cls) {
  return ((unsigned long long)cls[1] << 32) | cls[0];
}

__global__ void sk_hist_kernel(const uint8_t* __restrict__ mask,
                               const float* __restrict__ pri, int C, int N,
                               int level, unsigned* __restrict__ st) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned count;
  const int c = blockIdx.y;
  SelState s = sel_state(st, C);
  unsigned* cls = s.cls + c * kStateWords;
  if (level > 0 && cls[5]) return;  // fewer keys than k: all are taken
  for (int j = threadIdx.x; j < kBins; j += blockDim.x) hist[j] = 0;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const unsigned long long prefix = cls_prefix(cls);
  const int shift = 56 - 8 * level;
  const uint8_t* m = mask + (size_t)c * N;
  const float* pr = pri + (size_t)c * N;
  unsigned my = 0;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    if (!m[n]) continue;
    const unsigned long long key = pixel_key(pr[n], n);
    ++my;
    if (level == 0 || (key >> (shift + 8)) == (prefix >> (shift + 8))) {
      atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1u);
    }
  }
  if (level == 0 && my) atomicAdd(&count, my);
  __syncthreads();
  for (int j = threadIdx.x; j < kBins; j += blockDim.x) {
    if (hist[j]) atomicAdd(&s.hist[c * kBins + j], hist[j]);
  }
  if (level == 0 && threadIdx.x == 0 && count) atomicAdd(&cls[3], count);
}

// one thread per class: at level 0 it decides whether every masked key is
// taken (count <= k), else it takes the first digit whose cumulative count
// exceeds the remaining rank (the k-th smallest key has rank k - 1)
__global__ void sk_select_kernel(int C, int K, int level,
                                 unsigned* __restrict__ st) {
  SelState s = sel_state(st, C);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    unsigned* cls = s.cls + c * kStateWords;
    unsigned* h = s.hist + c * kBins;
    if (level == 0) {
      cls[2] = (unsigned)(K - 1);
      cls[5] = cls[3] <= (unsigned)K ? 1u : 0u;
    }
    if (!cls[5]) {
      const int shift = 56 - 8 * level;
      unsigned below = 0;
      int sel = 0;
      for (int b = 0; b < kBins; ++b) {
        if (below + h[b] > cls[2]) {
          sel = b;
          break;
        }
        below += h[b];
      }
      cls[2] -= below;
      const unsigned long long prefix =
          cls_prefix(cls) | ((unsigned long long)sel << shift);
      cls[0] = (unsigned)prefix;
      cls[1] = (unsigned)(prefix >> 32);
    }
    for (int b = 0; b < kBins; ++b) h[b] = 0;
  }
}

__global__ void sk_compact_kernel(const uint8_t* __restrict__ mask,
                                  const float* __restrict__ pri, int C, int N,
                                  int K, unsigned* __restrict__ st) {
  const int c = blockIdx.y;
  SelState s = sel_state(st, C);
  unsigned* cls = s.cls + c * kStateWords;
  const bool all = cls[5] != 0;
  const unsigned long long thresh = cls_prefix(cls);
  const uint8_t* m = mask + (size_t)c * N;
  const float* pr = pri + (size_t)c * N;
  unsigned long long* out = s.buf + (size_t)c * K;
  const int lane = threadIdx.x & 31;
  // whole warps walk the pixels together, for the warp-aggregated atomic
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < N;
       base += stride) {
    const int n = base + lane;
    unsigned long long key = 0;
    bool take = false;
    if (n < N && m[n]) {
      key = pixel_key(pr[n], n);
      take = all || key <= thresh;
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, take);
    if (!ballot) continue;
    unsigned first = 0;
    if (lane == 0) first = atomicAdd(&cls[4], (unsigned)__popc(ballot));
    first = __shfl_sync(0xFFFFFFFFu, first, 0);
    if (take) {
      const unsigned pos = first + __popc(ballot & ((1u << lane) - 1u));
      if (pos < (unsigned)K) out[pos] = key;
    }
  }
}

// one block per class: bitonic sort of the <= K survivors (padded with
// all-ones keys to a power of two), then the pixel indices in order
__global__ void sk_sort_kernel(int C, int K, int kpad, unsigned* __restrict__ st,
                               int* __restrict__ sel_idx,
                               int* __restrict__ n_sel) {
  extern __shared__ unsigned long long keys[];
  const int c = blockIdx.x;
  SelState s = sel_state(st, C);
  const unsigned* cls = s.cls + c * kStateWords;
  const int n = min((int)cls[4], K);
  const unsigned long long* src = s.buf + (size_t)c * K;
  for (int i = threadIdx.x; i < kpad; i += blockDim.x) {
    keys[i] = i < n ? src[i] : ~0ull;
  }
  __syncthreads();
  for (int k = 2; k <= kpad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kpad; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    sel_idx[(size_t)c * K + i] = i < n ? (int)(unsigned)keys[i] : 0;
  }
  if (threadIdx.x == 0) n_sel[c] = n;
}

// ---- block scan (select_keys_radix, sample_anchors) --------------------------

// exclusive block scan of one int per thread (blockDim.x == kScanThreads);
// returns the thread's exclusive prefix, *total the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_tot[warp - 1];
  *total = warp_tot[31];
  return before + x - v;
}

// ---- select_keys_radix (K4r) -------------------------------------------------
// state (u32 words, zeroed by the caller): histograms C x 256, then per class
// kRxStateWords words: prefix, remaining rank, count, all-taken flag

constexpr int kRxStateWords = 4;

__global__ void skr_hist_kernel(const uint8_t* __restrict__ mask,
                                const unsigned* __restrict__ keys, int C,
                                int N, int level, unsigned* __restrict__ st) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned count;
  const int c = blockIdx.y;
  unsigned* cls = st + C * kBins + c * kRxStateWords;
  if (level > 0 && cls[3]) return;  // at most kk keys: all are taken
  for (int j = threadIdx.x; j < kBins; j += blockDim.x) hist[j] = 0;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const unsigned prefix = cls[0];
  const int shift = 24 - 8 * level;
  const uint8_t* m = mask + (size_t)c * N;
  const unsigned* kc = keys + (size_t)c * N;
  unsigned my = 0;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    if (!m[n]) continue;
    const unsigned key = kc[n];
    ++my;
    if (level == 0 || (key >> (shift + 8)) == (prefix >> (shift + 8))) {
      atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1u);
    }
  }
  if (level == 0 && my) atomicAdd(&count, my);
  __syncthreads();
  for (int j = threadIdx.x; j < kBins; j += blockDim.x) {
    if (hist[j]) atomicAdd(&st[c * kBins + j], hist[j]);
  }
  if (level == 0 && threadIdx.x == 0 && count) atomicAdd(&cls[2], count);
}

// one thread per class: at level 0 it decides whether every masked key is
// taken (count <= kk), else it appends the digit of the rank-(kk-1) key
__global__ void skr_select_kernel(int C, int KK, int level,
                                  unsigned* __restrict__ st) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    unsigned* cls = st + C * kBins + c * kRxStateWords;
    unsigned* h = st + c * kBins;
    if (level == 0) {
      cls[1] = (unsigned)(KK - 1);
      cls[3] = cls[2] <= (unsigned)KK ? 1u : 0u;
    }
    if (!cls[3]) {
      const int shift = 24 - 8 * level;
      unsigned below = 0;
      int sel = 0;
      for (int b = 0; b < kBins; ++b) {
        if (below + h[b] > cls[1]) {
          sel = b;
          break;
        }
        below += h[b];
      }
      cls[1] -= below;
      cls[0] |= (unsigned)sel << shift;
    }
    for (int b = 0; b < kBins; ++b) h[b] = 0;
  }
}

// one block per class (kScanThreads threads): the first K selected pixels in
// pixel order, then N - 1 up to K
__global__ void skr_compact_kernel(const uint8_t* __restrict__ mask,
                                   const unsigned* __restrict__ keys, int C,
                                   int N, int K, const unsigned* __restrict__ st,
                                   int* __restrict__ idx,
                                   int* __restrict__ n_sel) {
  __shared__ int warp_tot[32];
  const int c = blockIdx.x;
  const unsigned* cls = st + C * kBins + c * kRxStateWords;
  const bool all = cls[3] != 0;
  const unsigned thresh = cls[0];
  const uint8_t* m = mask + (size_t)c * N;
  const unsigned* kc = keys + (size_t)c * N;
  int* out = idx + (size_t)c * K;
  int base = 0;
  for (int start = 0; start < N && base < K; start += kChunk) {
    const int first = start + threadIdx.x * kScanItems;
    int flags = 0, cnt = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int n = first + i;
      if (n < N && m[n] && (all || kc[n] <= thresh)) {
        flags |= 1 << i;
        ++cnt;
      }
    }
    int chunk_total;
    int at = base + block_exclusive_scan(cnt, warp_tot, &chunk_total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if ((flags & (1 << i)) && at < K) out[at] = first + i;
      at += (flags >> i) & 1;
    }
    base += chunk_total;
    __syncthreads();
  }
  for (int j = min(base, K) + threadIdx.x; j < K; j += blockDim.x) out[j] = N - 1;
  if (threadIdx.x == 0) n_sel[c] = (int)min(cls[2], (unsigned)K);
}

// ---- sample_anchors --------------------------------------------------------

__global__ void sample_anchors_kernel(const uint8_t* __restrict__ mask,
                                      const int* __restrict__ a_j,
                                      const float* __restrict__ u,
                                      int* __restrict__ idx,
                                      int* __restrict__ count, int N, int Q) {
  __shared__ int warp_tot[32];
  __shared__ int pos[kChunk];
  const int j = blockIdx.x;
  const uint8_t* m = mask + (size_t)a_j[j] * N;
  // pass 1: the number of set pixels
  int mine = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) mine += m[n] != 0;
  int total;
  block_exclusive_scan(mine, warp_tot, &total);
  const float nf = (float)total;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) idx[(size_t)j * Q + q] = N - 1;
  if (threadIdx.x == 0) count[j] = total;
  __syncthreads();
  // pass 2: chunks of kChunk pixels, kScanItems consecutive ones per thread
  int base = 0;
  for (int start = 0; start < N && base < total; start += kChunk) {
    const int first = start + threadIdx.x * kScanItems;
    int flags = 0, cnt = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int n = first + i;
      if (n < N && m[n]) {
        flags |= 1 << i;
        ++cnt;
      }
    }
    int chunk_total;
    int at = block_exclusive_scan(cnt, warp_tot, &chunk_total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (flags & (1 << i)) pos[at++] = first + i;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < Q; q += blockDim.x) {
      const int r = (int)floorf(__fmul_rn(u[(size_t)j * Q + q], nf));
      if (r >= base && r < base + chunk_total) idx[(size_t)j * Q + q] = pos[r - base];
    }
    base += chunk_total;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int u2pl_contra_pixel_masks(const void* prob, const void* labels,
                            const void* low, const void* high, void* anchor,
                            void* negative, void* low_valid, void* counts,
                            int B, int B_l, int C, int HW, int ignore,
                            float delta_p, float delta_n, int low_rank,
                            int high_rank, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C > kMaxClasses) return (int)cudaErrorInvalidValue;
  const int blocks = u2pl::blocks_for((long long)B * HW, 1024);
  pixel_masks_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)prob, (const int*)labels, (const uint8_t*)low,
      (const uint8_t*)high, (uint8_t*)anchor, (uint8_t*)negative,
      (float*)low_valid, (int*)counts, B, B_l, C, HW, ignore, delta_p, delta_n,
      low_rank, high_rank);
  return (int)cudaGetLastError();
}

int u2pl_select_keys_state_words(int C, int K) {
  return C * kBins + C * kStateWords + 2 * C * K;
}

int u2pl_contra_select_keys(const void* mask, const void* pri, void* sel_idx,
                            void* n_sel, void* state, int C, int N, int K,
                            void* stream) {
  if (C <= 0 || N <= 0 || K <= 0 || K > kMaxKeys) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(u2pl::blocks_for(N, 128), C);
  unsigned* st = (unsigned*)state;
  for (int level = 0; level < 8; ++level) {
    sk_hist_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)mask,
                                             (const float*)pri, C, N, level, st);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sk_select_kernel<<<1, 32, 0, s>>>(C, K, level, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sk_compact_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)mask,
                                              (const float*)pri, C, N, K, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int kpad = 2;
  while (kpad < K) kpad <<= 1;
  const int smem = kpad * (int)sizeof(unsigned long long);
  err = cudaFuncSetAttribute(sk_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sk_sort_kernel<<<C, kSortThreads, smem, s>>>(C, K, kpad, st, (int*)sel_idx,
                                               (int*)n_sel);
  return (int)cudaGetLastError();
}

int u2pl_select_keys_radix_state_words(int C) {
  return C * kBins + C * kRxStateWords;
}

int u2pl_contra_select_keys_radix(const void* mask, const void* keys,
                                  void* idx, void* n_sel, void* state, int C,
                                  int N, int K, void* stream) {
  if (C <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(u2pl::blocks_for(N, 128), C);
  unsigned* st = (unsigned*)state;
  const int kk = K < N ? K : N;
  for (int level = 0; level < 4; ++level) {
    skr_hist_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)mask,
                                              (const unsigned*)keys, C, N,
                                              level, st);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    skr_select_kernel<<<1, 32, 0, s>>>(C, kk, level, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  skr_compact_kernel<<<C, kScanThreads, 0, s>>>(
      (const uint8_t*)mask, (const unsigned*)keys, C, N, K, st, (int*)idx,
      (int*)n_sel);
  return (int)cudaGetLastError();
}

int u2pl_contra_sample_anchors(const void* mask, const void* a_j,
                               const void* u, void* idx, void* count, int C,
                               int N, int Q, void* stream) {
  if (C <= 0 || N <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  sample_anchors_kernel<<<C, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int*)a_j, (const float*)u, (int*)idx,
      (int*)count, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"

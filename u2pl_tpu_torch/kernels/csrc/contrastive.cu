// Kernel family K4 (sm_90a): the per-pixel masks, the negative-key selection
// and the anchor draws of the contrastive loss; replaces
// u2pl_tpu/losses/contrastive.py: _ranks_desc (:50) with the mask algebra of
// compute_contra_memobank_loss (:201-238), _select_keys_argsort (:89),
// _select_keys_radix (:106; K4r) and _sample_with_replacement (:73).
//
// Flagship shapes: N = 8 x 129 x 129 = 133,128 os4 pixels, C = 21 classes,
// K = 8192 keys per class, Q = 256 draws per position.
//
// contra_pixel_masks: a pixel's masks are non-zero at its label class L at
//   most, and negative never is on a labeled image (quirk 2 of the JAX
//   module), so one rank per pixel, of L (C compares), decides all three;
//   p[L] alone where no rank is needed.  A thread owns 4 pixels and writes
//   their (C, 4) bytes / floats of the anchor, negative and low-valid rows
//   as 4-byte and 16-byte stores; the per-class counts go through warp
//   reductions and integer atomics and leave with the last block (no
//   zero-fill).  Bound: memory, the bytes its inputs need
//   (u2pl_tpu_torch/kernels/timing_ab.py:masks_needed: the (C, N) outputs,
//   6 bytes a value, the labels and the masks, all C probabilities only
//   where a rank is needed; ~20.5 MB on the flagship's timed inputs, 6.1 us
//   at 3.35 TB/s).  0.0108 ms at the flagship, 0.0121-0.0123 at the
//   Cityscapes step's (4, 19, 193²), on an NVIDIA H100 80GB HBM3 at 700 W
//   (timing_ab.py); the first design (a thread per pixel ranking all C
//   classes, C^2 compares, and a torch.zeros of the counts) took 0.0240 /
//   0.0283 there (PERF.md).
// select_keys: JAX sorts each class's priorities (masked-out pixels at +inf)
//   and slices k: the k smallest (priority, pixel) pairs, ascending.  The
//   first design (18 launches: an 8-bit radix descent over a 64-bit key
//   with a histogram pass over every row and a one-thread bin walk per
//   level, a compaction, then a bitonic sort of <= k keys in one block per
//   class, 21 of 132 SMs) took 0.214 ms at the flagship on an NVIDIA H100
//   80GB HBM3 at 700 W, 49x its bytes bound; the dependent launches and
//   the single-block sort held it back.  This design is one launch, one
//   thread block cluster of 8 blocks per class (168 blocks at the
//   flagship, 2 per SM): each block reads its eighth of the row from HBM
//   once and keeps the order bits of its masked priorities in shared
//   memory; the radix descent to the k-th smallest runs over those 32 bits
//   (4 levels of 8), each level's 256-bin histograms summed across the
//   cluster through distributed shared memory; the survivors (keys under
//   the threshold, then the first ties at it in pixel order, which is the
//   64-bit key's order) are compacted in pixel order in place, sorted by
//   (key, pixel) per block (about k / 8 of them at the flagship; a bitonic
//   sort whose strides under 32 run in a warp's registers), and placed
//   by their rank over the cluster: their index plus a binary search in
//   each other block's sorted survivors.  Ascending (priority, pixel) is
//   the stable argsort's order, so the slab is the argsort's, ties
//   included.  Bound: memory, one read of the mask and the priorities
//   (~14 MB, 4.4 us).  0.087 ms at the flagship on that card
//   (u2pl_tpu_torch/kernels/timing_ab.py; torch.sort(stable=True) 0.276):
//   per block, the cross-block ranks take ~30% of the SM clocks (DSMEM
//   serves scattered loads at a few per clock), the radix descent ~30%,
//   the sort and the compaction ~25% (PERF.md).
// select_keys_radix (K4r): per class, kk = min(k, N) and cnt = #mask; when
//   cnt > kk the masked pixels whose u32 key is at or under the rank-(kk-1)
//   masked key t, else every masked pixel; the first k of them in pixel order,
//   N - 1 past them (JAX's clipped searchsorted miss); a tie at t admits the
//   lower-indexed tied pixels, as in JAX.  The first design (10 launches: a
//   torch.zeros of its state, per 8-bit level a histogram pass over every row
//   and a one-thread bin walk, then one block per class compacting its row
//   chunk by chunk, 21 of 132 SMs) took 0.168 ms at the flagship's (21,
//   133128), k 8192, and 0.176 at Cityscapes' (19, 148996), k 12288, by
//   timing_ab.py's clock on an NVIDIA H100 80GB HBM3 at 700 W.  This design
//   is one launch, one cluster of 8 blocks per class: each block reads its
//   eighth of the row from HBM once, keeps the raw keys and the mask bits in
//   shared memory and counts the masked pixels and the first level's
//   histogram on the way; the cluster sums the counts through distributed
//   shared memory, and only a class over the cap runs the descent (3 more
//   levels over the held keys); the compaction writes each block's selected
//   pixels at its base from ballots.  No zero-fill.  Bound: memory, one read
//   of the mask and the keys (~14 MB, 4.4 us).  0.0303 ms at the flagship
//   (15 of 21 classes over the cap), 0.0297 at Cityscapes, on that card;
//   a launch and the one read take ~0.010, the descent and the count ~0.014,
//   the compaction ~0.006 (cut-short builds; PERF.md).
// sample_anchors: a cluster of 8 blocks per position reads its anchor row
//   once, with loads as wide as the row's alignment, and keeps the prefix
//   count of each run of 32 words in shared memory; the blocks' totals meet
//   through distributed shared memory, and each draw r = floor(u * n) is
//   served by a binary search and a recount of one run in the block that
//   holds the r-th set pixel (searchsorted(cumsum, r + 1) of JAX, N - 1
//   where it finds none).
//   Bound: memory, one read of a (C, N) byte mask (0.0008 ms); a launch
//   and one short read alone take ~3.7 us on that card.  0.0081 ms at the
//   flagship, 0.0077 at Cityscapes' (19, 148996), on that card (a prefix
//   per word and no recount: 0.0065 / 0.0077, but rows past 464,383
//   one-byte words refused); the first design (one 1024-thread block per
//   position, 21 of 132 SMs, walking its row in 33 serial chunks of block
//   scans) took 0.0548 / 0.0611 there (PERF.md).

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxClasses = 32;
constexpr int kBins = 256;
constexpr int kMaxKeys = 16384;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

// ---- contra_pixel_masks ----------------------------------------------------
// A thread owns kMaskPix consecutive pixels (a group; the host's plan:
// losses/contrastive.py:_masks_plan).  Each pixel's outputs are non-zero in
// one row at most, its label class L: anchor and low-valid need p[L] alone,
// negative (never on a labeled image) the stable descending rank of L alone,
// C compares.  The group's decisions are packed one byte per pixel (its L,
// or kNoClass, and its anchor / negative / low-valid bits); per class a
// byte compare picks the group's pixels of that class, and the row's bytes
// go out as one 4-byte store per mask and one float4 for low-valid where
// N % 4 == 0 (every row then starts 4-aligned), byte by byte otherwise.
// The per-class counts: a warp reduction per class, shared partials per
// block, integer atomics into 2C words of kernels.tickets, moved out by the
// last block to finish (a ticket) and left zero: exact in any order, and no
// zero-fill launch.

constexpr int kMaskPix = 4;  // pixels per thread and group
constexpr int kMaskThreads = 128;
constexpr unsigned kNoClass = 0xFFu;

template <int kC>  // the class count, or 0: C at run time (at most kMaxClasses)
__global__ void __launch_bounds__(kMaskThreads) pixel_masks_kernel(
    const float* __restrict__ prob, const int* __restrict__ labels,
    const uint8_t* __restrict__ low, const uint8_t* __restrict__ high,
    uint8_t* __restrict__ anchor, uint8_t* __restrict__ negative,
    float* __restrict__ low_valid, int* __restrict__ counts, unsigned* __restrict__ ticket,
    int B, int B_l, int C_rt, int HW, int ignore, float delta_p, float delta_n, int low_rank,
    int high_rank, bool vec_in, bool vec_out) {
  const int C = kC > 0 ? kC : C_rt;
  __shared__ int s_cnt[2 * kMaxClasses];  // [n_low_valid (C), negatives (C)]
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 2 * kMaxClasses) s_cnt[tid] = 0;
  __syncthreads();
  const int N = B * HW;
  const int groups = (N + kMaskPix - 1) / kMaskPix;
  // block-uniform trips, so every lane takes part in the warp reductions
  for (int g0 = blockIdx.x * kMaskThreads; g0 < groups; g0 += gridDim.x * kMaskThreads) {
    const int g = g0 + tid;
    const int n0 = g * kMaskPix;
    const int cnt = g < groups ? min(kMaskPix, N - n0) : 0;
    unsigned lw = kNoClass * 0x01010101u, aw = 0, gw = 0, vw = 0;  // byte j: pixel n0 + j
    if (cnt > 0) {
      int lab[kMaskPix];
      unsigned lo = 0, hi = 0;  // byte j: low / high of pixel n0 + j
      if (vec_in && cnt == kMaskPix) {
        const int4 l4 = *reinterpret_cast<const int4*>(labels + n0);
        lab[0] = l4.x;
        lab[1] = l4.y;
        lab[2] = l4.z;
        lab[3] = l4.w;
        lo = *reinterpret_cast<const unsigned*>(low + n0);
        hi = *reinterpret_cast<const unsigned*>(high + n0);
      } else {
#pragma unroll
        for (int j = 0; j < kMaskPix; ++j) {
          lab[j] = j < cnt ? labels[n0 + j] : -1;
          lo |= j < cnt ? (unsigned)low[n0 + j] << (8 * j) : 0u;
          hi |= j < cnt ? (unsigned)high[n0 + j] << (8 * j) : 0u;
        }
      }
      int b = n0 / HW, p = n0 - b * HW;
#pragma unroll
      for (int j = 0; j < kMaskPix; ++j) {
        const int L = lab[j];
        if (j < cnt && (unsigned)L < (unsigned)C && L != ignore) {
          const bool lv = (lo >> (8 * j)) & 0xFFu;
          const bool want_neg = b >= B_l && ((hi >> (8 * j)) & 0xFFu);
          bool anc = false, neg = false;
          if (lv || want_neg) {
            const float* pr = prob + (size_t)b * C * HW + p;
            const float vl = pr[(size_t)L * HW];
            anc = lv && vl > delta_p;
            if (want_neg && vl < delta_n) {
              // the stable descending rank of L: #{d: p_d > p_L} + #{d < L: p_d == p_L}
              int rank = 0;
#pragma unroll
              for (int d = 0; d < (kC > 0 ? kC : kMaxClasses); ++d) {
                if (kC > 0 || d < C) {
                  const float v = pr[(size_t)d * HW];
                  rank += (v > vl) || (d < L && v == vl);
                }
              }
              neg = rank >= low_rank && rank < high_rank;
            }
          }
          lw = (lw & ~(0xFFu << (8 * j))) | ((unsigned)L << (8 * j));
          aw |= (unsigned)anc << (8 * j);
          gw |= (unsigned)neg << (8 * j);
          vw |= (unsigned)lv << (8 * j);
        }
        if (++p == HW) {
          p = 0;
          ++b;
        }
      }
    }
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const unsigned eq = __vcmpeq4(lw, (unsigned)c * 0x01010101u);  // 0xFF where L == c
      const unsigned a = aw & eq, ng = gw & eq, v = vw & eq;
      const size_t o = (size_t)c * N + n0;
      if (vec_out && cnt == kMaskPix) {
        *reinterpret_cast<unsigned*>(anchor + o) = a;
        *reinterpret_cast<unsigned*>(negative + o) = ng;
        *reinterpret_cast<float4*>(low_valid + o) = make_float4(
            __uint_as_float((v & 1u) * 0x3f800000u), __uint_as_float(((v >> 8) & 1u) * 0x3f800000u),
            __uint_as_float(((v >> 16) & 1u) * 0x3f800000u), __uint_as_float((v >> 24) * 0x3f800000u));
      } else {
        for (int j = 0; j < cnt; ++j) {
          anchor[o + j] = (a >> (8 * j)) & 1u;
          negative[o + j] = (ng >> (8 * j)) & 1u;
          low_valid[o + j] = ((v >> (8 * j)) & 1u) ? 1.f : 0.f;
        }
      }
      const int n_lv = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(v));
      const int n_neg = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(ng));
      if (lane == 0) {
        if (n_lv) atomicAdd(&s_cnt[c], n_lv);
        if (n_neg) atomicAdd(&s_cnt[C + c], n_neg);
      }
    }
  }
  __syncthreads();
  if (tid < 2 * C) {
    if (s_cnt[tid]) atomicAdd(ticket + 1 + tid, (unsigned)s_cnt[tid]);
    __threadfence();  // the counts before the ticket
  }
  __syncthreads();
  if (tid == 0) s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (s_last && tid < 2 * C) counts[tid] = (int)atomicExch(ticket + 1 + tid, 0u);
}

// ---- block scan (select_keys, select_keys_radix) ------------------------------

// exclusive block scan of one int per thread (blockDim.x == 32 * kWarps);
// returns the thread's exclusive prefix, *total the block's sum
template <int kWarps>
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
    int t = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_tot[warp - 1];
  *total = warp_tot[kWarps - 1];
  return before + x - v;
}

// ---- select_keys -------------------------------------------------------------
// One cluster of kSelCluster blocks per class; block `rank` of class c owns
// the pixels [rank * slice, (rank + 1) * slice) of row c (the host's plan:
// losses/contrastive.py:_select_plan).  Keys are the order bits of the f32
// priority, kSelSentinel outside the mask; the priority whose order bits
// are 0xFFFFFFFF (the NaN 0x7FFFFFFF) counts as outside the mask.
// Shared memory: two 256-bin histograms, kSelInfo ints, kSelWarps ints of
// scan scratch, the slice's keys (u32), then the survivors' local pixels
// (u16, pixcap of them).

constexpr int kSelCluster = 8;
constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelInfo = 8;  // masked count, ties, survivors, digit, below
constexpr int kSelHeader = 2 * kBins * 4 + kSelInfo * 4 + 32 * 4;  // bytes, 16-aligned
constexpr unsigned kSelSentinel = 0xFFFFFFFFu;
constexpr int kSelMaxShared = 232448;  // a block's shared memory on sm_90 (227 KB)

__device__ __forceinline__ unsigned long long sel_word(unsigned key, unsigned pixel) {
  return ((unsigned long long)key << 32) | pixel;
}

// the masked pixels' keys, in rounds of 4 per thread: a warp-uniform walk
// (the warps' shuffles and votes need every lane)
template <typename F>
__device__ __forceinline__ void sel_rounds(const unsigned* keys, int slice, F&& f) {
  for (int r0 = 0; r0 < slice; r0 += 4 * kSelThreads) {
    const int i0 = r0 + 4 * (int)threadIdx.x;
    uint4 q = make_uint4(kSelSentinel, kSelSentinel, kSelSentinel, kSelSentinel);
    if (i0 < slice) q = *reinterpret_cast<const uint4*>(keys + i0);
    f(q);
  }
}

// the bitonic steps of select_keys's sort inside one 64-slot tile, in a
// warp's registers: lane l holds slots l and l + 32 (+inf at or past n).
// `whole`: the merges of sizes 2 to 64 (the tile sorted); otherwise the
// strides 16 to 1 that end each larger merge
__device__ __forceinline__ void sel_tile_sort(unsigned* keys, unsigned short* pix, int n,
                                              int tile, bool whole) {
  const int lane = threadIdx.x & 31;
  const int i0 = tile * 64 + lane, i1 = i0 + 32;
  unsigned long long e0 = i0 < n ? sel_word(keys[i0], pix[i0]) : ~0ull;
  unsigned long long e1 = i1 < n ? sel_word(keys[i1], pix[i1]) : ~0ull;
  // slots s and s ^ m, the lower slot (bit `up` of s clear) taking the min
  auto exchange = [&](int m, int up) {
    const unsigned long long o0 = __shfl_xor_sync(0xFFFFFFFFu, e0, m);
    const unsigned long long o1 = __shfl_xor_sync(0xFFFFFFFFu, e1, m);
    const bool upper = lane & up;
    e0 = (o0 < e0) != upper ? o0 : e0;
    e1 = (o1 < e1) != upper ? o1 : e1;
  };
  if (whole) {
    for (int lg = 1; lg <= 6; ++lg) {
      if (lg <= 5) {
        exchange((1 << lg) - 1, 1 << (lg - 1));  // the mirror inside 2^lg slots
      } else {  // the mirror of 64: slot l against slot 63 - l, in lane 31 - l's e1
        const unsigned long long o1 = __shfl_xor_sync(0xFFFFFFFFu, e1, 31);
        const unsigned long long o0 = __shfl_xor_sync(0xFFFFFFFFu, e0, 31);
        e0 = o1 < e0 ? o1 : e0;
        e1 = o0 < e1 ? e1 : o0;
      }
      for (int lj = lg - 2; lj >= 0; --lj) exchange(1 << lj, 1 << lj);
    }
  } else {
    for (int lj = 4; lj >= 0; --lj) exchange(1 << lj, 1 << lj);
  }
  if (i0 < n) {
    keys[i0] = (unsigned)(e0 >> 32);
    pix[i0] = (unsigned short)e0;
  }
  if (i1 < n) {
    keys[i1] = (unsigned)(e1 >> 32);
    pix[i1] = (unsigned short)e1;
  }
}

__global__ void __cluster_dims__(kSelCluster, 1, 1) __launch_bounds__(kSelThreads, 2)
select_keys_kernel(const uint8_t* __restrict__ mask, const float* __restrict__ pri,
                   int* __restrict__ sel_idx, int* __restrict__ n_sel, int N, int K,
                   int slice) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(sel_smem);  // 2 x kBins
  int* info = reinterpret_cast<int*>(hist + 2 * kBins);
  int* warp_tot = info + kSelInfo;
  unsigned* keys = reinterpret_cast<unsigned*>(sel_smem + kSelHeader);
  unsigned short* pix = reinterpret_cast<unsigned short*>(keys + slice);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / kSelCluster;
  const int tid = threadIdx.x, lane = tid & 31;
  const int base = rank * slice;
  const int len = max(0, min(slice, N - base));
  const uint8_t* m = mask + (size_t)c * N + base;
  const float* pr = pri + (size_t)c * N + base;

  // the slice's keys and its masked count, 4 pixels per thread and step:
  // one 16-byte load of priorities and one 4-byte load of the mask where
  // the row's length keeps them aligned, several steps' loads in flight
  int mine = 0;
  const bool vec = N % 4 == 0;
#pragma unroll 4
  for (int i0 = 4 * tid; i0 < slice; i0 += 4 * kSelThreads) {
    unsigned k4[4];
    if (vec && i0 + 4 <= len) {
      const uchar4 mm = *reinterpret_cast<const uchar4*>(m + i0);
      const float4 pp = *reinterpret_cast<const float4*>(pr + i0);
      k4[0] = mm.x ? order_key(pp.x) : kSelSentinel;
      k4[1] = mm.y ? order_key(pp.y) : kSelSentinel;
      k4[2] = mm.z ? order_key(pp.z) : kSelSentinel;
      k4[3] = mm.w ? order_key(pp.w) : kSelSentinel;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        k4[u] = i < len && m[i] ? order_key(pr[i]) : kSelSentinel;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) mine += k4[u] != kSelSentinel;
    *reinterpret_cast<uint4*>(keys + i0) = make_uint4(k4[0], k4[1], k4[2], k4[3]);
  }
  for (int i = tid; i < 2 * kBins; i += kSelThreads) hist[i] = 0;
  int n_mine;
  block_exclusive_scan<kSelWarps>(mine, warp_tot, &n_mine);
  if (tid == 0) info[0] = n_mine;
  cluster.sync();
  int cnt = 0;
#pragma unroll
  for (int b = 0; b < kSelCluster; ++b) cnt += cluster.map_shared_rank(info, b)[0];
  const int take = min(K, cnt);

  // the survivors: the keys under T, then the first `ties` keys equal to T in
  // pixel order; all masked keys when they are at most K
  unsigned T = kSelSentinel;
  int ties = 0;
  if (cnt > K) {
    // radix descent over the key's 4 bytes to the K-th smallest key: per
    // level, a histogram of the keys under the prefix per block, summed over
    // the cluster's blocks through distributed shared memory (the two
    // buffers alternate, so one cluster barrier per level suffices)
    int rem = K - 1;
    unsigned prefix = 0;
    for (int level = 0; level < 4; ++level) {
      const int shift = 24 - 8 * level;
      unsigned* h = hist + (level & 1) * kBins;
      if (level >= 2) {
        for (int i = tid; i < kBins; i += kSelThreads) h[i] = 0;
        __syncthreads();
      }
      sel_rounds(keys, slice, [&](uint4 q) {
        const unsigned v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = v[u] != kSelSentinel &&
                          (level == 0 || (v[u] >> (shift + 8)) == (prefix >> (shift + 8)));
          const unsigned digit = (v[u] >> shift) & (kBins - 1);
          const unsigned act = __ballot_sync(0xFFFFFFFFu, in);
          if (in) {  // one atomic per distinct digit of the warp
            const unsigned peers = __match_any_sync(act, digit);
            if (lane == __ffs(peers) - 1) atomicAdd(&h[digit], (unsigned)__popc(peers));
          }
        }
      });
      cluster.sync();
      int tot = 0;
      if (tid < kBins) {
#pragma unroll
        for (int b = 0; b < kSelCluster; ++b) tot += (int)cluster.map_shared_rank(h, b)[tid];
      }
      int all_bins;
      const int below = block_exclusive_scan<kSelWarps>(tot, warp_tot, &all_bins);
      if (tid < kBins && below <= rem && rem < below + tot) {
        info[3] = tid;
        info[4] = below;
      }
      __syncthreads();
      prefix |= (unsigned)info[3] << shift;
      rem -= info[4];
    }
    T = prefix;
    ties = rem + 1;
    // the ties in the blocks before this one
    int eq = 0;
    sel_rounds(keys, slice, [&](uint4 q) {
      eq += (q.x == T) + (q.y == T) + (q.z == T) + (q.w == T);
    });
    int n_eq;
    block_exclusive_scan<kSelWarps>(eq, warp_tot, &n_eq);
    if (tid == 0) info[1] = n_eq;
    cluster.sync();
  }
  int tie_seen = 0;  // ties in pixel order before the current round
  if (cnt > K) {
    for (int b = 0; b < rank; ++b) tie_seen += cluster.map_shared_rank(info, b)[1];
  }
  const int ties_before = min(tie_seen, ties);

  // compaction in pixel order, in place: round by round, each key read
  // before the scan's barriers and written after them, at or below its slot
  int n_lt = 0;
  for (int r0 = 0; r0 < slice; r0 += 4 * kSelThreads) {
    const int i0 = r0 + 4 * tid;
    uint4 q = make_uint4(kSelSentinel, kSelSentinel, kSelSentinel, kSelSentinel);
    if (i0 < slice) q = *reinterpret_cast<const uint4*>(keys + i0);
    const unsigned v[4] = {q.x, q.y, q.z, q.w};
    int lt = 0, eq = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lt += v[u] < T;
      eq += v[u] == T && T != kSelSentinel;
    }
    int in_round;
    const int excl = block_exclusive_scan<kSelWarps>(lt | (eq << 16), warp_tot, &in_round);
    int at_lt = n_lt + (excl & 0xFFFF), tie = tie_seen + (excl >> 16);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool is_lt = v[u] < T;
      const bool is_eq = v[u] == T && T != kSelSentinel;
      if (is_lt || (is_eq && tie < ties)) {
        const int at = at_lt + min(tie, ties) - ties_before;
        keys[at] = v[u];
        pix[at] = (unsigned short)(i0 + u);
      }
      at_lt += is_lt;
      tie += is_eq;
    }
    n_lt += in_round & 0xFFFF;
    tie_seen += in_round >> 16;
    __syncthreads();
  }
  const int n_b = n_lt + min(tie_seen, ties) - ties_before;
  if (tid == 0) info[2] = n_b;

  // the block's survivors sorted by (key, pixel): a bitonic sort whose
  // merges all run ascending (the first step of each compares i with its
  // mirror), so the slots at or past n_b act as +inf and are never written.
  // The steps inside a 64-slot tile run in a warp's registers (two slots
  // per lane, shuffles, no block barrier): the whole sort of each tile
  // first, then per merge the steps of stride < 32; the others on shared
  // memory between barriers.
  int log_pad = 0;
  while ((1 << log_pad) < n_b) ++log_pad;
  const int half_pad = (1 << log_pad) >> 1;
  const int tiles = ((1 << log_pad) + 63) >> 6;
  auto cas = [&](int a, int b) {
    if (b < n_b) {
      const unsigned ka = keys[a], kb = keys[b];
      const unsigned short pa = pix[a], pb = pix[b];
      if (sel_word(kb, pb) < sel_word(ka, pa)) {
        keys[a] = kb;
        keys[b] = ka;
        pix[a] = pb;
        pix[b] = pa;
      }
    }
  };
  const int warp = tid >> 5;
  for (int tile = warp; tile < tiles; tile += kSelWarps) sel_tile_sort(keys, pix, n_b, tile, true);
  __syncthreads();
  for (int lg = 7; lg <= log_pad; ++lg) {
    const int size = 1 << lg;
    for (int t = tid; t < half_pad; t += kSelThreads) {
      const int g = (t >> (lg - 1)) << lg, off = t & ((size >> 1) - 1);
      cas(g + off, g + size - 1 - off);
    }
    __syncthreads();
    for (int lj = lg - 2; lj >= 5; --lj) {
      const int j = 1 << lj;
      for (int t = tid; t < half_pad; t += kSelThreads) {
        const int a = ((t >> lj) << (lj + 1)) + (t & (j - 1));
        cas(a, a + j);
      }
      __syncthreads();
    }
    for (int tile = warp; tile < tiles; tile += kSelWarps) sel_tile_sort(keys, pix, n_b, tile, false);
    __syncthreads();
  }
  cluster.sync();

  // each survivor's rank over the cluster: its index here plus, per other
  // block, the number of that block's survivors below it (binary searches
  // in distributed shared memory, all blocks in lockstep)
  int rn[kSelCluster];
  int top = 0;
#pragma unroll
  for (int b = 0; b < kSelCluster; ++b) {
    rn[b] = b == rank ? 0 : cluster.map_shared_rank(info, b)[2];
    top = max(top, rn[b]);
  }
  int step_top = 1;
  while (step_top <= top) step_top <<= 1;
  int* out = sel_idx + (size_t)c * K;
  for (int i = tid; i < n_b; i += kSelThreads) {
    const unsigned long long w = sel_word(keys[i], (unsigned)(base + pix[i]));
    int lo[kSelCluster];
#pragma unroll
    for (int b = 0; b < kSelCluster; ++b) lo[b] = 0;
    for (int step = step_top >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int b = 0; b < kSelCluster; ++b) {
        const int j = lo[b] + step;
        if (j <= rn[b]) {
          const unsigned k = cluster.map_shared_rank(keys, b)[j - 1];
          const unsigned p = cluster.map_shared_rank(pix, b)[j - 1];
          if (sel_word(k, (unsigned)(b * slice) + p) < w) lo[b] = j;
        }
      }
    }
    int at = i;
#pragma unroll
    for (int b = 0; b < kSelCluster; ++b) at += lo[b];
    out[at] = base + pix[i];
  }
  for (int j = take + rank * kSelThreads + tid; j < K; j += kSelCluster * kSelThreads) out[j] = 0;
  if (rank == 0 && tid == 0) n_sel[c] = take;
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---- select_keys_radix (K4r) -------------------------------------------------
// One cluster of kRxCluster blocks per class; block `rank` owns the pixels
// [rank * slice, (rank + 1) * slice) of row c, walked in chunks of kRxChunk
// pixels, a chunk per warp: lane l holds the chunk's pixels 4 l .. 4 l + 3
// (the host's plan: losses/contrastive.py:_radix_plan).  The first `held`
// chunks of the slice stay in shared memory as read: the raw u32 keys, and
// the mask as 4 ballot words per chunk (bit l of word u: pixel 4 l + u),
// which the count pass overwrites with the selection's; the chunks past
// them are read again from global memory by every pass.  The mask is its
// own bit, so a masked key 0xFFFFFFFF counts and is taken like any other.
// Dynamic shared memory: two 256-bin histograms, kRxInfo ints, 32 ints of
// scan scratch, kRxSeg chunk counts, then the held chunks' words and keys.

constexpr int kRxCluster = 8;
constexpr int kRxThreads = 512;
constexpr int kRxWarps = kRxThreads / 32;
constexpr int kRxChunk = 128;          // pixels per chunk: 4 per lane
constexpr int kRxUnroll = 4;           // chunks a warp loads at once in the first read
constexpr int kRxSeg = kRxThreads;     // chunks per segment of the write pass
constexpr int kRxInfo = 16;            // masked count, selected count, -, digit, below
constexpr int kRxHeader = 2 * kBins * 4 + kRxInfo * 4 + 32 * 4 + kRxSeg * 4;  // bytes, 16-aligned
constexpr int kRxChunkBytes = kRxChunk * 4 + 16;  // keys and 4 mask words

// lane's 4 pixels of the chunk at i0 (relative to the block's first pixel)
// from global memory: keys in k, mask bits in mb (bit u: pixel i0 + u)
__device__ __forceinline__ void rx_load(const uint8_t* m, const unsigned* keys, int i0, int len,
                                        bool vec, unsigned (&k)[4], unsigned& mb) {
  if (vec && i0 + 4 <= len) {
    const uchar4 mm = *reinterpret_cast<const uchar4*>(m + i0);
    const uint4 q = *reinterpret_cast<const uint4*>(keys + i0);
    k[0] = q.x;
    k[1] = q.y;
    k[2] = q.z;
    k[3] = q.w;
    mb = (mm.x != 0) | (mm.y != 0) << 1 | (mm.z != 0) << 2 | (mm.w != 0) << 3;
  } else {
    mb = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      k[u] = 0;
      if (i < len) {
        k[u] = keys[i];
        mb |= (unsigned)(m[i] != 0) << u;
      }
    }
  }
}

__device__ __forceinline__ uint4 rx_ballots(unsigned bits) {
  return make_uint4(__ballot_sync(0xFFFFFFFFu, bits & 1u), __ballot_sync(0xFFFFFFFFu, bits & 2u),
                    __ballot_sync(0xFFFFFFFFu, bits & 4u), __ballot_sync(0xFFFFFFFFu, bits & 8u));
}

__device__ __forceinline__ unsigned rx_lane_bits(uint4 w, int lane) {
  return ((w.x >> lane) & 1u) | ((w.y >> lane) & 1u) << 1 | ((w.z >> lane) & 1u) << 2 |
         ((w.w >> lane) & 1u) << 3;
}

__global__ void __cluster_dims__(kRxCluster, 1, 1) __launch_bounds__(kRxThreads, 2)
select_keys_radix_kernel(const uint8_t* __restrict__ mask, const unsigned* __restrict__ keys,
                         int* __restrict__ sel_idx, int* __restrict__ n_sel, int N, int K,
                         int slice, int held, bool vec) {
  extern __shared__ __align__(16) unsigned char rx_smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(rx_smem);  // 2 x kBins
  int* info = reinterpret_cast<int*>(hist + 2 * kBins);
  int* warp_tot = info + kRxInfo;
  int* seg = warp_tot + 32;  // a segment's chunk counts, then their bases
  uint4* words = reinterpret_cast<uint4*>(rx_smem + kRxHeader);  // per held chunk
  uint4* held_keys = words + held;  // 32 per held chunk, lane l's at [32 j + l]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / kRxCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = rank * slice;
  const int len = max(0, min(slice, N - base));
  const int chunks = (len + kRxChunk - 1) / kRxChunk;
  const uint8_t* m = mask + (size_t)c * N + base;
  const unsigned* kc = keys + (size_t)c * N + base;
  // the lane's keys and mask bits of chunk j
  auto quad = [&](int j, unsigned (&k)[4], unsigned& mb) {
    if (j < held) {
      const uint4 q = held_keys[32 * j + lane];
      k[0] = q.x;
      k[1] = q.y;
      k[2] = q.z;
      k[3] = q.w;
      mb = rx_lane_bits(words[j], lane);
    } else {
      rx_load(m, kc, j * kRxChunk + 4 * lane, len, vec, k, mb);
    }
  };

  for (int i = tid; i < 2 * kBins; i += kRxThreads) hist[i] = 0;
  __syncthreads();

  // the one read from HBM: the held chunks kept, the masked count, and the
  // first level's histogram (by the keys' top byte) on the way
  int mine = 0;
  for (int j0 = warp; j0 < chunks; j0 += kRxWarps * kRxUnroll) {
    unsigned k[kRxUnroll][4], mb[kRxUnroll];
#pragma unroll
    for (int r = 0; r < kRxUnroll; ++r) {
      const int j = j0 + r * kRxWarps;
      mb[r] = 0;
      if (j < chunks) rx_load(m, kc, j * kRxChunk + 4 * lane, len, vec, k[r], mb[r]);
    }
#pragma unroll
    for (int r = 0; r < kRxUnroll; ++r) {
      const int j = j0 + r * kRxWarps;  // warp-uniform
      if (j < chunks) {
        const uint4 w = rx_ballots(mb[r]);
        if (j < held) {
          held_keys[32 * j + lane] = make_uint4(k[r][0], k[r][1], k[r][2], k[r][3]);
          if (lane == 0) words[j] = w;
        }
        mine += __popc(mb[r]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if ((mb[r] >> u) & 1u) atomicAdd(&hist[k[r][u] >> 24], 1u);
        }
      }
    }
  }
  int n_mine;
  block_exclusive_scan<kRxWarps>(mine, warp_tot, &n_mine);
  if (tid == 0) info[0] = n_mine;
  cluster.sync();
  int cnt = 0, before = 0;
#pragma unroll
  for (int b = 0; b < kRxCluster; ++b) {
    const int v = cluster.map_shared_rank(info, b)[0];
    cnt += v;
    before += b < rank ? v : 0;
  }
  const int kk = min(K, N);
  const bool all = cnt <= kk;  // every masked pixel is taken: no descent
  unsigned t = 0xFFFFFFFFu;
  int total = cnt, block_base = before;
  if (!all) {
    // the rank-(kk - 1) masked key: per level, the blocks' 256-bin
    // histograms of the keys under the prefix, summed over the cluster
    // through distributed shared memory, and the digit picked by a block
    // scan in every block (the two buffers alternate, so one cluster
    // barrier per level suffices; level 0's came with the first read)
    int rem = kk - 1;
    unsigned prefix = 0;
    for (int level = 0; level < 4; ++level) {
      const int shift = 24 - 8 * level;
      unsigned* h = hist + (level & 1) * kBins;
      if (level > 0) {
        if (level >= 2) {
          for (int i = tid; i < kBins; i += kRxThreads) h[i] = 0;
          __syncthreads();
        }
        const unsigned hi = prefix >> (shift + 8);
        for (int j = warp; j < chunks; j += kRxWarps) {
          unsigned k[4], mb;
          quad(j, k, mb);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (((mb >> u) & 1u) && (k[u] >> (shift + 8)) == hi) {
              atomicAdd(&h[(k[u] >> shift) & (kBins - 1)], 1u);
            }
          }
        }
        cluster.sync();
      }
      int tot = 0;
      if (tid < kBins) {
#pragma unroll
        for (int b = 0; b < kRxCluster; ++b) tot += (int)cluster.map_shared_rank(h, b)[tid];
      }
      int all_bins;
      const int below = block_exclusive_scan<kRxWarps>(tot, warp_tot, &all_bins);
      if (tid < kBins && below <= rem && rem < below + tot) {
        info[3] = tid;
        info[4] = below;
      }
      __syncthreads();
      prefix |= (unsigned)info[3] << shift;
      rem -= info[4];
    }
    t = prefix;
    // the selection (masked, key <= t) per chunk: the held chunks' mask
    // words become its words; the block's count meets the others' for the
    // blocks' bases
    int sel_mine = 0;
    for (int j = warp; j < chunks; j += kRxWarps) {
      unsigned k[4], mb;
      quad(j, k, mb);
      unsigned s = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) s |= (unsigned)(((mb >> u) & 1u) && k[u] <= t) << u;
      if (j < held) {
        const uint4 w = rx_ballots(s);
        if (lane == 0) words[j] = w;
      }
      sel_mine += __popc(s);
    }
    int n_sel_b;
    block_exclusive_scan<kRxWarps>(sel_mine, warp_tot, &n_sel_b);
    if (tid == 0) info[1] = n_sel_b;
    cluster.sync();
    total = 0;
    block_base = 0;
#pragma unroll
    for (int b = 0; b < kRxCluster; ++b) {
      const int v = cluster.map_shared_rank(info, b)[1];
      total += v;
      block_base += b < rank ? v : 0;
    }
  }
  // the selection's 4 words of chunk j (warp-uniform j)
  auto sel_words = [&](int j) {
    if (j < held) return words[j];
    unsigned k[4], mb;
    rx_load(m, kc, j * kRxChunk + 4 * lane, len, vec, k, mb);
    unsigned s = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) s |= (unsigned)(((mb >> u) & 1u) && (all || k[u] <= t)) << u;
    return rx_ballots(s);
  };

  // compaction in pixel order: per segment of kRxSeg chunks, a block scan
  // of the chunks' counts, then each warp writes its chunks' selected
  // pixels below k at the block's base, the chunk's and the lane's
  int* out = sel_idx + (size_t)c * K;
  int seg_base = block_base;
  for (int s0 = 0; s0 < chunks && seg_base < K; s0 += kRxSeg) {  // block-uniform
    const int s1 = min(chunks, s0 + kRxSeg);
    for (int j = s0 + warp; j < s1; j += kRxWarps) {
      const uint4 w = sel_words(j);
      if (lane == 0) seg[j - s0] = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    }
    __syncthreads();
    const int v = tid < s1 - s0 ? seg[tid] : 0;
    int seg_tot;
    const int ex = block_exclusive_scan<kRxWarps>(v, warp_tot, &seg_tot);
    if (tid < s1 - s0) seg[tid] = ex;
    __syncthreads();
    for (int j = s0 + warp; j < s1; j += kRxWarps) {
      const int at0 = seg_base + seg[j - s0];
      if (at0 >= K) continue;  // warp-uniform
      const uint4 w = sel_words(j);
      const unsigned lt = (1u << lane) - 1u;
      int at = at0 + __popc(w.x & lt) + __popc(w.y & lt) + __popc(w.z & lt) + __popc(w.w & lt);
      const unsigned bits = rx_lane_bits(w, lane);
      const int pix = base + j * kRxChunk + 4 * lane;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((bits >> u) & 1u) {
          if (at < K) out[at] = pix + u;
          ++at;
        }
      }
    }
    seg_base += seg_tot;
    __syncthreads();  // the next segment rewrites seg
  }
  // past the selection, N - 1 (JAX's clipped searchsorted miss), spread
  // over the cluster
  for (long long j = (long long)min(total, K) + rank * kRxThreads + tid; j < K;
       j += kRxCluster * kRxThreads) {
    out[j] = N - 1;
  }
  if (rank == 0 && tid == 0) n_sel[c] = min(cnt, K);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---- sample_anchors --------------------------------------------------------
// One cluster of kAncCluster blocks per position j; block `rank` owns the
// words [rank * slice, (rank + 1) * slice) of row a_j[j], a word being the
// row's alignment, vec = gcd(N, 16, the mask's address) bytes (the host's
// plan: losses/contrastive.py:_anchors_plan).  Each warp reads a contiguous
// span of `runs` runs of 32 words, a run per load, once (torch.bool stores
// 0 / 1, so a 4-byte word's count is __popc(w & 0x01010101)), and keeps each
// run's exclusive prefix within the warp in shared memory; one block scan
// gives the warps' bases, and the cluster's blocks read each other's totals
// through distributed shared memory for their base and the row's n.  A draw
// r = floor(u * n) is served by the block whose pixels hold the r-th set
// one: its warp by the scanned totals, its run by a binary search of the
// prefixes, its word by counting the run's words again, kAncRescan loads at
// a time, its pixel inside the word; r outside [0, n) (n = 0, or u * n
// rounded up to n) gives N - 1, written by the last block.
// Dynamic shared memory: kAncHeader bytes (the warps' inclusive totals, the
// last one the block's), then the runs' prefixes (int), kAncWarps * runs.

constexpr int kAncCluster = 8;
constexpr int kAncThreads = 256;
constexpr int kAncWarps = kAncThreads / 32;
constexpr int kAncHeader = 256;  // bytes, >= kAncWarps * 4, 16-aligned
constexpr int kAncRescan = 8;  // a run's words counted again per round of loads

// the set pixels of the vec-byte word at p (p vec-aligned)
template <int kVec>
__device__ __forceinline__ void anc_load(const uint8_t* p, unsigned (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if constexpr (kVec == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (kVec == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (kVec == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (kVec == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    w[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ int anc_count(const unsigned (&w)[4]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < (kVec + 3) / 4; ++i) n += __popc(w[i] & 0x01010101u);
  return n;
}

template <int kVec>
__global__ void __cluster_dims__(kAncCluster, 1, 1) __launch_bounds__(kAncThreads)
sample_anchors_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ a_j,
                      const float* __restrict__ u, int* __restrict__ idx,
                      int* __restrict__ count, int N, int Q, int slice) {
  extern __shared__ __align__(16) unsigned char anc_smem[];
  int* warp_tot = reinterpret_cast<int*>(anc_smem);  // kAncWarps inclusive totals
  int* pre = reinterpret_cast<int*>(anc_smem + kAncHeader);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j = blockIdx.x / kAncCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* row = mask + (size_t)a_j[j] * N;
  const int first = rank * slice;  // the block's first word
  const int len = max(0, min(slice, N / kVec - first));
  const int runs = (slice + kAncThreads - 1) / kAncThreads;  // per warp
  const uint8_t* words = row + (size_t)first * kVec;

  // each run's set pixels, its exclusive prefix within the warp; run k of
  // the block holds its words [32 k, 32 k + 32)
  int tally = 0;
#pragma unroll 4
  for (int r = 0; r < runs; ++r) {
    const int i = (warp * runs + r) * 32 + lane;
    int c = 0;
    if (i < len) {
      unsigned w[4];
      anc_load<kVec>(words + (size_t)i * kVec, w);
      c = anc_count<kVec>(w);
    }
    c = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)c);
    if (lane == 0) pre[warp * runs + r] = tally;
    tally += c;
  }
  if (lane == 0) warp_tot[warp] = tally;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kAncWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kAncWarps) warp_tot[lane] = t;  // inclusive over the warps
  }
  __syncthreads();
  const int tot = warp_tot[kAncWarps - 1];
  cluster.sync();
  int base = 0, n = 0;
#pragma unroll
  for (int b = 0; b < kAncCluster; ++b) {
    const int t = cluster.map_shared_rank(warp_tot, b)[kAncWarps - 1];
    n += t;
    base += b < rank ? t : 0;
  }
  if (rank == 0 && tid == 0) count[j] = n;
  const float nf = (float)n;
  for (int q = tid; q < Q; q += kAncThreads) {
    const int r = (int)floorf(__fmul_rn(u[(size_t)j * Q + q], nf));
    if (r >= base && r < base + tot) {
      int k = r - base;
      int wp = 0;  // the warp whose words hold the k-th set pixel of the block
      while (warp_tot[wp] <= k) ++wp;
      k -= wp == 0 ? 0 : warp_tot[wp - 1];
      // the last run of the warp whose prefix is <= k
      int lo = wp * runs, hi = lo + runs - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= k) lo = mid;
        else hi = mid - 1;
      }
      k -= pre[lo];
      // the run's words counted again, kAncRescan at a time, to the word
      // that holds the k-th set pixel (it lies in this run, below len)
      int i = lo * 32;
      for (;; i += kAncRescan) {
        int c[kAncRescan], sum = 0;
#pragma unroll
        for (int e = 0; e < kAncRescan; ++e) {
          c[e] = 0;
          if (i + e < len) {
            unsigned w[4];
            anc_load<kVec>(words + (size_t)(i + e) * kVec, w);
            c[e] = anc_count<kVec>(w);
          }
          sum += c[e];
        }
        if (k < sum) {
          int at_word = 0;
          bool found = false;
#pragma unroll
          for (int e = 0; e < kAncRescan; ++e) {
            if (!found && k < c[e]) {
              found = true;
              at_word = e;
            } else if (!found) {
              k -= c[e];
            }
          }
          i += at_word;
          break;
        }
        k -= sum;
      }
      unsigned w[4];
      anc_load<kVec>(words + (size_t)i * kVec, w);
      int at = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int bit = (w[e >> 2] >> (8 * (e & 3))) & 1;
        if (bit && k == 0) at = e;
        k -= bit;
      }
      idx[(size_t)j * Q + q] = (first + i) * kVec + at;
    } else if (rank == kAncCluster - 1 && !(r >= 0 && r < n)) {
      idx[(size_t)j * Q + q] = N - 1;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

}  // namespace

extern "C" {

// the plan (losses/contrastive.py:_masks_plan): `blocks` blocks of
// kMaskThreads threads, kMaskPix pixels a thread; ticket: 1 + 2 *
// kMaxClasses zeroed u32 words of kernels.tickets, left zero.  Wide stores
// where N % 4 == 0, wide loads where labels are 16-aligned and low and
// high 4-aligned.
int u2pl_contra_pixel_masks(const void* prob, const void* labels,
                            const void* low, const void* high, void* anchor,
                            void* negative, void* low_valid, void* counts,
                            void* ticket, int B, int B_l, int C, int HW, int ignore,
                            float delta_p, float delta_n, int low_rank,
                            int high_rank, int blocks, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C > kMaxClasses || blocks <= 0 ||
      (long long)B * HW * C >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec_out = (B * HW) % kMaskPix == 0;
  const bool vec_in = (uintptr_t)labels % 16 == 0 && (uintptr_t)low % 4 == 0 &&
                      (uintptr_t)high % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    kernel<<<blocks, kMaskThreads, 0, s>>>(
        (const float*)prob, (const int*)labels, (const uint8_t*)low, (const uint8_t*)high,
        (uint8_t*)anchor, (uint8_t*)negative, (float*)low_valid, (int*)counts,
        (unsigned*)ticket, B, B_l, C, HW, ignore, delta_p, delta_n, low_rank, high_rank,
        vec_in, vec_out);
  };
  // the configs' class counts at compile time: 0.0108 / 0.0121 ms against
  // 0.0153 / 0.0158 for the run-time loop at the VOC / Cityscapes shapes
  // (NVIDIA H100 80GB HBM3, 700 W; timing_ab.py, PERF.md)
  if (C == 21) launch(pixel_masks_kernel<21>);  // VOC
  else if (C == 19) launch(pixel_masks_kernel<19>);  // Cityscapes
  else launch(pixel_masks_kernel<0>);
  return (int)cudaGetLastError();
}

// the plan (losses/contrastive.py:_select_plan): kSelCluster blocks per class
// of `slice` pixels each, pixcap survivors' pixels, smem bytes
int u2pl_contra_select_keys(const void* mask, const void* pri, void* sel_idx,
                            void* n_sel, int C, int N, int K, int slice,
                            int pixcap, int smem, void* stream) {
  if (C <= 0 || N <= 0 || K <= 0 || K > kMaxKeys || slice <= 0 || slice % 4 != 0 ||
      (long long)slice * kSelCluster < N || slice > 65536 || pixcap < min(K, slice) ||
      smem != kSelHeader + 4 * slice + 2 * pixcap || smem > kSelMaxShared) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      select_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  select_keys_kernel<<<C * kSelCluster, kSelThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const float*)pri, (int*)sel_idx, (int*)n_sel, N, K, slice);
  return (int)cudaGetLastError();
}

// the plan (losses/contrastive.py:_radix_plan): kRxCluster blocks per class
// of `slice` pixels each, the first `held` chunks of a slice in smem bytes of
// shared memory (as many as fit); wide loads where N % 4 == 0 and the
// pointers allow them
int u2pl_contra_select_keys_radix(const void* mask, const void* keys, void* idx, void* n_sel,
                                  int C, int N, int K, int slice, int held, int smem,
                                  void* stream) {
  const int chunks = slice > 0 ? (slice + kRxChunk - 1) / kRxChunk : 0;
  if (C <= 0 || N <= 0 || K <= 0 || slice <= 0 || slice % 4 != 0 ||
      (long long)slice * kRxCluster < N || held < 0 || held > chunks ||
      smem != kRxHeader + held * kRxChunkBytes || smem > kSelMaxShared ||
      (held < chunks && smem + kRxChunkBytes <= kSelMaxShared)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = N % 4 == 0 && (uintptr_t)mask % 4 == 0 && (uintptr_t)keys % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(select_keys_radix_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  select_keys_radix_kernel<<<C * kRxCluster, kRxThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const unsigned*)keys, (int*)idx, (int*)n_sel, N, K, slice, held,
      vec);
  return (int)cudaGetLastError();
}

// the plan (losses/contrastive.py:_anchors_plan): kAncCluster blocks per
// position of `slice` words of vec bytes each, smem bytes
int u2pl_contra_sample_anchors(const void* mask, const void* a_j,
                               const void* u, void* idx, void* count, int C,
                               int N, int Q, int vec, int slice, int smem, void* stream) {
  if (C <= 0 || N <= 0 || Q <= 0 || slice <= 0 || N % vec != 0 ||
      (long long)slice * kAncCluster * vec < N ||
      smem != kAncHeader + 4 * kAncWarps * ((slice + kAncThreads - 1) / kAncThreads) ||
      smem > kSelMaxShared) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<C * kAncCluster, kAncThreads, smem, s>>>(
        (const uint8_t*)mask, (const int*)a_j, (const float*)u, (int*)idx, (int*)count, N, Q,
        slice);
    return cudaGetLastError();
  };
  switch (vec) {
    case 16: return (int)launch(sample_anchors_kernel<16>);
    case 8: return (int)launch(sample_anchors_kernel<8>);
    case 4: return (int)launch(sample_anchors_kernel<4>);
    case 2: return (int)launch(sample_anchors_kernel<2>);
    case 1: return (int)launch(sample_anchors_kernel<1>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Kernel E (family K2, sm_90a): exact numpy-'linear' percentiles of a masked
// f32 map by radix selection; replaces u2pl_tpu/ops/quantile.py:
// masked_percentiles (:136) with _order_keys (:79), _keys_to_f32 (:90) and
// _kth_smallest_keys (:97).
//
// The JAX algorithm, on the card: every value becomes an order-preserving
// u32 key (masked-out values the key of +inf, so they sort last, as in the
// masked sort), and a radix descent finds the lo-th smallest key of each
// query without sorting.  The rank arithmetic (pct / 100 * (n - 1), floor,
// frac) is the JAX f32 arithmetic, each operation rounded on its own, so
// the result is bit-equal to the masked sort and to JAX.  The count n, the
// ranks and the result stay on the device: nothing syncs with the host.
//
// u2pl_kth_smallest (family K7) is the same descent with a rank in place of
// a percent: no mask (every value counts) and one query at the 0-based rank
// k - 1; replaces u2pl_tpu/losses/ohem.py:_kth_smallest (:35), OHEM's
// min_kept-th smallest target-class probability.
//
// Bound: bytes, one read of the values (and the mask): 4.2-5.3 MB at
// 1,052,676 / 1,182,722 values, ~1.5 us.  The first design ran the descent
// as ten launches (per level a histogram pass over the values and a
// one-warp digit pick; then a tail pass and a finalize) plus a memset of its
// state, five reads of the values: 0.071-0.073 ms at VOC on an NVIDIA H100
// 80GB HBM3 at 700 W, ~45x its bound.  This design is one cooperative launch
// of one 1024-thread block per SM:
//   - each block turns its slice of the values into keys once, keeps them
//     in shared memory (a slice longer than kMaxKeyBytes re-reads the rest
//     from global memory at every level) and counts n as it goes;
//   - per level, the block's histogram of the keys that match each query's
//     prefix (shared atomics) is added into that level's grid histogram
//     with integer atomics, exact whatever the order; after a grid barrier
//     every block reads it and picks each query's digit itself, by a
//     block-wide scan of the bins;
//   - the digits are kDigit bits wide, the last level takes the rest;
//   - at the last level the grid's histogram of the selected group also
//     gives sorted[lo + 1] without another pass: the count of keys <= the
//     selected one is the rank less what is left plus its bin's count, and
//     the next greater key is the next nonzero bin, or else the smallest key
//     above the group, which each block tracks in the same pass;
//   - the last block to finish (a ticket) picks the last digit, writes the
//     result and zeroes the histograms the call used, so a call needs no
//     memset.
// The workspace is one per device, zero between calls.  A grid that cannot
// be co-resident is refused with an error before the launch.  At most 4
// queries per call (the contrastive slice needs 3).  Measured and dropped
// (kernels/descent_variants.py): 11/11/10-bit digits (3 levels, 2
// barriers, but 2048 bins to scan per query and level), warp-aggregated
// shared atomics (__match_any_sync: slower even on a probability map's few
// hot bins), clearing the whole workspace.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxQueries = 4;
constexpr int kDigit = 8;  // bits of a level's digit; the last level takes the rest
constexpr int kLevels = (32 + kDigit - 1) / kDigit;
constexpr int kBins = 1 << kDigit;
constexpr int kDescThreads = 1024;
constexpr int kSegThreads = kDescThreads / kMaxQueries;  // threads that scan one query's bins
constexpr int kPer = kBins / kSegThreads;                // bins per thread in the scan
static_assert(kBins >= kSegThreads && kBins % kSegThreads == 0, "digit too narrow for the scan");
constexpr int kMaxKeyBytes = 176 * 1024;  // a block's keys in shared memory
constexpr unsigned kInfKey = 0xFF800000u;  // order key of +inf
constexpr unsigned kNone = 0xFFFFFFFFu;

// workspace words: the valid count n, the ticket, per query the complement
// of the smallest key above its last group (0: none), then per level
// kMaxQueries histograms of kBins (level 0: one, shared by every query)
constexpr int kWsCount = 0;
constexpr int kWsTicket = 1;
constexpr int kWsAbove = 4;
constexpr int kWsHist = 8;
constexpr int kWsWords = kWsHist + kLevels * kMaxQueries * kBins;

__host__ __device__ constexpr int level_shift(int level) {
  return 32 - kDigit * (level + 1) > 0 ? 32 - kDigit * (level + 1) : 0;
}

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_to_f32(unsigned key) {
  return __uint_as_float((key >> 31) == 0 ? ~key : (key & 0x7FFFFFFFu));
}

// a null mask: every value counts (the k-th smallest of u2pl_kth_smallest)
__device__ __forceinline__ unsigned key_at(const float* __restrict__ v,
                                           const uint8_t* __restrict__ m,
                                           unsigned i) {
  return (m == nullptr || m[i]) ? order_key(v[i]) : kInfKey;
}

// what every block of the grid holds alike, per query
struct Descent {
  unsigned prefix[kMaxQueries];  // the digits selected so far
  unsigned rem[kMaxQueries];     // the rank left among the keys with that prefix
  unsigned rank[kMaxQueries];    // the 0-based rank of the lo-th key, clamped
  int lo[kMaxQueries], hi[kMaxQueries];
  float frac[kMaxQueries];
  unsigned n;                    // valid values
  unsigned sel[kMaxQueries], below[kMaxQueries], count[kMaxQueries];
  unsigned next[kMaxQueries];    // the last level: the next nonzero bin
  unsigned above[kMaxQueries];   // the block's smallest key above the last group
  unsigned wsum[kDescThreads / 32];
  unsigned valid;
  bool last;
};

// Each query's digit at `level` from the grid's histogram gh (query q's at
// gh + q * kBins; level 0 one histogram for all): 256 threads scan a
// query's bins, kPer each.  The thread whose bins hold the remaining rank
// records the bin, the count below it and its count; with `last`, the
// thread holding the next nonzero bin records that too.  Every thread
// calls this.
template <bool PCT>
__device__ void select_digit(Descent& s, const unsigned* gh, int level, int K,
                             const float* __restrict__ pct, unsigned ntotal,
                             const unsigned* ws, bool last) {
  const int tid = threadIdx.x, lane = tid & 31, seg = tid / kSegThreads;
  const int part = tid % kSegThreads;
  const int segs = level == 0 ? 1 : K;
  if (level == 0 && tid < K) {
    // quantile.py:153-157 in f32, each operation rounded on its own; with no
    // percents, query 0 takes the 0-based rank already in s.rank
    if (PCT) {
      const int nv = (int)__ldcg(ws + kWsCount);
      const int nm1 = nv - 1 > 0 ? nv - 1 : 0;
      const float r = __fmul_rn(__fdiv_rn(pct[tid], 100.0f), __int2float_rn(nm1));
      const int lo = (int)floorf(r);
      s.lo[tid] = lo;
      s.hi[tid] = lo + 1 < nm1 ? lo + 1 : nm1;
      s.frac[tid] = __fsub_rn(r, __int2float_rn(lo));
      s.rank[tid] = (unsigned)(lo < 0 ? 0 : (lo > (int)ntotal - 1 ? (int)ntotal - 1 : lo));
      if (tid == 0) s.n = (unsigned)nv;
    }
    s.rem[tid] = s.rank[tid];
    s.prefix[tid] = 0;
  }
  unsigned h[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    h[e] = seg < segs ? __ldcg(gh + seg * kBins + part * kPer + e) : 0u;
    sum += h[e];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s.wsum[tid >> 5] = incl;
  __syncthreads();
  unsigned below = incl - sum;  // the query's keys in bins before this thread's
  for (int w = seg * (kSegThreads / 32); w < (tid >> 5); ++w) below += s.wsum[w];
  for (int q = 0; q < K; ++q) {
    if (seg != (level == 0 ? 0 : q)) continue;
    const unsigned r = s.rem[q];
    if (r < below || r >= below + sum) continue;
    unsigned acc = below;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (r >= acc && r < acc + h[e]) {
        s.sel[q] = part * kPer + e;
        s.below[q] = acc;
        s.count[q] = h[e];
      }
      acc += h[e];
    }
  }
  if (last && tid < K) s.next[tid] = kNone;
  __syncthreads();
  if (last) {
    // the bins between the selected one and the next nonzero one are empty,
    // so that bin is the nonzero one whose keys below are below + count
    for (int q = 0; q < K; ++q) {
      if (seg != q) continue;
      const unsigned want = s.below[q] + s.count[q];
      unsigned acc = below;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const unsigned b = part * kPer + e;
        if (h[e] && b > s.sel[q] && acc == want) s.next[q] = b;
        acc += h[e];
      }
    }
  }
  if (tid < K) {
    s.prefix[tid] |= s.sel[tid] << level_shift(level);
    s.rem[tid] -= s.below[tid];
  }
  __syncthreads();
}

// the block's histogram of the keys at `level`: per query, the keys whose
// higher digits are its prefix; at the last level (percentiles) also the
// smallest key above that group
template <bool PCT>
__device__ __forceinline__ void count_key(const Descent& s, unsigned* hist, int level,
                                          int K, unsigned key, bool in,
                                          unsigned (&above)[kMaxQueries]) {
  const int shift = level_shift(level);
  const int bits = (level == 0 ? 32 : level_shift(level - 1)) - shift;
  const unsigned bin = (key >> shift) & ((1u << bits) - 1);
  if (level == 0) {
    if (in) atomicAdd(hist + bin, 1u);
    return;
  }
  const int up = level_shift(level - 1);
#pragma unroll
  for (int q = 0; q < kMaxQueries; ++q) {
    if (q < K) {
      const unsigned kh = key >> up, ph = s.prefix[q] >> up;
      if (in && kh == ph) atomicAdd(hist + q * kBins + bin, 1u);
      if (PCT && level == kLevels - 1 && in && kh > ph) above[q] = min(above[q], key);
    }
  }
}

// adds the block's histograms into the grid's (gh) and clears them
__device__ __forceinline__ void flush(unsigned* hist, unsigned* gh, int segs) {
  for (int j = threadIdx.x; j < segs * kBins; j += kDescThreads) {
    if (hist[j]) {
      atomicAdd(gh + j, hist[j]);
      hist[j] = 0;
    }
  }
}

template <bool PCT>
__global__ void __launch_bounds__(kDescThreads, 1) radix_descent_kernel(
    const float* __restrict__ v, const uint8_t* __restrict__ m,
    const float* __restrict__ pct, unsigned rank0, unsigned n, int K,
    unsigned slice, unsigned cap, unsigned* __restrict__ ws,
    float* __restrict__ out) {
  extern __shared__ uint4 key_smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(key_smem);  // the slice's first `cap` keys
  __shared__ unsigned hist[kMaxQueries * kBins];
  __shared__ Descent s;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const unsigned base = blockIdx.x * slice;
  const unsigned cnt = base < n ? min(slice, n - base) : 0u;
  const unsigned held = min(cnt, cap);
  for (int j = tid; j < kMaxQueries * kBins; j += kDescThreads) hist[j] = 0;
  if (tid == 0) s.valid = 0;
  if (tid < kMaxQueries) {
    s.above[tid] = kNone;
    s.rank[tid] = rank0;
  }
  __syncthreads();

  // level 0 with the one read of the values: 4 per thread and step, as one
  // 16-byte load (and a 4-byte mask load) where aligned
  const float* vb = v + base;
  const uint8_t* mb = m ? m + base : nullptr;
  const bool vec = ((uintptr_t)vb & 15) == 0 && (mb == nullptr || ((uintptr_t)mb & 3) == 0);
  unsigned valid = 0, above[kMaxQueries] = {kNone, kNone, kNone, kNone};
  for (unsigned j0 = 0; j0 < cnt; j0 += 4 * kDescThreads) {
    const unsigned j = j0 + 4 * tid;
    unsigned k4[4];
    if (vec && j + 4 <= cnt) {
      const float4 x = *reinterpret_cast<const float4*>(vb + j);
      const uchar4 mm = mb ? *reinterpret_cast<const uchar4*>(mb + j) : make_uchar4(1, 1, 1, 1);
      k4[0] = mm.x ? order_key(x.x) : kInfKey;
      k4[1] = mm.y ? order_key(x.y) : kInfKey;
      k4[2] = mm.z ? order_key(x.z) : kInfKey;
      k4[3] = mm.w ? order_key(x.w) : kInfKey;
      if (PCT) valid += (mm.x != 0) + (mm.y != 0) + (mm.z != 0) + (mm.w != 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k4[e] = j + e < cnt ? key_at(vb, mb, j + e) : kInfKey;
        if (PCT && j + e < cnt) valid += mb == nullptr || mb[j + e];
      }
    }
    if (j + 4 <= held) {
      *reinterpret_cast<uint4*>(keys + j) = make_uint4(k4[0], k4[1], k4[2], k4[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + e < held) keys[j + e] = k4[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) count_key<PCT>(s, hist, 0, K, k4[e], j + e < cnt, above);
  }
  if (PCT) {
    valid = __reduce_add_sync(0xFFFFFFFFu, valid);
    if ((tid & 31) == 0 && valid) atomicAdd(&s.valid, valid);
  }
  __syncthreads();
  flush(hist, ws + kWsHist, 1);
  if (PCT && tid == 0 && s.valid) atomicAdd(ws + kWsCount, s.valid);
  grid.sync();

#pragma unroll 1
  for (int level = 1; level < kLevels; ++level) {
    unsigned* gh = ws + kWsHist + (level - 1) * kMaxQueries * kBins;
    select_digit<PCT>(s, gh, level - 1, K, pct, n, ws, false);
    for (unsigned j0 = 0; j0 < held; j0 += 4 * kDescThreads) {
      const unsigned j = j0 + 4 * tid;
      const uint4 k4 = j < held ? *reinterpret_cast<const uint4*>(keys + j) : make_uint4(0, 0, 0, 0);
      count_key<PCT>(s, hist, level, K, k4.x, j < held, above);
      count_key<PCT>(s, hist, level, K, k4.y, j + 1 < held, above);
      count_key<PCT>(s, hist, level, K, k4.z, j + 2 < held, above);
      count_key<PCT>(s, hist, level, K, k4.w, j + 3 < held, above);
    }
    for (unsigned j0 = held; j0 < cnt; j0 += kDescThreads) {  // past shared memory
      const unsigned j = j0 + tid;
      count_key<PCT>(s, hist, level, K, j < cnt ? key_at(vb, mb, j) : kInfKey, j < cnt, above);
    }
    if (PCT && level == kLevels - 1) {
#pragma unroll
      for (int q = 0; q < kMaxQueries; ++q) {
        const unsigned a = __reduce_min_sync(0xFFFFFFFFu, above[q]);
        if ((tid & 31) == 0 && a != kNone) atomicMin(&s.above[q], a);
      }
    }
    __syncthreads();
    flush(hist, gh + kMaxQueries * kBins, K);
    if (PCT && level == kLevels - 1 && tid < K && s.above[tid] != kNone) {
      atomicMax(ws + kWsAbove + tid, ~s.above[tid]);
    }
    if (level < kLevels - 1) grid.sync();
  }

  // the last block to add its counts picks the last digit and finishes
  __threadfence();
  __syncthreads();
  if (tid == 0) s.last = atomicInc(ws + kWsTicket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s.last) return;
  __threadfence();
  unsigned* gh = ws + kWsHist + (kLevels - 1) * kMaxQueries * kBins;
  select_digit<PCT>(s, gh, kLevels - 1, K, pct, n, ws, PCT);
  if (tid < K) {
    const unsigned key = s.prefix[tid];
    const float v_lo = key_to_f32(key);
    if (!PCT) {
      out[0] = v_lo;
    } else {
      // sorted[lo + 1]: the selected key again while the keys <= it reach
      // past rank hi, else the next greater key (the quantile.py:169-181
      // tail)
      const unsigned le = s.rank[tid] - s.rem[tid] + s.count[tid];
      const unsigned low = (1u << level_shift(kLevels - 2)) - 1;  // the last group's bits
      const unsigned nxt = s.next[tid] != kNone ? (key & ~low) | s.next[tid]
                                                : ~__ldcg(ws + kWsAbove + tid);
      const int lo = s.lo[tid], hi = s.hi[tid];
      float v_hi = (int)le > hi ? v_lo : key_to_f32(nxt);
      if (hi == lo) v_hi = v_lo;
      const float r = __fadd_rn(v_lo, __fmul_rn(s.frac[tid], __fsub_rn(v_hi, v_lo)));
      out[tid] = s.n > 0 ? r : INFINITY;
    }
  }
  __syncthreads();
  // every other block is done with the workspace: leave it zero (the
  // counters, level 0's histogram, K histograms of each later level)
  for (int j = tid; j < kWsHist + kBins; j += kDescThreads) {
    if (j != kWsTicket) ws[j] = 0;
  }
  for (int level = 1; level < kLevels; ++level) {
    for (int j = tid; j < K * kBins; j += kDescThreads) {
      ws[kWsHist + level * kMaxQueries * kBins + j] = 0;
    }
  }
}

template <bool PCT>
int launch_descent(const float* v, const uint8_t* m, const float* pct,
                   unsigned rank0, int n, int K, int grid, int slice, int cap,
                   unsigned* ws, float* out, cudaStream_t stream) {
  if (grid <= 0 || slice <= 0 || slice % 4 || (long long)grid * slice < n || cap < 0 ||
      cap > slice || cap % 4 || 4LL * cap > kMaxKeyBytes) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = radix_descent_kernel<PCT>;
  const int smem = 4 * cap;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the grid must be co-resident: one block per SM, where the occupancy
  // allows it
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDescThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  unsigned un = (unsigned)n, us = (unsigned)slice, uc = (unsigned)cap;
  void* args[] = {&v, &m, &pct, &rank0, &un, &K, &us, &uc, &ws, &out};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kDescThreads),
                                          args, (size_t)smem, stream);
}

}  // namespace

extern "C" {

int u2pl_quantile_max_queries(void) { return kMaxQueries; }

int u2pl_quantile_digit_bits(void) { return kDigit; }

int u2pl_quantile_max_key_bytes(void) { return kMaxKeyBytes; }

// the workspace: u2pl_quantile_state_words() u32 words, zero before a call
// and left zero by it
int u2pl_quantile_state_words(void) { return kWsWords; }

// (grid, slice, cap) from ops/quantile.py:_descent_plan: block b holds
// values [b * slice, (b + 1) * slice), the first cap of them in shared memory
int u2pl_masked_percentiles(const void* values, const void* mask,
                            const void* pct, void* out, void* state, int n,
                            int K, int grid, int slice, int cap, void* stream) {
  if (n <= 0 || K <= 0 || K > kMaxQueries) return (int)cudaErrorInvalidValue;
  return launch_descent<true>((const float*)values, (const uint8_t*)mask, (const float*)pct,
                              0u, n, K, grid, slice, cap, (unsigned*)state, (float*)out,
                              (cudaStream_t)stream);
}

// the exact k-th smallest (1-based) of n f32 values into out[0]
int u2pl_kth_smallest(const void* values, void* out, void* state, int n,
                      int k, int grid, int slice, int cap, void* stream) {
  if (n <= 0 || k < 1 || k > n) return (int)cudaErrorInvalidValue;
  return launch_descent<false>((const float*)values, nullptr, nullptr, (unsigned)(k - 1), n, 1,
                               grid, slice, cap, (unsigned*)state, (float*)out,
                               (cudaStream_t)stream);
}

}  // extern "C"

// Kernel E (family K2, sm_90a): exact numpy-'linear' percentiles of a masked
// f32 map by radix selection; replaces u2pl_tpu/ops/quantile.py:
// masked_percentiles (:136) with _order_keys (:79), _keys_to_f32 (:90) and
// _kth_smallest_keys (:97).
//
// The JAX algorithm, on the card: every value becomes an order-preserving
// u32 key (masked-out values the key of +inf, so they sort last, as in the
// masked sort), and a radix descent finds the lo-th smallest key of each
// query without sorting.  Four levels of 8 bits; at each level one pass
// builds per-block shared-memory histograms of the keys that still match the
// query's prefix and adds them into global integer counts (integer atomics:
// exact, and the same whatever the order of the blocks), and a one-block
// kernel picks the digit.  One more pass counts the keys <= the selected key
// and finds the smallest greater key (sorted[lo + 1] without a second
// descent), and a one-block kernel does the f32 interpolation.  The rank
// arithmetic (pct / 100 * (n - 1), floor, frac) is the JAX f32 arithmetic,
// each operation rounded on its own, so the result is bit-equal to the
// masked sort and to JAX.  The count n, the ranks and the result stay on the
// device: nothing syncs with the host.
//
// Bound: five reads of the values and the mask (~5 MB each at 1,052,676
// values), plus ten launches; the selection itself is O(K * 256) per level.
// At most 4 queries per call (the contrastive slice needs 3).
//
// u2pl_kth_smallest (family K7) is the same descent with a rank in place of
// a percent: no mask (every value counts) and one query at the 0-based rank
// k - 1; replaces u2pl_tpu/losses/ohem.py:_kth_smallest (:35), OHEM's
// min_kept-th smallest target-class probability.  The four histogram passes
// are E's own kernel; the result, the selected key turned back into its
// f32, stays on the device.  Bound: bytes, one read of the values (4.7 MB
// at 2 x 769²); the descent reads them four times, in nine launches.

#include <math.h>

#include "common.cuh"

namespace {

using u2pl::kThreads;

constexpr int kMaxQueries = 4;
constexpr int kBins = 256;
constexpr int kMaxBlocks = 528;  // 4 blocks of 256 threads per SM
constexpr unsigned kInfKey = 0xFF800000u;  // order key of +inf

// state words: [0] n; per query q at 8 + 8 q: prefix, remaining, lo, hi,
// frac (f32 bits), count_le, next_key; the histograms at kHist
constexpr int kHist = 64;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_to_f32(unsigned key) {
  return __uint_as_float((key >> 31) == 0 ? ~key : (key & 0x7FFFFFFFu));
}

__device__ __forceinline__ unsigned* q_state(unsigned* st, int q) {
  return st + 8 + 8 * q;
}

// a null mask: every value counts (the k-th smallest of u2pl_kth_smallest)
__device__ __forceinline__ bool counted(const uint8_t* __restrict__ m,
                                        unsigned i) {
  return m == nullptr || m[i];
}

__device__ __forceinline__ unsigned key_at(const float* __restrict__ v,
                                           const uint8_t* __restrict__ m,
                                           unsigned i) {
  return counted(m, i) ? order_key(v[i]) : kInfKey;
}

__global__ void radix_hist_kernel(const float* __restrict__ v,
                                  const uint8_t* __restrict__ m, unsigned n,
                                  int K, int level, unsigned* __restrict__ st) {
  __shared__ unsigned hist[kMaxQueries * kBins];
  __shared__ unsigned prefix[kMaxQueries];
  __shared__ unsigned valid;
  for (int j = threadIdx.x; j < K * kBins; j += blockDim.x) hist[j] = 0;
  if ((int)threadIdx.x < K) prefix[threadIdx.x] = q_state(st, threadIdx.x)[0];
  if (threadIdx.x == 0) valid = 0;
  __syncthreads();
  const int shift = 24 - 8 * level;
  unsigned count = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned key = key_at(v, m, i);
    if (level == 0) count += counted(m, i) ? 1u : 0u;
    const unsigned bin = (key >> shift) & (kBins - 1);
    for (int q = 0; q < K; ++q) {
      if (level == 0 || (key >> (shift + 8)) == (prefix[q] >> (shift + 8))) {
        atomicAdd(&hist[q * kBins + bin], 1u);
      }
    }
  }
  if (level == 0 && count) atomicAdd(&valid, count);
  __syncthreads();
  for (int j = threadIdx.x; j < K * kBins; j += blockDim.x) {
    if (hist[j]) atomicAdd(&st[kHist + j], hist[j]);
  }
  if (level == 0 && threadIdx.x == 0 && valid) atomicAdd(&st[0], valid);
}

// one thread per query: at level 0 it first turns the percent into ranks
// exactly as quantile.py:153-157 does (with no percents, query 0 takes the
// 0-based `rank0`); then it takes the first digit whose cumulative count
// exceeds the remaining rank, and clears its histogram
__global__ void radix_select_kernel(const float* __restrict__ pct, int rank0,
                                    unsigned n, int K, int level,
                                    unsigned* __restrict__ st) {
  const int q = threadIdx.x;
  if (q >= K) return;
  unsigned* s = q_state(st, q);
  if (level == 0 && pct == nullptr) {
    s[0] = 0;
    s[1] = (unsigned)rank0;
  } else if (level == 0) {
    const int nv = (int)st[0];
    const int nm1 = nv - 1 > 0 ? nv - 1 : 0;
    const float rank =
        __fmul_rn(__fdiv_rn(pct[q], 100.0f), __int2float_rn(nm1));
    const int lo = (int)floorf(rank);
    const int hi = lo + 1 < nm1 ? lo + 1 : nm1;
    const float frac = __fsub_rn(rank, __int2float_rn(lo));
    const int k = lo < 0 ? 0 : (lo > (int)n - 1 ? (int)n - 1 : lo);
    s[0] = 0;
    s[1] = (unsigned)k;
    s[2] = (unsigned)lo;
    s[3] = (unsigned)hi;
    s[4] = __float_as_uint(frac);
    s[5] = 0;
    s[6] = 0xFFFFFFFFu;
  }
  const int shift = 24 - 8 * level;
  unsigned* h = st + kHist + q * kBins;
  unsigned below = 0;
  int sel = 0;
  for (int b = 0; b < kBins; ++b) {
    if (below + h[b] > s[1]) {
      sel = b;
      break;
    }
    below += h[b];
  }
  s[1] -= below;
  s[0] |= (unsigned)sel << shift;
  for (int b = 0; b < kBins; ++b) h[b] = 0;
}

__global__ void quantile_tail_kernel(const float* __restrict__ v,
                                     const uint8_t* __restrict__ m, unsigned n,
                                     int K, unsigned* __restrict__ st) {
  __shared__ unsigned lo_key[kMaxQueries];
  __shared__ unsigned le[kMaxQueries];
  __shared__ unsigned nxt[kMaxQueries];
  if ((int)threadIdx.x < K) {
    lo_key[threadIdx.x] = q_state(st, threadIdx.x)[0];
    le[threadIdx.x] = 0;
    nxt[threadIdx.x] = 0xFFFFFFFFu;
  }
  __syncthreads();
  unsigned my_le[kMaxQueries] = {0, 0, 0, 0};
  unsigned my_next[kMaxQueries] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                   0xFFFFFFFFu};
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned key = key_at(v, m, i);
    for (int q = 0; q < K; ++q) {
      if (key <= lo_key[q]) {
        ++my_le[q];
      } else if (key < my_next[q]) {
        my_next[q] = key;
      }
    }
  }
  for (int q = 0; q < K; ++q) {
    if (my_le[q]) atomicAdd(&le[q], my_le[q]);
    if (my_next[q] != 0xFFFFFFFFu) atomicMin(&nxt[q], my_next[q]);
  }
  __syncthreads();
  if ((int)threadIdx.x < K) {
    unsigned* s = q_state(st, threadIdx.x);
    if (le[threadIdx.x]) atomicAdd(&s[5], le[threadIdx.x]);
    if (nxt[threadIdx.x] != 0xFFFFFFFFu) atomicMin(&s[6], nxt[threadIdx.x]);
  }
}

__global__ void quantile_finalize_kernel(int K, const unsigned* __restrict__ st,
                                         float* __restrict__ out) {
  const int q = threadIdx.x;
  if (q >= K) return;
  const unsigned* s = st + 8 + 8 * q;
  const int lo = (int)s[2], hi = (int)s[3];
  const float frac = __uint_as_float(s[4]);
  const float v_lo = key_to_f32(s[0]);
  float v_hi = (int)s[5] > hi ? v_lo : key_to_f32(s[6]);
  if (hi == lo) v_hi = v_lo;
  const float r = __fadd_rn(v_lo, __fmul_rn(frac, __fsub_rn(v_hi, v_lo)));
  out[q] = st[0] > 0 ? r : INFINITY;
}

__global__ void kth_finalize_kernel(const unsigned* __restrict__ st,
                                    float* __restrict__ out) {
  out[0] = key_to_f32(st[8]);  // query 0's selected key
}

}  // namespace

extern "C" {

int u2pl_quantile_max_queries(void) { return kMaxQueries; }

// state: u2pl_quantile_state_words() zeroed u32 words
int u2pl_quantile_state_words(void) { return kHist + kMaxQueries * kBins; }

int u2pl_masked_percentiles(const void* values, const void* mask,
                            const void* pct, void* out, void* state, int n,
                            int K, void* stream) {
  if (n <= 0 || K <= 0 || K > kMaxQueries) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = u2pl::blocks_for(n, kMaxBlocks);
  for (int level = 0; level < 4; ++level) {
    radix_hist_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)values, (const uint8_t*)mask, (unsigned)n, K, level,
        (unsigned*)state);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    radix_select_kernel<<<1, 32, 0, s>>>((const float*)pct, 0, (unsigned)n,
                                         K, level, (unsigned*)state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  quantile_tail_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)values, (const uint8_t*)mask, (unsigned)n, K,
      (unsigned*)state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantile_finalize_kernel<<<1, 32, 0, s>>>(K, (const unsigned*)state,
                                            (float*)out);
  return (int)cudaGetLastError();
}

// the exact k-th smallest (1-based) of n f32 values into out[0];
// state: u2pl_quantile_state_words() zeroed u32 words
int u2pl_kth_smallest(const void* values, void* out, void* state, int n,
                      int k, void* stream) {
  if (n <= 0 || k < 1 || k > n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = u2pl::blocks_for(n, kMaxBlocks);
  for (int level = 0; level < 4; ++level) {
    radix_hist_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)values, nullptr, (unsigned)n, 1, level,
        (unsigned*)state);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    radix_select_kernel<<<1, 32, 0, s>>>(nullptr, k - 1, (unsigned)n, 1,
                                         level, (unsigned*)state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  kth_finalize_kernel<<<1, 1, 0, s>>>((const unsigned*)state, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

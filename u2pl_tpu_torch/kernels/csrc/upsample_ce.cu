// The training half of kernel family K1 (sm_90a): the align-corners
// upsample of os4 logits fused with the per-pixel softmax reductions that
// consume it.
//
// C. u2pl_upsample_ce_fwd / u2pl_upsample_ce_bwd replace
//    u2pl_tpu/losses/ce.py:cross_entropy_ignore (:23) applied to
//    u2pl_tpu/train/steps.py:_upsample (:69): the mean (optionally
//    class-weighted) CE over non-ignored pixels of the upsampled logits, and
//    its gradient to the os4 logits.
// D. u2pl_upsample_softmax_stats replaces the pseudo-label reductions of
//    u2pl_tpu/train/steps.py:300-301 (max-prob exp(max - logsumexp) and the
//    first-max argmax) and u2pl_tpu/losses/unsup.py:teacher_entropy (:24),
//    applied to the upsampled teacher logits, each call computing the
//    outputs its caller selects.
//
// Inputs: os4 logits (B, C, h, w) f32, labels (B, H, W) int32, the tap tables
// of common.cuh.  Each kernel computes a pixel's C upsampled logits on the
// fly, exactly as kernel A would write them, and reduces over them: the
// (B, C, H, W) upsampled tensor (88 MB f32 at 4 x 21 x 513²) is never
// written by C or by D.  C's forward is a mode of D's kernel (below): the
// same staging and register layout, one expf per class, the labels read and
// lse written 4 pixels per 16-byte vector, and per block the partial sums
// of the weighted nll and the weight in double, added by a one-block
// finalize in a fixed order (no float atomics: the loss does not depend on
// the run).  Its first design, one thread per pixel that re-evaluated the
// 4-tap lerps from device memory in each of two passes over C (168 tap
// loads per pixel at C = 21), took 0.0776 ms at the VOC shape (4, 21, 129²)
// -> 513² on an NVIDIA H100 80GB HBM3 at 700 W, ~14x its bound (an expf
// per upsampled value and a logf per pixel on the special-function units);
// this one 0.040 ms there, 0.037-0.044 at Cityscapes' heads, where, as in
// D, the staging's L2 reads of the touched rows take the most.
//
// D writes only the outputs its caller asks for (the semi step's first call
// takes max-prob + argmax, its second the entropy).  Its first design ran
// one thread per pixel with three passes over C, each re-evaluating the
// lerps (252 loads per pixel at C = 21), and wrote all three outputs:
// 0.138 ms per call at the VOC shape (4, 21, 129²) -> 513² on an NVIDIA
// H100 80GB HBM3 at 700 W, 25x its bytes bound.  The work is instruction
// issue (the bytes are ~10-14 MB, 3-4 us), so the f32 instance cuts
// instructions: a block owns 1024 consecutive output pixels, stages the
// H-lerped input rows of the output rows they touch in shared memory (C x W
// floats per row, once per block), and each thread evaluates a pixel's C
// values with two shared reads and one lerp each, keeps them in registers
// (the array sized to C exactly at the configs' 21 and 19 classes, else to
// C in steps of 8, C <= 32), takes one expf per class (reused for the sum
// and the entropy's p), and stores 4 pixels per 16-byte vector.  The
// expressions and the class order are the first design's, so the outputs
// are the same bits.  0.0373-0.0379 / 0.059-0.060 ms for the max-prob +
// argmax / the entropy call at VOC, 0.042 / 0.063 at Cityscapes' (2, 19,
// 193²) -> 769² (u2pl_tpu_torch/kernels/timing_ab.py; PERF.md has the
// variants).  Its pixel loop is 516-558 instructions a pixel (prob) and
// 1344-1386 (entropy), its issue floor at VOC 0.0176 / 0.0436 ms
// (kernels/sass_count.py: loop instructions x pixels / 32 over 132 SMs x 4
// a clock at 1980 MHz).
// The bf16 instance (every config's logits) keeps that pixel code and
// stages by the copy engine (stats_ring_kernel, below): persistent blocks
// of 256 x spans threads, one an SM, each a run of spans in steps of
// `spans`; a step's raw input rows land in shared memory while the step
// before computes, its H pass reads them there, and its threads take the
// f32 instance's spans as they were.  Measured (timing_ab.py, NVIDIA H100
// 80GB HBM3, 700.00 W): prob 0.0362-0.0363 / entropy 0.0600 ms at VOC
// (parent 0.0393-0.0395 / 0.0621-0.0626), 0.0395 / 0.0637-0.0638 at
// Cityscapes (0.0440-0.0443 / 0.0644-0.0647); without its pixels (the
// staging alone) 0.0146 ms at VOC, without its H pass 0.028: the pixel loop
// at ~63% of its issue floor is what holds it.
//
// K7 prob. u2pl_ohem_target_prob replaces u2pl_tpu/losses/ohem.py:66-75
//    (OHEM's p_y = softmax(upsampled logits)[label], 1.0 at ignored pixels,
//    and the count of valid pixels) as a third mode of D's kernel, on C's
//    forward plan: it reads the labels as C's forward does, takes m, the
//    sum and the label's value in C's expressions and class order and
//    writes p_y = expf(vy - m) / s 4 pixels per 16-byte vector (the first
//    design's bits); num_valid is counted in integers, one atomic per
//    block, and moved out by the last block.  The first design, one thread
//    per pixel evaluating its 19 upsampled values twice from device memory
//    (~150 scattered loads per pixel), took 0.071 ms at Cityscapes' heads
//    on an NVIDIA H100 80GB HBM3 at 700 W; this mode 0.042 / 0.032 ms at
//    the main (2, 19, 193²) / aux (2, 19, 97²) head -> 769², ~8x its
//    operations bound, as C's forward.

// bfloat16 modes (the semi and supervised steps under a bf16 model): the
// logits In = __nv_bfloat16.  JAX upsamples them in the narrow branch of
// u2pl_tpu/ops/resize.py (f32 taps, each upsampled value rounded to bf16)
// and takes every reduction on the f32 cast of those values
// (ce.py:36-46, steps.py:295-301, unsup.py:24, ohem.py:66-75).  So each
// kernel reads bf16, interpolates in f32 as in f32 mode, rounds every
// upsampled value to bf16 (`up_value`) and then runs the f32 mode's
// statistics unchanged; an argmax over the rounded values keeps the first
// of exact ties.  C's backward rounds each full-resolution gradient value
// coef (softmax - onehot) to bf16, where the VJP of the astype to f32
// rounds the cotangent, sums the adjoint in f32 and writes a bf16
// gradient (the narrow branch's VJP: f32 einsums, one rounding at the
// end).  One kernel per function: In is a template parameter.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using u2pl::div_small;
using u2pl::kThreads;
using u2pl::round_bf16;
using u2pl::store_as;
using u2pl::tap_weight;
using u2pl::to_f32;

// one upsampled value from its H-lerped inputs: rounded to bf16 in the
// bf16 modes (BF), as the narrow branch's output is
template <bool BF>
__device__ __forceinline__ float up_value(float p, float a, float q, float b) {
  const float v = u2pl::lerp2(p, a, q, b);
  return BF ? round_bf16(v) : v;
}

constexpr long long kBwdMaxShared = 232448;  // a block's shared memory on sm_90 (227 KB)

// stats = [loss, denom]: the JAX normalisation, sum / max(denom, floor) where
// denom > 0 and 0 otherwise (floor 1 for the plain count, 1e-12 weighted)
__global__ void upsample_ce_finalize_kernel(const double* __restrict__ part,
                                            int nparts, float floor_,
                                            float* __restrict__ stats) {
  __shared__ double s_sum[kThreads];
  __shared__ double s_w[kThreads];
  double a = 0.0, b = 0.0;
  for (int j = threadIdx.x; j < nparts; j += blockDim.x) {
    a += part[j];
    b += part[nparts + j];
  }
  s_sum[threadIdx.x] = a;
  s_w[threadIdx.x] = b;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if ((int)threadIdx.x < stride) {
      s_sum[threadIdx.x] += s_sum[threadIdx.x + stride];
      s_w[threadIdx.x] += s_w[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float denom = (float)s_w[0];
    const float sum = (float)s_sum[0];
    stats[0] = denom > 0.0f ? sum / fmaxf(denom, floor_) : 0.0f;
    stats[1] = denom;
  }
}

// C's backward.  Once the forward's lse is saved, class c's full-resolution
// gradient coef (softmax - onehot) needs no other class, so a block owns a
// group of at most `cls` classes (the C classes split evenly over
// `groups`), `rows` input rows of one image (a band) and walks the output
// rows [oy_begin, oy_end) that reach the band, `chunk` at a time, with one
// barrier a step (its buffers doubled):
// - phase 1, every thread: g of the step's rows for the group's classes,
//   one output pixel per item (its label and lse from shared memory, its
//   column taps too, one expf per class), into the step's g rows.
//   Meanwhile the next step's labels and lse are copied into shared memory
//   (cp.async: no registers, waited for at the barrier), and each owner
//   (below) loads the next step's H-pass inputs of its column and stores
//   their lerps when its items are done;
// - phase 2, the owner of (class, input column ix), one pair or two a
//   thread: per output row the W sum s = sum over the output columns
//   reaching ix of tapw * g, ascending from 0 (the step's rows first, one
//   independent chain each), then the H sums of the two input rows each row
//   reaches, in row order, held in two registers (A-bwd's rolling pair); an
//   input row is stored when the walk has passed it.
// So no block-wide accumulator in shared memory, and two blocks share an
// SM, one's barrier overlapping the other's work; the host plans the bands
// to fill one wave of them (losses/ce.py:_bwd_plan).  The work is
// instruction issue, not bytes: at an exact ratio S = 4 or 8 (OW - 1 =
// S (W - 1): every training shape) the kernel is compiled for its NC
// classes a block, so the class loop has no branch (a group of fewer
// classes computes the missing ones from unused rows and never reads
// them), the owner's column taps are constants, o = S (ix - 1) + j with
// weight j / S or (2S - j) / S, and a g row holds output column ox at S +
// ox, so the owner of ix reads its 2S values at S ix with two vector loads
// (in bf16 the rows are bf16: each g value is rounded to bf16 anyway).
// Other shapes (NC 0) take any cls and read a table of tap weights.
// Every product and sum is the one-block-per-band design's, in its order
// (the zero weights' products included), so the gradient has its bits
// (losses/ce.py:upsample_ce_bwd_ordered gives them in torch ops).
constexpr int kBwdMaxThreads = 1024;
constexpr int kBwdExactThreads = 512;  // the exact-ratio kernels' most threads a block
constexpr int kBwdExactBlocks = 2;     // ... and their blocks an SM (64 registers)
constexpr int kBwdClasses = 4;         // the most classes of a block
constexpr int kBwdMaxChunk = 4;        // the most output rows of a step

__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// the weight of output column S (ix - 1) + j on input column ix at an exact
// ratio S: frac j / S, then 1 - frac (2S - j) / S (the tables' values)
template <int S>
__device__ __forceinline__ constexpr float tapw(int j) {
  return j < S ? (float)j / S : (float)(2 * S - j) / S;
}

// the 2S values of a g row from p (aligned to 2S elements' bytes / 2),
// widened to f32
template <int S>
__device__ __forceinline__ void load_g(const float* p, float (&v)[2 * S]) {
#pragma unroll
  for (int i = 0; i < 2 * S; i += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + i);
    v[i] = w.x;
    v[i + 1] = w.y;
    v[i + 2] = w.z;
    v[i + 3] = w.w;
  }
}
template <int S>
__device__ __forceinline__ void load_g(const __nv_bfloat16* p, float (&v)[2 * S]) {
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int i = 0; i < S; i += S / 2) {  // S / 2 words a load: 8 or 16 bytes
    unsigned w[S / 2];
    if constexpr (S == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(q + i);
      w[0] = t.x;
      w[1] = t.y;
    } else {
      const uint4 t = *reinterpret_cast<const uint4*>(q + i);
      w[0] = t.x;
      w[1] = t.y;
      w[2] = t.z;
      w[3] = t.w;
    }
#pragma unroll
    for (int h = 0; h < S / 2; ++h) {
      v[2 * (i + h)] = __uint_as_float(w[h] << 16);
      v[2 * (i + h) + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
  }
}

template <typename In, int S, int NC, int P>
__global__ void __launch_bounds__(S ? kBwdExactThreads : kBwdMaxThreads,
                                  S ? kBwdExactBlocks : 1) upsample_ce_bwd_kernel(
    const In* __restrict__ x, const int* __restrict__ labels,
    const float* __restrict__ cw, const float* __restrict__ lse,
    const float* __restrict__ stats, const float* __restrict__ gout,
    In* __restrict__ gx, const int* __restrict__ idx_h,
    const float* __restrict__ w_h, const int* __restrict__ rng_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w,
    const int* __restrict__ rng_w, int C, int H, int W, int OH, int OW,
    int ignore, float floor_, int groups, int cls, int rows, int bands, int chunk,
    int span, int gs) {
  extern __shared__ int4 smem[];
  constexpr bool BF = sizeof(In) == 2;
  constexpr int NCL = NC ? NC : kBwdClasses;  // the class loop's length
  if (NC) cls = NC;
  const int CQ = cls * gs, CWs = cls * W, PX = chunk * OW;
  // g rows, 2 x chunk x cls x gs, in In (f32, or bf16: g is rounded to
  // bf16), output column ox at S + ox; gs a multiple of 8, so rows are
  // 16-byte aligned
  In* gb = reinterpret_cast<In*>(smem);
  int4* rt = reinterpret_cast<int4*>(gb + 2 * chunk * CQ);  // 2 x chunk: (lo, w_lo, w_hi) a row
  int2* col = reinterpret_cast<int2*>(rt + 2 * chunk);      // OW: (lo | hi << 16, frac)
  int* ys = reinterpret_cast<int*>(col + OW);           // 2 x chunk x OW: labels
  float* ls = reinterpret_cast<float*>(ys + 2 * PX);    // 2 x chunk x OW: lse
  float* T = ls + 2 * PX;                               // 2 x chunk x cls x W: H-lerped rows
  float* cws = T + 2 * chunk * CWs;                     // C: class weights x scale
  float* wtab = cws + C;                                // S == 0: W x span column tap weights
  int* wstart = reinterpret_cast<int*>(wtab + W * span);  // S == 0: first output column
  int* wcount = wstart + W;                               // S == 0: output columns

  const int tid = threadIdx.x, nt = blockDim.x;
  const int grp = blockIdx.x % groups;
  const int bb = blockIdx.x / groups;  // image * bands + band
  const int b = bb / bands;
  const int iy0 = (bb - b * bands) * rows, iy1 = min(iy0 + rows, H);
  const int c0 = grp * C / groups, nc = (grp + 1) * C / groups - c0;
  const int ob = rng_h[iy0], oe = rng_h[H + iy1 - 1];
  const int plane = H * W;
  const int* lab = labels + (size_t)b * OH * OW;
  const float* lse_b = lse + (size_t)b * OH * OW;
  const float denom = stats[1];
  const float scale = denom > 0.0f ? gout[0] / fmaxf(denom, floor_) : 0.0f;

  // the labels and lse of the step at output row oyc into buffer `buf`
  auto copy_pixels = [&](int oyc, int buf) {
    const int n = min(chunk, oe - oyc) * OW;
    const int* ysrc = lab + oyc * OW;
    const float* lsrc = lse_b + oyc * OW;
    for (int p = tid; p < n; p += nt) {
      copy_async4(ys + buf * PX + p, ysrc + p);
      copy_async4(ls + buf * PX + p, lsrc + p);
    }
  };
  if (ob < oe) copy_pixels(ob, 0);
  for (int ox = tid; ox < OW; ox += nt) {
    col[ox] = make_int2(idx_w[ox] | (idx_w[OW + ox] << 16), __float_as_int(w_w[OW + ox]));
  }
  // kernel C's coef of a valid pixel of class y: w[y] * gout / max(denom, floor)
  for (int c = tid; c < C; c += nt) cws[c] = (cw ? cw[c] : 1.0f) * scale;
  if constexpr (S == 0) {
    for (int k = tid; k < W * span; k += nt) {
      const int ix = k / span, j = k - ix * span;
      const int s0 = rng_w[ix], n = rng_w[W + ix] - s0;
      if (j == 0) {
        wstart[ix] = s0;
        wcount[ix] = n;
      }
      if (j < n) wtab[k] = tap_weight(idx_w, w_w, OW, s0 + j, ix);
    }
  }

  // this thread's P (class c0 + u, input column ix) pairs, tid + p nt, if
  // it owns them
  int u[P], ix[P];
  bool own[P];
  const In* xo[P];
  In* out[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int q = tid + p * nt;
    u[p] = q / W;
    ix[p] = q - u[p] * W;
    own[p] = u[p] < nc;
    xo[p] = x + ((size_t)b * C + c0 + u[p]) * plane + ix[p];
    out[p] = gx + ((size_t)b * C + c0 + u[p]) * plane + ix[p];
  }
  float xa[P][kBwdMaxChunk], xc[P][kBwdMaxChunk];
  // the H pass of the step at output row oyc, the owners' columns: its
  // inputs loaded by load_rows, the lerps stored into buffer `buf` by
  // store_rows
  auto load_rows = [&](int oyc) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < kBwdMaxChunk; ++k) {
        if (own[p] && k < chunk && oyc + k < oe) {
          xa[p][k] = to_f32(xo[p][idx_h[oyc + k] * W]);
          xc[p][k] = to_f32(xo[p][idx_h[OH + oyc + k] * W]);
        }
      }
    }
  };
  auto store_rows = [&](int oyc, int buf) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int k = 0; k < kBwdMaxChunk; ++k) {
        if (own[p] && k < chunk && oyc + k < oe) {
          T[(buf * chunk + k) * CWs + u[p] * W + ix[p]] =
              u2pl::lerp2(w_h[oyc + k], xa[p][k], w_h[OH + oyc + k], xc[p][k]);
        }
      }
    }
  };
  load_rows(ob);
  store_rows(ob, 0);
  // each pair's input rows L and L + 1 take the current output row; rows
  // [iy0, next) are stored
  float a0[P], a1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) a0[p] = a1[p] = 0.0f;
  int L = ob < oe ? idx_h[ob] : iy1, next = iy0;
  auto flush = [&](int upto) {  // store input rows [next, upto) of the band
    for (; next < upto; ++next) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (own[p]) {
          store_as(out[p] + (size_t)next * W,
                   next == L ? a0[p] : next == L + 1 ? a1[p] : 0.0f);
        }
      }
    }
  };
  copy_async_wait();
  __syncthreads();  // col, cws, the tables, the first step's H pass and pixels

  const int dk = nt / OW, dox = nt - dk * OW;
  int buf = 0;
  for (int oyc = ob; oyc < oe; oyc += chunk, buf ^= 1) {
    const int nk = min(chunk, oe - oyc);
    const bool more = oyc + chunk < oe;
    if (more) copy_pixels(oyc + chunk, buf ^ 1);
    if (more) load_rows(oyc + chunk);
    int4* rb = rt + buf * chunk;
    if (tid < nk) {
      const int r = oyc + tid, lo = idx_h[r];
      rb[tid] = make_int4(lo, __float_as_int(tap_weight(idx_h, w_h, OH, r, lo)),
                          __float_as_int(tap_weight(idx_h, w_h, OH, r, lo + 1)), 0);
    }
    // phase 1: g of the step's rows (kernel C's expression), the group's
    // classes of one output pixel per item
    In* g0 = gb + buf * chunk * CQ;
    const float* T0 = T + buf * chunk * CWs;
    const int* yb = ys + buf * PX;
    const float* lb = ls + buf * PX;
    int k = tid / OW, px = tid - k * OW;
    for (int p = tid; p < nk * OW; p += nt) {
      const int y = yb[p];
      const float l = lb[p];
      In* gp = g0 + k * CQ + S + px;
      const bool valid = y != ignore && y >= 0 && y < C;
      const float coefv = valid ? cws[y] : 0.0f;
      if (coefv == 0.0f) {
#pragma unroll
        for (int v = 0; v < NCL; ++v) {
          if (NC || v < nc) store_as(gp + v * gs, 0.0f);
        }
      } else {
        const int2 t = col[px];
        const float q = __int_as_float(t.y), pw = __fsub_rn(1.0f, q);
        const float* T0c = T0 + k * CWs + (t.x & 0xffff);
        const float* T1c = T0 + k * CWs + (t.x >> 16);
        const int yl = y - c0;
#pragma unroll
        for (int v = 0; v < NCL; ++v) {
          if (NC || v < nc) {
            const float e = expf(up_value<BF>(pw, T0c[v * W], q, T1c[v * W]) - l);
            const float gv = coefv * (v == yl ? e - 1.0f : e);
            store_as(gp + v * gs, gv);  // bf16: rounded, as the VJP of the cast rounds it
          }
        }
      }
      k += dk;
      px += dox;
      if (px >= OW) {
        px -= OW;
        ++k;
      }
    }
    if (more) store_rows(oyc + chunk, buf ^ 1);
    copy_async_wait();
    __syncthreads();

    // phase 2: the owners' W sums of the step's rows, then their H sums
    if (own[0]) {
      float sw[P][kBwdMaxChunk];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int kk = 0; kk < kBwdMaxChunk; ++kk) {
          if (own[p] && kk < nk) {
            const In* gr = g0 + kk * CQ + u[p] * gs;
            float sum = 0.0f;
            if constexpr (S > 0) {
              // output column S (ix - 1) + j, at S ix + j: 2S values, j from
              // S at ix = 0, to S + 1 at ix = W - 1
              float gv[2 * S];
              load_g<S>(gr + S * ix[p], gv);
              if (ix[p] > 0 && ix[p] < W - 1) {
#pragma unroll
                for (int j = 0; j < 2 * S; ++j) sum = __fadd_rn(sum, __fmul_rn(tapw<S>(j), gv[j]));
              } else {
                const int jb = ix[p] == 0 ? S : 0, je = ix[p] == W - 1 ? S + 1 : 2 * S;
#pragma unroll
                for (int j = 0; j < 2 * S; ++j) {
                  if (j >= jb && j < je) sum = __fadd_rn(sum, __fmul_rn(tapw<S>(j), gv[j]));
                }
              }
            } else {
              const float* wt = wtab + ix[p] * span;
              const int s0 = wstart[ix[p]], n = wcount[ix[p]];
              for (int j = 0; j < n; ++j) {
                sum = __fadd_rn(sum, __fmul_rn(wt[j], to_f32(gr[s0 + j])));
              }
            }
            sw[p][kk] = sum;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBwdMaxChunk; ++kk) {
        if (kk < nk) {
          const int4 r = rb[kk];
          const int lo = r.x;
          if (lo != L) {  // input rows below lo have all their output rows
            flush(min(lo, iy1));
#pragma unroll
            for (int p = 0; p < P; ++p) {
              a0[p] = lo == L + 1 ? a1[p] : 0.0f;
              a1[p] = 0.0f;
            }
            L = lo;
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {
            a0[p] = __fadd_rn(a0[p], __fmul_rn(__int_as_float(r.y), sw[p][kk]));
            a1[p] = __fadd_rn(a1[p], __fmul_rn(__int_as_float(r.z), sw[p][kk]));
          }
        }
      }
    }
  }
  if (own[0]) flush(iy1);
}

// ---- D: upsample_softmax_stats --------------------------------------------
// The outputs a call writes: kStatsProb (max-prob and argmax), kStatsEntropy
// or both; the wrapper passes null for the others.
constexpr int kStatsProb = 1;
constexpr int kStatsEntropy = 2;
constexpr int kStatsCE = 4;  // kernel C's forward: lse and the block's partial sums
constexpr int kStatsTargetProb = 8;  // K7 prob: p_y and the count of valid pixels
constexpr int kStatsMaxClasses = 32;   // one pixel's C values live in registers
constexpr int kStatsThreads = 256;
// bytes of taps and H-lerped rows: what a block may use on sm_90 (227 KB)
// less room for the static shared memory of C's reduction
constexpr int kStatsMaxShared = 224 * 1024;

// the statistics of one output pixel from its row's H-lerped inputs Tr
// (class c at Tr + c * W) and its column taps t = (lo, hi, 1 - frac, frac):
// kernel D's first design's expressions in its class order, with each
// upsampled value evaluated once and each exp(v - max) once
template <int MAXC, int MODE, bool EXACT, bool BF>
__device__ __forceinline__ void stats_pixel(const float* __restrict__ Tr, int W,
                                            int C, int4 t, float& mp, int& am,
                                            float& en) {
  const float p = __int_as_float(t.z), q = __int_as_float(t.w);
  float v[MAXC];
  float m = 0.0f;
  int arg = 0;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (EXACT || c < C) {
      v[c] = up_value<BF>(p, Tr[c * W + t.x], q, Tr[c * W + t.y]);
      // first maximum; a NaN counts as the maximum, the first NaN wins
      // (jnp.argmax / torch.argmax, as kernel B)
      if (c == 0 || (m == m && (v[c] > m || v[c] != v[c]))) {
        m = v[c];
        arg = c;
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (EXACT || c < C) {
      v[c] = expf(v[c] - m);
      s += v[c];
    }
  }
  if (MODE & kStatsProb) {
    // steps.py:300: exp(max - logsumexp), logsumexp = max + log(sum)
    mp = expf(m - (m + logf(s)));
    am = arg;
  }
  if (MODE & kStatsEntropy) {
    // unsup.py:24-27: -sum p log(p + 1e-10), p = exp(v - max) / sum
    float e = 0.0f;
    // bf16: the quotients' reciprocal of s formed once (u2pl::div_r1, the
    // same bits as '/')
    const float r1 = BF ? u2pl::rcp_refined(s) : 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (EXACT || c < C) {
        const float pc = BF ? u2pl::div_r1(v[c], s, r1) : v[c] / s;
        e += pc * logf(pc + 1e-10f);
      }
    }
    en = -e;
  }
}

// the softmax terms of one output pixel of label y: returns m and sets s
// and vy, its class-y value (0 where y is outside [0, C)), in the first
// designs' expressions and class order: m = fmaxf over the classes from
// -inf, s = sum of expf(v - m).  MAXC 0 takes any C, evaluating each value
// again for the sum (the same bits).
template <int MAXC, bool EXACT, bool BF>
__device__ __forceinline__ float softmax_terms(const float* __restrict__ Tr, int W, int C,
                                               int4 t, int y, float& vy, float& s) {
  const float p = __int_as_float(t.z), q = __int_as_float(t.w);
  float m = -INFINITY;
  s = 0.0f;
  vy = 0.0f;
  if constexpr (MAXC == 0) {
    for (int c = 0; c < C; ++c) {
      const float v = up_value<BF>(p, Tr[c * W + t.x], q, Tr[c * W + t.y]);
      m = fmaxf(m, v);
      if (c == y) vy = v;
    }
    for (int c = 0; c < C; ++c) s += expf(up_value<BF>(p, Tr[c * W + t.x], q, Tr[c * W + t.y]) - m);
  } else {
    float v[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (EXACT || c < C) {
        v[c] = up_value<BF>(p, Tr[c * W + t.x], q, Tr[c * W + t.y]);
        m = fmaxf(m, v[c]);
        if (c == y) vy = v[c];
      }
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (EXACT || c < C) s += expf(v[c] - m);
    }
  }
  return m;
}

// kernel C's forward for one output pixel: its logsumexp m + logf(s)
template <int MAXC, bool EXACT, bool BF>
__device__ __forceinline__ float ce_pixel(const float* __restrict__ Tr, int W, int C,
                                          int4 t, int y, float& vy) {
  float s;
  const float m = softmax_terms<MAXC, EXACT, BF>(Tr, W, C, t, y, vy, s);
  return m + logf(s);
}

// K7 prob for one output pixel: p_y = expf(vy - m) / s, the first K7
// design's (ohem.py:71-72), and 1.0 where y is ignored or outside [0, C)
template <int MAXC, bool EXACT, bool BF>
__device__ __forceinline__ float target_prob_pixel(const float* __restrict__ Tr, int W,
                                                   int C, int4 t, int y, int ignore,
                                                   unsigned& valid) {
  if (y == ignore || y < 0 || y >= C) return 1.0f;
  ++valid;
  float vy, s;
  const float m = softmax_terms<MAXC, EXACT, BF>(Tr, W, C, t, y, vy, s);
  return expf(vy - m) / s;
}

// The pixels [k0, k1) of one span (at most kStatsThreads chunks of 4), a
// 4-pixel chunk per thread t: thread t takes pixels k0 + 4t .., one pixel
// at a time (the pixel's code is emitted once: four copies of a
// C-unrolled pixel overflow the instruction cache), each output stored as
// one 16-byte vector; T holds the H-lerped rows of the flat output rows
// from R0 on (RING: a ring of nt rows, row R0 + r at slot slot0 + r mod nt;
// else row R0 + r at r), class c at T + row * C * W + c * W.  kStatsCE: the
// thread's weighted nll and weight into acc, acc_w; kStatsTargetProb: its
// valid pixels into valid.
template <int MAXC, int MODE, bool EXACT, bool BF, bool RING>
__device__ __forceinline__ void stats_chunks(
    const float* __restrict__ T, int slot0, int nt, const int4* __restrict__ scol, int quarter,
    int C, int W, int OW, float inv_ow, unsigned R0, unsigned k0, unsigned k1, int t,
    const int* __restrict__ labels, const float* __restrict__ cw, int ignore,
    float* __restrict__ maxprob, int* __restrict__ argmax, float* __restrict__ entropy,
    double& acc, double& acc_w, unsigned& valid) {
  const int CW = C * W;
  const unsigned base = R0 * OW;  // pixel local - base is in row local / OW of T
  const bool vec = ((uintptr_t)labels & 15) == 0;
  for (unsigned k = k0 + 4u * t; k < k1; k += 4u * kStatsThreads) {
    const int local = (int)(k - base);
    int slot = div_small(local, OW, inv_ow);  // T's row of this flat output row
    int ox = local - slot * OW;
    if (RING) {
      slot += slot0;
      if (slot >= nt) slot -= nt;
    }
    int4 lab = make_int4(ignore, ignore, ignore, ignore);
    if constexpr (MODE == kStatsCE || MODE == kStatsTargetProb) {
      if (vec && k + 4 <= k1) {
        lab = *reinterpret_cast<const int4*>(labels + k);
      } else {
        lab.x = labels[k];
        if (k + 1 < k1) lab.y = labels[k + 1];
        if (k + 2 < k1) lab.z = labels[k + 2];
        if (k + 3 < k1) lab.w = labels[k + 3];
      }
    }
    float mpv[4], env[4];
    int amv[4];
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      float mp = 0.0f, en = 0.0f;
      int am = 0;
      if (k + i < k1) {
        const int4 t = scol[(ox & 3) * quarter + (ox >> 2)];
        if constexpr (MODE == kStatsCE) {
          const int y = i == 0 ? lab.x : i == 1 ? lab.y : i == 2 ? lab.z : lab.w;
          float vy;
          mp = ce_pixel<MAXC, EXACT, BF>(T + slot * CW, W, C, t, y, vy);  // the lse
          if (y != ignore && y >= 0 && y < C) {
            const float wy = cw ? cw[y] : 1.0f;
            acc += (double)((mp - vy) * wy);
            acc_w += (double)wy;
          }
        } else if constexpr (MODE == kStatsTargetProb) {
          const int y = i == 0 ? lab.x : i == 1 ? lab.y : i == 2 ? lab.z : lab.w;
          mp = target_prob_pixel<MAXC, EXACT, BF>(T + slot * CW, W, C, t, y, ignore, valid);
        } else {
          stats_pixel<MAXC, MODE, EXACT, BF>(T + slot * CW, W, C, t, mp, am, en);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // register slots, not a local-memory array
        if (j == i) {
          mpv[j] = mp;
          amv[j] = am;
          env[j] = en;
        }
      }
      if (++ox == OW) {  // the chunk runs on into the next row
        ox = 0;
        ++slot;
        if (RING && slot == nt) slot = 0;
      }
    }
    if (k + 4 <= k1) {
      if (MODE & (kStatsProb | kStatsCE | kStatsTargetProb)) {  // the lse; p_y
        *reinterpret_cast<float4*>(maxprob + k) = make_float4(mpv[0], mpv[1], mpv[2], mpv[3]);
      }
      if (MODE & kStatsProb) {
        *reinterpret_cast<int4*>(argmax + k) = make_int4(amv[0], amv[1], amv[2], amv[3]);
      }
      if (MODE & kStatsEntropy) {
        *reinterpret_cast<float4*>(entropy + k) = make_float4(env[0], env[1], env[2], env[3]);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the output's last, partial chunk
      if (k + j < k1) {
        if (MODE & (kStatsProb | kStatsCE | kStatsTargetProb)) maxprob[k + j] = mpv[j];
        if (MODE & kStatsProb) argmax[k + j] = amv[j];
        if (MODE & kStatsEntropy) entropy[k + j] = env[j];
      }
    }
  }
}

// The f32 instance: a block owns `span` consecutive pixels [k0, k0 + span)
// of the flat (B, OH, OW) output (span a multiple of 4, so every 4-pixel
// chunk is 16-byte aligned): every thread gets the same number of chunks,
// whatever OW is.  It stages the column taps (by column % 4, as kernel A),
// the row taps of the flat output rows R0 + r that the span touches, and
// then their H-lerped input rows T[r][c][ix] in shared memory: a thread
// takes kStageBatch (class, column) items, issues their loads before it
// stores any, and walks the rows for them (rows that share an input row
// then read it from L1).  Each thread then takes aligned 4-pixel chunks
// (stats_chunks).  In kernel C's forward (MODE kStatsCE) a thread reads its
// chunk's 4 labels as one 16-byte vector, writes their lse as another, and
// sums its pixels' weighted nll and weight in double; the block adds its
// threads' sums in a fixed order (warp shuffles, then the warps in turn)
// into part[block] and part[blocks + block].  In K7 prob (MODE
// kStatsTargetProb) it reads the labels so too, writes p_y as a 16-byte
// vector, and counts its valid pixels; each block adds its count into
// ticket[1] with one integer atomic (exact, whatever the order), and the
// last block to finish (ticket[0], kernels.tickets) moves the sum into
// num_valid and takes ticket[1] back to 0: no zero-fill launch.  Where this
// staging, a barrier between loads and pixels in every block, cost the
// most at the bf16 instance's shapes, the ring below takes its place.
constexpr int kStageBatch = 8;

template <int MAXC, int MODE, bool EXACT>
__global__ void __launch_bounds__(kStatsThreads) upsample_softmax_stats_kernel(
    const float* __restrict__ x, float* __restrict__ maxprob,
    int* __restrict__ argmax, float* __restrict__ entropy,
    const int* __restrict__ labels, const float* __restrict__ cw,
    double* __restrict__ part, int* __restrict__ num_valid, unsigned* __restrict__ ticket,
    int ignore, const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w, int C,
    int H, int W, int OH, int OW, unsigned total, int span, int quarter,
    int max_rows, float inv_ow) {
  extern __shared__ int4 scol[];  // (lo, hi, 1 - frac, frac) per output column
  int4* rtab = scol + 4 * quarter;  // per touched row: input row offsets, weights
  float* T = reinterpret_cast<float*>(rtab + max_rows);
  const unsigned k0 = blockIdx.x * (unsigned)span;
  const unsigned k1 = min(k0 + (unsigned)span, total);
  const unsigned R0 = k0 / OW;  // the first and last flat output rows
  const int nr = (int)((k1 - 1) / OW - R0) + 1;
  const int plane = H * W, CW = C * W;
  __shared__ unsigned block_valid;  // kStatsTargetProb
  if (threadIdx.x == 0) block_valid = 0;
  for (int ox = threadIdx.x; ox < OW; ox += kStatsThreads) {
    scol[(ox & 3) * quarter + (ox >> 2)] =
        make_int4(idx_w[ox], idx_w[OW + ox], __float_as_int(w_w[ox]),
                  __float_as_int(w_w[OW + ox]));
  }
  for (int r = threadIdx.x; r < nr; r += kStatsThreads) {
    const unsigned R = R0 + r;
    const int b = (int)(R / OH), oy = (int)(R - (unsigned)b * OH);
    const int img = b * C * plane;
    rtab[r] = make_int4(img + idx_h[oy] * W, img + idx_h[OH + oy] * W,
                        __float_as_int(w_h[oy]), __float_as_int(w_h[OH + oy]));
  }
  __syncthreads();
  // the H pass: a thread takes kStageBatch (class, column) items and walks
  // the touched rows for them, so output rows that share an input row read
  // it from L1 rather than again from L2
  const float inv_w = 1.0f / (float)W;
  for (int k = threadIdx.x; k < CW; k += kStageBatch * kStatsThreads) {
    int off[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int kk = k + j * kStatsThreads;
      const int c = div_small(kk, W, inv_w);
      off[j] = c * plane + kk - c * W;  // class c, column ix
    }
    for (int r = 0; r < nr; ++r) {
      const int4 rt = rtab[r];
      float x0[kStageBatch], x1[kStageBatch];
#pragma unroll
      for (int j = 0; j < kStageBatch; ++j) {
        if (k + j * kStatsThreads < CW) {
          x0[j] = to_f32(x[rt.x + off[j]]);
          x1[j] = to_f32(x[rt.y + off[j]]);
        }
      }
#pragma unroll
      for (int j = 0; j < kStageBatch; ++j) {
        const int kk = k + j * kStatsThreads;
        if (kk < CW) {
          T[r * CW + kk] = u2pl::lerp2(__int_as_float(rt.z), x0[j], __int_as_float(rt.w), x1[j]);
        }
      }
    }
  }
  __syncthreads();
  double acc = 0.0, acc_w = 0.0;  // kStatsCE: the thread's weighted nll and weight
  unsigned valid = 0;             // kStatsTargetProb: the thread's valid pixels
  stats_chunks<MAXC, MODE, EXACT, false, false>(T, 0, max_rows, scol, quarter, C, W, OW, inv_ow,
                                             R0, k0, k1, threadIdx.x, labels, cw, ignore,
                                             maxprob, argmax, entropy, acc, acc_w, valid);
  if constexpr (MODE == kStatsCE) {
    __shared__ double red[2][kStatsThreads / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, o);
      acc_w += __shfl_down_sync(0xffffffffu, acc_w, o);
    }
    if ((threadIdx.x & 31) == 0) {
      red[0][threadIdx.x >> 5] = acc;
      red[1][threadIdx.x >> 5] = acc_w;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double a = 0.0, b = 0.0;
      for (int j = 0; j < kStatsThreads / 32; ++j) {
        a += red[0][j];
        b += red[1][j];
      }
      part[blockIdx.x] = a;
      part[gridDim.x + blockIdx.x] = b;
    }
  }
  if constexpr (MODE == kStatsTargetProb) {
    valid = __reduce_add_sync(0xffffffffu, valid);
    if ((threadIdx.x & 31) == 0 && valid) atomicAdd(&block_valid, valid);
    __syncthreads();
    if (threadIdx.x == 0) {
      if (block_valid) atomicAdd(ticket + 1, block_valid);
      __threadfence();  // the count before the ticket
      if (atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1) {
        *num_valid = (int)atomicExch(ticket + 1, 0u);
      }
    }
  }
}

// ---- the bf16 instance: persistent blocks on a staged ring ---------------
// (In = __nv_bfloat16: D's two semi-step calls, C's forward, K7 prob.)  A
// step is `spans` consecutive spans of the plan above (its span, so C's
// partial sums and K7's counts are the ones the f32 instance forms), taken
// by a block of kStatsThreads x spans threads: thread t works span t /
// kStatsThreads as that span's thread t % kStatsThreads.  The blocks are
// persistent (as many as the SMs hold, at most one a step's spans), each
// taking a contiguous run of spans, a step at a time.  A step's raw bf16
// input rows arrive by the copy engine: one bulk copy per (image, class) of
// the input rows its output rows reach, 16-byte aligned (the run widened to
// whole 16-byte blocks: the first and last of them hold the run's ends, so
// the copy never leaves the pages of the logits), into one buffer,
// completing on an mbarrier.  Per step: wait for its rows; every thread
// H-lerps the step's output rows from them into T (the f32 instance's
// staging expression, read from shared memory instead of L2), a ring of a
// step's rows (flat row R at R mod rows) that keeps the row a step shares
// with the one before; a barrier, after which warp 0 issues the next
// step's copies into the freed buffer while every thread computes its
// span's pixels (stats_chunks: the same code as the f32 instance); a
// barrier.  So the copies of step n + 1 are in flight while step n is
// computed.  The host picks the spans a step (losses/ce.py:_stats_ring: 4
// at VOC, 3 at Cityscapes, whose 1155 spans split 9 a block).  Variants
// measured at VOC prob on an NVIDIA H100 80GB HBM3 at 700 W that stayed
// out: 2 spans a step (0.039 ms, two blocks an SM) and 1 (0.048) against
// 4 (0.036); T holding two steps' rows, the next step's H pass taken by the
// warps done with this step's pixels, one barrier a step (0.0386 against
// 0.0384).  The entropy's quotients share one reciprocal of the sum
// (u2pl::div_r1: 0.0585 against 0.0597 ms with '/').
constexpr int kRingMaxSpans = 4;

// the shared memory of a ring block (losses/ce.py:_ring_bytes): the column
// taps, per step row its raw offsets and weights, per image group its copy
// layout and per row its group, T's rows, the raw buffer, the mbarrier
__host__ __device__ inline long long ring_bytes(int C, int W, int OW, int rows, int raw) {
  return 64LL * ((OW + 3) / 4) + 48LL * rows + ((4LL * rows * C * W + 15) & ~15LL) + raw + 16;
}

template <int MAXC, int MODE, bool EXACT>
__global__ void __launch_bounds__(kStatsThreads * kRingMaxSpans) stats_ring_kernel(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ maxprob,
    int* __restrict__ argmax, float* __restrict__ entropy,
    const int* __restrict__ labels, const float* __restrict__ cw,
    double* __restrict__ part, int* __restrict__ num_valid, unsigned* __restrict__ ticket,
    int ignore, const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w, int C, int H, int W,
    int OH, int OW, unsigned total, int span, int spans, int nparts, int quarter, int rows,
    int raw_bytes, float inv_ow) {
  extern __shared__ int4 scol[];  // (lo, hi, 1 - frac, frac) per output column
  int4* rtab = scol + 4 * quarter;  // per step row: its lo and hi rows in a run, weights
  int4* gtab = rtab + rows;         // per image group: byte base, class stride, shift, i0
  int* rgrp = reinterpret_cast<int*>(gtab + rows);  // per step row: its group
  float* T = reinterpret_cast<float*>(rgrp + 4 * rows);
  char* raw = reinterpret_cast<char*>(T) + ((4LL * rows * C * W + 15) & ~15LL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(raw + raw_bytes);
  __shared__ double red[2][kRingMaxSpans][kStatsThreads / 32];  // kStatsCE
  __shared__ unsigned block_valid;                              // kStatsTargetProb
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int CW = C * W, HW = H * W;
  // the block's spans [p0, p1), in steps of `spans` (the last may hold fewer)
  const int p0 = (int)((long long)blockIdx.x * nparts / gridDim.x);
  const int p1 = (int)((long long)(blockIdx.x + 1) * nparts / gridDim.x);
  auto first = [&](int p) { return (unsigned)p * span; };
  auto stop = [&](int p) { return min((unsigned)min(p + spans, p1) * span, total); };
  if (tid == 0) {
    block_valid = 0;
    u2pl::mbar_init(bar, 1);
  }
  for (int ox = tid; ox < OW; ox += nthreads) {
    scol[(ox & 3) * quarter + (ox >> 2)] =
        make_int4(idx_w[ox], idx_w[OW + ox], __float_as_int(w_w[ox]), __float_as_int(w_w[OW + ox]));
  }
  __syncthreads();

  // warp 0: the tables of the step from span p and its copies.  Its output
  // rows [Ra, Rb] fall in images bA .. Rb / OH, a group each: the input rows
  // [i0, i1] of class c are one run of (i1 - i0 + 1) W elements, copied from
  // the 16-byte block holding its first element to the group's base + c *
  // stride; the run's shift in that block counts from the address, x8 (the
  // logits may be a view that starts anywhere on their 2-byte elements).
  const int x8 = (int)(((uintptr_t)x >> 1) & 7);
  auto issue = [&](int p) {
    const unsigned k0 = first(p), k1 = stop(p);
    const int Ra = (int)(k0 / OW), Rb = (int)((k1 - 1) / OW), bA = Ra / OH;
    const int ng = Rb / OH - bA + 1;
    if (lane == 0) {
      int base = 0;
      for (int g = 0; g < ng; ++g) {
        const int b = bA + g;
        const int oy0 = max(Ra - b * OH, 0), oy1 = min(Rb - b * OH, OH - 1);
        const int i0 = idx_h[oy0], n_el = (idx_h[OH + oy1] - i0 + 1) * W;
        const int stride = 2 * ((n_el + 14) & ~7);  // bytes a class
        const long long e = ((long long)b * C * H + i0) * W;
        gtab[g] = make_int4(base, stride, (int)((x8 + e) & 7), i0);
        base += C * stride;
      }
      if (base > raw_bytes) __trap();  // the plan's bound (losses/ce.py:_stats_ring)
    }
    for (int r = lane; r <= Rb - Ra; r += 32) {
      const int R = Ra + r, b = R / OH, oy = R - b * OH, g = b - bA;
      const int i0 = g == 0 ? idx_h[max(Ra - b * OH, 0)] : idx_h[0];
      rgrp[r] = g;
      rtab[r] = make_int4((idx_h[oy] - i0) * W, (idx_h[OH + oy] - i0) * W,
                          __float_as_int(w_h[oy]), __float_as_int(w_h[OH + oy]));
    }
    __syncwarp();
    unsigned bytes = 0;
    for (int i = lane; i < ng * C; i += 32) {
      const int g = i / C, c = i - g * C;
      const int4 gt = gtab[g];
      const int b = bA + g;
      const int oy1 = min(Rb - b * OH, OH - 1);
      const int n_el = (idx_h[OH + oy1] - gt.w + 1) * W;
      const int shift = (gt.z + c * (HW & 7)) & 7;
      bytes += 2u * (unsigned)((shift + n_el + 7) & ~7);
    }
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) u2pl::mbar_expect(bar, bytes);
    __syncwarp();
    for (int i = lane; i < ng * C; i += 32) {
      const int g = i / C, c = i - g * C;
      const int4 gt = gtab[g];
      const int b = bA + g;
      const int oy1 = min(Rb - b * OH, OH - 1);
      const int n_el = (idx_h[OH + oy1] - gt.w + 1) * W;
      const long long e = ((long long)b * C + c) * HW + (long long)gt.w * W;
      const int shift = (int)((x8 + e) & 7);
      u2pl::bulk_copy(raw + gt.x + c * gt.y, x + (e - shift), 2u * ((shift + n_el + 7) & ~7),
                      bar);
    }
  };
  const float inv_w = 1.0f / (float)W;
  const int hw8 = HW & 7;
  unsigned phase = 0;
  int done = -1;  // T holds the flat rows up to `done` (those of the step before)
  // the H pass of the step from span p (once its copies have landed): its
  // rows past `done`, (class, column) items walking the rows, into T's ring
  // (a row the step shares with the one before stays at its slot: the new
  // rows, at most rows - 1 past it, take the others)
  auto lerp = [&](int p) {
    u2pl::mbar_wait(bar, phase);
    phase ^= 1;
    const int Ra = (int)(first(p) / OW), Rb = (int)((stop(p) - 1) / OW);
    const int r0 = max(done + 1, Ra) - Ra, nr = Rb - Ra + 1;
    const int slot0 = (Ra + r0) % rows;  // T's row of the first new row
    for (int k = tid; k < CW; k += nthreads) {
      const int c = div_small(k, W, inv_w), ix = k - c * W;
      int gcur = -1, slot = slot0;
      const __nv_bfloat16* src = nullptr;
      for (int r = r0; r < nr; ++r) {
        const int g = rgrp[r];
        if (g != gcur) {
          const int4 gt = gtab[g];
          src = reinterpret_cast<const __nv_bfloat16*>(raw + gt.x + c * gt.y) +
                ((gt.z + c * hw8) & 7) + ix;
          gcur = g;
        }
        const int4 rt = rtab[r];
        T[slot * CW + k] = u2pl::lerp2(__int_as_float(rt.z), to_f32(src[rt.x]),
                                       __int_as_float(rt.w), to_f32(src[rt.y]));
        if (++slot == rows) slot = 0;
      }
    }
    done = Rb;
  };

  if (warp == 0 && p0 < p1) issue(p0);
  __syncthreads();  // the first step's tables
  const int s = tid / kStatsThreads, t = tid - s * kStatsThreads;  // this thread's span
  unsigned valid = 0;
  for (int p = p0; p < p1; p += spans) {
    const unsigned k0 = first(p), k1 = stop(p);
    const unsigned R0 = k0 / OW;
    lerp(p);
    __syncthreads();  // T written; the raw buffer and the tables free
    if (warp == 0 && p + spans < p1) {
      u2pl::fence_async_shared();
      issue(p + spans);
    }
    const unsigned ks = k0 + (unsigned)s * span;
    double acc = 0.0, acc_w = 0.0;
    if (ks < k1) {
      stats_chunks<MAXC, MODE, EXACT, true, true>(
          T, (int)(R0 % rows), rows, scol, quarter, C, W, OW, inv_ow, R0, ks,
          min(ks + (unsigned)span, k1), t, labels, cw, ignore, maxprob, argmax, entropy, acc,
          acc_w, valid);
    }
    if constexpr (MODE == kStatsCE) {
      // the span's partial sums, as the f32 instance's block forms them
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, o);
        acc_w += __shfl_down_sync(0xffffffffu, acc_w, o);
      }
      if (lane == 0) {
        red[0][s][t >> 5] = acc;
        red[1][s][t >> 5] = acc_w;
      }
    }
    __syncthreads();  // T's rows of this step free
    if constexpr (MODE == kStatsCE) {
      if (t == 0 && ks < k1) {
        double a = 0.0, b = 0.0;
        for (int j = 0; j < kStatsThreads / 32; ++j) {
          a += red[0][s][j];
          b += red[1][s][j];
        }
        part[p + s] = a;
        part[nparts + p + s] = b;
      }
    }
  }
  if constexpr (MODE == kStatsTargetProb) {
    valid = __reduce_add_sync(0xffffffffu, valid);
    if (lane == 0 && valid) atomicAdd(&block_valid, valid);
    __syncthreads();
    if (tid == 0) {
      if (block_valid) atomicAdd(ticket + 1, block_valid);
      __threadfence();  // the count before the ticket
      if (atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1) {
        *num_valid = (int)atomicExch(ticket + 1, 0u);
      }
    }
  }
}

struct StatsArgs {
  const void* x;  // float or __nv_bfloat16 (the launch's In)
  float* maxprob;  // kStatsCE: the lse; kStatsTargetProb: p_y
  int* argmax;
  float* entropy;
  const int* labels;  // kStatsCE: labels, class weights or null, partial sums
  const float* cw;
  double* part;
  int* num_valid;  // kStatsTargetProb: the count out, and its two ticket words
  unsigned* ticket;
  int ignore;
  const int* idx_h;
  const float* w_h;
  const int* idx_w;
  const float* w_w;
  int C, H, W, OH, OW;
  unsigned total;
  int span, quarter, max_rows, smem;
  int spans, raw_bytes;  // the bf16 ring (losses/ce.py:_stats_ring)
};

// the ring's grid: as many blocks as the SMs hold, at most one a step's spans
template <int MAXC, int MODE, bool EXACT>
cudaError_t launch_ring(const StatsArgs& a, cudaStream_t stream) {
  auto kernel = stats_ring_kernel<MAXC, MODE, EXACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const int threads = kStatsThreads * a.spans;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, a.smem)) !=
          cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int nparts = (int)((a.total + a.span - 1) / a.span);  // the spans
  kernel<<<min((nparts + a.spans - 1) / a.spans, sms * per_sm), threads, a.smem, stream>>>(
      (const __nv_bfloat16*)a.x, a.maxprob, a.argmax, a.entropy, a.labels, a.cw, a.part,
      a.num_valid, a.ticket, a.ignore, a.idx_h, a.w_h, a.idx_w, a.w_w, a.C, a.H, a.W, a.OH,
      a.OW, a.total, a.span, a.spans, nparts, a.quarter, a.max_rows, a.raw_bytes,
      1.0f / (float)a.OW);
  return cudaGetLastError();
}

template <int MAXC, int MODE, bool EXACT, typename In>
cudaError_t launch_stats(const StatsArgs& a, cudaStream_t stream) {
  if constexpr (sizeof(In) == 2) {
    return launch_ring<MAXC, MODE, EXACT>(a, stream);
  } else {
    auto kernel = upsample_softmax_stats_kernel<MAXC, MODE, EXACT>;
    if (a.smem > 48 * 1024) {  // above the default dynamic shared memory of a block
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<(a.total + a.span - 1) / a.span, kStatsThreads, a.smem, stream>>>(
        (const float*)a.x, a.maxprob, a.argmax, a.entropy, a.labels, a.cw, a.part, a.num_valid,
        a.ticket, a.ignore, a.idx_h, a.w_h, a.idx_w, a.w_w, a.C, a.H, a.W, a.OH, a.OW, a.total,
        a.span, a.quarter, a.max_rows, 1.0f / (float)a.OW);
    return cudaGetLastError();
  }
}

// the configs' class counts exactly (no per-class guard), else the
// smallest register array that holds C classes; C's forward and K7 prob
// take any C (MAXC 0: no register array)
template <int MODE, typename In>
cudaError_t launch_stats_in(const StatsArgs& a, cudaStream_t stream) {
  if (a.C == 21) return launch_stats<21, MODE, true, In>(a, stream);  // VOC
  if (a.C == 19) return launch_stats<19, MODE, true, In>(a, stream);  // Cityscapes
  if (a.C <= 8) return launch_stats<8, MODE, false, In>(a, stream);
  if (a.C <= 16) return launch_stats<16, MODE, false, In>(a, stream);
  if (a.C <= 24) return launch_stats<24, MODE, false, In>(a, stream);
  if constexpr (MODE == kStatsCE || MODE == kStatsTargetProb) {
    if (a.C > kStatsMaxClasses) return launch_stats<0, MODE, false, In>(a, stream);
  }
  return launch_stats<32, MODE, false, In>(a, stream);
}

// the logits' dtype: 0 float32, 1 bfloat16 (losses/ce.py:LOGIT_DTYPES)
template <int MODE>
cudaError_t launch_stats_mode(const StatsArgs& a, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_stats_in<MODE, __nv_bfloat16>(a, stream);
  return launch_stats_in<MODE, float>(a, stream);
}

// a plan (span, max_rows, spans, raw_bytes) from losses/ce.py:_stats_launch:
// span a multiple of 4, room for every row a span touches (f32: spans and
// raw_bytes 0; bf16: a step of `spans` spans, in 1 .. kRingMaxSpans,
// max_rows the rows a step touches and raw_bytes a multiple of 16, the
// most a step's copies take), within kStatsMaxShared; the block's shared
// memory in *smem
bool stats_plan_ok(int B, int C, int W, int OH, int OW, int span, int max_rows, int spans,
                   int raw_bytes, int dtype, int* smem) {
  const long long total = (long long)B * OH * OW;
  const long long bytes =
      dtype == 1 ? ring_bytes(C, W, OW, max_rows, raw_bytes)
                 : 64LL * ((OW + 3) / 4) + (long long)max_rows * (4LL * C * W + 16);
  const int per_step = dtype == 1 ? spans : 1;
  *smem = (int)min(bytes, (long long)INT_MAX);
  return span > 0 && span % 4 == 0 && total < (1LL << 31) && OW < (1 << 23) &&
         (dtype == 1 ? spans >= 1 && spans <= kRingMaxSpans && raw_bytes >= 0 &&
                           raw_bytes % 16 == 0
                     : spans == 0 && raw_bytes == 0) &&
         max_rows >= min((long long)span * per_step / OW + 2, (long long)B * OH) &&
         bytes <= kStatsMaxShared && (long long)max_rows * C * W < (1 << 24);
}

struct BwdArgs {
  const void* x;  // float or __nv_bfloat16 (the launch's In), as gx
  const int* labels;
  const float* cw;
  const float* lse;
  const float* stats;
  const float* gout;
  void* gx;
  const int* idx_h;
  const float* w_h;
  const int* rng_h;
  const int* idx_w;
  const float* w_w;
  const int* rng_w;
  int C, H, W, OH, OW, ignore;
  float floor_;
  int groups, cls, rows, bands, chunk, span, gs;
};

template <typename In, int S, int NC, int P>
cudaError_t launch_bwd(const BwdArgs& a, unsigned blocks, int threads, int smem,
                       cudaStream_t stream) {
  auto kernel = upsample_ce_bwd_kernel<In, S, NC, P>;
  if (smem > 48 * 1024) {  // above the default dynamic shared memory of a block
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, (size_t)smem, stream>>>(
      (const In*)a.x, a.labels, a.cw, a.lse, a.stats, a.gout, (In*)a.gx, a.idx_h, a.w_h,
      a.rng_h, a.idx_w, a.w_w, a.rng_w, a.C, a.H, a.W, a.OH, a.OW, a.ignore, a.floor_,
      a.groups, a.cls, a.rows, a.bands, a.chunk, a.span, a.gs);
  return cudaGetLastError();
}

// at the exact ratio S: its 3 or 4 classes a block, 1 or 2 pairs a thread
template <typename In, int S>
cudaError_t launch_bwd_exact(const BwdArgs& a, int pairs, unsigned blocks, int threads,
                             int smem, cudaStream_t stream) {
  if (a.cls == 3) {
    if (pairs == 2) return launch_bwd<In, S, 3, 2>(a, blocks, threads, smem, stream);
    return launch_bwd<In, S, 3, 1>(a, blocks, threads, smem, stream);
  }
  if (pairs == 2) return launch_bwd<In, S, 4, 2>(a, blocks, threads, smem, stream);
  return launch_bwd<In, S, 4, 1>(a, blocks, threads, smem, stream);
}

template <typename In>
cudaError_t launch_bwd_ratio(const BwdArgs& a, int ratio, int pairs, unsigned blocks,
                             int threads, int smem, cudaStream_t stream) {
  if (ratio == 4) return launch_bwd_exact<In, 4>(a, pairs, blocks, threads, smem, stream);
  if (ratio == 8) return launch_bwd_exact<In, 8>(a, pairs, blocks, threads, smem, stream);
  return launch_bwd<In, 0, 0, 1>(a, blocks, threads, smem, stream);
}

}  // namespace

extern "C" {

// part: 2 x ceil(B * OH * OW / span) doubles; stats: 2 floats [loss, denom];
// (span, max_rows) from losses/ce.py:_stats_plan
int u2pl_upsample_ce_fwd(const void* x, const void* labels, const void* cw,
                         void* lse, void* part, void* stats, const void* idx_h,
                         const void* w_h, const void* idx_w, const void* w_w,
                         int B, int C, int H, int W, int OH, int OW,
                         int ignore, float floor_, int span, int max_rows, int spans,
                         int raw_bytes, int dtype, void* stream) {
  int smem = 0;
  if (C <= 0 || H <= 0 || W <= 0 || (dtype != 0 && dtype != 1) ||
      !stats_plan_ok(B, C, W, OH, OW, span, max_rows, spans, raw_bytes, dtype, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)B * OH * OW;
  const int blocks = total > 0 ? (int)((total + span - 1) / span) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0) {
    const StatsArgs a = {x, (float*)lse, nullptr, nullptr, (const int*)labels,
                         (const float*)cw, (double*)part, nullptr, nullptr, ignore,
                         (const int*)idx_h, (const float*)w_h, (const int*)idx_w,
                         (const float*)w_w, C, H, W, OH, OW, (unsigned)total, span,
                         (OW + 3) / 4, max_rows, smem, spans, raw_bytes};
    const cudaError_t err = launch_stats_mode<kStatsCE>(a, dtype, st);
    if (err != cudaSuccess) return (int)err;
  }
  upsample_ce_finalize_kernel<<<1, kThreads, 0, st>>>((const double*)part, blocks, floor_,
                                                     (float*)stats);
  return (int)cudaGetLastError();
}

// shared memory of the backward's block, in bytes (losses/ce.py:_bwd_smem):
// two steps' g rows of `cls` classes (`gbytes` a value: the logits' dtype),
// two steps' row taps, the column taps, two steps' labels and lse and
// H-lerped rows, the class weights and, at no exact ratio, the column tap
// weights
static long long bwd_smem(int C, int W, int OW, int cls, int chunk, int span, int gs,
                          int ratio, int gbytes) {
  return 2LL * gbytes * chunk * cls * gs + 32LL * chunk + 8LL * OW + 16LL * chunk * OW +
         4LL * (2LL * chunk * cls * W + C + (ratio ? 0LL : (long long)W * span + 2LL * W));
}

// (groups, cls, rows, bands, chunk, threads, span, gs, ratio) from
// losses/ce.py:_bwd_plan: blocks of `threads` on (image, band of `rows`
// input rows, one of `groups` class groups of at most `cls`), `chunk`
// output rows a step, g rows of `gs` elements; ratio 4 or 8 where OW - 1 =
// ratio (W - 1), else 0
int u2pl_upsample_ce_bwd(const void* x, const void* labels, const void* cw,
                         const void* lse, const void* stats, const void* gout,
                         void* gx, const void* idx_h, const void* w_h,
                         const void* rng_h, const void* idx_w, const void* w_w,
                         const void* rng_w, int B, int C, int H, int W, int OH,
                         int OW, int ignore, float floor_, int groups, int cls, int rows,
                         int bands, int chunk, int threads, int span, int gs, int ratio,
                         int dtype, void* stream) {
  if ((long long)B * C * H * W <= 0) return (int)cudaGetLastError();
  const bool exact = ratio == 4 || ratio == 8;
  if (OH <= 0 || OW <= 0 || W >= 32768 || (dtype != 0 && dtype != 1) || cls < 1 ||
      cls > kBwdClasses || groups != (C + cls - 1) / cls || rows <= 0 ||
      bands != (H + rows - 1) / rows || chunk < 1 || chunk > kBwdMaxChunk ||
      threads % 32 != 0 || threads > (exact ? kBwdExactThreads : kBwdMaxThreads) ||
      threads * (exact ? 2 : 1) < cls * W || span <= 0 || gs % 8 != 0 ||
      gs < OW + 2 * ratio ||
      (ratio != 0 && !(exact && W >= 2 && OW - 1 == ratio * (W - 1) && cls >= 3))) {
    return (int)cudaErrorInvalidValue;
  }
  const int pairs = threads < cls * W ? 2 : 1;  // owner pairs a thread
  const long long smem = bwd_smem(C, W, OW, cls, chunk, span, gs, ratio, dtype == 1 ? 2 : 4);
  if (smem > kBwdMaxShared) return (int)cudaErrorInvalidValue;
  const BwdArgs a = {x, (const int*)labels, (const float*)cw, (const float*)lse,
                     (const float*)stats, (const float*)gout, gx, (const int*)idx_h,
                     (const float*)w_h, (const int*)rng_h, (const int*)idx_w,
                     (const float*)w_w, (const int*)rng_w, C, H, W, OH, OW, ignore,
                     floor_, groups, cls, rows, bands, chunk, span, gs};
  const unsigned blocks = (unsigned)B * bands * groups;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    return (int)launch_bwd_ratio<__nv_bfloat16>(a, ratio, pairs, blocks, threads, (int)smem,
                                                st);
  }
  return (int)launch_bwd_ratio<float>(a, ratio, pairs, blocks, threads, (int)smem, st);
}

// maxprob and argmax both or neither, entropy or not (at least one output);
// (span, max_rows) from losses/ce.py:_stats_plan
int u2pl_upsample_softmax_stats(const void* x, void* maxprob, void* argmax,
                                void* entropy, const void* idx_h,
                                const void* w_h, const void* idx_w,
                                const void* w_w, int B, int C, int H, int W,
                                int OH, int OW, int span, int max_rows, int spans,
                                int raw_bytes, int dtype, void* stream) {
  const int mode = (maxprob ? kStatsProb : 0) | (entropy ? kStatsEntropy : 0);
  int smem = 0;
  if (!maxprob != !argmax || mode == 0 || C <= 0 || (dtype != 0 && dtype != 1) ||
      C > kStatsMaxClasses || H <= 0 || W <= 0 ||
      !stats_plan_ok(B, C, W, OH, OW, span, max_rows, spans, raw_bytes, dtype, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || OH <= 0 || OW <= 0) return (int)cudaGetLastError();
  const StatsArgs a = {x, (float*)maxprob, (int*)argmax, (float*)entropy,
                       nullptr, nullptr, nullptr, nullptr, nullptr, 0, (const int*)idx_h,
                       (const float*)w_h, (const int*)idx_w, (const float*)w_w, C, H, W, OH, OW,
                       (unsigned)((long long)B * OH * OW), span, (OW + 3) / 4, max_rows, smem,
                       spans, raw_bytes};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (mode == kStatsProb) {
    err = launch_stats_mode<kStatsProb>(a, dtype, st);
  } else if (mode == kStatsEntropy) {
    err = launch_stats_mode<kStatsEntropy>(a, dtype, st);
  } else {
    err = launch_stats_mode<kStatsProb | kStatsEntropy>(a, dtype, st);
  }
  return (int)err;
}

// K7 prob: p_y (B, OH, OW) f32 and num_valid (one int32, written by the
// launch); ticket: two zeroed u32 words of kernels.tickets, left zero;
// (span, max_rows) from losses/ce.py:_stats_plan
int u2pl_ohem_target_prob(const void* x, const void* labels, void* p_y,
                          void* num_valid, void* ticket, const void* idx_h,
                          const void* w_h, const void* idx_w, const void* w_w,
                          int B, int C, int H, int W, int OH, int OW, int ignore,
                          int span, int max_rows, int spans, int raw_bytes, int dtype,
                          void* stream) {
  int smem = 0;
  const long long total = (long long)B * OH * OW;
  if (total <= 0 || C <= 0 || H <= 0 || W <= 0 || (dtype != 0 && dtype != 1) ||
      !stats_plan_ok(B, C, W, OH, OW, span, max_rows, spans, raw_bytes, dtype, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const StatsArgs a = {x, (float*)p_y, nullptr, nullptr, (const int*)labels,
                       nullptr, nullptr, (int*)num_valid, (unsigned*)ticket, ignore,
                       (const int*)idx_h, (const float*)w_h, (const int*)idx_w,
                       (const float*)w_w, C, H, W, OH, OW, (unsigned)total, span,
                       (OW + 3) / 4, max_rows, smem, spans, raw_bytes};
  return (int)launch_stats_mode<kStatsTargetProb>(a, dtype, (cudaStream_t)stream);
}

}  // extern "C"

// Align-corners bilinear resize kernels (sm_90a).
//
// A. u2pl_resize_bilinear_ac replaces u2pl_tpu/ops/resize.py:resize_bilinear
//    (kernel family K1): (B, C, H, W) f32 -> (B, C, OH, OW) f32.  On the TPU
//    it was two dense interpolation matmuls on the MXU.
// A-bwd. u2pl_resize_bilinear_ac_bwd is its adjoint (the VJP XLA derives
//    from the two einsums): (B, C, OH, OW) f32 -> (B, C, H, W) f32.
// B. u2pl_resize_argmax_ac replaces the host-side resize + argmax of
//    u2pl_tpu/serving.py:InferEngine.to_mask (resize_bilinear_numpy, then
//    argmax(-1)): one image's (C, H, W) f32 or bf16 logits -> (OH, OW)
//    uint8 labels.
//
// All three are bound by device-memory bytes, not arithmetic (4 taps and 3
// lerps per output value).
//
// Kernel A writes 88 MB at the serving shape (4, 21, 129²) -> 513² (28 us
// at 3.35 TB/s) and 136 MB at the decoder's (8, 256, 65²) -> 129².  Its
// first design ran one thread per output in a grid-stride loop: per value
// two 32-bit divisions and two modulos by runtime sizes, 8 tap loads and 4
// gathers, ~120 instructions for 4 bytes stored: 0.114 / 0.163 ms at the
// serving / decoder shapes on an NVIDIA H100 80GB HBM3 at 700 W, a quarter
// and a third of the bound (F.interpolate: 0.088 / 0.83 ms;
// u2pl_tpu_torch/kernels/timing_ab.py).  This design takes the index work
// out of the output loop, 0.038 / 0.095 ms there:
// - a block owns a band of `rows` output rows of one plane (blockIdx.x =
//   plane * bands + band; one division per block); the band is a
//   contiguous range of the flat output;
// - the block stages the column taps (lo, hi, 1 - frac, frac) of every
//   output column in shared memory as one int4, ordered by column % 4 so
//   that a warp reads them without bank conflicts, and the H pass of its
//   rows T[r][c] = lerp2(a, x[h0, c], b, x[h1, c]) for every input column
//   c, one warp per row: once per row, not four times per output value;
// - each thread then owns aligned 4-float chunks of the band: per output
//   one int4 of taps, 2 shared reads of T and one W lerp; the row and
//   column of a chunk come from a float reciprocal corrected to the exact
//   quotient;
// - 16-byte streaming stores (__stcs: the output is larger than the 50 MB
//   L2 and is read by the next kernel, not this one), scalar stores where
//   a chunk wraps a row or crosses the band's ends.
// The same products and sums, each rounded on its own, as common.cuh's
// `upsampled` (H pass, then W pass), so the same bits as kernels C, D and
// K7 evaluate inside themselves.  Shared memory per block: 16 B per output
// column (rounded up to 4 columns) plus 4 B per input column and band row,
// at most kResizeMaxShared.  The host plans the bands (ops/resize.py:
// _fwd_plan: about 4096 outputs a band, as many rows as that memory holds).
//
// A few planes (a 3-plane request image, 513² or 769²; eval's image at each
// scale) make too few bands to fill the card: at VOC's (1, 3, 375, 500) ->
// 513², 171 blocks, one partial wave, each block's tap staging, H pass (a
// warp's row of 500 columns in 16 load steps) and W pass one after the
// other: 0.0115-0.0118 ms against 0.0058-0.0060 for F.interpolate.  There
// the plan gives no bands (fewer than 4 blocks an SM) and the direct kernel
// runs: a thread per output pixel for every plane, its taps packed as one
// int4 per row and column, loaded once for all planes, then 4 inputs a
// plane, all issued before the first is used; the same products and sums.
// It takes 0.0042-0.0044 ms there and 0.0093-0.0094 at Cityscapes' (1, 3,
// 1024, 2048) -> 769² (F.interpolate 0.0144-0.0146; the 25 MB input stays
// in L2 from call to call), on an NVIDIA H100 80GB HBM3 at 700 W
// (timing_ab.py).  Shorter bands (u2pl_tpu_torch/kernels/plan_sweep.py)
// keep each block's serial chain and are slower; so were an H pass flat
// over the block with its loads batched (its registers halved the blocks
// an SM at the logits' 84 planes) and a thread per 4 flat outputs (12
// loads an output).
//
// A-bwd is in gather form: each INPUT element sums the output rows and
// columns whose taps reach it, so no two threads write one address and no
// float atomics are needed; the gradient is the same bit for bit from run to
// run.  The outputs reaching input index i are those with lo[o] in {i-1, i},
// contiguous because lo is non-decreasing; the host passes them as
// [start[0..n), end[0..n)] per axis.  The W reduction runs before the H one,
// as in the einsum VJP: gx[iy][ix] = sum over oy of wy * S[oy][ix], S[oy][ix]
// = sum over ox of wx * gy[oy][ox], each sum from 0 in ascending order.
// Bytes bound it: 136 MB of gy read and 35 MB of gx written at the decoder's
// (8, 256, 129²) -> 65² (0.051 ms at 3.35 TB/s).  Its first design ran one
// thread per input element (two divisions and modulos per element, two tap
// table lookups per (oy, ox) pair, every gy value fetched by ~4 threads):
// 0.252 ms there on an NVIDIA H100 80GB HBM3 at 700 W.  This design streams:
// - a thread owns one input column ix of a band of input rows of one plane
//   (the whole plane at the decoder's shapes; ops/resize.py:_bwd_plan) and
//   holds the column's tap weights in registers (at most 4 output columns
//   reach it in every downsample and in an upsample of up to about 2x;
//   wider columns read their weights from the tables);
// - it walks the output rows that reach its band in ascending order: per
//   row it loads the few gy values of its column's output range (the lanes
//   of a warp, on consecutive columns, read one contiguous stretch of the
//   row; kBwdRows rows' loads are issued before any is used), takes the W
//   sum S,
//   and adds wy * S to the two input rows the output row reaches (lo, lo + 1),
//   kept in registers;
// - when lo moves on, the input rows below it are complete and are stored
//   (the lanes' stores are consecutive): no shared memory, no barrier.
// 0.076 ms there (68% of the bound).  Kernel A's banded form (gy rows
// staged in shared memory, W-reduced into S rows there, then gx from S)
// took 0.154 ms: its index arithmetic and barriers, not its bytes, bound
// it.  8 rows' loads in flight per thread need 80 registers, and VOC's
// 133,120 threads then take two waves (PERF.md).  Same products and sums in
// the same order as the first design, so the same bits.
//
// Kernel B keeps the per-class values in registers: it reads the logits
// once and writes one byte per pixel, where the unfused path writes and
// re-reads an (OH, OW, C) f32 intermediate.  It runs one thread per output
// pixel in a grid-stride loop.
//
// bfloat16 modes (the JAX function under a bf16 model, u2pl_tpu/ops/
// resize.py:76-123): A and A-bwd take T = __nv_bfloat16 in and out, with
// the arithmetic in f32.  The narrow branch (fewer than 64 channels, or
// weights not exact in bf16) is the f32 path with only the output rounded to
// bf16.  The wide branch (the decoder's 256-channel os8 -> os4 upsample:
// every weight a bf16, every product exact in f32) also rounds the
// separable intermediate to bf16 between the passes, as the JAX einsums
// do: the H pass's T rows in A, and in A-bwd the W sum S before it enters
// the H sum (the transposed einsums' convert_element_type).  The host picks
// the branch (ops/resize.py:_wide).  One kernel per function: the element
// type and the branch are template parameters.
//
// bf16 inference (u2pl_tpu/evallib/slide.py, u2pl_tpu/serving.py under
// --dtype bfloat16): after the forward and its narrow upsample, the JAX
// package resizes the bf16 logits with resize_bilinear_numpy, which widens
// them to f32 first (u2pl_tpu/ops/resize.py:233) and rounds nothing after.
// So B reads bf16 logits and widens each tap on load, then runs the f32
// arithmetic and argmax (its labels are the f32 mode's on the exact
// upcast); and A has a bf16-in, f32-out mode (kModeBf16F32) for the
// multi-scale sum of eval: the f32 mode on the exact upcast.
//
// Taps and index widths: see common.cuh.  Index arithmetic is 32-bit
// unsigned (the wrappers refuse tensors of 2^31 elements or more): 64-bit
// division is a long instruction sequence on the GPU.

#include "common.cuh"

namespace {

using u2pl::blocks_for;
using u2pl::div_small;
using u2pl::kThreads;
using u2pl::lerp2;
using u2pl::round_bf16;
using u2pl::store4_cs;
using u2pl::store_as;
using u2pl::tap_weight;
using u2pl::to_f32;

constexpr int kResizeMaxShared = 160 * 1024;  // bytes of taps and H-lerped rows

// shared-memory slot of output column ox's taps: the columns are stored
// by ox % 4, so the lanes of a warp, each on its own 4 consecutive columns,
// read 32 consecutive int4 (no bank conflicts)
__device__ __forceinline__ int col_slot(int ox, int quarter) {
  return (ox & 3) * quarter + (ox >> 2);
}

// T: the input's element type (float; __nv_bfloat16 in the bf16 modes), O
// the output's (T, or float from bf16 in kModeBf16F32); WIDE rounds the H
// pass to bf16; (rows, bands) from ops/resize.py:_fwd_plan
template <typename T, typename O, bool WIDE>
__global__ void __launch_bounds__(kThreads) resize_bilinear_ac_kernel(
    const T* __restrict__ x, O* __restrict__ y,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ idx_w, const float* __restrict__ w_w, int H, int W,
    int OH, int OW, int rows, int bands, int quarter, float inv_ow) {
  extern __shared__ int4 col[];  // (lo, hi, 1 - frac, frac) per output column
  float* Trows = reinterpret_cast<float*>(col + 4 * quarter);  // the band's H-lerped rows
  const int plane = blockIdx.x / bands;
  const int oy0 = (blockIdx.x - plane * bands) * rows;
  const int nr = min(rows, OH - oy0);
  for (int ox = threadIdx.x; ox < OW; ox += kThreads) {
    col[col_slot(ox, quarter)] = make_int4(idx_w[ox], idx_w[OW + ox],
                                           __float_as_int(w_w[ox]),
                                           __float_as_int(w_w[OW + ox]));
  }
  // the H pass: one warp per band row, the lanes along the input row
  const T* xp = x + (size_t)plane * H * W;
  for (int r = threadIdx.x >> 5; r < nr; r += kThreads / 32) {
    const int oy = oy0 + r;
    const float a = w_h[oy], b = w_h[OH + oy];
    const T* x0 = xp + idx_h[oy] * W;
    const T* x1 = xp + idx_h[OH + oy] * W;
    float* Tr = Trows + r * W;
    for (int c = threadIdx.x & 31; c < W; c += 32) {
      const float v = lerp2(a, to_f32(x0[c]), b, to_f32(x1[c]));
      Tr[c] = WIDE ? round_bf16(v) : v;
    }
  }
  __syncthreads();
  const unsigned s = ((unsigned)plane * OH + oy0) * OW;  // the band's outputs [s, e)
  const unsigned e = s + (unsigned)nr * OW;
  for (unsigned k = (s & ~3u) + 4u * threadIdx.x; k < e; k += 4u * kThreads) {
    const int local = (int)((k < s ? s : k) - s);
    int r = div_small(local, OW, inv_ow);
    int ox = local - r * OW;
    if (k >= s && k + 4 <= e && ox + 4 <= OW) {  // 4 outputs of one row
      const float* Tr = Trows + r * W;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 t = col[col_slot(ox + i, quarter)];
        v[i] = lerp2(__int_as_float(t.z), Tr[t.x], __int_as_float(t.w), Tr[t.y]);
      }
      store4_cs(y + k, v);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a band's ragged ends, a row's wrap
      if (k + i >= s && k + i < e) {
        const int4 t = col[col_slot(ox, quarter)];
        const float* Tr = Trows + r * W;
        store_as(y + k + i, lerp2(__int_as_float(t.z), Tr[t.x], __int_as_float(t.w), Tr[t.y]));
        if (++ox == OW) {
          ox = 0;
          ++r;
        }
      }
    }
  }
}

constexpr int kDirectPlanes = 4;  // planes whose loads a direct kernel thread issues together

// A with few planes (ops/resize.py:_fwd_plan gives FWD_DIRECT): a thread per
// output pixel (oy, ox), for every plane, straight from the input: its two
// H-pass values from their 2 + 2 taps, then the W lerp (the band kernel's
// products and sums); no shared memory, no barrier.  The taps come packed,
// (lo, hi, 1 - frac, frac) as one int4 per output row and column
// (ops/resize.py:_device_taps4), loaded once for all planes; the lanes of
// a warp, on consecutive columns, read consecutive taps and nearby inputs
// and store consecutive outputs.
template <typename T, typename O, bool WIDE>
__global__ void __launch_bounds__(kThreads) resize_bilinear_ac_direct_kernel(
    const T* __restrict__ x, O* __restrict__ y, const int4* __restrict__ taps_h,
    const int4* __restrict__ taps_w, int planes, int H, int W, int OH, int OW) {
  const unsigned area = (unsigned)OH * OW;
  const unsigned pix = blockIdx.x * kThreads + threadIdx.x;  // oy * OW + ox
  if (pix >= area) return;
  const int oy = (int)(pix / (unsigned)OW), ox = (int)(pix - (unsigned)oy * OW);
  const int4 rt = taps_h[oy], ct = taps_w[ox];
  const float a = __int_as_float(rt.z), b = __int_as_float(rt.w);
  const float p = __int_as_float(ct.z), q = __int_as_float(ct.w);
  const int h0 = rt.x * W, h1 = rt.y * W;
  const size_t in_plane = (size_t)H * W;
  for (int c0 = 0; c0 < planes; c0 += kDirectPlanes) {
    float x00[kDirectPlanes], x10[kDirectPlanes], x01[kDirectPlanes], x11[kDirectPlanes];
#pragma unroll
    for (int j = 0; j < kDirectPlanes; ++j) {
      if (c0 + j < planes) {
        const T* xp = x + (c0 + j) * in_plane;
        x00[j] = to_f32(xp[h0 + ct.x]);
        x10[j] = to_f32(xp[h1 + ct.x]);
        x01[j] = to_f32(xp[h0 + ct.y]);
        x11[j] = to_f32(xp[h1 + ct.y]);
      }
    }
#pragma unroll
    for (int j = 0; j < kDirectPlanes; ++j) {
      if (c0 + j < planes) {
        float t0 = lerp2(a, x00[j], b, x10[j]);
        float t1 = lerp2(a, x01[j], b, x11[j]);
        if (WIDE) {
          t0 = round_bf16(t0);
          t1 = round_bf16(t1);
        }
        store_as(y + (size_t)(c0 + j) * area + pix, lerp2(p, t0, q, t1));
      }
    }
  }
}

// A's bf16 wide branch at an exact 2x upsample, n -> 2n - 1 on both axes
// (the decoder's os8 -> os4: (8, 256, 65²) -> 129² at VOC, (4, 256, 97²) ->
// 193² at Cityscapes): output index o takes input o / 2 with weight 1 and
// o / 2 + 1 (clamped) with weight 0 when o is even, both with weight 1/2
// when it is odd, on both axes; the tap tables hold just these values.  So
// a thread takes input element (i, j) of a plane and writes the 2 x 2
// outputs (2i + {0, 1}, 2j + {0, 1}) it leads (1 x 1 at the last row and
// column): 4 loads (i and i + 1, j and j + 1, clamped), the 4 H-pass values
// (each rounded to bf16), 4 W lerps; no table, no shared memory, no
// barrier.  The lanes of a warp, on consecutive j, read consecutive inputs
// and together write whole runs of two output rows.  The same products and
// sums as the band kernel (lerp2 with the tables' weights, the zero-weight
// products included, so non-finite inputs give its bits too).
__global__ void __launch_bounds__(kThreads) resize_bilinear_ac_wide2x_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, unsigned planes, int H,
    int W, float inv_w) {
  const int t = blockIdx.x * kThreads + threadIdx.x;  // i * W + j
  if (t >= H * W) return;
  const int i = div_small(t, W, inv_w), j = t - i * W;
  const int di = i + 1 < H ? W : 0, dj = j + 1 < W ? 1 : 0;  // the clamped neighbours
  const int OW = 2 * W - 1;
  const unsigned in_plane = (unsigned)H * W, out_plane = (unsigned)(2 * H - 1) * OW;
  for (unsigned plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const __nv_bfloat16* xp = x + plane * in_plane + t;
    const float x00 = to_f32(xp[0]), x01 = to_f32(xp[dj]);
    const float x10 = to_f32(xp[di]), x11 = to_f32(xp[di + dj]);
    __nv_bfloat16* yp = y + plane * out_plane + (unsigned)(2 * i) * OW + 2 * j;
    // output row 2i: the H pass with weights 1, 0
    const float e0 = round_bf16(lerp2(1.0f, x00, 0.0f, x10));
    const float e1 = round_bf16(lerp2(1.0f, x01, 0.0f, x11));
    yp[0] = __float2bfloat16_rn(lerp2(1.0f, e0, 0.0f, e1));
    if (dj) yp[1] = __float2bfloat16_rn(lerp2(0.5f, e0, 0.5f, e1));
    if (di) {  // output row 2i + 1: weights 1/2, 1/2
      const float o0 = round_bf16(lerp2(0.5f, x00, 0.5f, x10));
      const float o1 = round_bf16(lerp2(0.5f, x01, 0.5f, x11));
      yp[OW] = __float2bfloat16_rn(lerp2(1.0f, o0, 0.0f, o1));
      if (dj) yp[OW + 1] = __float2bfloat16_rn(lerp2(0.5f, o0, 0.5f, o1));
    }
  }
}

constexpr int kBwdRows = 4;  // gy rows whose loads a thread issues together

// A-bwd: thread (plane, band, ix); MAXW 0 reads any number of column taps
// from the tables, else holds at most MAXW in registers; T and WIDE as in A
// (WIDE rounds each W sum to bf16)
template <int MAXW, typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads) resize_bilinear_ac_bwd_kernel(
    const T* __restrict__ gy, T* __restrict__ gx,
    const int* __restrict__ idx_h, const float* __restrict__ w_h,
    const int* __restrict__ rng_h, const int* __restrict__ idx_w,
    const float* __restrict__ w_w, const int* __restrict__ rng_w, unsigned threads,
    int H, int W, int OH, int OW, int rows, int bands) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const unsigned pb = t / W;  // plane * bands + band
  const int ix = (int)(t - pb * W);
  const unsigned plane = pb / bands;
  const int iy0 = (int)(pb - plane * bands) * rows;
  const int iy1 = min(iy0 + rows, H);
  const int ox0 = rng_w[ix], cnt = rng_w[W + ix] - ox0;
  float wx[MAXW > 0 ? MAXW : 1];
#pragma unroll
  for (int j = 0; j < MAXW; ++j) wx[j] = j < cnt ? tap_weight(idx_w, w_w, OW, ox0 + j, ix) : 0.0f;
  const T* g = gy + (size_t)plane * OH * OW + ox0;
  T* out = gx + (size_t)plane * H * W + ix;
  const int ob = rng_h[iy0], oe = rng_h[H + iy1 - 1];
  // rows L and L + 1 take the current output row; rows [iy0, next) are stored
  int L = ob < oe ? idx_h[ob] : iy1, next = iy0;
  float a0 = 0.0f, a1 = 0.0f;
  auto flush = [&](int upto) {  // store input rows [next, upto) of the band
    for (; next < upto; ++next) {
      store_as(out + (size_t)next * W, next == L ? a0 : next == L + 1 ? a1 : 0.0f);
    }
  };
  for (int oy0 = ob; oy0 < oe; oy0 += kBwdRows) {
    float v[kBwdRows][MAXW > 0 ? MAXW : 1];
    if constexpr (MAXW > 0) {
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
#pragma unroll
        for (int j = 0; j < MAXW; ++j) {
          v[u][j] = oy0 + u < oe && j < cnt ? to_f32(g[(size_t)(oy0 + u) * OW + j]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdRows; ++u) {
      const int oy = oy0 + u;
      if (oy >= oe) break;
      float s = 0.0f;
      if constexpr (MAXW > 0) {
#pragma unroll
        for (int j = 0; j < MAXW; ++j) {
          if (j < cnt) s = __fadd_rn(s, __fmul_rn(wx[j], v[u][j]));
        }
      } else {
        const T* row = g + (size_t)oy * OW;
        for (int j = 0; j < cnt; ++j) {
          s = __fadd_rn(s, __fmul_rn(tap_weight(idx_w, w_w, OW, ox0 + j, ix), to_f32(row[j])));
        }
      }
      if (WIDE) s = round_bf16(s);
      const int lo = idx_h[oy];
      if (lo != L) {  // input rows below lo have all their output rows
        flush(min(lo, iy1));
        a0 = lo == L + 1 ? a1 : 0.0f;
        a1 = 0.0f;
        L = lo;
      }
      a0 = __fadd_rn(a0, __fmul_rn(tap_weight(idx_h, w_h, OH, oy, lo), s));
      a1 = __fadd_rn(a1, __fmul_rn(tap_weight(idx_h, w_h, OH, oy, lo + 1), s));
    }
  }
  flush(iy1);
}

// the W sum of one output row of A-bwd's 2x adjoint for input column ix:
// output columns 2ix - 2 .. 2ix + 1 with weights 0, 1/2, 1, 1/2 (the first
// two from ix = 1 on, the last up to ix = W - 2), from 0 in ascending
// order as the band kernel adds them.  The weight-1 product is v[2] itself
// (a NaN's bits end canonical at the bf16 rounding either way).
__device__ __forceinline__ float wsum_2x(const float (&v)[4], bool left, bool right) {
  float s = 0.0f;
  if (left) {
    s = __fadd_rn(s, __fmul_rn(0.0f, v[0]));
    s = __fadd_rn(s, __fmul_rn(0.5f, v[1]));
  }
  s = __fadd_rn(s, v[2]);
  if (right) s = __fadd_rn(s, __fmul_rn(0.5f, v[3]));
  return s;
}

// A-bwd's bf16 wide branch at an exact 2x upsample (the adjoint of
// resize_bilinear_ac_wide2x_kernel; the decoder's (8, 256, 129²) -> 65² at
// VOC, (4, 256, 193²) -> 97² at Cityscapes).  Input index i is reached by
// output indices 2i - 2 .. 2i + 1 with the tap tables' weights 0, 1/2, 1,
// 1/2 (clamped at the edges: 1, 1/2 at i = 0; 0, 1/2, 1 at the last), on
// both axes.  A thread takes input column ix of R consecutive input rows
// iy0 .. iy0 + R - 1 of a plane: it loads the 4 x (2R + 2) gy values that
// reach them (all issued before the first is used; the lanes of a warp, on
// consecutive ix, read one stretch of each output row), forms the 2R + 2 W
// sums (each rounded to bf16; a sum serves two input rows) and each input
// row's H sum over ascending output rows, rounded to bf16 once.  No table,
// no shared memory, no barrier; the band kernel's products and sums (the
// zero-weight ones included), so its bits, inf and NaN too.  R = 1: 0.0743
// ms at VOC, 0.0818 at Cityscapes (the bf16 band kernel 0.0960 / 0.1328;
// bytes bound 0.0255 / 0.0285) on an NVIDIA H100 80GB HBM3 at 700 W
// (timing_ab.py).  The gy loads' latency holds it (each value is read by
// four threads): 2 or 4 rows a thread were slower, and aligned word loads
// with shuffles (a quarter of the load instructions) or 2 planes a thread
// were no faster (PERF.md).
template <int R>
__global__ void __launch_bounds__(kThreads) resize_bilinear_ac_bwd_wide2x_kernel(
    const __nv_bfloat16* __restrict__ gy, __nv_bfloat16* __restrict__ gx, unsigned planes,
    int H, int W, int groups, float inv_w) {
  const int t = blockIdx.x * kThreads + threadIdx.x;  // group * W + ix
  if (t >= groups * W) return;
  const int k = div_small(t, W, inv_w), ix = t - k * W;
  const int iy0 = k * R, OH = 2 * H - 1, OW = 2 * W - 1;
  const bool left = ix > 0, right = ix + 1 < W;
  const unsigned in_plane = (unsigned)H * W, out_plane = (unsigned)OH * OW;
  for (unsigned plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    // output rows 2 iy0 - 2 + u, u < 2R + 2, columns 2ix - 2 .. 2ix + 1
    const __nv_bfloat16* g = gy + plane * out_plane + 2 * ix;
    float v[2 * R + 2][4];
#pragma unroll
    for (int u = 0; u < 2 * R + 2; ++u) {
      const int oy = 2 * iy0 - 2 + u;
      const bool row = oy >= 0 && oy < OH;
      const __nv_bfloat16* p = g + (row ? oy : 0) * OW;
      v[u][0] = row && left ? to_f32(p[-2]) : 0.0f;
      v[u][1] = row && left ? to_f32(p[-1]) : 0.0f;
      v[u][2] = row ? to_f32(p[0]) : 0.0f;
      v[u][3] = row && right ? to_f32(p[1]) : 0.0f;
    }
    float s[2 * R + 2];
#pragma unroll
    for (int u = 0; u < 2 * R + 2; ++u) s[u] = round_bf16(wsum_2x(v[u], left, right));
    __nv_bfloat16* out = gx + plane * in_plane + ix;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int iy = iy0 + r;
      if (iy >= H) break;
      float a = 0.0f;  // output rows 2iy - 2 .. 2iy + 1: s[2r .. 2r + 3]
      if (iy > 0) {
        a = __fadd_rn(a, __fmul_rn(0.0f, s[2 * r]));
        a = __fadd_rn(a, __fmul_rn(0.5f, s[2 * r + 1]));
      }
      a = __fadd_rn(a, s[2 * r + 2]);
      if (iy + 1 < H) a = __fadd_rn(a, __fmul_rn(0.5f, s[2 * r + 3]));
      out[iy * W] = __float2bfloat16_rn(a);
    }
  }
}

struct ResizeArgs {
  const void* x;  // A: x, A-bwd: gy
  void* y;        // A: y, A-bwd: gx
  const int4* taps_h;  // A's direct kernel: the packed taps
  const int4* taps_w;
  const int* idx_h;
  const float* w_h;
  const int* rng_h;
  const int* idx_w;
  const float* w_w;
  const int* rng_w;
  int H, W, OH, OW;
};

// A's kernels (ops/resize.py: FWD_BAND, FWD_DIRECT, FWD_WIDE_2X)
enum { kFwdBand = 0, kFwdDirect = 1, kFwdWide2x = 2 };

template <typename T, typename O, bool WIDE>
cudaError_t launch_fwd(const ResizeArgs& a, unsigned planes, int kind, int rows, int bands,
                       cudaStream_t stream) {
  if constexpr (WIDE) {
    if (kind == kFwdWide2x) {  // a thread per input element
      const dim3 grid((a.H * a.W + kThreads - 1) / kThreads, min(planes, 65535u));
      resize_bilinear_ac_wide2x_kernel<<<grid, kThreads, 0, stream>>>(
          (const T*)a.x, (O*)a.y, planes, a.H, a.W, 1.0f / (float)a.W);
      return cudaGetLastError();
    }
  }
  if (kind == kFwdDirect) {  // a thread per output pixel
    const unsigned area = (unsigned)a.OH * (unsigned)a.OW;
    resize_bilinear_ac_direct_kernel<T, O, WIDE>
        <<<(area + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            (const T*)a.x, (O*)a.y, a.taps_h, a.taps_w, (int)planes, a.H, a.W, a.OH, a.OW);
    return cudaGetLastError();
  }
  const int quarter = (a.OW + 3) / 4;
  const int smem = quarter * 64 + rows * a.W * 4;
  const unsigned blocks = planes * (unsigned)bands;
  auto kernel = resize_bilinear_ac_kernel<T, O, WIDE>;
  if (smem > 48 * 1024) {  // above the default dynamic shared memory of a block
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>((const T*)a.x, (O*)a.y, a.idx_h, a.w_h, a.idx_w,
                                             a.w_w, a.H, a.W, a.OH, a.OW, rows, bands,
                                             quarter, 1.0f / (float)a.OW);
  return cudaGetLastError();
}

template <int MAXW, typename T, bool WIDE>
cudaError_t launch_bwd(const ResizeArgs& a, unsigned threads, int rows, int bands,
                       cudaStream_t stream) {
  resize_bilinear_ac_bwd_kernel<MAXW, T, WIDE>
      <<<(threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          (const T*)a.x, (T*)a.y, a.idx_h, a.w_h, a.rng_h, a.idx_w, a.w_w, a.rng_w, threads,
          a.H, a.W, a.OH, a.OW, rows, bands);
  return cudaGetLastError();
}

template <typename T, bool WIDE>
cudaError_t launch_bwd_span(const ResizeArgs& a, unsigned threads, int rows, int bands,
                            int wspan, cudaStream_t stream) {
  if (wspan <= 4) {  // every downsample, an upsample of up to about 2x
    return launch_bwd<4, T, WIDE>(a, threads, rows, bands, stream);
  }
  return launch_bwd<0, T, WIDE>(a, threads, rows, bands, stream);
}

// A-bwd's kernels (ops/resize.py: BWD_BAND, BWD_WIDE_2X)
enum { kBwdBand = 0, kBwdWide2x = 1 };

// the 2x adjoint: a thread per input column of `rows` input rows (bands of
// them: ceil(H / rows)), for every plane
template <int R>
cudaError_t launch_bwd_2x(const ResizeArgs& a, unsigned planes, int bands, cudaStream_t stream) {
  const dim3 grid((bands * a.W + kThreads - 1) / kThreads, min(planes, 65535u));
  resize_bilinear_ac_bwd_wide2x_kernel<R><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)a.x, (__nv_bfloat16*)a.y, planes, a.H, a.W, bands,
      1.0f / (float)a.W);
  return cudaGetLastError();
}

// T: the logits' element type (float, or __nv_bfloat16 widened on load)
template <typename T>
__global__ void resize_argmax_ac_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ out,
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

// the modes of A and A-bwd (ops/resize.py:_resize_mode): f32, the bf16
// narrow branch, the bf16 wide branch, and (A only) bf16 in, f32 out
enum { kModeF32 = 0, kModeBf16 = 1, kModeBf16Wide = 2, kModeBf16F32 = 3 };

// (kernel, rows, bands) from ops/resize.py:_fwd_plan: kFwdBand, bands of
// `rows` output rows of a plane, a block each, staging the tables idx_h /
// w_h / idx_w / w_w; kFwdDirect, which reads the packed tables taps_h /
// taps_w; kFwdWide2x, the bf16 wide branch's exact 2x upsample (align
// corners, n -> 2n - 1 on both axes), which reads no table
int u2pl_resize_bilinear_ac(const void* x, void* y, const void* idx_h,
                            const void* w_h, const void* idx_w, const void* w_w,
                            const void* taps_h, const void* taps_w, int planes, int H,
                            int W, int OH, int OW, int kernel, int rows, int bands, int mode,
                            void* stream) {
  if (mode < kModeF32 || mode > kModeBf16F32) return (int)cudaErrorInvalidValue;
  if (planes <= 0 || OH <= 0 || OW <= 0) return (int)cudaGetLastError();
  const int quarter = (OW + 3) / 4;
  if (H <= 0 || W <= 0 || (long long)planes * OH * OW >= (1LL << 31) ||
      (kernel == kFwdDirect && (taps_h == nullptr || taps_w == nullptr)) ||
      (kernel == kFwdWide2x && !(mode == kModeBf16Wide && H >= 2 && W >= 2 &&
                                 OH == 2 * H - 1 && OW == 2 * W - 1 &&
                                 (long long)H * W < (1 << 24))) ||
      (kernel == kFwdBand &&
       (rows <= 0 || bands != (OH + rows - 1) / rows ||
        (long long)quarter * 64 + (long long)rows * W * 4 > kResizeMaxShared)) ||
      kernel < kFwdBand || kernel > kFwdWide2x) {
    return (int)cudaErrorInvalidValue;
  }
  const ResizeArgs a = {x, y, (const int4*)taps_h, (const int4*)taps_w, (const int*)idx_h,
                        (const float*)w_h, nullptr, (const int*)idx_w, (const float*)w_w,
                        nullptr, H, W, OH, OW};
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (mode == kModeBf16Wide) {
    return (int)launch_fwd<bf16, bf16, true>(a, planes, kernel, rows, bands, st);
  }
  if (mode == kModeBf16) {
    return (int)launch_fwd<bf16, bf16, false>(a, planes, kernel, rows, bands, st);
  }
  if (mode == kModeBf16F32) {
    return (int)launch_fwd<bf16, float, false>(a, planes, kernel, rows, bands, st);
  }
  return (int)launch_fwd<float, float, false>(a, planes, kernel, rows, bands, st);
}

// (kernel, rows, bands, wspan) from ops/resize.py:_bwd_plan: kBwdBand,
// bands of `rows` input rows, at most wspan output columns reaching one
// input column, from the tables idx / w / rng; kBwdWide2x, the bf16 wide
// branch's exact 2x adjoint (align corners, n -> 2n - 1 on both axes), a
// thread per input column of `rows` (1, 2 or 4) input rows, no table
int u2pl_resize_bilinear_ac_bwd(const void* gy, void* gx, const void* idx_h,
                                const void* w_h, const void* rng_h,
                                const void* idx_w, const void* w_w,
                                const void* rng_w, int planes, int H, int W,
                                int OH, int OW, int kernel, int rows, int bands, int wspan,
                                int mode, void* stream) {
  if (mode < kModeF32 || mode > kModeBf16Wide) return (int)cudaErrorInvalidValue;
  if (planes <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  const long long threads = (long long)planes * bands * W;
  if (OH <= 0 || OW <= 0 || rows <= 0 || bands != (H + rows - 1) / rows || wspan <= 0 ||
      threads >= (1LL << 31) || kernel < kBwdBand || kernel > kBwdWide2x ||
      (kernel == kBwdWide2x &&
       !(mode == kModeBf16Wide && H >= 2 && W >= 2 && OH == 2 * H - 1 && OW == 2 * W - 1 &&
         (rows == 1 || rows == 2 || rows == 4) && (long long)bands * W < (1 << 24)))) {
    return (int)cudaErrorInvalidValue;
  }
  const ResizeArgs a = {gy, gx, nullptr, nullptr, (const int*)idx_h, (const float*)w_h,
                        (const int*)rng_h, (const int*)idx_w, (const float*)w_w,
                        (const int*)rng_w, H, W, OH, OW};
  cudaStream_t st = (cudaStream_t)stream;
  if (kernel == kBwdWide2x) {
    const unsigned p = (unsigned)planes;
    if (rows == 1) return (int)launch_bwd_2x<1>(a, p, bands, st);
    if (rows == 2) return (int)launch_bwd_2x<2>(a, p, bands, st);
    return (int)launch_bwd_2x<4>(a, p, bands, st);
  }
  const unsigned n = (unsigned)threads;
  if (mode == kModeBf16Wide) {
    return (int)launch_bwd_span<__nv_bfloat16, true>(a, n, rows, bands, wspan, st);
  }
  if (mode == kModeBf16) {
    return (int)launch_bwd_span<__nv_bfloat16, false>(a, n, rows, bands, wspan, st);
  }
  return (int)launch_bwd_span<float, false>(a, n, rows, bands, wspan, st);
}

// dtype: 0 float32 logits, 1 bfloat16 (widened on load)
int u2pl_resize_argmax_ac(const void* x, void* out, const void* idx_h,
                          const void* w_h, const void* idx_w, const void* w_w,
                          int C, int H, int W, int OH, int OW, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)OH * OW;
  if (total > 0) {
    const int blocks = blocks_for(total);
    cudaStream_t st = (cudaStream_t)stream;
    const int* ih = (const int*)idx_h;
    const int* iw = (const int*)idx_w;
    const float* wh = (const float*)w_h;
    const float* ww = (const float*)w_w;
    if (dtype == 1) {
      resize_argmax_ac_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          (const __nv_bfloat16*)x, (uint8_t*)out, ih, wh, iw, ww, C, H, W, OH, OW);
    } else {
      resize_argmax_ac_kernel<float><<<blocks, kThreads, 0, st>>>(
          (const float*)x, (uint8_t*)out, ih, wh, iw, ww, C, H, W, OH, OW);
    }
  }
  return (int)cudaGetLastError();
}

const char* u2pl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

"""The host-side launch plans of kernel A (`ops/resize.py:_fwd_plan`: the
band plan at many planes, the direct kernel at few, within shared memory)
and K6 bwd (`losses/contrastive.py:_infonce_bwd_tile`, its chunk table and
stores walked as the kernel makes them: every element once), of kernel
A-bwd (`ops/resize.py:_bwd_plan`), of kernels C fwd, D and K7 prob
(`losses/ce.py:_stats_plan`; the bf16 ring, `_stats_ring`: its steps walked,
every pixel once, every row's input rows staged), of K6 fwd
(`losses/contrastive.py:_infonce_group`: a bf16 bank's chunks of 32 keys
by the copy engine, the transposed reduction bit-equal to the butterfly), K5 (`memobank.py:
_enqueue_tile`), the radix descent of E and K7 kth (`ops/quantile.py:
_descent_plan`) and K4's masks and anchor draws (`losses/contrastive.py:
_masks_plan`, `_anchors_plan`), on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); what they are
given is computed here in Python, so these tests hold the plans to what the
kernels assume: every input row's output range inside the rows its band
walks, every C fwd / D block within shared memory, at the main path's
shapes and every card test's shape, for several SM counts; K6 fwd's key
groups within their registers, each key fetched before it is reduced and
reduced once in key order; K5's tiles writing every row once; the
descent's blocks holding every value once, within shared memory; K4
masks' threads taking every pixel once with aligned stores; K4 anchors'
blocks and warps reading every word of a row once, aligned, and the draws
served from their prefixes as the plain version serves them; K4r's blocks
owning every pixel once, as many chunks held as shared memory takes, no
row refused; K3c's blocks taking every pixel once, co-resident, within
shared memory.
"""

import numpy as np
import pytest
import torch

from u2pl_tpu_torch import memobank as mb
from u2pl_tpu_torch.losses import ce
from u2pl_tpu_torch.losses import contrastive as tc
from u2pl_tpu_torch.ops import mixing as tm
from u2pl_tpu_torch.ops import quantile as tq
from u2pl_tpu_torch.ops import resize as tr
from u2pl_tpu_torch.ops.resize import _interp_matrix_np, _ranges_np

def _bands(h, oh, rows):
    """Per band of `rows` input rows: (first input row, end, first output
    row, end), the output rows A-bwd walks for the band, read from the
    range table as the kernel reads it (resize.cu: rng_h[iy0] ..
    rng_h[H + iy1 - 1])."""
    start, end = _ranges_np(h, oh, True)
    return [(iy0, min(iy0 + rows, h), int(start[iy0]), int(end[min(iy0 + rows, h) - 1]))
            for iy0 in range(0, h, rows)]


# A-bwd as (planes, h, w, oh, ow): the decoder's adjoint at VOC (8 x 256
# planes, os4 129² -> os8 65²) and Cityscapes (4 x 256, 193² -> 97²), and
# tests/test_torch_cuda.py's shapes (scale 4 and 8, a downsample, H or W of
# 1, band edges)
A_BWD_SHAPES = [
    (2048, 65, 65, 129, 129),
    (1024, 97, 97, 193, 193),
    (16, 65, 65, 129, 129),
    (10, 129, 129, 513, 513),
    (6, 13, 13, 97, 97),
    (6, 33, 17, 7, 9),
    (6, 1, 5, 4, 10),
    (6, 5, 1, 10, 4),
    (6, 7, 9, 33, 17),
    (24, 37, 37, 145, 145),
]


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("planes,h,w,oh,ow", A_BWD_SHAPES)
def test_a_bwd_bands_cover_every_input_rows_outputs(planes, h, w, oh, ow, sms):
    kernel, rows, bands, wspan = tr._bwd_plan(planes, h, w, oh, ow, sms)
    assert kernel == tr.BWD_BAND
    start_w, end_w = _ranges_np(w, ow, True)
    assert wspan == max((end_w - start_w).max(), 1)
    target = sms * tr.BWD_THREADS_PER_SM  # threads: enough, with the tallest bands that give it
    assert planes * bands * w >= target or rows == 1
    assert rows == h or planes * -(-h // (rows + 1)) * w < target
    windows = _bands(h, oh, rows)
    assert len(windows) == bands == -(-h // rows)
    assert [iy for iy0, iy1, _, _ in windows for iy in range(iy0, iy1)] == list(range(h))
    dense = _interp_matrix_np(h, oh, True)  # (oh, h)
    start_h, end_h = _ranges_np(h, oh, True)
    walked = set()
    for iy0, iy1, ob, oe in windows:
        walked.update(range(ob, oe))
        for iy in range(iy0, iy1):
            reach = np.nonzero(dense[:, iy])[0]
            assert ((reach >= ob) & (reach < oe)).all()
            assert ob <= start_h[iy] and end_h[iy] <= oe
    # every output row that reaches an input row is walked by some band
    assert set(np.nonzero(dense.any(axis=1))[0]) <= walked


@pytest.mark.parametrize("planes,h,w,oh,ow", [(2048, 65, 65, 129, 129), (1024, 97, 97, 193, 193)])
def test_a_bwd_plan_takes_whole_planes_at_the_decoders_shapes(planes, h, w, oh, ow):
    assert tr._bwd_plan(planes, h, w, oh, ow, 132) == (tr.BWD_BAND, h, 1, 4)


# C fwd and D as (B, C, h, w, OH, OW): the VOC CE (and D), the Cityscapes
# main / unsup and aux heads, and tests/test_torch_cuda.py's shapes
STATS_SHAPES = [
    (4, 21, 129, 129, 513, 513),
    (2, 19, 193, 193, 769, 769),
    (2, 19, 97, 97, 769, 769),
    (2, 21, 33, 33, 129, 129),
    (2, 19, 25, 25, 97, 97),
    (3, 27, 9, 7, 33, 25),
    (2, 40, 9, 9, 33, 33),
    (3, 5, 9, 7, 33, 25),
    (2, 3, 13, 13, 97, 97),
    (1, 64, 300, 300, 1200, 1200),
]


@pytest.mark.parametrize("b,c,h,w,oh,ow", STATS_SHAPES)
def test_stats_plan_fits_every_row_a_block_touches(b, c, h, w, oh, ow):
    span, max_rows, smem = ce._stats_plan(b, c, w, oh, ow)
    assert span % 4 == 0 and smem <= ce.STATS_MAX_SHARED
    assert smem == 64 * -(-ow // 4) + max_rows * (4 * c * w + 16)
    total = b * oh * ow
    k0 = np.arange(0, total, span)
    touched = (np.minimum(k0 + span, total) - 1) // ow - k0 // ow + 1
    assert touched.max() <= max_rows
    if ow <= 769 and c * w <= 19 * 193:  # the main path's shapes: 1024 pixels per block
        assert span == ce.STATS_SPAN


def test_stats_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="64 classes at widths 1000"):
        ce._stats_plan(1, 64, 1000, 4000, 4000)


# an SM of the H100 (sm_90): shared memory (228 KB), what each block
# reserves of it, threads
SM_SHARED, BLOCK_RESERVED, SM_THREADS = 233472, 1024, 2048


def _ring_walk(b, c, h, w, oh, ow, sms, grid):
    """The bf16 stats kernel's ring (upsample_ce.cu: stats_ring_kernel) as
    it runs on `grid` blocks: per block its spans [p0, p1) in steps of
    `spans` (the last may hold fewer), per step the
    output rows it touches, its image groups' copies (byte base, bytes, the
    run's first element and length, its shift in the first 16-byte block)
    as `issue` lays them out, and per row the raw elements it reads;
    returns (pixels taken per flat pixel, spans written per span, the most
    rows and raw bytes of a step, every row read inside its group's run and
    T's rows on distinct slots of its ring)."""
    span, _, _ = ce._stats_plan(b, c, w, oh, ow)
    ring = ce._stats_ring(b, c, h, w, oh, ow, sms)
    lo, hi, _ = tr._interp_taps_np(h, oh, True)
    total = b * oh * ow
    nparts = -(-total // span)
    taken = np.zeros(total, dtype=np.int64)
    parts = np.zeros(nparts, dtype=np.int64)
    most_rows = most_raw = 0
    inside = True
    for blk in range(grid):
        p0, p1 = blk * nparts // grid, (blk + 1) * nparts // grid
        done = -1  # T's ring holds the rows up to `done` (the step before's)
        for p in range(p0, p1, ring.spans):  # the block's spans, a step at a time
            k0, k1 = p * span, min(min(p + ring.spans, p1) * span, total)
            ra, rb = k0 // ow, (k1 - 1) // ow
            most_rows = max(most_rows, rb - ra + 1)
            # the step's rows on distinct slots of T's ring, the row it
            # shares with the step before kept where that step wrote it
            inside &= len({r % ring.rows for r in range(ra, rb + 1)}) == rb - ra + 1
            inside &= done < ra or done == ra  # consecutive steps share a row at most
            done = rb
            groups, base = {}, 0
            for img in range(ra // oh, rb // oh + 1):
                oy0, oy1 = max(ra - img * oh, 0), min(rb - img * oh, oh - 1)
                i0, n_el = int(lo[oy0]), int(hi[oy1] - lo[oy0] + 1) * w
                stride = 2 * ((n_el + 14) & ~7)
                for cls in range(c):
                    e = (img * c + cls) * h * w + i0 * w
                    nbytes = 2 * ((e % 8 + n_el + 7) & ~7)
                    inside &= nbytes <= stride and (base + cls * stride) % 16 == 0
                groups[img] = (i0, n_el)
                base += c * stride
            most_raw = max(most_raw, base)
            for r in range(ra, rb + 1):
                i0, n_el = groups[r // oh]
                oy = r % oh
                inside &= i0 * w <= lo[oy] * w and (hi[oy] + 1) * w <= i0 * w + n_el
            for s_ in range(ring.spans):  # each span's threads: 4 pixels each
                ks = k0 + s_ * span
                if ks < k1:
                    parts[p + s_] += 1
                    taken[ks:min(ks + span, k1)] += 1
    return taken, parts, most_rows, most_raw, inside


# the ring at STATS_SHAPES' bf16-capable shapes, planned for several SM
# counts, on grids of one block to the kernel's (min(SMs x blocks an SM,
# steps): one block an SM or two)
@pytest.mark.parametrize("sms,per_sm", [(132, 1), (132, 2), (114, 1), (16, 1), (1, 1)])
@pytest.mark.parametrize("b,c,h,w,oh,ow", STATS_SHAPES[:-1])
def test_stats_ring_steps_take_every_pixel_once_within_shared_memory(b, c, h, w, oh, ow, sms,
                                                                     per_sm):
    ring = ce._stats_ring(b, c, h, w, oh, ow, sms)
    span = ce._stats_plan(b, c, w, oh, ow)[0]
    nparts = -(-(b * oh * ow) // span)
    steps = -(-nparts // ring.spans)
    taken, parts, rows, raw, inside = _ring_walk(b, c, h, w, oh, ow, sms,
                                                 min(sms * per_sm, steps))
    assert (taken == 1).all() and (parts == 1).all()  # every pixel, every span's sums once
    assert rows <= ring.rows and raw <= ring.raw_bytes and ring.raw_bytes % 16 == 0
    # each row's lo and hi input rows staged, copies 16-byte aligned, T's
    # rows on distinct slots
    assert inside
    assert ring.smem == ce._ring_bytes(c, w, ow, ring.rows, ring.raw_bytes)
    assert ring.smem <= ce.STATS_MAX_SHARED and ring.rows * c * w < 2**24
    per_sm = min(SM_SHARED // (ring.smem + BLOCK_RESERVED),
                 SM_THREADS // (256 * ring.spans))
    assert per_sm >= 1  # co-resident: at least one block an SM
    # the spans: a block's ceil(nparts / sms) spans in steps with the fewest
    # idle span slots (the main path on 132 SMs: VOC 8 spans a block in 2
    # steps of 4, Cityscapes 9 in 3 of 3)
    per_block = -(-nparts // sms)
    assert -(-per_block // ring.spans) * ring.spans == min(
        -(-per_block // k) * k for k in range(1, ce.STATS_RING_MAX_SPANS + 1)
        if ce._ring_bytes(c, w, ow, min(span * k // ow + 2, b * oh), ce._ring_raw_bytes(
            b, c, h, w, oh, ow, span, span * k)) <= ce.STATS_MAX_SHARED)
    if sms == 132 and (b, c, w, ow) == (4, 21, 129, 513):
        assert ring.spans == 4
    if sms == 132 and (b, c, ow) == (2, 19, 769):
        assert ring.spans == 3
    assert ce._stats_launch(b, c, h, w, oh, ow, torch.bfloat16, sms) == (
        span, ring.rows, ring.spans, ring.raw_bytes)
    assert ce._stats_launch(b, c, h, w, oh, ow, torch.float32, sms)[2:] == (0, 0)


def test_stats_ring_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="bf16 kernel"):
        ce._stats_ring(1, 64, 300, 300, 1200, 1200, 132)


# ---- K6 fwd (losses/contrastive.py:_infonce_group) and K5
# (memobank.py:_enqueue_tile): the kernels' loops, walked here in Python

def _infonce_key_schedule(m, g):
    """The order in which K6 fwd's draw loop (infonce.cu:infonce_draw) fetches
    and reduces its M keys in groups of g: a list of ("rows", chunk),
    ("fetch", key) and ("reduce", key) events; rows of a chunk of 32 keys are
    computed when the first group of the chunk is fetched."""
    events = []

    def fetch(g0):
        if g0 % 32 == 0:
            events.append(("rows", g0 // 32))
        events.extend(("fetch", k) for k in range(g0, min(g0 + g, m)))

    if m > 0:
        fetch(0)
    for g0 in range(0, m, g):
        if g0 + g < m:
            fetch(g0 + g)
        events.extend(("reduce", k) for k in range(g0, min(g0 + g, m)))
    return events


def _infonce_copy_schedule(m):
    """K6 fwd's draw on a bf16 bank (infonce.cu:infonce_draw_copy): per
    chunk of 32 keys ("copy", c0, nk, expected bytes) with lane k's row
    into slot k, ("wait", c0), then ("update", key, slot) in key order; the
    next chunk's copies once the slots are read."""
    events = []
    for c0 in range(0, m, tc.INFONCE_CHUNK):
        nk = min(tc.INFONCE_CHUNK, m - c0)
        events.append(("copy", c0, nk, nk * tc.INFONCE_ROW_BYTES))
        events.append(("wait", c0))
        events.extend(("update", c0 + k, k) for k in range(nk))
    return events


def _transposed_sums(v):
    """The kernel's transposed reduction (infonce.cu:infonce_draw_copy: the
    first level at offset 16, keys i and i + 16 kept by the lanes of the
    lower and upper half, then `halve` at 8, 4, 2, 1) of v[lane, key],
    (32, 32) float32 partials: what each lane holds at the end (its t[0])."""
    lanes = np.arange(32)
    upper = (lanes & 16) != 0
    keep = np.where(upper[:, None], v[:, 16:], v[:, :16])
    send = np.where(upper[:, None], v[:, :16], v[:, 16:])
    t = (keep + send[lanes ^ 16]).astype(np.float32)
    for o in (8, 4, 2, 1):
        n = t.shape[1] // 2
        up = ((lanes & o) != 0)[:, None]
        keep, send = np.where(up, t[:, n:], t[:, :n]), np.where(up, t[:, :n], t[:, n:])
        t = (keep + send[lanes ^ o]).astype(np.float32)
    return t[:, 0]


def _butterfly_sums(v):
    """warp_sum2's xor butterfly (offsets 16 .. 1) of each key's 32 lane
    partials, as lane 0 ends with it (every lane holds the same bits)."""
    lanes = np.arange(32)
    t = v.copy()
    for o in (16, 8, 4, 2, 1):
        t = (t + t[lanes ^ o]).astype(np.float32)
    return t[0]


@pytest.mark.parametrize("m", [0, 1, 7, 31, 32, 33, 50, 63, 64, 65, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_infonce_groups_fit_their_registers_and_reduce_every_key_in_order(m, dtype):
    g = tc._infonce_group(dtype)
    assert g == {torch.bfloat16: tc.INFONCE_CHUNK, torch.float32: 2}[dtype]  # the kernel's
    if dtype == torch.float32:  # rows in registers, two groups in flight
        assert 2 * g * 8 <= tc.INFONCE_ROW_REGS and 32 % g == 0
        events = _infonce_key_schedule(m, g)
        fetched = [k for e, k in events if e == "fetch"]
        reduced = [k for e, k in events if e == "reduce"]
        assert fetched == list(range(m)) and reduced == list(range(m))  # once each, in order
        chunks = [k for e, k in events if e == "rows"]
        assert chunks == list(range(-(-m // 32)))
        in_flight, seen_rows, most = set(), set(), 0
        for e, k in events:
            if e == "rows":
                seen_rows.add(k)
            elif e == "fetch":
                assert k // 32 in seen_rows  # its row was computed first
                in_flight.add(k)
                most = max(most, len(in_flight))
            else:
                assert k in in_flight  # fetched before it is reduced
                in_flight.remove(k)
        assert most <= 2 * g and (m <= g or most > g)  # two groups in flight
        return
    # a bf16 bank: 32 rows of shared memory a warp, by the copy engine
    events = _infonce_copy_schedule(m)
    landed, updated, slots = set(), [], {}
    for ev in events:
        if ev[0] == "copy":
            _, c0, nk, nbytes = ev
            assert 1 <= nk <= g and nbytes == nk * 512  # what the mbarrier expects
            slots = {c0 + k: k for k in range(nk)}  # lane k's row into slot k
            pending = set(slots)
        elif ev[0] == "wait":
            landed |= pending
        else:
            _, key, slot = ev
            assert key in landed and slots[key] == slot < g  # copied before it is used
            updated.append(key)
    assert updated == list(range(m))  # every key once, in key order (M = 0: none)
    smem = tc._infonce_copy_bytes()
    assert smem == tc.INFONCE_COPY_WARPS * (g * 512 + 16)
    assert tc.INFONCE_COPY_BLOCKS_PER_SM * (smem + BLOCK_RESERVED) <= SM_SHARED
    # the kernel's 128 registers a thread (its build log), two blocks an SM
    assert tc.INFONCE_COPY_BLOCKS_PER_SM * tc.INFONCE_COPY_WARPS * 32 * 128 <= 65536


@pytest.mark.parametrize("seed", range(4))
def test_infonce_transposed_reduction_is_the_butterflys_bits(seed):
    """Lane k of the transposed reduction holds key k's sums with
    warp_sum2's bits: the same pairs at each level (float addition
    commutes)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((32, 32)) * 10.0 ** rng.integers(-3, 4, (32, 32))).astype(np.float32)
    assert np.array_equal(_transposed_sums(v).view(np.int32), _butterfly_sums(v).view(np.int32))


TILE_ROWS = 1024  # memobank.cu: kMaxTileRows, the rows a tile lists


def _enqueue_rows(n_sel, ptr, sizes, k, pixels, tile, sel):
    """The (class, rank, ring row) K5 writes (memobank.cu:mb_enqueue_kernel),
    by tile: the written ranks (each class's newest min(n_new, size)) whose
    pixel lies in the tile, the first TILE_ROWS listed, the rest written by
    the thread that found them; and how many tiles overflowed."""
    n_new = np.minimum(n_sel, k)
    written, overflowed = [], 0
    for t0 in range(0, pixels, tile):
        listed = 0
        for c in range(len(n_sel)):
            for r in range(max(n_new[c] - sizes[c], 0), n_new[c]):
                if t0 <= sel[c, r] < min(t0 + tile, pixels):
                    listed += 1
                    written.append((c, r, int((ptr[c] + r) % sizes[c])))
        overflowed += listed > TILE_ROWS
    return written, overflowed


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("case", ["flagship", "wrap", "over_size", "one_class", "empty"])
def test_enqueue_tiles_write_every_row_once(case, sms):
    rng = np.random.RandomState(3)
    c, k, pixels = (21, 8192, 8 * 129 * 129) if case in ("flagship", "one_class") else (5, 40, 90)
    sizes = np.full(c, 50000 if c == 21 else 12)
    ptr = rng.randint(0, sizes)
    sel = np.stack([rng.permutation(pixels)[:k] if k <= pixels else rng.randint(0, pixels, k)
                    for _ in range(c)])
    n_sel = {"flagship": rng.randint(0, 2000, c),
             "wrap": np.array([12, 7, 0, 11, 3]),  # rings wrap from a random ptr
             "over_size": np.array([40, 13, 25, 0, 12]),  # more than the ring holds
             "one_class": np.eye(c, dtype=int)[3] * k,  # 8192 rows of one class
             "empty": np.zeros(c, dtype=int)}[case]
    tile = mb._enqueue_tile(pixels, sms)
    tiles = -(-pixels // tile)
    assert tiles <= mb.ENQUEUE_TILES_PER_SM * sms and (tiles - 1) * tile < pixels
    got, overflowed = _enqueue_rows(n_sel, ptr, sizes, k, pixels, tile, sel)
    n_new = np.minimum(n_sel, k)
    want = sorted((j, r, int((ptr[j] + r) % sizes[j])) for j in range(c)
                  for r in range(max(n_new[j] - sizes[j], 0), n_new[j]))
    assert sorted(got) == want and len(got) == len(set(got))
    assert len({(j, row) for j, _, row in got}) == len(got)  # a ring row at most once
    if case == "one_class" and sms == 1:
        assert overflowed  # the rows past a tile's list are written too


def _gather_writes(n_sel, k, pixels, tile, sel, chunks=32):
    """The (class, rank) slab rows K5's gather writes (memobank.cu:
    mb_gather_kernel), by tile: the rows below min(n_sel, K) whose pixel
    lies in the tile, the first TILE_ROWS listed and written by the block's
    (row, chunk) items (item i: listed row i % n, chunk i // n; each row
    whole only if every chunk is taken once), the rest by the thread that
    found them; and how many tiles overflowed."""
    n_new = np.minimum(n_sel, k)
    live = np.arange(sel.shape[1])[None, :] < n_new[:, None]
    written, overflowed = [], 0
    for t0 in range(0, pixels, tile):
        cs, rs = np.nonzero(live & (sel >= t0) & (sel < min(t0 + tile, pixels)))
        n = min(len(cs), TILE_ROWS)
        items = np.arange(n * chunks)
        taken = np.zeros((n, chunks), dtype=int)
        np.add.at(taken, (items % n, items // n), 1)
        assert (taken == 1).all()
        written += list(zip(cs.tolist(), rs.tolist()))  # the listed ones, then the rest
        overflowed += int(len(cs) > TILE_ROWS)
    return written, overflowed


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("case", ["flagship", "dense", "shared", "over_k", "empty"])
def test_gather_tiles_write_every_row_once(case, sms):
    """K5's gather in pixel order: its tiles and lists write every slab row
    below min(n_sel, K) exactly once and no row past it, at the
    flagship's selection counts, a tile denser than its list, a pixel
    selected by several classes, n_sel > K and all classes empty."""
    rng = np.random.RandomState(4)
    c, k, pixels = (21, 8192, 8 * 129 * 129) if case in ("flagship", "dense") else (5, 40, 90)
    sel = np.stack([rng.permutation(pixels)[:k] if k <= pixels else rng.randint(0, pixels, k)
                    for _ in range(c)])
    n_sel = {"flagship": np.array([8192, 475, 494, 479, 489, 510, 493, 507, 477, 473, 488, 484,
                                   500, 459, 512, 530, 514, 512, 506, 469, 488]),
             "dense": np.full(c, 2048),  # every row in the first 300 pixels
             "shared": np.array([40, 13, 25, 0, 12]),  # every class the same pixels
             "over_k": np.array([52, 40, 41, 7, 100]),
             "empty": np.zeros(c, dtype=int)}[case]
    if case == "dense":
        sel = rng.randint(0, 300, (c, k))
    if case == "shared":
        sel[:] = sel[0]
    tile = mb._gather_tile(pixels, sms)
    tiles = -(-pixels // tile)
    assert 1 <= tile <= mb.GATHER_MAX_TILE
    assert tiles <= mb.GATHER_TILES_PER_SM * sms or tile == mb.GATHER_MAX_TILE
    assert (tiles - 1) * tile < pixels
    got, overflowed = _gather_writes(n_sel, k, pixels, tile, sel)
    n_new = np.minimum(n_sel, k)
    want = [(j, r) for j in range(c) for r in range(n_new[j])]
    assert sorted(got) == want and len(got) == len(set(got))
    if case == "dense":
        assert overflowed  # the rows past a tile's list are written too


# ---- the radix descent of E and K7 kth (ops/quantile.py:_descent_plan):
# the values of VOC's and Cityscapes' maps, one value, fewer values than
# blocks, a batch-8 Cityscapes map, and one past the grid's shared memory

@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("n", [1_052_676, 1_182_722, 1, 77, 8 * 769 * 769, 6_000_000])
def test_descent_plan_holds_every_value_once(n, sms):
    grid, slice_, cap = tq._descent_plan(n, sms)
    assert grid == sms and slice_ % 4 == 0 and cap % 4 == 0 and 0 < cap <= slice_
    assert 4 * cap <= tq.DESCENT_KEY_BYTES
    held = np.zeros(n, np.int64)
    in_smem = 0
    for b in range(grid):  # as the kernel: base = b * slice, cnt = min(slice, n - base)
        base = b * slice_
        cnt = max(0, min(slice_, n - base))
        held[base:base + cnt] += 1
        in_smem += min(cnt, cap)
    assert (held == 1).all()
    assert slice_ < 4 + -(-n // grid)  # the least multiple of 4 that covers n
    if n <= grid * tq.DESCENT_KEY_BYTES // 4 - 4 * grid:
        assert in_smem == n  # no value is read again from global memory


# ---- K4 masks and anchor draws (losses/contrastive.py:_masks_plan,
# _anchors_plan): the flagship's (8 x 129²) and the Cityscapes configs'
# (4 x 193²) pixels, small odd ones, rows of 16- and 2-byte words, and an
# odd row of 1,000,003 pixels (16 runs a warp)

K4_N = [133128, 148996, 189, 100, 1, 4 * 97 * 97, 9008, 9002, 1_000_003]


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("n", K4_N)
def test_masks_plan_takes_every_pixel_once_with_aligned_stores(n, sms):
    """Walked as pixel_masks_kernel walks it: block k's trips start at
    (k + i * blocks) * threads, thread t takes group start + t while it is
    below ceil(n / 4); each group's pixels once; where the kernel's entry
    stores wide (n % 4 == 0) each class row's 4 bytes start 4-aligned and
    its 4 floats 16-aligned."""
    threads, pix = tc.MASKS_THREADS, tc.MASKS_PIXELS
    vec_out = n % pix == 0  # as u2pl_contra_pixel_masks decides it
    for c in (1, 19, 21, 32):
        blocks = tc._masks_plan(n, c, sms)
        assert 1 <= blocks <= tc.MASKS_BLOCKS_PER_SM * sms
        groups = -(-n // pix)
        taken = np.zeros(n, np.int32)
        for k in range(blocks):
            for g0 in range(k * threads, groups, blocks * threads):
                g = np.arange(g0, min(g0 + threads, groups))
                for j in range(pix):
                    p = g * pix + j
                    np.add.at(taken, p[p < n], 1)
                if vec_out:
                    full = g[g * pix + pix <= n] * pix
                    offs = (np.arange(c)[:, None] * n + full[None]).ravel()
                    assert (offs % 4 == 0).all() and (offs * 4 % 16 == 0).all()
        assert (taken == 1).all()
    with pytest.raises(ValueError, match="classes"):
        tc._masks_plan(n, 33, sms)
    with pytest.raises(ValueError, match="2\\^31"):
        tc._masks_plan(2**27, 32, sms)


def _anchors_walk(row, u, vec, slice_):
    """sample_anchors_kernel on one row, in its layout: the blocks of the
    cluster, their warps' spans of `runs` runs of 32 words, a run per load,
    each run's exclusive prefix within its warp, the warps' inclusive
    totals, then each draw r = floor(u * n) served by the block, warp, run
    (a binary search of the prefixes), word (the run counted again, 8 words
    a round) and byte that hold it, N - 1 outside [0, n).  Returns (idx, n,
    the words each block and warp read)."""
    n_pix = row.shape[0]
    words = n_pix // vec
    counts = row.reshape(words, vec).sum(1).astype(np.int64)
    warps = tc.ANCHORS_THREADS // 32
    runs = -(-slice_ // tc.ANCHORS_THREADS)
    blocks, read = [], []
    for rank in range(tc.ANCHORS_CLUSTER):
        first = rank * slice_
        ln = max(0, min(slice_, words - first))
        seg = np.zeros(warps * runs * tc.ANCHORS_RUN, np.int64)
        seg[:ln] = counts[first:first + ln]
        per_run = seg.reshape(warps, runs, tc.ANCHORS_RUN).sum(2)
        pre = (np.cumsum(per_run, 1) - per_run).ravel()  # exclusive within each warp
        warp_tot = np.cumsum(per_run.sum(1)).tolist()
        read.extend(range(first, first + ln))
        blocks.append((first, ln, pre, warp_tot))
    n = sum(b[3][-1] for b in blocks)
    idx = np.full(u.shape[0], -1, np.int64)
    base = 0
    for rank, (first, ln, pre, warp_tot) in enumerate(blocks):
        tot = warp_tot[-1]
        r = np.floor(u * np.float32(n)).astype(np.int64)  # u * n in f32, as __fmul_rn
        for q in np.nonzero((r >= base) & (r < base + tot))[0]:
            k = int(r[q] - base)
            wp = next(w for w in range(warps) if warp_tot[w] > k)
            k -= warp_tot[wp - 1] if wp else 0
            lo = wp * runs + int(np.searchsorted(pre[wp * runs:(wp + 1) * runs], k,
                                                 side="right")) - 1
            k -= int(pre[lo])
            i = lo * tc.ANCHORS_RUN
            while True:  # rounds of 8 words, none past the block's words
                c = [int(counts[first + i + e]) if i + e < ln else 0 for e in range(8)]
                if k < sum(c):
                    e = 0
                    while k >= c[e]:
                        k -= c[e]
                        e += 1
                    i += e
                    break
                k -= sum(c)
                i += 8
            assert lo * tc.ANCHORS_RUN <= i < min((lo + 1) * tc.ANCHORS_RUN, ln)
            bits = row[(first + i) * vec:(first + i + 1) * vec]
            idx[q] = (first + i) * vec + int(np.nonzero(bits)[0][k])
        if rank == tc.ANCHORS_CLUSTER - 1:
            idx[(r < 0) | (r >= n)] = n_pix - 1
        base += tot
    return idx, n, read


@pytest.mark.parametrize("address", [0x7F0000000000, 0x7F0000000004, 0x7F0000000001])
@pytest.mark.parametrize("n", K4_N)
def test_anchors_plan_reads_every_word_once_and_serves_the_draws(n, address):
    """_anchors_plan's words are vec-aligned for every row of a mask at
    `address`; the cluster's blocks and their warps read every word once,
    within shared memory; and the draws served from the prefixes, walked
    as the kernel walks them, are sample_anchors_plain's, for an empty, a
    sparse, a ~60% and a full row, u = 0 and the largest u below 1."""
    vec, slice_, smem = tc._anchors_plan(n, address)
    align = address & -address
    assert vec in (1, 2, 4, 8, 16) and n % vec == 0 and min(align, 16) % vec == 0
    runs = -(-slice_ // tc.ANCHORS_THREADS)
    assert smem == tc.ANCHORS_HEADER_BYTES + 4 * (tc.ANCHORS_THREADS // 32) * runs
    assert smem <= tc.ANCHORS_MAX_SHARED
    assert slice_ * tc.ANCHORS_CLUSTER * vec >= n > (slice_ - 1) * tc.ANCHORS_CLUSTER * vec
    rows = 3
    assert all((address + r * n + w * vec) % vec == 0 for r in range(rows) for w in (0, 1, n // vec - 1))
    rng = np.random.RandomState(n % 1000)
    mask = np.stack([np.zeros(n, bool), rng.rand(n) < 0.002, rng.rand(n) < 0.6, np.ones(n, bool)])
    u = rng.rand(mask.shape[0], 64).astype(np.float32)
    u[:, 0] = np.float32(0.99999994)
    u[:, 1] = 0.0
    ref_idx, ref_n = tc.sample_anchors_plain(
        torch.from_numpy(mask), torch.arange(mask.shape[0], dtype=torch.int32), torch.from_numpy(u))
    for j in range(mask.shape[0]):
        idx, cnt, read = _anchors_walk(mask[j].astype(np.uint8), u[j], vec, slice_)
        assert sorted(read) == list(range(n // vec))
        assert cnt == int(ref_n[j])
        np.testing.assert_array_equal(idx, ref_idx[j].numpy())


def test_anchors_plan_refuses_rows_past_shared_memory():
    """An odd row (1-byte words) of 14,860,287 pixels is the longest whose
    runs' prefixes fit a block's 227 KB; one more run per warp does not."""
    assert tc._anchors_plan(14_860_287, 0x7F0000000000)[2] == tc.ANCHORS_MAX_SHARED
    with pytest.raises(ValueError, match="shared memory"):
        tc._anchors_plan(14_860_289, 0x7F0000000000)
    assert tc._anchors_plan(133128, 0x7F0000000000)[:2] == (8, 2081)
    assert tc._anchors_plan(148996, 0x7F0000000000)[:2] == (4, 4657)


# ---- K4r (losses/contrastive.py:_radix_plan): the flagship's and the
# Cityscapes configs' rows, the card tests' (a row past shared memory, a
# row of 37 under k), N = 1, and rows far past shared memory

RADIX_N = [133128, 148996, 442368, 442369, 1_000_003, 1000, 37, 1, 8 * 97 * 97, 10_000_000,
           2**31 - 100]


@pytest.mark.parametrize("n", RADIX_N)
@pytest.mark.parametrize("k", [1, 16, 8192, 12288, 16385, 2_000_000])
def test_radix_plan_covers_every_pixel_and_holds_what_fits(n, k):
    """`select_keys_radix`'s cluster plan: the 8 blocks' slices (multiples
    of 4) own every pixel once; a block holds every chunk of its slice while
    they fit in shared memory (slices up to 55,296 pixels: rows up to
    442,368), else as many as fit, the rest read again; the plan does not
    depend on C (1 to 32) or k (k > N included), and refuses no row."""
    chunk, cluster = tc.RADIX_CHUNK, tc.RADIX_CLUSTER
    for c in (1, 19, 21, 32):
        slice_, held, smem = tc._radix_plan(c, n, k)
        assert (slice_, held, smem) == tc._radix_plan(1, n, 1)
    assert slice_ % 4 == 0 and slice_ * cluster >= n > (slice_ - 4) * cluster
    if n < 10**6:
        owned = np.zeros(n, np.int32)
        for r in range(cluster):
            owned[r * slice_: min((r + 1) * slice_, n)] += 1
        assert (owned == 1).all()
    chunks = -(-slice_ // chunk)
    assert smem == tc.RADIX_HEADER_BYTES + held * tc.RADIX_CHUNK_BYTES <= tc.RADIX_MAX_SHARED
    assert 0 < held <= chunks
    whole = held == chunks
    assert whole == (n <= 442368)
    if not whole:  # as many as fit: the C entry's check
        assert smem + tc.RADIX_CHUNK_BYTES > tc.RADIX_MAX_SHARED
    # the kernel's 4-pixel quads start 4-aligned in every row where n % 4 == 0
    if n % 4 == 0:
        assert all((r * slice_ + j * chunk + 4 * lane) % 4 == 0
                   for r in range(cluster) for j in (0, chunks - 1) for lane in (0, 31))


def test_radix_plan_refuses_only_what_is_no_row():
    for c, n, k in ((0, 10, 1), (1, 0, 1), (1, 10, 0), (1, 2**31, 1)):
        with pytest.raises(ValueError):
            tc._radix_plan(c, n, k)


# ---- K3c (ops/mixing.py:_classmix_plan): the flagship's (4, 513²), the
# Cityscapes configs' (2, 769²), the card tests' shapes, B = 64 at 65²

CLASSMIX_SHAPES = [(4, 513, 513), (2, 769, 769), (4, 129, 129), (3, 33, 29), (1, 9, 7),
                   (64, 65, 65), (64, 513, 513), (1, 1, 1), (2, 257, 255)]


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
@pytest.mark.parametrize("b,h,w", CLASSMIX_SHAPES)
def test_classmix_plan_takes_every_position_once_co_resident(b, h, w, sms):
    """K3c's cooperative grid: at most MIX_BLOCKS_PER_SM blocks per SM (the
    co-resident count the C entry checks) and no more than b * h * w /
    MIX_THREADS, each of the h * w positions owned by one block (in every
    sample), no block empty; a block holds the draws and the labels of at
    most MIX_MAX_HELD / b positions (all of its span at the configs'
    shapes: B 4 at 513², B 2 at 769²), two blocks an SM within its shared
    memory, and reads the rest again."""
    hw = h * w
    for c in (2, 19, 21, 64):
        grid, span, held, smem = tm._classmix_plan(b, h, w, c, sms)
        assert 1 <= grid <= tm.MIX_BLOCKS_PER_SM * sms
        assert grid == 1 or grid <= b * hw // tm.MIX_THREADS
        assert grid * span >= hw > (grid - 1) * span  # no block empty
        assert held == min(span, tm.MIX_MAX_HELD // b) and b * held <= tm.MIX_MAX_HELD
        assert smem == 4 * b * (c + held) <= tm.MIX_MAX_SHARED
        assert tm.MIX_BLOCKS_PER_SM * (smem + 2 * 64 * 8) <= 228 * 1024
        if (b, h, w) in ((4, 513, 513), (2, 769, 769)) and sms >= 114:
            assert held == span
        owned = np.zeros(hw, np.int32)
        for g in range(grid):
            owned[min(g * span, hw):min((g + 1) * span, hw)] += 1
        assert (owned == 1).all()


def test_classmix_plan_refuses_past_its_limits():
    with pytest.raises(ValueError, match="samples"):
        tm._classmix_plan(65, 9, 7, 21, 132)
    with pytest.raises(ValueError, match="2\\^32"):
        tm._classmix_plan(64, 8193, 8193, 21, 132)
    with pytest.raises(ValueError, match="classes"):
        tm._classmix_plan(4, 9, 7, 65, 132)


# ---- kernel A (ops/resize.py:_fwd_plan) -------------------------------------

def _band_plan(h, w, oh, ow):
    """Kernel A's band plan as the C entry computed it before the plan moved
    to the host: about 4096 outputs a band, bands of even height, as many
    rows as RESIZE_MAX_SHARED holds."""
    quarter = -(-ow // 4)
    target = min(oh, -(-4096 // ow))
    even = max(1, (oh + target // 2) // target)
    rows = min(-(-oh // even), (tr.RESIZE_MAX_SHARED - quarter * 64) // (w * 4))
    return rows, -(-oh // rows)


# (planes, h, w, oh, ow, rows, bands) of that band plan at the paths' many-plane
# shapes: the VOC logits (4 x 21), the decoders (8 x 256 at VOC, 4 x 256 at
# Cityscapes) and the Cityscapes eval crops (8 x 19)
A_MANY_PLANES = [
    (84, 129, 129, 513, 513, 9, 57),
    (2048, 65, 65, 129, 129, 33, 4),
    (1024, 97, 97, 193, 193, 22, 9),
    (152, 193, 193, 769, 769, 7, 110),
]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("planes,h,w,oh,ow,rows,bands", A_MANY_PLANES)
def test_a_fwd_plan_keeps_the_band_plan_at_many_planes(planes, h, w, oh, ow, rows, bands, sms):
    assert _band_plan(h, w, oh, ow) == (rows, bands)
    assert tr._fwd_plan(planes, h, w, oh, ow, sms) == tr.FwdPlan(tr.FWD_BAND, rows, bands)


# (h, w, oh, ow) of the 3-plane images: the VOC and Cityscapes request
# images and VOC eval's image at scales 0.75 and 1.25; small odd shapes
A_FEW_PLANES = [(375, 500, 513, 513), (1024, 2048, 769, 769), (375, 500, 281, 375),
                (375, 500, 469, 625), (7, 9, 33, 17), (1, 5, 4, 10)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("h,w,oh,ow", A_FEW_PLANES)
def test_a_fwd_plan_takes_the_direct_kernel_for_few_planes(h, w, oh, ow, sms):
    """At 3 planes the band plan's blocks are fewer than FWD_BLOCKS_PER_SM
    an SM at the request and eval images on 114 or 132 SMs: the direct
    kernel, whose grid (a 256-thread block per 256 output pixels,
    common.cuh: kThreads) then fills every SM; where they are not, the
    band plan."""
    rows, bands = _band_plan(h, w, oh, ow)
    plan = tr._fwd_plan(3, h, w, oh, ow, sms)
    if 3 * bands < tr.FWD_BLOCKS_PER_SM * sms:
        assert plan == tr.FwdPlan(tr.FWD_DIRECT, 0, 0)
    else:
        assert plan == tr.FwdPlan(tr.FWD_BAND, rows, bands)
    if sms >= 114 and oh > 100:
        assert plan.kernel == tr.FWD_DIRECT and -(-oh * ow // 256) >= sms


@pytest.mark.parametrize("planes", [1, 3, 9, 10, 21, 84])
def test_a_fwd_plan_switches_where_the_band_plan_is_too_few_blocks(planes):
    """At (129², 513²) the band plan's 57 bands make 9 planes 513 blocks,
    under 4 x 132: 9 planes and fewer take the direct kernel, 10 and more
    the band plan."""
    plan = tr._fwd_plan(planes, 129, 129, 513, 513, 132)
    assert plan == (tr.FwdPlan(tr.FWD_BAND, 9, 57) if planes >= 10 else tr.FwdPlan(tr.FWD_DIRECT))


@pytest.mark.parametrize("planes", [1, 3, 84, 2048])
@pytest.mark.parametrize("h,w,oh,ow", A_FEW_PLANES + [(129, 129, 513, 513), (65, 65, 129, 129),
                                                       (1, 1, 100000, 1), (9, 7, 13, 30),
                                                       (2, 4000, 3, 8000)])
def test_a_fwd_plan_bands_fit_shared_memory(planes, h, w, oh, ow):
    """A band plan's taps and H-lerped rows fit RESIZE_MAX_SHARED, and its
    bands cover every output row once."""
    kernel, rows, bands = tr._fwd_plan(planes, h, w, oh, ow, 132)
    if kernel == tr.FWD_DIRECT:
        assert (rows, bands) == (0, 0)
        assert planes * _band_plan(h, w, oh, ow)[1] < tr.FWD_BLOCKS_PER_SM * 132
        return
    assert 1 <= rows <= oh and bands == -(-oh // rows) and (bands - 1) * rows < oh
    assert -(-ow // 4) * 64 + rows * w * 4 <= tr.RESIZE_MAX_SHARED


@pytest.mark.parametrize("n_in,n_out", [(375, 513), (2048, 769), (1, 6), (513, 129), (5, 1)])
def test_a_direct_taps_are_the_band_kernels_packed(n_in, n_out):
    """The direct kernel's int4 per output index is the band kernel's
    (lo, hi, 1 - frac, frac), bit for bit."""
    packed = tr._device_taps4(n_in, n_out, True, torch.device("cpu"))
    idx, w = tr._device_taps(n_in, n_out, True, torch.device("cpu"))
    assert packed.shape == (n_out, 4) and packed.dtype == torch.int32 and packed.is_contiguous()
    assert torch.equal(packed[:, :2].T, idx)
    assert torch.equal(packed[:, 2:].contiguous().view(torch.float32).T, w)


# ---- K6 bwd (losses/contrastive.py:_infonce_bwd_tile): its stores walked --

def _infonce_bwd_walk(b, hw, tile, itemsize, hits):
    """K6 bwd's chunk table and stores as its blocks make them
    (infonce.cu:infonce_bwd_kernel): per block a tile of pixels of one
    image; the warp of a segment (a hit pixel p) writes p's field at
    (alignment m, chunk (p + m) // V, element (p + m) % V) for every m < V;
    the store loop walks the 256 plane rows [e0, e0 + np) in 16-byte chunks
    of V = 16 / itemsize elements, chunk k of a row with e0 % V = m holding
    tile pixels k * V - m + e, and reads element e's field.  Returns the
    count of writes per element of the flat (b, 256, hw) gradient, and
    whether every written element read its own pixel's field (its pixel + 1
    where it has a draw, 0 elsewhere)."""
    v = 16 // itemsize
    writes = np.zeros(b * 256 * hw, np.int64)
    fields_right = True
    hit = np.zeros(b * hw, bool)
    hit[hits] = True
    tiles = -(-hw // tile)
    for blk in range(b * tiles):
        bi, p0 = blk // tiles, (blk % tiles) * tile
        n = min(tile, hw - p0)
        chunks = (n + 2 * v - 2) // v
        assert chunks <= (tc.INFONCE_MAX_TILE + 2 * v - 2) // v
        table = np.zeros((v, chunks, v), np.int64)
        for p in np.nonzero(hit[bi * hw + p0:bi * hw + p0 + n])[0]:
            for m in range(v):
                k, e = divmod(p + m, v)
                assert k < chunks and table[m, k, e] == 0
                table[m, k, e] = p + 1
        f = np.arange(256)
        e0 = bi * 256 * hw + f * hw + p0
        m = e0 % v
        assert (-(-(m + n) // v) <= chunks).all()  # every row's chunks are items
        k = np.arange(chunks)
        lo = k[None, :] * v - m[:, None]  # (plane, chunk): its first tile pixel
        local = lo[..., None] + np.arange(v)  # (plane, chunk, element)
        inside = (local >= 0) & (local < n) & (lo[..., None] < n)
        at = (e0 - m)[:, None, None] + (k * v)[None, :, None] + np.arange(v)
        np.add.at(writes, at[inside], 1)
        read = table[m[:, None, None], k[None, :, None], np.arange(v)[None, None, :]]
        want = np.where(hit[bi * hw + p0 + np.clip(local, 0, n - 1)], local + 1, 0)
        fields_right &= bool((read[inside] == want[inside]).all())
    return writes, fields_right


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,h,w,sms", [(2, 37, 29, 4), (3, 9, 7, 1), (1, 33, 33, 2),
                                        (2, 129, 129, 132)])
def test_infonce_bwd_tiles_write_every_element_once(b, h, w, sms, itemsize):
    """Every element of the gradient is written once, the ragged ends of a
    row's tile element by element, and reads its own pixel's field of the
    chunk table; hw not a multiple of 8 (so a tile's rows take every
    alignment)."""
    hw = h * w
    tile = tc._infonce_bwd_tile(b * hw, sms)
    assert tile % 4 == 0 and 4 <= tile <= tc.INFONCE_MAX_TILE
    blocks = b * -(-hw // tile)
    assert tile == tc.INFONCE_MAX_TILE or blocks >= tc.INFONCE_BWD_BLOCKS_PER_SM * sms - b
    rng = np.random.RandomState(b * hw)
    hits = rng.choice(b * hw, size=max(1, b * hw // 25), replace=False)
    writes, fields_right = _infonce_bwd_walk(b, hw, tile, itemsize, hits)
    assert (writes == 1).all() and fields_right


def test_infonce_bwd_tile_at_the_flagship():
    """The flagship's 8 x 129² pixels on 132 SMs: 508-pixel tiles, 33 a
    plane, 264 blocks (two an SM)."""
    tile = tc._infonce_bwd_tile(8 * 129 * 129, 132)
    assert tile == 508 and 8 * -(-129 * 129 // tile) == 264


# (planes, h, w, oh, ow) of the decoders' bf16 wide upsamples: VOC's 4 + 4
# images at 65² -> 129², Cityscapes' 2 + 2 at 97² -> 193², and reduced batches
A_WIDE_2X = [(2048, 65, 65, 129, 129), (1024, 97, 97, 193, 193), (512, 65, 65, 129, 129),
             (256, 97, 97, 193, 193), (64, 3, 3, 5, 5)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("planes,h,w,oh,ow", A_WIDE_2X)
def test_a_fwd_plan_takes_the_wide_2x_kernel_at_the_decoders(planes, h, w, oh, ow, sms):
    """The bf16 wide branch (mode 2) of an align-corners n -> 2n - 1
    upsample takes the exact 2x kernel, whatever the plane count; every
    other mode at the same shape keeps its band (or direct) plan."""
    assert tr._fwd_plan(planes, h, w, oh, ow, sms, 2) == tr.FwdPlan(tr.FWD_WIDE_2X, 0, 0)
    for mode in (0, 1, 3):
        assert tr._fwd_plan(planes, h, w, oh, ow, sms, mode) == tr._fwd_plan(
            planes, h, w, oh, ow, sms)
    assert tr._fwd_plan(planes, h, w, oh, ow, sms).kernel != tr.FWD_WIDE_2X
    assert tr._fwd_plan(planes, h, w, oh, ow, sms, 2, False) == tr._fwd_plan(
        planes, h, w, oh, ow, sms)


# wide-mode shapes around the decoders': a 4x upsample, the logits' shape,
# 2x on one axis only, a single row, and a 3-plane exact 2x
A_WIDE_ELSEWHERE = [(2048, 33, 33, 129, 129), (84, 129, 129, 513, 513),
                    (256, 65, 65, 129, 130), (256, 1, 65, 1, 129), (3, 375, 500, 749, 999)]


@pytest.mark.parametrize("planes,h,w,oh,ow", A_WIDE_ELSEWHERE)
def test_a_fwd_plan_keeps_the_band_or_direct_kernel_elsewhere(planes, h, w, oh, ow):
    """The wide mode at a shape that is not an exact 2x upsample on both
    axes (or of a single row) keeps the plan the other modes take."""
    two_x = h >= 2 and w >= 2 and (oh, ow) == (2 * h - 1, 2 * w - 1)
    plan = tr._fwd_plan(planes, h, w, oh, ow, 132, 2)
    if two_x:
        assert plan.kernel == tr.FWD_WIDE_2X
    else:
        assert plan == tr._fwd_plan(planes, h, w, oh, ow, 132)
        assert plan.kernel != tr.FWD_WIDE_2X


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("planes,h,w,oh,ow", A_WIDE_2X + A_WIDE_ELSEWHERE)
def test_a_bwd_plan_takes_the_2x_adjoint_where_a_takes_its_2x_kernel(planes, h, w, oh, ow,
                                                                     align):
    """A-bwd's 2x adjoint runs exactly where kernel A runs its exact 2x
    kernel (the bf16 wide mode of an align-corners n -> 2n - 1 upsample on
    both axes); every other mode and shape keeps the band kernel's plan."""
    for mode in (0, 1, 2):
        fwd = tr._fwd_plan(planes, h, w, oh, ow, 132, mode, align)
        bwd = tr._bwd_plan(planes, h, w, oh, ow, 132, mode, align)
        assert (bwd.kernel == tr.BWD_WIDE_2X) == (fwd.kernel == tr.FWD_WIDE_2X)
        if bwd.kernel == tr.BWD_WIDE_2X:
            assert bwd.rows == tr.BWD_2X_ROWS and bwd.bands == -(-h // tr.BWD_2X_ROWS)
        else:
            assert bwd == tr._bwd_plan(planes, h, w, oh, ow, 132, 0, align)
            assert bwd.kernel == tr.BWD_BAND


def _adjoint_2x_walk(gy, rows):
    """A-bwd's 2x adjoint (resize.cu: resize_bilinear_ac_bwd_wide2x_kernel) as
    its threads compute it, in torch ops: the thread of input column ix and
    group k loads output rows 2 k rows - 2 + u, u < 2 rows + 2 (those inside
    the plane), at columns 2ix - 2 .. 2ix + 1 (those inside: 1, 1/2 at ix =
    0; 0, 1/2, 1 at the last), takes each row's W sum (wsum_2x) rounded to
    bf16, then for each of its input rows the H sum over its window's four
    (or fewer) rows, rounded to bf16 once."""
    b, c, oh, ow = gy.shape
    h, w = (oh + 1) // 2, (ow + 1) // 2
    g = gy.float()
    ix = torch.arange(w)
    left, right = ix > 0, ix + 1 < w
    v = [g.index_select(3, (2 * ix - 2 + j).clamp(0, ow - 1)) for j in range(4)]
    zero = torch.zeros_like(v[0])
    s = torch.where(left, zero + 0.0 * v[0], zero)
    s = torch.where(left, s + 0.5 * v[1], s)
    s = s + v[2]
    s = torch.where(right, s + 0.5 * v[3], s)
    s = s.to(torch.bfloat16).float()  # (b, c, oh, w): every output row's W sums
    out = torch.empty((b, c, h, w), dtype=torch.bfloat16)
    for k in range(-(-h // rows)):
        win = [s[:, :, oy] if 0 <= oy < oh else None
               for oy in range(2 * k * rows - 2, 2 * k * rows + 2 * rows)]
        for r in range(rows):
            iy = k * rows + r
            if iy >= h:
                break
            a = torch.zeros((b, c, w))
            if iy > 0:
                a = a + 0.0 * win[2 * r]
                a = a + 0.5 * win[2 * r + 1]
            a = a + win[2 * r + 2]
            if iy + 1 < h:
                a = a + 0.5 * win[2 * r + 3]
            out[:, :, iy] = a.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("shape", [(1, 64, 5, 7), (1, 64, 2, 2), (2, 64, 9, 2), (1, 67, 6, 3)])
def test_a_bwd_2x_walk_bit_equal_to_ordered_sums(shape, rows):
    """The 2x adjoint's per-thread sums, its edge columns and rows and the
    window of 2 rows + 2 output rows included, are A-bwd's ordered sums
    (`resize_bilinear_bwd_ordered`) bit for bit, with inf and NaN in gy."""
    b, c, h, w = shape
    g = torch.Generator().manual_seed(23)
    gy = torch.randn((b, c, 2 * h - 1, 2 * w - 1), generator=g) * 3
    gy[0, 0, 0, 0], gy[0, 1, -1, -1], gy[-1, 2, 1, 2 * w - 2] = float("inf"), float("nan"), -float("inf")
    gy = gy.to(torch.bfloat16)
    assert tr._wide(gy.dtype, c, (h, w), gy.shape[2:], True)
    want = tr.resize_bilinear_bwd_ordered(gy, (h, w))
    assert want.dtype == torch.bfloat16
    assert torch.equal(_adjoint_2x_walk(gy, rows).view(torch.int16), want.view(torch.int16))


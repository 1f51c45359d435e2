"""The host-side launch plans of kernel A-bwd (`ops/resize.py:_bwd_plan`)
and of kernels C fwd and D (`losses/ce.py:_stats_plan`), on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); what they are
given is computed here in Python, so these tests hold the plans to what the
kernels assume: every input row's output range inside the rows its band
walks, every C fwd / D block within shared memory, at the main path's
shapes and every card test's shape, for several SM counts.
"""

import numpy as np
import pytest

from u2pl_tpu_torch.losses import ce
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
    rows, bands, wspan = tr._bwd_plan(planes, h, w, oh, ow, sms)
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
    assert tr._bwd_plan(planes, h, w, oh, ow, 132) == (h, 1, 4)


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

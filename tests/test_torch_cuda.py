"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

(`--noconftest`: tests/conftest.py pins JAX to the CPU and imports it.)
"""

import math

import pytest
import torch

from u2pl_tpu_torch.ops import resize as tr

pytestmark = pytest.mark.cuda

# the (in, out) list of tests/test_ops.py:19-26, plus the decoder's upsample
SIZES = [
    ((129, 129), (513, 513)),
    ((513, 513), (129, 129)),
    ((97, 65), (513, 513)),
    ((7, 9), (33, 17)),
    ((33, 17), (7, 9)),
    ((1, 5), (4, 10)),
    ((65, 65), (129, 129)),
]

ARGMAX_SHAPES = [
    ((21, 513, 513), (375, 500)),
    ((21, 513, 513), (500, 333)),
    ((21, 33, 17), (7, 9)),
    ((5, 1, 5), (4, 10)),
]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain version
    return torch.device("cuda")


@pytest.mark.parametrize("insz,outsz", SIZES)
@pytest.mark.parametrize("align", [True, False])
def test_kernel_a_matches_plain(insz, outsz, align):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 3, insz[0], insz[1], device=dev, generator=g)
    n = tr.resize_bilinear.launches
    got = tr.resize_bilinear(x, outsz, align)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.launches == n + 1
    ref = tr.resize_bilinear_plain(x, outsz, align)
    # products and sums rounded one by one in both: only the matmul's
    # FMA/summation order differs, well inside 1e-5 for |x| < 6
    assert (got - ref).abs().max().item() <= 1e-5


# chip_smoke.py's A_SHAPES (serving, decoder, odd), a 1-pixel input and an
# output width that is not a multiple of 4
A_EXACT_SHAPES = [
    ((4, 21, 129, 129), (513, 513)),
    ((8, 256, 65, 65), (129, 129)),
    ((2, 3, 97, 65), (513, 513)),
    ((2, 3, 7, 9), (33, 17)),
    ((2, 3, 1, 5), (4, 10)),
    ((2, 3, 1, 1), (6, 7)),
    ((3, 5, 9, 7), (13, 30)),
]


@pytest.mark.parametrize("shape,outsz", A_EXACT_SHAPES)
@pytest.mark.parametrize("align", [True, False])
def test_kernel_a_bit_equal_to_rounded_formula(shape, outsz, align):
    """Kernel A computes the H pass, then the W pass, each product and sum
    rounded on its own: bit-equal to those ops one by one in torch."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(*shape, device=dev, generator=g)
    n = tr.resize_bilinear.shapes[(shape, outsz)]
    got = tr.resize_bilinear(x, outsz, align)
    ref = tr.resize_bilinear_rounded(x, outsz, align)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.shapes[(shape, outsz)] == n + 1
    assert got.shape == ref.shape and torch.equal(got, ref)


# kernel A with few planes (ops/resize.py:_fwd_plan's direct kernel): the
# VOC and Cityscapes request images, VOC eval's image at scales 0.75 and
# 1.25, and 9 / 10 planes at the logits' shape, on either side of the plan's
# switch to the band kernel
A_FEW_PLANE_SHAPES = [
    ((1, 3, 375, 500), (513, 513)),
    ((1, 3, 1024, 2048), (769, 769)),
    ((1, 3, 375, 500), (281, 375)),
    ((1, 3, 375, 500), (469, 625)),
    ((9, 1, 129, 129), (513, 513)),
    ((1, 10, 129, 129), (513, 513)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,outsz", A_FEW_PLANE_SHAPES)
def test_kernel_a_few_planes_bit_equal_to_rounded_formula(shape, outsz, dtype):
    """Kernel A's direct kernel gives the bits of its rounded formula, in
    f32 and in the bf16 narrow mode (fewer than 64 channels); so does the
    band kernel past the switch."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(*shape, device=dev, generator=g) * 3).to(dtype)
    planes = shape[0] * shape[1]
    plan = tr._fwd_plan(planes, *shape[2:], *outsz, tr._sm_count(dev))
    assert (plan.kernel == tr.FWD_DIRECT) == (planes < 10 or shape[2] != 129)
    n = tr.resize_bilinear.launches
    got = tr.resize_bilinear(x, outsz)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.launches == n + 1 and got.dtype == dtype
    assert torch.equal(got, tr.resize_bilinear_rounded(x, outsz))


@pytest.mark.parametrize("chw,outsz", ARGMAX_SHAPES)
def test_kernel_b_matches_plain(chw, outsz):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*chw, device=dev, generator=g)
    n = tr.resize_argmax.launches
    got = tr.resize_argmax(x, outsz)
    torch.cuda.synchronize()
    assert tr.resize_argmax.launches == n + 1
    ref = tr.resize_argmax_plain(x, outsz)
    # labels may differ only where the two best classes are within f32
    # rounding of each other
    top2 = tr.resize_bilinear_plain(x[None], outsz)[0].topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * top2[0].abs().clamp(min=1.0)
    assert not ((got != ref) & ~near_tie).any()


@pytest.mark.parametrize("hw,outsz", [((375, 500), (513, 513)), ((500, 333), (513, 513)),
                                      ((1024, 2048), (769, 769)), ((281, 500), (210, 375))])
def test_kernel_a_on_a_normalised_image(tmp_path, hw, outsz):
    """The request image's load (`serving.load_image`): uploaded as uint8,
    normalised on the card bit-equal to the numpy route, then resized by
    kernel A within 1e-5 of the numpy route's host resize (about an ulp
    of |x| < 3) and bit-equal to the rounded H-then-W formula."""
    import numpy as np
    from PIL import Image

    from u2pl_tpu_torch.serving import load_image, load_image_plain

    dev = _cuda()
    mean = np.asarray([123.675, 116.28, 103.53], np.float32)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    path = str(tmp_path / "img.png")
    rng = np.random.RandomState(0)
    Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(path)
    plain, size = load_image_plain(path, mean, std, None, dev)
    got, size_ = load_image(path, mean, std, None, dev)
    assert size == size_ == hw and torch.equal(got, plain)
    n = tr.resize_bilinear.shapes[((1, 3) + hw, outsz)]
    got, _ = load_image(path, mean, std, outsz, dev)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.shapes[((1, 3) + hw, outsz)] == n + 1
    want, _ = load_image_plain(path, mean, std, outsz, dev)
    assert got.shape == want.shape == (3,) + outsz
    assert (got - want).abs().max().item() <= 1e-5
    exact = tr.resize_bilinear_rounded(plain[None], outsz)[0]
    assert torch.equal(got, exact)


@pytest.mark.parametrize("chw", [(21, 375, 500), (19, 1024, 2048), (5, 7, 9), (2, 1, 1)])
def test_kernel_b_at_identity_size_is_argmax(chw):
    """Eval's multi-scale total goes to kernel B at its own size: the
    align-corners taps are the identity, so the labels are the first-maximum
    argmax exactly (ties planted)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*chw, device=dev, generator=g)
    x[1] = torch.where(torch.rand(chw[1:], device=dev, generator=g) < 0.1, x[0], x[1])
    n = tr.resize_argmax.launches
    got = tr.resize_argmax(x, chw[1:])
    torch.cuda.synchronize()
    assert tr.resize_argmax.launches == n + 1
    assert torch.equal(got, x.argmax(dim=0).to(torch.uint8))


def test_kernels_refuse_what_they_do_not_take():
    dev = _cuda()
    x = torch.randn(2, 3, 8, 8, device=dev)
    with pytest.raises(TypeError):
        tr.resize_bilinear(x.double(), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_bilinear(x.transpose(2, 3), (4, 4))
    with pytest.raises(ValueError):  # the taps of 20000 columns exceed shared memory
        tr.resize_bilinear(x, (4, 20000))
    with pytest.raises(TypeError):
        tr.resize_argmax(x[0].half(), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_argmax(torch.randn(256, 4, 4, device=dev), (8, 8))


# ---- the training slice's kernels: A-bwd, C, D, E, K3 ----------------------

BWD_SHAPES = [
    ((2, 8, 65, 65), (129, 129)),  # decoder upsample, narrowed
    ((2, 5, 129, 129), (513, 513)),  # logits upsample
    ((2, 3, 33, 17), (7, 9)),  # a downsample
    ((2, 3, 1, 5), (4, 10)),
]


@pytest.mark.parametrize("shape,outsz", BWD_SHAPES)
def test_kernel_a_bwd_matches_plain_adjoint(shape, outsz):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
    y = tr.resize_bilinear(x, outsz)
    assert y.requires_grad  # kernel A keeps the autograd graph
    gy = torch.randn(y.shape, device=dev, generator=g)
    n = tr.resize_bilinear_bwd.launches
    (gx,) = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert tr.resize_bilinear_bwd.launches == n + 1
    ref = tr.resize_bilinear_bwd_plain(gy, shape[2:])
    # gather-form sums vs a matmul's order: within 1e-5 of the gradient's max
    assert (gx - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    again = tr.resize_bilinear_bwd(gy, shape[2:])
    assert torch.equal(again, gx)  # deterministic: no atomics


def _ordered_adjoint(gy, h, w, round_w=False):
    """A-bwd's sums in its order, one torch op per product and per sum (so
    each rounded on its own): per output row the W sum over ascending output
    columns from 0, then per input row the H sum over ascending output rows
    from 0, with common.cuh's tap_weight values; `round_w`: each W sum
    rounded to bf16 before it enters the H sum."""
    import numpy as np

    def table(n_in, n_out):  # (output index, weight, in range) per input index and slot
        lo, hi, frac = tr._interp_taps_np(n_in, n_out, True)
        w0, w1 = np.float32(1.0) - frac, frac
        start, end = tr._ranges_np(n_in, n_out, True)
        span = max(int((end - start).max()), 1)
        o = np.minimum(start[None, :] + np.arange(span)[:, None], n_out - 1)  # (span, n_in)
        i = np.arange(n_in)[None, :]
        wt = np.where(lo[o] == i, w0[o], np.float32(0.0)).astype(np.float32)
        wt = np.where(hi[o] == i, (wt + w1[o]).astype(np.float32), wt)
        mask = start[None, :] + np.arange(span)[:, None] < end[None, :]
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gy.device)  # noqa: E731
        return to(o.astype(np.int64)), to(wt), to(mask)

    o_w, wt_w, m_w = table(w, gy.shape[3])
    o_h, wt_h, m_h = table(h, gy.shape[2])
    s = torch.zeros(gy.shape[:3] + (w,), device=gy.device)
    for j in range(o_w.shape[0]):
        s = torch.where(m_w[j], s + wt_w[j] * gy.index_select(3, o_w[j]), s)
    if round_w:
        s = s.to(torch.bfloat16).float()
    gx = torch.zeros(gy.shape[:2] + (h, w), device=gy.device)
    for j in range(o_h.shape[0]):
        gx = torch.where(m_h[j][:, None], gx + wt_h[j][:, None] * s.index_select(2, o_h[j]), gx)
    return gx


# A-bwd: the decoder's adjoint at VOC and Cityscapes (whole planes, 4
# column taps in registers), the logits' upsample and a scale-8 one (8 and
# 16 taps: the kernel's table-reading form; the first in bands of 2 rows
# and a last one of 1), a downsample, H = 1, W = 1, and 37 rows in bands
# of 1 (of 13 with sms 4)
A_BWD_EXACT_SHAPES = [
    ((8, 256, 65, 65), (129, 129)),
    ((4, 256, 97, 97), (193, 193)),
    ((2, 5, 129, 129), (513, 513)),
    ((2, 3, 13, 13), (97, 97)),
    ((2, 3, 33, 17), (7, 9)),
    ((2, 3, 1, 5), (4, 10)),
    ((2, 3, 5, 1), (10, 4)),
    ((8, 3, 37, 37), (145, 145)),
]


@pytest.mark.parametrize("sms", [None, 4])
@pytest.mark.parametrize("shape,outsz", A_BWD_EXACT_SHAPES)
def test_kernel_a_bwd_bit_equal_to_ordered_sums(shape, outsz, sms, monkeypatch):
    """sms None: the card's own band plan; 4: fewer, taller bands."""
    dev = _cuda()
    if sms is not None:
        monkeypatch.setattr(tr, "_sm_count", lambda device: sms)
    g = torch.Generator(device=dev).manual_seed(11)
    gy = torch.randn(shape[:2] + outsz, device=dev, generator=g)
    n = tr.resize_bilinear_bwd.launches
    got = tr.resize_bilinear_bwd(gy, shape[2:])
    want = _ordered_adjoint(gy, *shape[2:])
    torch.cuda.synchronize()
    assert tr.resize_bilinear_bwd.launches == n + 1
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(tr.resize_bilinear_bwd(gy, shape[2:]), got)


def _ordered_adjoint_bf16(gy, h, w):
    """`_ordered_adjoint` in A-bwd's bf16 wide mode, the VJP of JAX's bf16
    wide branch (u2pl_tpu/ops/resize.py:101-112): the bf16 gy widened
    exactly, each W sum rounded to bf16 before it enters the H sum, the
    result rounded to bf16 once."""
    return _ordered_adjoint(gy.float(), h, w, round_w=True).to(torch.bfloat16)


# A-bwd's 2x adjoint (the bf16 wide branch at n -> 2n - 1 on both axes):
# the decoders' shapes at batch 1 and 2, an odd plane count, H or W of 2,
# and an even H (a thread's last row pair whole)
A_BWD_2X_SHAPES = [
    ((1, 256, 65, 65), (129, 129)),
    ((2, 256, 65, 65), (129, 129)),
    ((1, 256, 97, 97), (193, 193)),
    ((2, 256, 97, 97), (193, 193)),
    ((1, 67, 5, 7), (9, 13)),
    ((1, 64, 2, 9), (3, 17)),
    ((2, 64, 9, 2), (17, 3)),
    ((3, 64, 2, 2), (3, 3)),
    ((1, 64, 8, 6), (15, 11)),
]


@pytest.mark.parametrize("non_finite", [False, True])
@pytest.mark.parametrize("shape,outsz", A_BWD_2X_SHAPES)
def test_kernel_a_bwd_bf16_bit_equal_to_ordered_sums(shape, outsz, non_finite):
    """A-bwd's bf16 wide branch at an exact 2x upsample takes the 2x
    adjoint, bit-equal to the ordered bf16 sums (`_ordered_adjoint_bf16`,
    and the package's `resize_bilinear_bwd_ordered`), inf and NaN in gy
    included (the zero-weight products kept)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(23)
    gy = torch.randn(shape[:2] + outsz, device=dev, generator=g) * 3
    if non_finite:
        gy[0, 0, 0, 0], gy[0, 1, -1, -1] = float("inf"), float("nan")
        gy[-1, 2, 1, outsz[1] // 2], gy[0, -1, outsz[0] // 2, 0] = -float("inf"), float("nan")
    gy = gy.to(torch.bfloat16)
    plan = tr._bwd_plan(shape[0] * shape[1], *shape[2:], *outsz, tr._sm_count(dev),
                        tr._resize_mode(gy.dtype, shape[1], shape[2:], outsz, True))
    assert plan.kernel == tr.BWD_WIDE_2X
    n = tr.resize_bilinear_bwd.launches
    got = tr.resize_bilinear_bwd(gy, shape[2:])
    torch.cuda.synchronize()
    assert tr.resize_bilinear_bwd.launches == n + 1 and got.dtype == torch.bfloat16
    want = _ordered_adjoint_bf16(gy, *shape[2:])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(tr.resize_bilinear_bwd_ordered(gy, shape[2:]).view(torch.int16),
                       want.view(torch.int16))


def test_kernel_a_bwd_bf16_2x_at_an_odd_address():
    """The 2x adjoint's aligned word loads follow gy's address: a
    contiguous view starting at an odd bf16 element gives the same bits."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(27)
    shape, outsz = (2, 64, 9, 8), (17, 15)
    n = shape[0] * shape[1] * outsz[0] * outsz[1]
    flat = (torch.randn(n + 1, device=dev, generator=g) * 3).to(torch.bfloat16)
    gy = flat[1:].view(shape[:2] + outsz)
    assert gy.is_contiguous() and gy.data_ptr() % 4 == 2
    got = tr.resize_bilinear_bwd(gy, shape[2:])
    want = _ordered_adjoint_bf16(gy.clone(), *shape[2:])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# shapes A-bwd takes in its band kernel in bf16: the wide branch at a 4x
# upsample and at one not exact in bf16 (narrow then), the narrow branch
# at a 2x upsample (21 channels) and an odd one
A_BWD_BF16_BAND_SHAPES = [
    ((1, 256, 33, 33), (129, 129)),
    ((2, 64, 9, 7), (20, 13)),
    ((2, 21, 65, 65), (129, 129)),
    ((3, 5, 9, 7), (13, 30)),
]


@pytest.mark.parametrize("shape,outsz", A_BWD_BF16_BAND_SHAPES)
def test_kernel_a_bwd_bf16_band_kernel_elsewhere(shape, outsz):
    """Every bf16 A-bwd that is not the wide branch of an exact 2x upsample
    keeps the band kernel and its bits: the ordered sums with the W sum
    rounded in the wide branch, only the result rounded in the narrow one."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(25)
    gy = (torch.randn(shape[:2] + outsz, device=dev, generator=g) * 3).to(torch.bfloat16)
    mode = tr._resize_mode(gy.dtype, shape[1], shape[2:], outsz, True)
    plan = tr._bwd_plan(shape[0] * shape[1], *shape[2:], *outsz, tr._sm_count(dev), mode)
    assert plan.kernel == tr.BWD_BAND
    got = tr.resize_bilinear_bwd(gy, shape[2:])
    want = (_ordered_adjoint_bf16(gy, *shape[2:]) if mode == 2 else
            _ordered_adjoint(gy.float(), *shape[2:]).to(torch.bfloat16))
    assert torch.equal(got, want)


def _labels(g, b, h, w, c, dev, ignore_frac=0.1):
    lab = torch.randint(0, c, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    drop = torch.rand((b, h, w), device=dev, generator=g) < ignore_frac
    return torch.where(drop, torch.full_like(lab, 255), lab)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,outsz", [((2, 21, 33, 33), (129, 129)), ((3, 5, 9, 7), (33, 25))])
def test_kernel_c_matches_plain(shape, outsz, weighted):
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
    lab = _labels(g, shape[0], *outsz, shape[1], dev)
    cw = torch.rand(shape[1], device=dev, generator=g) if weighted else None
    n = (ce.upsample_cross_entropy.fwd_launches, ce.upsample_cross_entropy.bwd_launches)
    loss = ce.upsample_cross_entropy(x, lab, 255, cw)
    (gx,) = torch.autograd.grad(loss * 3.0, x)
    torch.cuda.synchronize()
    assert (ce.upsample_cross_entropy.fwd_launches, ce.upsample_cross_entropy.bwd_launches) == (
        n[0] + 1, n[1] + 1,
    )
    xp = x.detach().clone().requires_grad_(True)
    ref = ce.upsample_cross_entropy_plain(xp, lab, 255, cw)
    (gref,) = torch.autograd.grad(ref * 3.0, xp)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert (gx - gref).abs().max().item() <= 1e-6 * max(gref.abs().max().item(), 1e-30)


def test_kernel_c_all_ignored_is_zero():
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    x = torch.randn(2, 5, 9, 9, device=dev, requires_grad=True)
    lab = torch.full((2, 33, 33), 255, dtype=torch.int32, device=dev)
    loss = ce.upsample_cross_entropy(x, lab)
    (gx,) = torch.autograd.grad(loss, x)
    assert loss.item() == 0.0 and not gx.any()


# C's forward at the configs' class counts (21, 19: the exact register
# arrays), a count between them (27: C in steps of 8) and one above 32 (40:
# no register array)
C_FWD_SHAPES = [
    ((2, 21, 33, 33), (129, 129)),
    ((2, 19, 25, 25), (97, 97)),
    ((3, 27, 9, 7), (33, 25)),
    ((2, 40, 9, 9), (33, 33)),
]


@pytest.mark.parametrize("ignore_frac", [0.1, 0.9, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,outsz", C_FWD_SHAPES)
def test_kernel_c_fwd_matches_plain_and_repeats(shape, outsz, weighted, ignore_frac):
    """The loss within 1e-5 of the plain version (0 where every label is
    ignored); labels >= C count as ignored; the loss, and the gradient C's
    backward computes from the forward's saved lse, bit-equal run to run."""
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    c = shape[1]
    x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
    lab = _labels(g, shape[0], *outsz, c, dev, ignore_frac)
    cw = torch.rand(c, device=dev, generator=g) if weighted else None
    n = ce.upsample_cross_entropy.fwd_launches
    loss = ce.upsample_cross_entropy(x, lab, 255, cw)
    torch.cuda.synchronize()
    assert ce.upsample_cross_entropy.fwd_launches == n + 1
    ref = ce.upsample_cross_entropy_plain(x.detach(), lab, 255, cw)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    if ignore_frac == 1.0:
        assert loss.item() == 0.0
    past = torch.where(lab == 255, torch.full_like(lab, c + 2), lab)
    assert torch.equal(ce.upsample_cross_entropy(x.detach(), past, 255, cw), loss.detach())
    (gx,) = torch.autograd.grad(loss, x)
    again = ce.upsample_cross_entropy(x, lab, 255, cw)
    (gx2,) = torch.autograd.grad(again, x)
    assert torch.equal(again.detach(), loss.detach()) and torch.equal(gx2, gx)


# C's backward, fused with its adjoint resize: the existing shapes, scale 8,
# a 37-row map in bands of 3 on a 132-SM card (a 1-row band at the edge),
# odd sizes
C_BWD_SHAPES = [
    ((2, 21, 33, 33), (129, 129)),
    ((3, 5, 9, 7), (33, 25)),
    ((2, 3, 13, 13), (97, 97)),
    ((8, 3, 37, 37), (145, 145)),
    ((2, 5, 17, 23), (65, 90)),
]


@pytest.mark.parametrize("sms", [None, 4])
@pytest.mark.parametrize("ignore_frac", [0.1, 0.9])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,outsz", C_BWD_SHAPES)
def test_kernel_c_bwd_matches_plain(shape, outsz, weighted, ignore_frac, sms, monkeypatch):
    """sms None: the card's own plan; 4: bands of half an image or more."""
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    if sms is not None:
        monkeypatch.setattr(ce, "_sm_count", lambda device: sms)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(*shape, device=dev, generator=g, requires_grad=True)
    lab = _labels(g, shape[0], *outsz, shape[1], dev, ignore_frac)
    cw = torch.rand(shape[1], device=dev, generator=g) if weighted else None
    loss = ce.upsample_cross_entropy(x, lab, 255, cw)
    n = (ce.upsample_cross_entropy.bwd_launches, tr.resize_bilinear_bwd.launches)
    (gx,) = torch.autograd.grad(loss * 3.0, x, retain_graph=True)
    torch.cuda.synchronize()
    # one fused launch, no A-bwd
    assert (ce.upsample_cross_entropy.bwd_launches, tr.resize_bilinear_bwd.launches) == (
        n[0] + 1, n[1])
    plain = ce.upsample_ce_bwd_plain(x.detach(), lab, cw, 255, 3.0)
    xp = x.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ce.upsample_cross_entropy_plain(xp, lab, 255, cw) * 3.0, xp)
    for ref in (plain, auto):
        assert (gx - ref).abs().max().item() <= 1e-6 * max(ref.abs().max().item(), 1e-30)
    (again,) = torch.autograd.grad(loss * 3.0, x)
    assert torch.equal(again, gx)  # deterministic: no atomics


@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_c_bwd_all_ignored_is_zero(weighted):
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    x = torch.randn(2, 3, 13, 13, device=dev, requires_grad=True)
    lab = torch.full((2, 97, 97), 255, dtype=torch.int32, device=dev)
    cw = torch.ones(3, device=dev) if weighted else None
    (gx,) = torch.autograd.grad(ce.upsample_cross_entropy(x, lab, 255, cw), x)
    assert gx.shape == x.shape and not gx.any()


def test_kernel_c_bwd_counts_labels_past_c_as_ignored():
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, 5, 17, 23, device=dev, generator=g, requires_grad=True)
    lab = _labels(g, 2, 65, 90, 5, dev)
    past, ign = lab.clone(), lab.clone()
    past[:, ::3] = 7
    ign[:, ::3] = 255
    (gp,) = torch.autograd.grad(ce.upsample_cross_entropy(x, past), x)
    (gi,) = torch.autograd.grad(ce.upsample_cross_entropy(x, ign), x)
    assert torch.equal(gp, gi)


def test_kernel_c_refuses_a_width_its_backward_cannot_take_before_the_forward():
    """Logits wider than the backward's BWD_MAX_THREADS columns raise in the
    forward when they need a gradient (no forward launch), and run the
    forward alone when they do not."""
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    w = ce.BWD_MAX_THREADS + 1
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1, 3, 2, w, device=dev, generator=g)
    lab = _labels(g, 1, 5, w, 3, dev)
    n = ce.upsample_cross_entropy.fwd_launches
    xg = x.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="owner threads"):
        ce.upsample_cross_entropy(xg, lab)
    assert ce.upsample_cross_entropy.fwd_launches == n
    with torch.no_grad():
        loss = ce.upsample_cross_entropy(xg, lab)
    assert ce.upsample_cross_entropy.fwd_launches == n + 1 and torch.isfinite(loss)


def test_kernel_c_bwd_allocates_no_full_resolution_gradient():
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    b, c, oh, ow = 4, 21, 513, 513
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(b, c, 129, 129, device=dev, generator=g, requires_grad=True)
    lab = _labels(g, b, oh, ow, c, dev)
    loss = ce.upsample_cross_entropy(x, lab)
    torch.autograd.grad(loss, x, retain_graph=True)  # the tables, cached
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (gx,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < b * c * oh * ow * 4


@pytest.mark.parametrize("shape,outsz", [((2, 21, 33, 33), (129, 129)), ((3, 5, 9, 7), (33, 25))])
def test_kernel_d_matches_plain(shape, outsz):
    from u2pl_tpu_torch.losses import unsup

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(*shape, device=dev, generator=g) * 3
    n = unsup.upsample_softmax_stats.launches
    mp, am, ent = unsup.upsample_softmax_stats(x, outsz)
    torch.cuda.synchronize()
    assert unsup.upsample_softmax_stats.launches == n + 1
    rmp, ram, rent = unsup.upsample_softmax_stats_plain(x, outsz)
    assert ((mp - rmp).abs() <= 1e-5 * rmp.abs()).all()
    assert ((ent - rent).abs() <= 1e-5 * rent.abs().clamp(min=1e-3)).all()
    top2 = tr.resize_bilinear_plain(x, outsz).topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs().clamp(min=1.0)
    assert am.dtype == torch.int32 and not ((am != ram) & ~near_tie).any()


D_TOL = 1e-5  # chip_smoke.py's: relative, max-prob and entropy


# the VOC step's (4, 21, 129²) -> 513², the Cityscapes step's (2, 19, 193²)
# -> 769², and an odd shape whose rows do not split into 16-byte chunks
D_SHAPES = [((4, 21, 129, 129), (513, 513)), ((2, 19, 193, 193), (769, 769)),
            ((3, 5, 9, 7), (33, 25))]


@pytest.mark.parametrize("outputs", ["prob", "entropy", "all"])
@pytest.mark.parametrize("shape,outsz", D_SHAPES)
def test_kernel_d_output_selection(shape, outsz, outputs):
    """Kernel D writes only the selected outputs: bit-equal to the
    all-outputs launch, within D_TOL of the plain version, argmax equal off
    near-ties; one launch per call."""
    from u2pl_tpu_torch.losses import unsup

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(*shape, device=dev, generator=g) * 3
    full = unsup.upsample_softmax_stats(x, outsz)
    n = unsup.upsample_softmax_stats.launches
    got = unsup.upsample_softmax_stats(x, outsz, outputs=outputs)
    torch.cuda.synchronize()
    assert unsup.upsample_softmax_stats.launches == n + 1
    keep = {"prob": (True, True, False), "entropy": (False, False, True),
            "all": (True, True, True)}[outputs]
    assert tuple(t is not None for t in got) == keep
    for a, b in zip(got, full):
        assert a is None or torch.equal(a, b)
    rmp, ram, rent = unsup.upsample_softmax_stats_plain(x, outsz)
    if keep[0]:
        assert ((got[0] - rmp).abs() <= D_TOL * rmp.abs()).all()
        top2 = tr.resize_bilinear_plain(x, outsz).topk(2, dim=1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs().clamp(min=1.0)
        assert got[1].dtype == torch.int32 and not ((got[1] != ram) & ~near_tie).any()
    if keep[2]:
        assert ((got[2] - rent).abs() <= D_TOL * rent.abs().clamp(min=1e-3)).all()


def test_kernel_d_refuses_what_it_cannot_hold():
    from u2pl_tpu_torch.losses import unsup

    dev = _cuda()
    with pytest.raises(ValueError, match="classes"):
        unsup.upsample_softmax_stats(torch.zeros(1, 33, 5, 5, device=dev), (9, 9))
    with pytest.raises(ValueError, match="outputs"):
        unsup.upsample_softmax_stats(torch.zeros(1, 3, 5, 5, device=dev), (9, 9), outputs="x")


def _percentile_cases(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    v = torch.rand(1000, device=dev, generator=g)
    m = torch.rand(1000, device=dev, generator=g) < 0.85
    dup = torch.randint(0, 7, (5000,), device=dev, generator=g).float() * 0.25 - 0.5
    one = torch.zeros(300, dtype=torch.bool, device=dev)
    one[17] = True
    return [
        ("random", v, m),
        ("duplicates", dup, torch.rand(5000, device=dev, generator=g) < 0.5),
        ("empty", v, torch.zeros_like(m)),
        ("n=1", v[:300], one),
        ("all", v, torch.ones_like(m)),
    ]


def test_kernel_e_bit_equal_to_plain():
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    pct = torch.tensor([0.0, 37.5, 80.0, 100.0], device=dev)
    for name, v, m in _percentile_cases(dev):
        n = quantile.masked_percentiles.launches
        got = quantile.masked_percentiles(v, m, pct)
        torch.cuda.synchronize()
        assert quantile.masked_percentiles.launches == n + 1
        ref = quantile.masked_percentiles_plain(v, m, pct)
        assert torch.equal(got, ref), (name, got, ref)


def _descent_capacity(dev):
    """The values the descent's grid holds in shared memory on this card."""
    from u2pl_tpu_torch.ops import quantile

    grid, _, cap = quantile._descent_plan(1 << 30, tr._sm_count(dev))
    return grid * cap


def _descent_cases(dev):
    """Kernel E's grid cases: ties, an empty mask, n not a multiple of the
    grid, n under the grid's block count, n past its shared memory."""
    g = torch.Generator(device=dev).manual_seed(5)
    sms = tr._sm_count(dev)
    cases = []
    for name, n in (("ties", 1_052_676), ("n % grid != 0", 1_182_722 + 3 * sms + 1),
                    ("n < grid", sms // 2 + 1), ("past shared memory",
                                                 _descent_capacity(dev) + 12_345)):
        v = torch.rand(n, device=dev, generator=g) * 3
        v[: n // 4] = torch.randint(0, 9, (n // 4,), device=dev, generator=g).float() * 0.25
        m = torch.rand(n, device=dev, generator=g) < 0.85
        cases.append((name, v, m))
    cases.append(("all masked", cases[0][1], torch.zeros_like(cases[0][2])))
    return cases


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_kernel_e_descent_cases(k):
    """One cooperative launch per call, bit-equal to the masked sort, and
    the workspace left zero."""
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    pct = torch.tensor([0.0, 85.0, 37.5, 100.0][:k], device=dev)
    for name, v, m in _descent_cases(dev):
        n = quantile.masked_percentiles.launches
        got = quantile.masked_percentiles(v, m, pct)
        torch.cuda.synchronize()
        assert quantile.masked_percentiles.launches == n + 1
        ref = quantile.masked_percentiles_plain(v, m, pct)
        assert torch.equal(got, ref), (name, got, ref)
        assert not quantile._workspace(v.device).any(), name


def test_kernel_descent_layout_matches_the_host():
    from u2pl_tpu_torch.kernels import load
    from u2pl_tpu_torch.ops import quantile

    _cuda()
    lib = load()
    assert lib.u2pl_quantile_digit_bits() == quantile.DESCENT_DIGIT_BITS
    assert lib.u2pl_quantile_max_key_bytes() == quantile.DESCENT_KEY_BYTES


def test_kernel_descent_refuses_a_grid_that_cannot_be_co_resident(monkeypatch):
    """A grid past one block per SM raises through kernels.check; nothing
    falls back."""
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    v = torch.rand(10_000, device=dev)
    _, slice_, cap = quantile._descent_plan(v.numel(), tr._sm_count(dev))
    monkeypatch.setattr(quantile, "_descent_launch",
                        lambda values: (4 * tr._sm_count(dev), slice_, cap))
    with pytest.raises(RuntimeError, match="CUDA error"):
        quantile.kth_smallest(v, 10)
    with pytest.raises(RuntimeError, match="CUDA error"):
        quantile.masked_percentiles(v, v > 0.5, torch.tensor([50.0], device=dev))


@pytest.mark.parametrize("mode", ["cutmix", "cutout"])
def test_kernel_k3_bit_equal_to_plain(mode):
    from u2pl_tpu_torch.ops import mixing

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    img = torch.randn(3, 3, 33, 29, device=dev, generator=g)
    lab = torch.randint(0, 21, (3, 33, 29), device=dev, generator=g, dtype=torch.int32)
    prob = torch.rand(3, 33, 29, device=dev, generator=g)
    boxes = mixing.draw_boxes(g, 3, 33, 29)
    n = mixing.generate_unsup_data.launches
    got = mixing.generate_unsup_data(img, lab, prob, boxes, mode)
    torch.cuda.synchronize()
    assert mixing.generate_unsup_data.launches == n + 1
    ref = mixing.generate_unsup_data_plain(img, lab, prob, boxes, mode)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _classmix_inputs(dev, b, c, h, w, seed=13, ci=3):
    """Images of `ci` channels, pseudo-labels (some 255, sample 1 a single
    class), max-probs and the (B, C) draws, with ties among a sample's
    draws."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn(b, ci, h, w, device=dev, generator=g)
    lab = torch.randint(0, c, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    lab[torch.rand(b, h, w, device=dev, generator=g) < 0.05] = 255
    lab[1 % b] = 3
    prob = torch.rand(b, h, w, device=dev, generator=g)
    u = torch.rand(b, c, device=dev, generator=g)
    u[0, 1::3] = u[0, 0]  # tied draws
    return img, lab, prob, u


@pytest.mark.parametrize("b,c,h,w,all_ignored,ci", [
    (4, 21, 513, 513, False, 3), (3, 5, 33, 29, False, 3), (1, 64, 9, 7, False, 3),
    (2, 21, 769, 769, False, 3),  # the Cityscapes crop (odd planes: no 16-byte alignment)
    (3, 21, 65, 65, True, 3),  # every label 255: only class C - 1 present, nothing kept
    (64, 64, 65, 65, False, 3),  # the wrapper's limits, MAX_BATCH and MAX_CLASSES
    (3, 7, 40, 33, False, 1), (2, 7, 40, 33, False, 4),  # other channel counts: read in place
])
def test_kernel_k3c_classmix_bit_equal_to_plain(b, c, h, w, all_ignored, ci):
    """Bit-equal to the plain version, in one cooperative launch per call
    (a profiler trace shows one kernel, no memset or zero fill), its ticket
    and presence words back to 0 after every call."""
    from u2pl_tpu_torch.kernels import TICKET_CLASSMIX, tickets
    from u2pl_tpu_torch.ops import mixing

    dev = _cuda()
    img, lab, prob, u = _classmix_inputs(dev, b, c, h, w, ci=ci)
    if all_ignored:
        lab.fill_(255)
    n = mixing.generate_unsup_data.classmix_launches
    got = mixing.generate_unsup_data(img, lab, prob, u, "classmix")
    torch.cuda.synchronize()
    assert mixing.generate_unsup_data.classmix_launches == n + 1
    assert not tickets(dev)[TICKET_CLASSMIX:].any()
    ref = mixing.generate_unsup_data_plain(img, lab, prob, u, "classmix")
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    if all_ignored:
        assert torch.equal(got[1], torch.roll(lab, -1, 0))
    again = mixing.generate_unsup_data(img, lab, prob, u, "classmix")
    assert all(torch.equal(a, r) for a, r in zip(again, got))
    _one_kernel(lambda: mixing.generate_unsup_data(img, lab, prob, u, "classmix"),
                "unsup_class_mix_kernel")


# ---- the contrastive slice's kernels: K4, K5, K6 -----------------------------

# (B, B_l, C, h, w): the flagship's os4 batch, an odd one, and the
# Cityscapes configs' os4 batch
CONTRA_SHAPES = [(8, 4, 21, 129, 129), (3, 1, 5, 9, 7), (4, 2, 19, 193, 193)]


def _contra_inputs(dev, b, b_l, c, h, w, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    prob = torch.softmax(3 * torch.randn(b, c, h, w, device=dev, generator=g), dim=1)
    prob[0, :, 0, :4] = 1.0 / c  # tied probabilities
    labels = torch.randint(0, c, (b, h, w), device=dev, generator=g, dtype=torch.int32)
    labels[torch.rand(b, h, w, device=dev, generator=g) < 0.1] = 255
    low = torch.rand(b, h, w, device=dev, generator=g) < 0.8
    high = torch.rand(b, h, w, device=dev, generator=g) < 0.6
    return g, prob, labels, low, high


def _contra_cfg(**kw):
    from u2pl_tpu_torch.config import parse_config

    raw = {"low_rank": 3, "high_rank": 20, "num_negatives": 50, "num_queries": 256, **kw}
    return parse_config({"trainer": {"contrastive": raw}}).trainer.contrastive


def _device_ops(fn):
    """{device op name: count} of one call of `fn` in a torch.profiler trace
    (after a first call outside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.count}


def _one_kernel(fn, name):
    ops = _device_ops(fn)
    assert len(ops) == 1 and name in next(iter(ops)) and next(iter(ops.values())) == 1, ops
    assert not any("memset" in k.lower() for k in ops), ops


@pytest.mark.parametrize("shape", CONTRA_SHAPES)
def test_kernel_pixel_masks_bit_equal(shape):
    from u2pl_tpu_torch.kernels import TICKET_CONTRA_MASKS, tickets
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    b, b_l, c, h, w = shape
    _, prob, labels, low, high = _contra_inputs(dev, *shape)
    cfg = _contra_cfg(low_rank=1 if c < 8 else 3, high_rank=3 if c < 8 else 20)
    n = tc.contra_pixel_masks.launches
    got = tc.contra_pixel_masks(prob, labels, low, high, b_l, cfg)
    torch.cuda.synchronize()
    assert tc.contra_pixel_masks.launches == n + 1
    ref = tc.contra_pixel_masks_plain(prob, labels, low, high, b_l, cfg)
    for name, x, y in zip(("anchor", "negative", "low_valid", "counts"), got, ref):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert ref[0].any() and ref[1].any()
    # one launch per call, no zero-fill: the counts' words go back to 0
    again = tc.contra_pixel_masks(prob, labels, low, high, b_l, cfg)
    assert all(torch.equal(x, y) for x, y in zip(again, got))
    assert not tickets(dev)[TICKET_CONTRA_MASKS:].any()
    _one_kernel(lambda: tc.contra_pixel_masks(prob, labels, low, high, b_l, cfg),
                "pixel_masks_kernel")


@pytest.mark.parametrize("ignore,num_labeled", [(255, 0), (255, 3), (2, 1)])
def test_kernel_pixel_masks_views_and_labels(ignore, num_labeled):
    """Inputs that are views at unaligned offsets (scalar loads; N a
    multiple of 4, so the stores stay wide), labels in [C, 255) and an
    ignore label inside [0, C), no and every image labeled."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    b, c, h, w = 3, 5, 33, 32
    _, prob, labels, low, high = _contra_inputs(dev, b, num_labeled, c, h, w)
    labels[0, :3] = c + 9
    n = b * h * w
    lab_v = torch.empty(n + 1, dtype=torch.int32, device=dev)[1:].view(b, h, w)
    lab_v.copy_(labels)
    low_v = torch.empty(n + 1, dtype=torch.bool, device=dev)[1:].view(b, h, w)
    low_v.copy_(low)
    high_v = torch.empty(n + 3, dtype=torch.bool, device=dev)[3:].view(b, h, w)
    high_v.copy_(high)
    cfg = _contra_cfg(low_rank=1, high_rank=4)
    args = (prob, lab_v, low_v, high_v, num_labeled, cfg, ignore)
    got = tc.contra_pixel_masks(*args)
    ref = tc.contra_pixel_masks_plain(*args)
    for name, x, y in zip(("anchor", "negative", "low_valid", "counts"), got, ref):
        assert torch.equal(x, y), name
    assert ref[0].any() and ref[1].any() == (num_labeled < b)


def _select_inputs(dev, c, n, density, ties, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(c, n, device=dev, generator=g) < density
    pri = torch.rand(c, n, device=dev, generator=g)
    if ties:
        pri = torch.floor(pri * 16) / 16
    return mask, pri


@pytest.mark.parametrize("c,n,k,density,ties", [
    (21, 133128, 8192, 0.3, False),  # the flagship: over the cap
    (21, 133128, 16384, 0.05, False),  # the largest k, under the cap
    (21, 133128, 8192, 0.3, True),  # tied priorities across the threshold
    (5, 1000, 16, 0.5, False),
    (5, 1000, 700, 0.5, True),
    (3, 37, 64, 1.0, False),  # fewer pixels than k
])
def test_kernel_select_keys_bit_equal(c, n, k, density, ties):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask, pri = _select_inputs(dev, c, n, density, ties)
    mask[c - 1] = False  # an empty class
    cnt = tc.select_keys.launches
    idx, n_sel = tc.select_keys(mask, pri, k)
    torch.cuda.synchronize()
    assert tc.select_keys.launches == cnt + 1
    ref_idx, ref_n = tc.select_keys_plain(mask, pri, k)
    assert torch.equal(n_sel, ref_n)
    for j in range(c):
        m = int(ref_n[j])
        assert torch.equal(idx[j, :m], ref_idx[j, :m]), j


@pytest.mark.parametrize("c,n,k,density,ties,empty", [
    (1, 133128, 8192, 0.3, False, False),  # one class, over the cap
    (32, 133128, 8192, 0.3, True, True),  # the most classes, tied priorities
    (21, 133128, 16384, 0.3, True, False),  # the largest k, over the cap, ties
    (21, 148996, 12288, 0.3, False, True),  # the Cityscapes configs' pixels and cap
    (21, 133128, 8192, 0.0, False, True),  # every class empty
    (4, 9, 16384, 1.0, True, False),  # fewer pixels than one block's share
])
def test_kernel_select_keys_more_cases(c, n, k, density, ties, empty):
    """select_keys bit-equal to the stable argsort at more shapes, one
    launch per call, and zeros past each class's n_sel."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask, pri = _select_inputs(dev, c, n, density, ties)
    if empty:
        mask[c - 1] = False
    cnt = tc.select_keys.launches
    idx, n_sel = tc.select_keys(mask, pri, k)
    torch.cuda.synchronize()
    assert tc.select_keys.launches == cnt + 1
    ref_idx, ref_n = tc.select_keys_plain(mask, pri, k)
    assert torch.equal(n_sel, ref_n)
    for j in range(c):
        m = int(ref_n[j])
        assert torch.equal(idx[j, :m], ref_idx[j, :m]), j
        assert not idx[j, m:].any(), j


def _radix_inputs(dev, c, n, density, seed=8):
    """A (C, N) mask and u32 keys in int32: class 0 with a planted tie at
    its rank-k key, class 1 with a masked key 0xFFFFFFFF, the last class
    empty."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(c, n, device=dev, generator=g) < density
    keys = torch.randint(0, 2**32, (c, n), device=dev, generator=g, dtype=torch.int64)
    keys[0, 7::7] = keys[0, 0]  # many equal keys in class 0
    keys[1, :5] = 0xFFFFFFFF
    mask[1, :5] = True
    mask[c - 1] = False
    return mask, keys.to(torch.int32)


@pytest.mark.parametrize("c,n,k,density", [
    (21, 133128, 8192, 0.3),  # the flagship: over the cap
    (21, 133128, 8192, 0.03),  # under the cap
    (19, 148996, 12288, 0.3),  # the Cityscapes configs' rows and cap
    (5, 1000, 16, 0.5),
    (5, 1000, 143, 1.0),  # the planted tie lands at the threshold
    (3, 37, 64, 1.0),  # fewer pixels than k
    (3, 1_000_003, 8192, 0.3),  # a row past shared memory: chunks read again, two segments
    (3, 1_000_003, 400_000, 0.3),  # ... and under a cap past MAX_KEYS
    (2, 1, 5, 1.0),  # one pixel
])
def test_kernel_select_keys_radix_bit_equal(c, n, k, density):
    """Bit-equal to the plain version, in one launch per call (a profiler
    trace shows one kernel, no memset or zero fill), leaving every ticket
    word at 0."""
    from u2pl_tpu_torch.kernels import tickets
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask, keys = _radix_inputs(dev, c, n, density)
    cnt = tc.select_keys_radix.launches
    idx, n_sel = tc.select_keys_radix(mask, keys, k)
    torch.cuda.synchronize()
    assert tc.select_keys_radix.launches == cnt + 1
    ref_idx, ref_n = tc.select_keys_radix_plain(mask, keys, k)
    assert torch.equal(n_sel, ref_n) and torch.equal(idx, ref_idx)
    assert not tickets(dev).any()
    _one_kernel(lambda: tc.select_keys_radix(mask, keys, k), "select_keys_radix_kernel")


@pytest.mark.parametrize("c,n,q,density", [(21, 133128, 256, 0.02), (5, 9000, 64, 0.3),
                                           (4, 100, 33, 0.0), (19, 148996, 256, 0.02),
                                           (3, 189, 40, 0.5), (5, 9008, 64, 0.3),
                                           (5, 9002, 64, 0.3), (3, 1_000_003, 256, 0.3)])
def test_kernel_sample_anchors_bit_equal(c, n, q, density):
    """Row 0 empty, row 1 ~60% set (like class 0's anchors), the largest
    draw below 1 in every row; words of gcd(n, 16) bytes (16 at n = 9008,
    2 at 9002, 1 for the odd rows, of which 1,000,003 is past what a
    prefix per word could hold); one launch per call, no zero-fill."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(8)
    mask = torch.rand(c, n, device=dev, generator=g) < density
    mask[0] = False
    mask[1] = torch.rand(n, device=dev, generator=g) < 0.6
    assert tc._anchors_plan(n, mask.data_ptr())[0] == math.gcd(n, 16)
    a_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    u = torch.rand(c, q, device=dev, generator=g)
    u[:, 0] = 0.99999994  # the largest draw below 1
    cnt = tc.sample_anchors.launches
    got = tc.sample_anchors(mask, a_j, u)
    torch.cuda.synchronize()
    assert tc.sample_anchors.launches == cnt + 1
    ref = tc.sample_anchors_plain(mask, a_j, u)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    _one_kernel(lambda: tc.sample_anchors(mask, a_j, u), "sample_anchors_kernel")
    # a mask at an odd address: 1-byte words
    odd = torch.empty(c * n + 1, dtype=torch.bool, device=dev)[1:].view(c, n)
    odd.copy_(mask)
    got = tc.sample_anchors(odd, a_j, u)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _prefilled_bank(dev, c, f, queue, class0, dtype, seed=9):
    from u2pl_tpu_torch.memobank import init_memobank

    bank = init_memobank(c, f, queue, class0, dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    bank.keys.copy_(torch.randn(bank.keys.shape, device=dev, generator=g).to(dtype))
    bank.occupancy.copy_(torch.minimum(
        torch.randint(0, class0 + 1, (c,), device=dev, generator=g, dtype=torch.int32), bank.sizes))
    bank.ptr.copy_(torch.remainder(bank.occupancy + 7, bank.sizes).to(torch.int32))
    return bank


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,h,w,k,queue,class0", [
    (8, 21, 129, 129, 8192, 30000, 50000),  # the flagship bank, wrapping
    (2, 5, 9, 7, 16, 12, 20),  # k close to the queue: the ring wraps within one write
    (2, 3, 5, 5, 40, 12, 20),  # k beyond the queue: only the newest `size` rows land
])
def test_kernel_memobank_enqueue_bit_equal(dtype, b, c, h, w, k, queue, class0):
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(10)
    rep = torch.randn(b, 256, h, w, device=dev, generator=g)
    bank = _prefilled_bank(dev, c, 256, queue, class0, dtype)
    n = b * h * w
    sel = torch.stack([torch.randperm(n, device=dev, generator=g)[:k] if k <= n else
                       torch.randint(0, n, (k,), device=dev, generator=g) for _ in range(c)])
    sel = sel.to(torch.int32)
    n_sel = torch.randint(0, k + 1, (c,), device=dev, generator=g, dtype=torch.int32)
    n_sel[0] = k
    ref = memobank_enqueue_plain(clone_bank(bank), rep, sel, n_sel)
    cnt = memobank_enqueue.launches
    got = memobank_enqueue(bank, rep, sel, n_sel)
    torch.cuda.synchronize()
    assert memobank_enqueue.launches == cnt + 1
    for name in ("keys", "ptr", "occupancy"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,h,w,k,queue,case", [
    (8, 21, 129, 129, 8192, 30000, "one_class"),  # every row in one class, the rest empty
    (2, 5, 9, 7, 40, 12, "over_size"),  # n_sel > size in every class
    (2, 19, 33, 33, 2000, 700, "mixed"),  # wraps, n_sel > K, empty classes
])
def test_kernel_memobank_enqueue_more_cases(dtype, b, c, h, w, k, queue, case):
    """K5's grid-stride over the written rows, bit-equal to the plain
    version, twice in a row (the second call from the first's ptr and
    occupancy, after its last block moved them)."""
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(14)
    rep = torch.randn(b, 256, h, w, device=dev, generator=g)
    bank = _prefilled_bank(dev, c, 256, queue, queue, dtype)
    n = b * h * w
    sel = torch.randint(0, n, (c, k), device=dev, generator=g, dtype=torch.int32)
    if case == "one_class":
        n_sel = torch.zeros(c, dtype=torch.int32, device=dev)
        n_sel[3] = k
    elif case == "over_size":
        n_sel = torch.full((c,), k, dtype=torch.int32, device=dev)
    else:
        n_sel = torch.randint(0, k + 1, (c,), device=dev, generator=g, dtype=torch.int32)
        n_sel[:4] = torch.tensor([0, k + 5, queue + 3, 0], dtype=torch.int32)
    ref = clone_bank(bank)
    for _ in range(2):
        ref = memobank_enqueue_plain(ref, rep, sel, n_sel)
        bank = memobank_enqueue(bank, rep, sel, n_sel)
        torch.cuda.synchronize()
        for name in ("keys", "ptr", "occupancy"):
            assert torch.equal(getattr(bank, name), getattr(ref, name)), name


@pytest.mark.parametrize("rep_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bank_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [1, 3, 8])
def test_kernel_memobank_gather_and_slabs_bit_equal(rep_dtype, bank_dtype, w):
    """K5's modes for several ranks: each rank's gathered slab equal to
    `gather_rows` below its counts, and the slab enqueue of the W slabs
    bit-equal to `enqueue_segments` twice in a row, with counts over K, 0,
    and a class past its queue (the newest `size` rows kept)."""
    from u2pl_tpu_torch.memobank import (
        clone_bank, memobank_enqueue_slabs, memobank_enqueue_slabs_plain, memobank_gather,
        memobank_gather_plain,
    )

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(20 + w)
    b, c, h, wd, k, queue = 2, 7, 13, 11, 40, 96
    rep = torch.randn(b, 256, h, wd, device=dev, generator=g).to(rep_dtype)
    bank = _prefilled_bank(dev, c, 256, queue, queue, bank_dtype)
    slabs, counts = [], []
    for _ in range(w):
        sel = torch.randint(0, b * h * wd, (c, k), device=dev, generator=g, dtype=torch.int32)
        n = torch.randint(0, k + 1, (c,), device=dev, generator=g, dtype=torch.int32)
        n[:3] = torch.tensor([k, 0, k + 9], dtype=torch.int32)
        slab = memobank_gather(rep, sel, n)
        ref = memobank_gather_plain(rep, sel, n)
        rows = torch.arange(k, device=dev)[None, :] < torch.clamp(n, max=k)[:, None]
        assert slab.dtype == rep_dtype and torch.equal(slab[rows], ref[rows])
        slabs.append(slab)
        counts.append(n)
    slabs, counts = torch.stack(slabs), torch.stack(counts)
    ref = clone_bank(bank)
    for _ in range(2):
        ref = memobank_enqueue_slabs_plain(ref, slabs, counts)
        bank = memobank_enqueue_slabs(bank, slabs, counts)
        torch.cuda.synchronize()
        for name in ("keys", "ptr", "occupancy"):
            assert torch.equal(getattr(bank, name), getattr(ref, name)), name


@pytest.mark.parametrize("rep_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["flagship", "dense", "shared", "over_k", "empty", "images"])
def test_kernel_memobank_gather_pixel_order_cases(rep_dtype, case, monkeypatch):
    """K5's gather in pixel order, bit-equal to `memobank_gather_plain` below
    min(n_sel, K): the flagship's counts on a (8, 256, 129²) rep, a tile
    denser than its list (every row in 300 pixels), a pixel selected by
    several classes, n_sel > K, all classes empty, and tiles across images
    (one SM: the largest tile); rows past the counts left unwritten."""
    from u2pl_tpu_torch import memobank as mb

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(26)
    flagship = [8192, 475, 494, 479, 489, 510, 493, 507, 477, 473, 488, 484, 500, 459, 512,
                530, 514, 512, 506, 469, 488]
    b, hw, c, k = (8, 129, 21, 8192) if case in ("flagship", "dense") else (3, 47, 6, 300)
    n = b * hw * hw
    rep = torch.randn(b, 256, hw, hw, device=dev, generator=g).to(rep_dtype)
    sel = torch.stack([torch.randperm(n, device=dev, generator=g)[:k] for _ in range(c)])
    counts = {"flagship": flagship, "dense": [2048] * c, "shared": [300, 17, 0, 250, 300, 9],
              "over_k": [301, 400, 299, 5, 1000, 0], "empty": [0] * c,
              "images": [300, 280, 290, 300, 0, 150]}[case]
    if case == "dense":
        sel = torch.randint(0, 300, (c, k), device=dev, generator=g)
    if case == "shared":
        sel[:] = sel[0]
    sel = sel.to(torch.int32).contiguous()
    n_sel = torch.tensor(counts, dtype=torch.int32, device=dev)
    if case == "images":
        monkeypatch.setattr(tr, "_sm_count", lambda device: 1)
    launches = mb.memobank_gather.launches
    slab = mb.memobank_gather(rep, sel, n_sel)
    torch.cuda.synchronize()
    assert mb.memobank_gather.launches == launches + 1
    ref = mb.memobank_gather_plain(rep, sel, n_sel)
    rows = torch.arange(k, device=dev)[None, :] < torch.clamp(n_sel, max=k)[:, None]
    assert slab.dtype == rep_dtype and torch.equal(slab[rows], ref[rows])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 13, 50, 67])
def test_kernel_infonce_fwd_groups_match_plain_and_repeat(dtype, m):
    """K6's forward with M not a multiple of its key group (a bf16 bank's
    chunk of 32 keys, 2 f32 rows) and over two or more of them, inactive
    positions and a bank
    class of occupancy 1: the loss within the flagship test's tolerance,
    the gradient within 1e-5 of its max, and the same loss and directions
    bits on a second call."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    b, c, h, w, q = 2, 9, 17, 15, 64
    g = torch.Generator(device=dev).manual_seed(15)
    bank = _prefilled_bank(dev, c, 256, 300, 300, dtype)
    rep = torch.randn(b, 256, h, w, device=dev, generator=g, requires_grad=True)
    positive = torch.randn(c, 256, device=dev, generator=g)
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    bank.occupancy[b_j[0].long()] = 0  # position 0 inactive, as is the last
    bank.occupancy[b_j[1].long()] = 1  # position 1 draws row 0 only
    anchor_idx, active, valid_seg = _anchor_draws("repeats", dev, g, b, c, h, w, q, bank, b_j)
    u_neg = torch.rand(c, q * m, device=dev, generator=g)
    args = (anchor_idx, positive, bank, b_j, u_neg, active, valid_seg, 0.5)
    loss = tc.contra_infonce(rep, *args)
    gdir = loss.grad_fn.saved_tensors[3][active]  # inactive positions' rows are not written
    again = tc.contra_infonce(rep, *args)
    torch.cuda.synchronize()
    assert torch.equal(loss, again) and torch.equal(gdir, again.grad_fn.saved_tensors[3][active])
    assert not active[0] and not active[-1] and active[1]
    ref = tc.contra_infonce_plain(rep.detach().clone().requires_grad_(True), *args)
    assert ref.item() > 0
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    (grad,) = torch.autograd.grad(loss, rep)
    rp = rep.detach().clone().requires_grad_(True)
    (gref,) = torch.autograd.grad(tc.contra_infonce_plain(rp, *args), rp)
    # 1e-5 of max |grad|, as for the loss: at M = 67 this kernel and the
    # first design (the same bits) are 1.5e-6 (bf16) / 1.9e-6 (f32) off the
    # plain version's autograd, above the 1e-6 the flagship test meets at 50
    ratio = (grad - gref).abs().max().item() / gref.abs().max().item()
    assert ratio <= 1e-5, ratio


INFONCE_LAYOUTS = ["repeats", "one_pixel", "distinct", "shared_inactive", "across_positions"]


def _anchor_draws(layout, dev, g, b, c, h, w, q, bank, b_j):
    """(anchor_idx (C, Q) int32, active (C,) bool, valid_seg) with the draws
    laid over the pixels as `layout` says:
      repeats           disjoint anchor pixels per position, 8 each, drawn
                        with repeats;
      one_pixel         all of a position's draws on one pixel;
      distinct          every draw on its own pixel;
      shared_inactive   as repeats, and the inactive positions draw the
                        active positions' pixels;
      across_positions  every position draws from one pool of 2C pixels, so
                        positions share pixels.
    The last position is inactive (valid_seg C - 1), and so is any whose
    bank class b_j is empty."""
    n = b * h * w
    perm = torch.randperm(n, device=dev, generator=g)
    if layout == "one_pixel":
        idx = perm[:c].view(c, 1).expand(c, q)
    elif layout == "distinct":
        idx = perm[: c * q].view(c, q)
    elif layout == "across_positions":
        idx = perm[: 2 * c][torch.randint(0, 2 * c, (c, q), device=dev, generator=g)]
    else:
        pix = perm[: c * 8].view(c, 8)
        idx = pix.gather(1, torch.randint(0, 8, (c, q), device=dev, generator=g))
    idx = idx.to(torch.int32).contiguous()
    valid_seg = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    active = (torch.arange(c, device=dev) < valid_seg) & (bank.occupancy[b_j.long()] > 0)
    if layout == "shared_inactive":
        act = active.nonzero().flatten()
        for k, j in enumerate((~active).nonzero().flatten().tolist()):
            idx[j] = idx[act[k % act.numel()]].roll(k + 1)
    return idx, active, valid_seg


def _off_anchors(grad, idx, active):
    """The gradient's rows (NHWC) at pixels no active draw hit."""
    b, f, h, w = grad.shape
    hit = torch.zeros(b * h * w, dtype=torch.bool, device=grad.device)
    hit[idx[active].flatten().long()] = True
    return grad.permute(0, 2, 3, 1).reshape(-1, f)[~hit]


@pytest.mark.parametrize("layout", INFONCE_LAYOUTS)
@pytest.mark.parametrize("b,c,h,w,q,m,cap", [(8, 21, 129, 129, 256, 50, 50000),
                                             (3, 5, 9, 7, 16, 4, 20),
                                             (4, 19, 193, 193, 256, 50, 50000)],
                         ids=["voc", "small", "cityscapes"])
def test_kernel_infonce_fwd_bwd_match_plain(b, c, h, w, q, m, cap, layout):
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    bank = _prefilled_bank(dev, c, 256, min(cap, 30000), cap, torch.bfloat16)
    bank.occupancy[1] = 0  # an empty bank class
    rep = torch.randn(b, 256, h, w, device=dev, generator=g, requires_grad=True)
    positive = torch.randn(c, 256, device=dev, generator=g)
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    anchor_idx, active, valid_seg = _anchor_draws(layout, dev, g, b, c, h, w, q, bank, b_j)
    u_neg = torch.rand(c, q * m, device=dev, generator=g)
    args = (anchor_idx, positive, bank, b_j, u_neg, active, valid_seg, 0.5)
    cnt = (tc.contra_infonce.fwd_launches, tc.contra_infonce.bwd_launches)
    loss = tc.contra_infonce(rep, *args)
    (grad,) = torch.autograd.grad(loss * 3.0, rep)
    torch.cuda.synchronize()
    assert (tc.contra_infonce.fwd_launches, tc.contra_infonce.bwd_launches) == (cnt[0] + 1, cnt[1] + 1)
    rp = rep.detach().clone().requires_grad_(True)
    ref = tc.contra_infonce_plain(rp, *args)
    (gref,) = torch.autograd.grad(ref * 3.0, rp)
    assert ref.item() > 0
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert (grad - gref).abs().max().item() <= 1e-6 * gref.abs().max().item()
    again = torch.autograd.grad(tc.contra_infonce(rep, *args) * 3.0, rep)[0]
    assert torch.equal(again, grad)  # deterministic: no float atomics
    assert not _off_anchors(grad, anchor_idx, active).any()
    # valid_seg <= 1: zero loss, zero gradient
    zero = tc.contra_infonce(rep, *args[:6], torch.tensor(1, dtype=torch.int32, device=dev), 0.5)
    (gz,) = torch.autograd.grad(zero, rep)
    assert zero.item() == 0.0 and not gz.any()


@pytest.mark.parametrize("layout", INFONCE_LAYOUTS)
def test_kernel_infonce_bwd_bit_equal_to_ordered_sums(layout):
    """K6's backward alone, on random directions at the flagship shape: each
    pixel's active draws summed from zero in (j, q) order, then one multiply
    by g / max(valid_seg, 1) / Q, zero elsewhere: bit for bit."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    b, c, h, w, q = 8, 21, 129, 129, 256
    g = torch.Generator(device=dev).manual_seed(13)
    bank = _prefilled_bank(dev, c, 256, 30000, 50000, torch.bfloat16)
    bank.occupancy[1] = 0
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    idx, active, valid_seg = _anchor_draws(layout, dev, g, b, c, h, w, q, bank, b_j)
    gdir = torch.randn(c, q, 256, device=dev, generator=g)
    gout = torch.tensor(3.0, device=dev)
    got = tc._infonce_bwd_cuda(idx, active, valid_seg, gdir, gout, (b, 256, h, w))
    rows = torch.zeros(b * h * w, 256, device=dev)
    for j in active.nonzero().flatten().tolist():
        for k in range(q):
            rows[idx[j, k].long()] += gdir[j, k]
    coef = gout / valid_seg.float().clamp(min=1.0) / q
    want = (rows * coef).view(b, h, w, 256).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(tc._infonce_bwd_cuda(idx, active, valid_seg, gdir, gout, (b, 256, h, w)), got)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("layout,b,h,w", [("repeats", 8, 129, 129), ("one_pixel", 8, 129, 129),
                                          ("across_positions", 8, 129, 129),
                                          ("repeats", 3, 9, 7), ("across_positions", 2, 37, 29)])
def test_kernel_infonce_bwd_bf16_bit_equal_to_ordered_sums(layout, b, h, w, split):
    """K6's backward into a bf16 rep gradient, on random directions: each
    active draw's row coef * d rounded to bf16 (split: d * coef plus the
    negatives' part dn * coef rounded to bf16 first, then the row rounded),
    a pixel's rows added in bf16 from zero, each add rounded, in ascending
    w = j * Q + q; zero elsewhere: bit for bit.  h * w = 16641, 63 and 1073
    are not multiples of 8."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    c, q = 21, 256
    g = torch.Generator(device=dev).manual_seed(14)
    bank = _prefilled_bank(dev, c, 256, 30000, 50000, torch.bfloat16)
    bank.occupancy[1] = 0
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    idx, active, valid_seg = _anchor_draws(layout, dev, g, b, c, h, w, q, bank, b_j)
    gdir = torch.randn(*((2,) if split else ()), c, q, 256, device=dev, generator=g)
    gout = torch.tensor(3.0, device=dev)
    shape = (b, 256, h, w)
    got = tc._infonce_bwd_cuda(idx, active, valid_seg, gdir, gout, shape, torch.bfloat16)
    coef = gout / valid_seg.float().clamp(min=1.0) / q
    rows = torch.zeros(b * h * w, 256, device=dev)
    for j in active.nonzero().flatten().tolist():
        for k in range(q):
            if split:
                d = gdir[0, j, k] * coef + (gdir[1, j, k] * coef).bfloat16().float()
            else:
                d = gdir[j, k] * coef
            p = idx[j, k].long()
            rows[p] = (rows[p] + d.bfloat16().float()).bfloat16().float()
    want = rows.bfloat16().view(b, h, w, 256).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    again = tc._infonce_bwd_cuda(idx, active, valid_seg, gdir, gout, shape, torch.bfloat16)
    assert torch.equal(again, got)


def test_kernel_infonce_refuses_draws_over_the_capacity():
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    c, q = 33, 256  # 8448 draws: above the backward's MAX_DRAWS
    assert c * q > tc.MAX_DRAWS
    bank = _prefilled_bank(dev, c, 256, 20, 20, torch.bfloat16)
    rep = torch.randn(1, 256, 8, 8, device=dev, requires_grad=True)
    idx = torch.zeros(c, q, dtype=torch.int32, device=dev)
    active = torch.ones(c, dtype=torch.bool, device=dev)
    valid_seg = torch.tensor(c, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="MAX_DRAWS|exceed"):
        tc.contra_infonce(rep, idx, torch.randn(c, 256, device=dev), bank,
                          torch.arange(c, dtype=torch.int32, device=dev),
                          torch.rand(c, q * 2, device=dev), active, valid_seg, 0.5)
    with pytest.raises(ValueError):
        tc._infonce_bwd_cuda(idx, active, valid_seg, torch.zeros(c, q, 256, device=dev),
                             torch.tensor(1.0, device=dev), (1, 256, 8, 8))


def test_contrastive_kernels_refuse_what_they_do_not_take():
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    mask = torch.ones(3, 10, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        tc.select_keys(mask, torch.rand(3, 10, device=dev), tc.MAX_KEYS + 1)
    with pytest.raises(ValueError):
        tc.select_keys(mask.to(torch.uint8), torch.rand(3, 10, device=dev), 4)
    with pytest.raises(ValueError):
        tc.sample_anchors(mask, torch.arange(3, device=dev), torch.rand(3, 4, device=dev))


# ---- the Cityscapes slice's kernels: K7 (OHEM) --------------------------------

# (B, C, h, w) logits -> (H, W) labels: the Cityscapes main and aux heads, an odd one
OHEM_SHAPES = [((2, 19, 193, 193), (769, 769)), ((2, 19, 97, 97), (769, 769)),
               ((3, 5, 9, 7), (33, 25))]


def _ohem_inputs(dev, shape, outsz, ignore_frac=0.05, seed=12):
    """Logits whose label's class leads at most pixels (classes constant on
    4x4 cells of the logits' grid, the class +4, the rest -4, plus noise), so
    p_y spreads from ~0 to ~1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w = shape
    cells = torch.randint(0, c, (b, -(-h // 4), -(-w // 4)), device=dev, generator=g,
                          dtype=torch.int32)
    lab_s = tr.resize_nearest(cells, (h, w))
    onehot = torch.nn.functional.one_hot(lab_s.long(), c).permute(0, 3, 1, 2).float()
    x = (8 * onehot - 4 + 0.3 * torch.randn(shape, device=dev, generator=g)).contiguous()
    lab = tr.resize_nearest(lab_s, outsz).contiguous()
    lab[torch.rand(lab.shape, device=dev, generator=g) < ignore_frac] = 255
    return x, lab


@pytest.mark.parametrize("shape,outsz", OHEM_SHAPES)
def test_kernel_ohem_target_prob_matches_plain(shape, outsz):
    from u2pl_tpu_torch.losses import ohem

    dev = _cuda()
    x, lab = _ohem_inputs(dev, shape, outsz)
    n = ohem.ohem_target_prob.launches
    p, nv = ohem.ohem_target_prob(x, lab)
    torch.cuda.synchronize()
    assert ohem.ohem_target_prob.launches == n + 1
    ref, nv_ref = ohem.ohem_target_prob_plain(x, lab)
    assert nv.dtype == torch.int32 and torch.equal(nv, nv_ref)
    # exp(x_y - max) / sum on kernel A's upsampled logits: the plain softmax
    # of the same logits (measured bit-equal); the plain version's matmul
    # resize rounds the logits (|x| < 6) up to 9.5e-7 apart
    via_a, _ = ohem._target_prob(tr.resize_bilinear(x, outsz), lab, 255)
    assert ((p - via_a).abs() <= 1e-6 * via_a).all()
    assert ((p - ref).abs() <= 2e-6 * ref).all()
    assert torch.equal(p[lab == 255], torch.ones_like(p[lab == 255]))


def test_kernel_ohem_target_prob_counts_and_repeats():
    """num_valid from the last block's ticket: right on repeated calls, 0 on
    an all-ignored map, the ticket words back at 0; p_y the same bits on
    every call (one launch each, counted by the logits' (h, w))."""
    from u2pl_tpu_torch.kernels import TICKET_OHEM_PROB, tickets
    from u2pl_tpu_torch.losses import ohem

    dev = _cuda()
    for shape, outsz in OHEM_SHAPES:
        for ignore_frac in (0.05, 1.0):
            x, lab = _ohem_inputs(dev, shape, outsz, ignore_frac=ignore_frac)
            want = int((lab != 255).sum())
            before = ohem.ohem_target_prob.shapes[tuple(x.shape[2:])]
            first, nv0 = ohem.ohem_target_prob(x, lab)
            for _ in range(3):
                p, nv = ohem.ohem_target_prob(x, lab)
                torch.cuda.synchronize()
                assert int(nv) == int(nv0) == want and torch.equal(p, first)
            assert not tickets(x.device)[TICKET_OHEM_PROB:TICKET_OHEM_PROB + 2].any()
            assert ohem.ohem_target_prob.shapes[tuple(x.shape[2:])] == before + 4


def _kth_cases(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    n = 2 * 769 * 769
    p = torch.rand(n, device=dev, generator=g)
    p[torch.rand(n, device=dev, generator=g) < 0.3] = 0.5  # a tie block
    p[torch.rand(n, device=dev, generator=g) < 0.05] = 1.0  # the ignored-pixel filler
    dup = torch.randint(0, 7, (5000,), device=dev, generator=g).float() * 0.25 - 0.5
    return [(p, k) for k in (1, 100000, n // 2, n)] + [(dup, k) for k in (1, 2500, 5000)] + [
        (torch.ones(333, device=dev), 100)]


def test_kernel_kth_smallest_bit_equal_to_plain():
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    for v, k in _kth_cases(dev):
        n = quantile.kth_smallest.launches
        got = quantile.kth_smallest(v, k)
        torch.cuda.synchronize()
        assert quantile.kth_smallest.launches == n + 1
        ref = quantile.kth_smallest_plain(v, k)
        assert got.dim() == 0 and torch.equal(got, ref), (v.numel(), k, got, ref)
    with pytest.raises(ValueError):
        quantile.kth_smallest(torch.rand(10, device=dev), 11)


def test_kernel_kth_smallest_descent_cases():
    """k = 1, k = n and the Cityscapes config's k (100000) at the heads'
    n, n past the grid's shared memory, n under its block count."""
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(14)
    for n in (2 * 769 * 769, _descent_capacity(dev) + 777, tr._sm_count(dev) - 1):
        p = torch.rand(n, device=dev, generator=g)
        p[torch.rand(n, device=dev, generator=g) < 0.05] = 1.0
        for k in sorted({1, min(100000, n), n}):
            got = quantile.kth_smallest(p, k)
            torch.cuda.synchronize()
            assert torch.equal(got, quantile.kth_smallest_plain(p, k)), (n, k)
            assert not quantile._workspace(p.device).any()


@pytest.mark.parametrize("min_kept,ignore_frac", [(10, 0.05), (100000, 0.05), (100000, 0.95),
                                                  (100000, 1.0)])
def test_kernel_ohem_keep_labels_bit_equal(min_kept, ignore_frac):
    """thresh sets the threshold, the k-th value does, fewer valid pixels
    than min_kept (every valid pixel kept), an all-ignored map."""
    from u2pl_tpu_torch.losses import ohem
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    x, lab = _ohem_inputs(dev, *OHEM_SHAPES[0], ignore_frac=ignore_frac)
    p, nv = ohem.ohem_target_prob_plain(x, lab)
    kth = quantile.kth_smallest_plain(p, min(p.numel(), min_kept))
    n = ohem.ohem_keep_labels.launches
    got = ohem.ohem_keep_labels(lab, p, kth, nv, 0.7, min_kept)
    torch.cuda.synchronize()
    assert ohem.ohem_keep_labels.launches == n + 1
    ref = ohem.ohem_keep_labels_plain(lab, p, kth, nv, 0.7, min_kept)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    if 0 < int(nv) < min_kept:
        assert int((got != 255).sum()) == int(nv)


@pytest.mark.parametrize("shape,outsz,use_weight", [
    (*OHEM_SHAPES[1], False), (*OHEM_SHAPES[1], True), (*OHEM_SHAPES[2], False)])
def test_ohem_cross_entropy_matches_plain(shape, outsz, use_weight):
    """The whole OHEM loss through the kernels: its value against the plain
    route, rel 1e-5; its gradient against the plain CE of the same kept
    labels, 1e-6 of the max (the kept set may differ from the plain route's
    on pixels within rounding of the threshold)."""
    from u2pl_tpu_torch.losses import ce, ohem
    from u2pl_tpu_torch.ops import quantile

    dev = _cuda()
    x, lab = _ohem_inputs(dev, shape, outsz)
    min_kept = lab.numel() // 10
    xk, xp, xs = (x.clone().requires_grad_(True) for _ in range(3))
    loss = ohem.ohem_cross_entropy(xk, lab, 0.7, min_kept, 255, use_weight)
    (gk,) = torch.autograd.grad(loss * 3.0, xk)
    ref = ohem.ohem_cross_entropy_plain(xp, lab, 0.7, min_kept, 255, use_weight)
    p, nv = ohem.ohem_target_prob(x, lab)
    kept = ohem.ohem_keep_labels(lab, p, quantile.kth_smallest(p, min_kept), nv, 0.7, min_kept)
    same = ce.upsample_cross_entropy_plain(xs, kept, 255, ohem._class_weight(use_weight, dev))
    (gs,) = torch.autograd.grad(same * 3.0, xs)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert (gk - gs).abs().max().item() <= 1e-6 * gs.abs().max().item()


# ---- bfloat16 modes (A, A-bwd, C, D / K7 prob, K5, K6) -----------------------

def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def assert_bf16_flips(got, want, max_frac=0.01, row_dim=None):
    """Two bf16 results of the same f32 values summed in other orders: equal
    but at rounding boundaries, there one bf16 ulp apart, in at most
    `max_frac` of the elements.  The ulp is of the larger magnitude; with
    `row_dim` (a dim or dims), of the largest there (a gradient whose
    terms, each rounded to bf16, may cancel to a small element)."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    a, b = got.float(), want.float()
    diff = a != b
    scale = torch.maximum(a.abs(), b.abs())
    if row_dim is not None:
        scale = scale.amax(dim=row_dim, keepdim=True).expand_as(scale)
    assert ((a - b).abs() <= _bf16_ulp(scale))[diff].all()
    assert diff.float().mean().item() <= max_frac


# the decoder's upsamples (wide: 256 channels, bf16-exact weights) and the
# logits' (narrow), at small shapes, and an odd narrow one
# the decoders' shapes at a reduced batch (the exact 2x kernel), a wide 4x
# upsample (the band kernel), 67 planes of a 2x one whose output ends in a
# partial run of 8 and one narrower than 8 (every run wraps a row)
BF16_A_SHAPES = [((2, 256, 33, 33), (65, 65)), ((2, 64, 49, 49), (97, 97)),
                 ((2, 21, 33, 33), (129, 129)), ((3, 5, 9, 7), (13, 30)),
                 ((2, 256, 65, 65), (129, 129)), ((1, 256, 97, 97), (193, 193)),
                 ((1, 256, 33, 33), (129, 129)), ((1, 67, 5, 7), (9, 13)),
                 ((1, 64, 3, 3), (5, 5))]


@pytest.mark.parametrize("shape,outsz", BF16_A_SHAPES)
def test_kernel_a_bf16_bit_equal_to_rounded_formula(shape, outsz):
    """Kernel A's bf16 modes: the wide branch rounds its H pass to bf16, the
    narrow one only the output; bit-equal to `resize_bilinear_rounded` on
    the bf16 input (its ops one by one, in f32, rounded where the kernel
    rounds)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(20)
    x = (torch.randn(*shape, device=dev, generator=g) * 3).to(torch.bfloat16)
    assert tr._wide(x.dtype, shape[1], shape[2:], outsz, True) == (shape[1] >= 64)
    n = tr.resize_bilinear.launches
    got = tr.resize_bilinear(x, outsz)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.launches == n + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, tr.resize_bilinear_rounded(x, outsz))
    if shape[1] >= 64:  # every product exact: the plain einsums give the same bits
        assert torch.equal(got, tr.resize_bilinear_plain(x, outsz))
    two_x = shape[1] >= 64 and outsz == (2 * shape[2] - 1, 2 * shape[3] - 1)
    plan = tr._fwd_plan(shape[0] * shape[1], *shape[2:], *outsz, tr._sm_count(dev),
                        tr._resize_mode(x.dtype, shape[1], shape[2:], outsz, True))
    assert (plan.kernel == tr.FWD_WIDE_2X) == two_x


def test_kernel_a_bf16_wide_2x_non_finite_inputs():
    """The exact 2x kernel keeps the band kernel's products, the zero-weight
    ones included: inf and NaN inputs give the rounded formula's bits."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(2, 256, 65, 65, device=dev, generator=g)
    x[0, 0, 7, 9], x[0, 1, 64, 64], x[1, 3, 0, 0] = float("inf"), float("nan"), -float("inf")
    x = x.to(torch.bfloat16)
    assert tr._fwd_plan(512, 65, 65, 129, 129, tr._sm_count(dev), 2).kernel == tr.FWD_WIDE_2X
    got = tr.resize_bilinear(x, (129, 129))
    want = tr.resize_bilinear_rounded(x, (129, 129))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shape,outsz", BF16_A_SHAPES)
def test_kernel_a_bwd_bf16_matches_plain(shape, outsz):
    """A-bwd's bf16 modes against the plain adjoint in bf16 (the wide
    branch's W sum rounded to bf16 in both): the same values summed in
    another order, so equal but at bf16 rounding boundaries."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(21)
    gy = torch.randn(shape[:2] + outsz, device=dev, generator=g).to(torch.bfloat16)
    n = tr.resize_bilinear_bwd.launches
    got = tr.resize_bilinear_bwd(gy, shape[2:])
    torch.cuda.synchronize()
    assert tr.resize_bilinear_bwd.launches == n + 1
    assert_bf16_flips(got, tr.resize_bilinear_bwd_plain(gy, shape[2:]))
    assert torch.equal(tr.resize_bilinear_bwd(gy, shape[2:]), got)


def _rounded_stats(x, outsz):
    """Kernel D's statistics of kernel A's bf16 upsample (the bits D
    computes inside), in torch ops."""
    from u2pl_tpu_torch.losses import unsup

    up = tr.resize_bilinear_rounded(x, outsz).float()
    mp = torch.exp(up.amax(dim=1) - torch.logsumexp(up, dim=1))
    return mp, up.argmax(dim=1).to(torch.int32), unsup.teacher_entropy(up)


@pytest.mark.parametrize("shape,outsz", [((2, 21, 33, 33), (129, 129)), ((2, 19, 25, 25), (97, 97)),
                                         ((3, 5, 9, 7), (33, 25))])
def test_kernel_c_d_k7_bf16_match_the_rounded_upsample(shape, outsz):
    """C fwd, D and K7 prob in bf16: their softmax terms of kernel A's
    bf16-rounded upsample, as the f32 modes' of its f32 one (rtol 1e-5);
    the argmax of the rounded values, exact ties to the first class, equal."""
    from u2pl_tpu_torch.losses import ce, ohem, unsup

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(22)
    x = (torch.randn(*shape, device=dev, generator=g) * 3).to(torch.bfloat16)
    x[:, 1] = x[:, 0]  # exact ties
    lab = _labels(g, shape[0], *outsz, shape[1], dev)
    mp, am, ent = unsup.upsample_softmax_stats(x, outsz, outputs="all")
    rmp, ram, rent = _rounded_stats(x, outsz)
    assert ((mp - rmp).abs() <= 1e-5 * rmp).all()
    assert ((ent - rent).abs() <= 1e-5 * rent.abs().clamp(min=1e-3)).all()
    assert torch.equal(am, ram) and (am != 1).all()
    loss = ce.upsample_cross_entropy(x, lab)
    ref = ce.cross_entropy_ignore(tr.resize_bilinear_rounded(x, outsz), lab)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    p_y, nv = ohem.ohem_target_prob(x, lab)
    rp, rnv = ohem._target_prob(tr.resize_bilinear_rounded(x, outsz), lab, 255)
    assert torch.equal(nv, rnv) and ((p_y - rp).abs() <= 1e-5 * rp).all()


# the bf16 stats kernel's ring (losses/ce.py:_stats_ring): steps whose rows
# cross two or more images (OH x OW under a span: 3 images a step at
# 33 x 25), class counts outside {19, 21} (5 and 27 in registers, 40 for C
# fwd and K7 prob with none) and the VOC step's shape
RING_SHAPES = [((3, 5, 9, 7), (33, 25)), ((2, 27, 9, 7), (33, 25)), ((2, 40, 9, 9), (33, 33)),
               ((4, 21, 129, 129), (513, 513))]


@pytest.mark.parametrize("shape,outsz", RING_SHAPES)
def test_kernel_stats_ring_bf16_cases(shape, outsz):
    """D, C fwd and K7 prob on bf16 logits through the staged ring: D's
    selections bit-equal to its all-outputs call and within 1e-5 of the
    statistics of kernel A's rounded upsample (argmax equal, exact ties to
    the first class); C's loss and K7's p_y within 1e-5 of theirs on that
    upsample, num_valid equal; each the same bits on a second call.  The
    logits are a view one image into a larger tensor, as the semi step's
    unlabeled half is: its start need not be 16-byte aligned (the copies
    are aligned from the address)."""
    from u2pl_tpu_torch.losses import ce, ohem, unsup

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(31)
    b, c = shape[:2]
    whole = (torch.randn(b + 1, *shape[1:], device=dev, generator=g) * 3).to(torch.bfloat16)
    x = whole[1:]
    x[:, 1] = x[:, 0]  # exact ties
    lab = _labels(g, b, *outsz, c, dev)
    up = tr.resize_bilinear_rounded(x, outsz)
    if c <= unsup.MAX_STATS_CLASSES:
        full = unsup.upsample_softmax_stats(x, outsz, outputs="all")
        for outputs, keep in (("prob", (0, 1)), ("entropy", (2,))):
            got = unsup.upsample_softmax_stats(x, outsz, outputs=outputs)
            assert all(torch.equal(got[i], full[i]) for i in keep)
        rmp, ram, rent = _rounded_stats(x, outsz)
        assert ((full[0] - rmp).abs() <= 1e-5 * rmp).all()
        assert ((full[2] - rent).abs() <= 1e-5 * rent.abs().clamp(min=1e-3)).all()
        assert torch.equal(full[1], ram) and (full[1] != 1).all()
        again = unsup.upsample_softmax_stats(x, outsz, outputs="all")
        assert all(torch.equal(a, f) for a, f in zip(again, full))
    loss = ce.upsample_cross_entropy(x, lab)
    ref = ce.cross_entropy_ignore(up, lab)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert torch.equal(loss, ce.upsample_cross_entropy(x, lab))
    p_y, nv = ohem.ohem_target_prob(x, lab)
    rp, rnv = ohem._target_prob(up, lab, 255)
    assert torch.equal(nv, rnv) and ((p_y - rp).abs() <= 1e-5 * rp).all()
    p2, nv2 = ohem.ohem_target_prob(x, lab)
    assert torch.equal(p_y, p2) and torch.equal(nv, nv2)


@pytest.mark.parametrize("rep_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["q_past_1024", "one_active", "no_keys"])
def test_kernel_infonce_fwd_copy_engine_cases(case, rep_dtype):
    """K6's forward on a bf16 bank (its keys by the copy engine, 32 a chunk,
    reduced transposed): Q = 1100 draws a position
    (past a block's 1024 threads), a single active position, and M = 0; the
    loss within 1e-5 of
    the float64 plain route on the same inputs, the same loss and
    directions bits on a second call."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(32)
    b, c, h, w, q, m = 2, 3, 17, 15, 1100 if case == "q_past_1024" else 64, 50
    m = 0 if case == "no_keys" else m
    bank = _prefilled_bank(dev, c, 256, 300, 300, torch.bfloat16)
    bank.occupancy.copy_(bank.sizes)
    rep = torch.randn(b, 256, h, w, device=dev, generator=g).to(rep_dtype).requires_grad_(True)
    positive = torch.randn(c, 256, device=dev, generator=g)
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    anchor_idx = torch.randint(0, b * h * w, (c, q), device=dev, generator=g, dtype=torch.int32)
    active = torch.ones(c, dtype=torch.bool, device=dev)
    if case == "one_active":
        active[1:] = False
    valid_seg = torch.tensor(c, dtype=torch.int32, device=dev)
    u_neg = torch.rand(c, q * m, device=dev, generator=g)
    args = (anchor_idx, positive, bank, b_j, u_neg, active, valid_seg, 0.5)
    loss = tc.contra_infonce(rep, *args)
    again = tc.contra_infonce(rep, *args)
    torch.cuda.synchronize()
    gdir, gdir2 = (t.grad_fn.saved_tensors[3][..., active, :, :] for t in (loss, again))
    assert torch.equal(loss, again) and torch.equal(gdir, gdir2)
    ref = tc.contra_infonce_plain(rep.detach().double(), *args)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape,outsz", [((2, 21, 33, 33), (129, 129)), ((3, 5, 9, 7), (33, 25))])
def test_kernel_c_bwd_bf16_matches_plain(shape, outsz, weighted):
    """C's backward in bf16 against `upsample_ce_bwd_plain` in bf16 (the
    full-resolution gradient rounded to bf16 in both, the adjoint summed in
    another order): equal but at bf16 rounding boundaries."""
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(23)
    x = (torch.randn(*shape, device=dev, generator=g) * 3).to(torch.bfloat16).requires_grad_(True)
    lab = _labels(g, shape[0], *outsz, shape[1], dev)
    cw = torch.rand(shape[1], device=dev, generator=g) if weighted else None
    n = ce.upsample_cross_entropy.bwd_launches
    (gx,) = torch.autograd.grad(ce.upsample_cross_entropy(x, lab, 255, cw) * 3.0, x)
    torch.cuda.synchronize()
    assert ce.upsample_cross_entropy.bwd_launches == n + 1 and gx.dtype == torch.bfloat16
    # per (image, class) plane: the full-resolution terms, rounded apart at
    # their boundaries, may cancel to a small element of the adjoint's sum
    assert_bf16_flips(gx, ce.upsample_ce_bwd_plain(x.detach(), lab, cw, 255, 3.0),
                      row_dim=(2, 3))


# C's backward against its ordered formula: ratio 4 at 21 classes (7
# groups of 3), ratio 8 at 19 (groups of 3 and 4), a width that is no exact
# ratio (its tap table) at 5 (2 + 3), ratio 4 with the last image's labels
# all ignored, and 193 columns of 4-class groups (two owner pairs a thread)
C_BWD_ORDERED_SHAPES = [((2, 21, 33, 33), (129, 129), False),
                        ((2, 19, 25, 25), (193, 193), False),
                        ((2, 5, 17, 23), (65, 90), False),
                        ((3, 19, 13, 13), (49, 49), True),
                        ((1, 19, 9, 193), (33, 769), False)]


@pytest.mark.parametrize("sms", [None, 4])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,outsz,last_ignored", C_BWD_ORDERED_SHAPES)
def test_kernel_c_bwd_bit_equal_to_ordered_formula(shape, outsz, last_ignored, dtype, weighted,
                                                   sms, monkeypatch):
    """C's backward, both modes, bit-equal to `upsample_ce_bwd_ordered` on
    the forward's saved lse and denominator (sms None: the card's own plan;
    4: taller bands)."""
    from u2pl_tpu_torch.losses import ce

    dev = _cuda()
    if sms is not None:
        monkeypatch.setattr(ce, "_sm_count", lambda device: sms)
    g = torch.Generator(device=dev).manual_seed(25)
    x = (torch.randn(*shape, device=dev, generator=g) * 3).to(dtype).requires_grad_(True)
    lab = _labels(g, shape[0], *outsz, shape[1], dev)
    if last_ignored:
        lab[-1] = 255
    cw = torch.rand(shape[1], device=dev, generator=g) if weighted else None
    loss = ce.upsample_cross_entropy(x, lab, 255, cw)
    _, _, lse, stats, _ = loss.grad_fn.saved_tensors
    n = ce.upsample_cross_entropy.bwd_launches
    (gx,) = torch.autograd.grad(loss * 3.0, x)
    torch.cuda.synchronize()
    assert ce.upsample_cross_entropy.bwd_launches == n + 1 and gx.dtype == dtype
    want = ce.upsample_ce_bwd_ordered(x.detach(), lab, cw, 255, 3.0, lse, stats[1])
    assert torch.equal(gx, want)
    if last_ignored:
        assert not gx[-1].any()


@pytest.mark.parametrize("bank_dtype", [torch.bfloat16, torch.float32])
def test_kernel_memobank_enqueue_bf16_rep_bit_equal(bank_dtype):
    """K5 on a bf16 rep: the rows copied into a bf16 bank, widened into an
    f32 one, bit-equal to the plain version."""
    from u2pl_tpu_torch.memobank import clone_bank, memobank_enqueue, memobank_enqueue_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(24)
    rep = torch.randn(4, 256, 33, 33, device=dev, generator=g).to(torch.bfloat16)
    bank = _prefilled_bank(dev, 5, 256, 300, 500, bank_dtype)
    sel = torch.stack([torch.randperm(4 * 33 * 33, device=dev, generator=g)[:400]
                       for _ in range(5)]).to(torch.int32)
    n_sel = torch.tensor([400, 17, 0, 300, 399], dtype=torch.int32, device=dev)
    ref = memobank_enqueue_plain(clone_bank(bank), rep, sel, n_sel)
    got = memobank_enqueue(bank, rep, sel, n_sel)
    torch.cuda.synchronize()
    for name in ("keys", "ptr", "occupancy"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("bank_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["repeats", "one_pixel", "across_positions"])
def test_kernel_infonce_bf16_rep_matches_plain(bank_dtype, layout):
    """K6 on a bf16 rep: the loss rtol 1e-5 of the plain version's (its f32
    arithmetic in another order); the bf16 gradient (each draw's row
    rounded, a bf16 bank's negatives' part rounded apart, a pixel's rows
    added in bf16 in (j, q) order) equal but at bf16 rounding boundaries."""
    from u2pl_tpu_torch.losses import contrastive as tc

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(25)
    b, c, h, w, q, m = 4, 5, 17, 17, 32, 8
    bank = _prefilled_bank(dev, c, 256, 300, 500, bank_dtype)
    rep = torch.randn(b, 256, h, w, device=dev, generator=g).to(torch.bfloat16).requires_grad_(True)
    positive = torch.randn(c, 256, device=dev, generator=g)
    b_j = torch.randperm(c, device=dev, generator=g).to(torch.int32)
    anchor_idx, active, valid_seg = _anchor_draws(layout, dev, g, b, c, h, w, q, bank, b_j)
    u_neg = torch.rand(c, q * m, device=dev, generator=g)
    args = (anchor_idx, positive, bank, b_j, u_neg, active, valid_seg, 0.5)
    loss = tc.contra_infonce(rep, *args)
    (grad,) = torch.autograd.grad(loss * 3.0, rep)
    torch.cuda.synchronize()
    assert grad.dtype == torch.bfloat16
    rp = rep.detach().clone().requires_grad_(True)
    ref = tc.contra_infonce_plain(rp, *args)
    (gref,) = torch.autograd.grad(ref * 3.0, rp)
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert_bf16_flips(grad, gref, max_frac=0.02, row_dim=1)
    again = torch.autograd.grad(tc.contra_infonce(rep, *args) * 3.0, rep)[0]
    assert torch.equal(again, grad)
    assert not _off_anchors(grad.float(), anchor_idx, active).any()


def test_bf16_wrappers_refuse_other_dtypes():
    """A wrapper takes the dtypes it has a mode for, and raises on others."""
    from u2pl_tpu_torch.losses import ce, unsup

    dev = _cuda()
    x = torch.randn(2, 5, 9, 9, device=dev)
    lab = torch.zeros(2, 33, 33, dtype=torch.int32, device=dev)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            tr.resize_bilinear(x.to(bad), (17, 17))
        with pytest.raises(TypeError):
            ce.upsample_cross_entropy(x.to(bad), lab)
        with pytest.raises(TypeError):
            unsup.upsample_softmax_stats(x.to(bad), (33, 33))
    for bad in (torch.float16, torch.float64):  # kernel B: float32 or bfloat16
        with pytest.raises(TypeError):
            tr.resize_argmax(x[0].to(bad), (17, 17))
        with pytest.raises(TypeError):  # A's f32-out mode takes bf16 alone
            tr.resize_bilinear(x.to(bad), (17, 17), out_dtype=torch.float32)
    with pytest.raises(TypeError):  # no f32 -> bf16 mode
        tr.resize_bilinear(x, (17, 17), out_dtype=torch.bfloat16)


# kernel B's bf16 mode: the serving shapes (VOC 513² -> a 500x375 image,
# Cityscapes 769² -> 1024x2048), eval's identity size and odd ones
B_BF16_SHAPES = [((21, 513, 513), (375, 500)), ((19, 769, 769), (1024, 2048)),
                 ((21, 375, 500), (375, 500)), ((5, 7, 9), (13, 30)), ((3, 1, 5), (4, 10))]


@pytest.mark.parametrize("chw,outsz", B_BF16_SHAPES)
def test_kernel_b_bf16_equals_its_f32_mode_on_the_upcast(chw, outsz):
    """Kernel B on bf16 logits widens each tap on load and computes as its
    f32 mode: the labels equal the f32 mode's on `logits.float()` at every
    pixel, ties planted (two classes equal on a tenth of the pixels)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(21)
    x = (torch.randn(*chw, device=dev, generator=g) * 4).to(torch.bfloat16)
    x[1] = torch.where(torch.rand(chw[1:], device=dev, generator=g) < 0.1, x[0], x[1])
    n, nb = tr.resize_argmax.launches, tr.resize_argmax.dtypes[torch.bfloat16]
    got = tr.resize_argmax(x, outsz)
    torch.cuda.synchronize()
    assert tr.resize_argmax.launches == n + 1 and got.dtype == torch.uint8
    assert tr.resize_argmax.dtypes[torch.bfloat16] == nb + 1
    assert torch.equal(got, tr.resize_argmax(x.float(), outsz))
    # the plain version upcasts first too: labels differ from it only at
    # f32 near-ties of the upcast's resize (its einsum sums in another order)
    ref = tr.resize_argmax_plain(x, outsz)
    top2 = tr.resize_bilinear_plain(x[None].float(), outsz)[0].topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * top2[0].abs().clamp(min=1.0)
    assert not ((got != ref) & ~near_tie).any()


# kernel A's bf16 -> f32 mode: VOC eval's per-scale logits back to a
# 500x375 image, the logits' shape in serving, and odd ones
A_BF16_F32_SHAPES = [((1, 21, 281, 375), (375, 500)), ((1, 21, 469, 625), (375, 500)),
                     ((2, 21, 33, 33), (129, 129)), ((1, 256, 33, 33), (65, 65)),
                     ((3, 5, 9, 7), (13, 30)), ((1, 3, 1, 5), (4, 10))]


@pytest.mark.parametrize("shape,outsz", A_BF16_F32_SHAPES)
def test_kernel_a_bf16_to_f32_bit_equal_to_its_f32_mode(shape, outsz):
    """Kernel A's bf16-in, f32-out mode (`out_dtype=torch.float32`): the
    f32 mode on the exact upcast, bit for bit, with no rounding (not even
    the wide branch's at 256 channels), and so `resize_bilinear_rounded` of
    `x.float()`."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(22)
    x = (torch.randn(*shape, device=dev, generator=g) * 3).to(torch.bfloat16)
    n, n3 = tr.resize_bilinear.launches, tr.resize_bilinear.modes[3]
    got = tr.resize_bilinear(x, outsz, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.launches == n + 1 and tr.resize_bilinear.modes[3] == n3 + 1
    assert got.dtype == torch.float32 and got.shape == shape[:2] + outsz
    assert torch.equal(got, tr.resize_bilinear(x.float(), outsz))
    assert torch.equal(got, tr.resize_bilinear_rounded(x.float(), outsz))
    same = tr.resize_bilinear(x, shape[2:], out_dtype=torch.float32)  # identity: the upcast
    assert same.dtype == torch.float32 and torch.equal(same, x.float())

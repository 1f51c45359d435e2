"""Strong augmentation of the unlabeled batch: the CutMix / Cutout box modes
and ClassMix (port of u2pl_tpu/ops/mixing.py).

The draws are made apart from their application, so a test can feed both
packages the same draws.  Box modes: `boxes_from_uniforms` turns three
uniforms per sample into (y0, x0, h, w) with the JAX package's own float32
formulas (`_randint`, `_cutout_box_mask`: width ~ U{W/ratio+1, ..., W-1},
height = round(area/ratio / width) (half to even in both), uniform
placement), and `draw_boxes` takes the uniforms from a `torch.Generator`.
ClassMix: a (B, C) float32 block of uniforms, one (C,) vector per sample
(JAX: uniform(split(k_mix, B)[i], (C,))), ranks the classes present in each
sample's pseudo-labels (`class_half_mask_plain`).  `draw_mix` draws what the
mode needs.

`generate_unsup_data` applies the draws: kernel K3 (box modes) or K3c
(classmix) of `kernels/csrc/mixing.cu` on the card, `torch.where` with the
masks on the CPU.  `generate_unsup_data.launches` counts K3's launches,
`generate_unsup_data.classmix_launches` K3c's.
"""

from __future__ import annotations

from typing import Tuple

import torch

MODES = ("cutmix", "cutout", "classmix")
MAX_CLASSES = 64  # K3c keeps each sample's present classes in a u64 bitmask
MAX_BATCH = 64  # ... and every sample's selection in shared memory


def check_mode(mode: str) -> None:
    """Raise unless `mode` is an `unsupervised.apply_aug` mode."""
    if mode not in MODES:
        raise ValueError(f"unknown unsup aug mode {mode!r}")


def boxes_from_uniforms(
    u: torch.Tensor, im_h: int, im_w: int, ratio: float = 2.0
) -> torch.Tensor:
    """(B, 3) uniforms in [0, 1) -> (B, 4) int32 boxes (y0, x0, h, w): column
    0 draws the width, 1 the left edge, 2 the top edge, as the three keys of
    u2pl_tpu/ops/mixing.py:_cutout_box_mask (:33-37)."""
    u = u.to(torch.float32)

    def randint(ui, lo, hi):
        # np.random.randint(lo, hi) parity in f32: lo + floor(u * (hi - lo))
        return (lo + torch.floor(ui * (hi - lo))).to(torch.int32)

    def f32(v):
        return torch.full_like(u[:, 0], float(v))

    area = im_h * im_w / ratio
    w = randint(u[:, 0], f32(int(im_w / ratio) + 1), f32(im_w))
    h = torch.round(f32(area) / w.to(torch.float32)).to(torch.int32)
    x0 = randint(u[:, 1], f32(0), (im_w - w + 1).to(torch.float32))
    y0 = randint(u[:, 2], f32(0), (im_h - h + 1).to(torch.float32))
    return torch.stack([y0, x0, h, w], dim=1)


def draw_boxes(
    generator: torch.Generator, batch: int, im_h: int, im_w: int, ratio: float = 2.0
) -> torch.Tensor:
    """(batch, 4) int32 boxes on the generator's device, from its draws."""
    u = torch.rand((batch, 3), generator=generator, device=generator.device)
    return boxes_from_uniforms(u, im_h, im_w, ratio)


def draw_mix(
    generator: torch.Generator, mode: str, batch: int, im_h: int, im_w: int, num_classes: int
) -> torch.Tensor:
    """The draws of `mode` from `generator`: (batch, 4) int32 boxes, or for
    classmix (batch, num_classes) float32 uniforms."""
    if mode == "classmix":
        return torch.rand((batch, num_classes), generator=generator, device=generator.device)
    return draw_boxes(generator, batch, im_h, im_w)


def class_half_mask_plain(target: torch.Tensor, u: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) int32, 1 where sample i's pseudo-label is in a random half
    (n_present // 2) of the classes present in it: the literal port of
    u2pl_tpu/ops/mixing.py:_class_half_mask (:49-59) per sample, with its
    uniforms u[i] (C,).  Labels are clipped to [0, C-1] before marking, so
    255 counts as class C-1, as there."""
    out = []
    for t, ui in zip(target, u):
        cl = torch.clamp(t.reshape(-1).long(), 0, num_classes - 1)
        present = torch.bincount(cl, minlength=num_classes) > 0
        k = present.sum() // 2
        scores = torch.where(present, ui.to(torch.float32), torch.full_like(ui, float("inf")))
        order = torch.sort(scores, stable=True).indices
        rank = torch.sort(order, stable=True).indices
        selected = present & (rank < k)
        out.append(selected[torch.clamp(t.long(), 0, num_classes - 1)].to(torch.int32))
    return torch.stack(out)


def box_masks(boxes: torch.Tensor, im_h: int, im_w: int) -> torch.Tensor:
    """(B, H, W) bool, True inside each sample's box."""
    ys = torch.arange(im_h, device=boxes.device)[None, :, None]
    xs = torch.arange(im_w, device=boxes.device)[None, None, :]
    y0, x0, h, w = (boxes[:, j, None, None] for j in range(4))
    return (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)


def generate_unsup_data_plain(
    data: torch.Tensor,
    target: torch.Tensor,
    logits: torch.Tensor,
    draws: torch.Tensor,
    mode: str,
    ignore_label: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernels K3 and K3c."""
    if mode == "classmix":
        inside = class_half_mask_plain(target, draws, draws.shape[1]) == 0
    else:
        inside = box_masks(draws, target.shape[1], target.shape[2])
    if mode == "cutout":
        keep = (~inside).to(data.dtype)
        return (
            data * keep[:, None],
            torch.where(inside, torch.full_like(target, ignore_label), target),
            logits * keep.to(logits.dtype),
        )
    nxt = lambda x: torch.roll(x, -1, dims=0)  # noqa: E731  (i+1) % B partner
    return (
        torch.where(inside[:, None], nxt(data), data),
        torch.where(inside, nxt(target), target),
        torch.where(inside, nxt(logits), logits),
    )


# K3c's kernel: one cooperative launch of MIX_BLOCKS_PER_SM blocks of
# MIX_THREADS threads per SM at most, each owning a span of the H x W
# positions in every sample and holding up to MIX_MAX_HELD of their labels
# in shared memory (kMixThreads, kMixMaxShared in mixing.cu)
MIX_THREADS = 512
MIX_BLOCKS_PER_SM = 2
MIX_MAX_HELD = 16384
MIX_MAX_SHARED = 80 * 1024


def _classmix_plan(b: int, h: int, w: int, c: int, sms: int) -> Tuple[int, int, int, int]:
    """(grid, span, held, smem) of K3c's cooperative kernel for (b, h, w)
    labels and c classes on `sms` SMs: block g owns the positions [g * span,
    (g + 1) * span) of the h * w plane in every sample (grid * span covers
    them, no block empty; at most MIX_BLOCKS_PER_SM blocks per SM, so the
    grid is co-resident, and no more blocks than b * h * w / MIX_THREADS);
    it keeps the (b, c) draws and the labels of its first `held` positions
    (b * held <= MIX_MAX_HELD) in smem bytes of shared memory, and reads the
    rest again in the blend.  Raises past the kernel's 32-bit pixel index."""
    hw = h * w
    if not 0 < b <= MAX_BATCH or not 0 < b * hw < 2**32 or not 0 < c <= MAX_CLASSES:
        raise ValueError(f"generate_unsup_data: classmix of {b} samples of {h} x {w}, {c} "
                         f"classes (at most {MAX_BATCH} samples, {MAX_CLASSES} classes, under "
                         f"2^32 pixels)")
    grid = max(1, min(MIX_BLOCKS_PER_SM * sms, b * hw // MIX_THREADS, hw))
    span = -(-hw // grid)
    held = min(span, MIX_MAX_HELD // b)
    return -(-hw // span), span, held, 4 * b * (c + held)


def generate_unsup_data(
    data: torch.Tensor,
    target: torch.Tensor,
    logits: torch.Tensor,
    draws: torch.Tensor,
    mode: str,
    ignore_label: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX `generate_unsup_data`, with the draws given.

    data (B, 3, H, W) f32; target (B, H, W) int32 pseudo-labels; logits
    (B, H, W) f32 max teacher prob; draws (B, 4) int32 boxes (y0, x0, h, w)
    for the box modes, (B, C) f32 uniforms for classmix.
    cutmix: inside sample i's box, take sample (i+1) % B's pixel;
    cutout: inside the box, zero image and max-prob and ignore the label;
    classmix: keep sample i's pixels of a random half of its present
    classes, take sample (i+1) % B's elsewhere."""
    check_mode(mode)
    b, h, w = target.shape
    want = (b, draws.shape[1] if mode == "classmix" else 4)
    if data.dim() != 4 or data.shape[0] != b or data.shape[2:] != (h, w) or (
        logits.shape != target.shape or draws.dim() != 2 or tuple(draws.shape) != want
    ):
        raise ValueError(
            f"generate_unsup_data: data {tuple(data.shape)}, target "
            f"{tuple(target.shape)}, logits {tuple(logits.shape)}, draws {tuple(draws.shape)}"
        )
    if data.device.type == "cpu":
        return generate_unsup_data_plain(data, target, logits, draws, mode, ignore_label)
    from u2pl_tpu_torch.ops.resize import _check_cuda

    _check_cuda(data, 4, "generate_unsup_data")
    _check_cuda(logits, 3, "generate_unsup_data logits")
    if target.device != data.device or target.dtype != torch.int32 or not target.is_contiguous():
        raise TypeError("generate_unsup_data: target must be contiguous int32 on the card")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    img_out, lab_out, prob_out = (
        torch.empty_like(data), torch.empty_like(target), torch.empty_like(logits)
    )
    if mode == "classmix":
        _check_cuda(draws, 2, "generate_unsup_data classmix draws")
        c = draws.shape[1]
        if c > MAX_CLASSES or b > MAX_BATCH:
            raise ValueError(f"generate_unsup_data: classmix takes at most {MAX_CLASSES} "
                             f"classes and {MAX_BATCH} samples, got {c} and {b}")
        if target.numel() == 0:
            return img_out, lab_out, prob_out
        from u2pl_tpu_torch.kernels import TICKET_CLASSMIX, tickets
        from u2pl_tpu_torch.ops.resize import _sm_count

        grid, span, held, smem = _classmix_plan(b, h, w, c, _sm_count(data.device))
        with torch.cuda.device(data.device):
            err = lib.u2pl_unsup_class_mix(
                data.data_ptr(), target.data_ptr(), logits.data_ptr(), draws.data_ptr(),
                tickets(data.device)[TICKET_CLASSMIX].data_ptr(), img_out.data_ptr(),
                lab_out.data_ptr(), prob_out.data_ptr(), b, data.shape[1], h, w, c, grid, span,
                held, smem, torch.cuda.current_stream(data.device).cuda_stream,
            )
        check(lib, err, "unsup_class_mix launch")
        generate_unsup_data.classmix_launches += 1
        return img_out, lab_out, prob_out
    boxes = draws
    if boxes.device != data.device or boxes.dtype != torch.int32 or not boxes.is_contiguous():
        raise TypeError("generate_unsup_data: boxes must be contiguous int32 on the card")
    with torch.cuda.device(data.device):
        err = lib.u2pl_unsup_mix_boxes(
            data.data_ptr(), target.data_ptr(), logits.data_ptr(), boxes.data_ptr(),
            img_out.data_ptr(), lab_out.data_ptr(), prob_out.data_ptr(),
            b, data.shape[1], h, w, int(mode == "cutout"), int(ignore_label),
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    check(lib, err, "unsup_mix_boxes launch")
    generate_unsup_data.launches += 1
    return img_out, lab_out, prob_out


generate_unsup_data.launches = 0
generate_unsup_data.classmix_launches = 0

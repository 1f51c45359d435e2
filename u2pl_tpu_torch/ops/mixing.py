"""Strong augmentation of the unlabeled batch: the CutMix / Cutout box modes
(port of u2pl_tpu/ops/mixing.py).

The box geometry is drawn apart from its application, so a test can feed
both packages the same draws: `boxes_from_uniforms` turns three uniforms
per sample into (y0, x0, h, w) with the JAX package's own float32 formulas
(`_randint`, `_cutout_box_mask`: width ~ U{W/ratio+1, ..., W-1}, height =
round(area/ratio / width) (half to even in both), uniform placement), and
`draw_boxes` takes the uniforms from a `torch.Generator`.
`generate_unsup_data` applies the boxes: kernel K3
(`kernels/csrc/mixing.cu`) on the card, `torch.where` with the box masks on
the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

MODES = ("cutmix", "cutout")


def check_mode(mode: str) -> None:
    """Raise unless `mode` is a ported `unsupervised.apply_aug` mode."""
    if mode == "classmix":
        raise NotImplementedError(
            "apply_aug: classmix is not ported yet (ROADMAP.md queue 1, "
            "'ClassMix'); no experiment config uses it"
        )
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
    boxes: torch.Tensor,
    mode: str,
    ignore_label: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K3."""
    inside = box_masks(boxes, target.shape[1], target.shape[2])
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


def generate_unsup_data(
    data: torch.Tensor,
    target: torch.Tensor,
    logits: torch.Tensor,
    boxes: torch.Tensor,
    mode: str,
    ignore_label: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX `generate_unsup_data` for the box modes, with the boxes given.

    data (B, 3, H, W) f32; target (B, H, W) int32 pseudo-labels; logits
    (B, H, W) f32 max teacher prob; boxes (B, 4) int32 (y0, x0, h, w).
    cutmix: inside sample i's box, take sample (i+1) % B's pixel;
    cutout: inside the box, zero image and max-prob and ignore the label."""
    check_mode(mode)
    b, h, w = target.shape
    if data.dim() != 4 or data.shape[0] != b or data.shape[2:] != (h, w) or (
        logits.shape != target.shape or boxes.shape != (b, 4)
    ):
        raise ValueError(
            f"generate_unsup_data: data {tuple(data.shape)}, target "
            f"{tuple(target.shape)}, logits {tuple(logits.shape)}, boxes {tuple(boxes.shape)}"
        )
    if data.device.type == "cpu":
        return generate_unsup_data_plain(data, target, logits, boxes, mode, ignore_label)
    from u2pl_tpu_torch.ops.resize import _check_cuda_f32

    _check_cuda_f32(data, 4, "generate_unsup_data")
    _check_cuda_f32(logits, 3, "generate_unsup_data logits")
    for name, t in (("target", target), ("boxes", boxes)):
        if t.device != data.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"generate_unsup_data: {name} must be contiguous int32 on the card")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    img_out, lab_out, prob_out = (
        torch.empty_like(data), torch.empty_like(target), torch.empty_like(logits)
    )
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

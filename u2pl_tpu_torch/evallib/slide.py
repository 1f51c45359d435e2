"""Sliding-window / multi-scale offline evaluation (port of
u2pl_tpu/evallib/slide.py; reference eval.py:158-339).

  * make_net_process: forward + align-corners upsample to the input size
    (eval.py:158-181);
  * scale_crop_process: pad to the crop with zeros, the overlapping crop
    grid with stride ceil(crop * 2/3), every crop of the grid in one
    batched forward, the logits summed into a canvas crop by crop in
    raster order and divided by the visit counts, unpadded, resized to
    (h, w) (eval.py:184-223);
  * scale_whole_process: the whole-image forward (eval.py:226-232);
  * predict_city / predict_whole: the multi-scale loops, long-side scaling
    for Cityscapes (eval.py:269-282), h * scale, w * scale for VOC
    (eval.py:330-336), Python `round` for the scaled sizes, then the
    first-maximum argmax.

Everything stays on the image's device as (C, H, W) tensors: the image,
the crops, the canvas, the counts and the running total.  The canvas
arithmetic is the JAX version's elementwise float32 in its order, so it is
the same to the bit; the resizes are kernel A (`resize_bilinear`) and the
last resize with its argmax is kernel B (`resize_argmax`), which agree
with the JAX package's dense numpy resize to about an ulp.  With one scale
kernel B resizes the scale's logits to (h, w) itself; with several it
takes the summed total at its own size, where the align-corners taps are
the identity and exact.  The bucketed whole-image forward of the JAX
package (slide.py:35-101) is not ported: it exists to avoid XLA
recompiles.

A bfloat16 model (`--dtype bfloat16`) rounds where the JAX package's does.
The jaxpr of `make_net_process`'s `fwd` (u2pl_tpu/evallib/slide.py:116-119)
for a bf16 model, from the classifier's last conv on: the conv and its
bias add in bf16, then `convert_element_type` bf16 -> f32 (exact), the two
f32 interpolation dots, and one `convert_element_type` f32 -> bf16 of the
upsampled logits: the narrow resize's single rounding, kernel A's narrow
bf16 mode here.  After `fwd`, every JAX resize of those logits is
`resize_bilinear_numpy`, which widens them to f32 first
(u2pl_tpu/ops/resize.py:233), and the canvas, the multi-scale total and
the argmax are numpy f32: nothing is rounded again.  So here the logits
leave `net_process` in bf16; the crop grid adds them into its f32 canvas
by exact upcast (`pred += lg`, as numpy's f32 += bf16), a scale's resize
back to (h, w) is kernel A's bf16-in, f32-out mode, the total is f32, and
kernel B takes a single scale's bf16 logits, widening each on load.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from u2pl_tpu_torch.ops.resize import resize_argmax, resize_bilinear

# crops of one (image, scale) per forward; more are run in chunks (the sum
# does not change).  32 is Cityscapes' 769² grid at scale 2.0, 2048 x 4096.
MAX_CROPS_PER_FORWARD = 32


def make_net_process(model: torch.nn.Module) -> Callable:
    """Returns f(images (B, 3, H, W) float32 on the model's device) ->
    logits (B, C, H, W) there in the model's compute dtype, upsampled to the
    input size (kernel A on the card; a bf16 model's logits take its narrow
    bf16 mode, rounded once, as JAX's).

    Unlike the JAX version there is no compiled program per batch shape to
    reuse, so a partial batch is run as it is, not zero-padded."""
    model.eval()

    @torch.inference_mode()
    def net_process(images: torch.Tensor) -> torch.Tensor:
        pred = model(images)["pred"]
        return resize_bilinear(pred, images.shape[2:], align_corners=True)

    return net_process


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, H, W) -> (C, h, w) float32, align corners (kernel A on the card;
    bf16 logits take its bf16-in, f32-out mode: `resize_bilinear_numpy`)."""
    return resize_bilinear(x[None].contiguous(), (h, w), align_corners=True,
                           out_dtype=torch.float32)[0]


def crop_grid_logits(
    net_process: Callable,
    image: torch.Tensor,
    classes: int,
    crop_h: int,
    crop_w: int,
    stride_rate: float = 2.0 / 3.0,
) -> torch.Tensor:
    """The crop grid's averaged logits (classes, H, W) of a (3, H, W) image,
    before the resize to the output size."""
    _, ori_h, ori_w = image.shape
    pad_h = max(crop_h - ori_h, 0)
    pad_w = max(crop_w - ori_w, 0)
    ph0, pw0 = pad_h // 2, pad_w // 2
    if pad_h > 0 or pad_w > 0:
        image = F.pad(image, (pw0, pad_w - pw0, ph0, pad_h - ph0), value=0.0)
    _, new_h, new_w = image.shape
    stride_h = int(math.ceil(crop_h * stride_rate))
    stride_w = int(math.ceil(crop_w * stride_rate))
    grid_h = int(math.ceil(float(new_h - crop_h) / stride_h) + 1)
    grid_w = int(math.ceil(float(new_w - crop_w) / stride_w) + 1)

    coords = []
    for ih in range(grid_h):
        for iw in range(grid_w):
            s_h = min(ih * stride_h + crop_h, new_h) - crop_h
            s_w = min(iw * stride_w + crop_w, new_w) - crop_w
            coords.append((s_h, s_w))
    crops = torch.stack([image[:, s_h:s_h + crop_h, s_w:s_w + crop_w] for s_h, s_w in coords])
    logits = torch.cat([net_process(crops[i:i + MAX_CROPS_PER_FORWARD])
                        for i in range(0, len(coords), MAX_CROPS_PER_FORWARD)])

    pred = torch.zeros((classes, new_h, new_w), dtype=torch.float32, device=image.device)
    count = torch.zeros((new_h, new_w), dtype=torch.float32, device=image.device)
    for (s_h, s_w), lg in zip(coords, logits):
        pred[:, s_h:s_h + crop_h, s_w:s_w + crop_w] += lg.float()  # bf16: exact
        count[s_h:s_h + crop_h, s_w:s_w + crop_w] += 1
    pred /= count
    return pred[:, ph0:ph0 + ori_h, pw0:pw0 + ori_w]


def scale_crop_process(
    net_process: Callable,
    image: torch.Tensor,  # (3, H, W) normalized
    classes: int,
    crop_h: int,
    crop_w: int,
    h: int,
    w: int,
    stride_rate: float = 2.0 / 3.0,
) -> torch.Tensor:
    """The crop grid's logits resized to (classes, h, w)."""
    pred = crop_grid_logits(net_process, image, classes, crop_h, crop_w, stride_rate)
    return _resize(pred, h, w)


def scale_whole_process(
    net_process: Callable, image: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """The whole-image forward's logits resized to (classes, h, w)."""
    return _resize(net_process(image[None])[0], h, w)


def _argmax_over_scales(scales, logits_at: Callable, h: int, w: int) -> torch.Tensor:
    """uint8 (h, w) first-maximum argmax of the sum over `scales` of each
    scale's logits (`logits_at(scale)`, at their own size, f32 or bf16)
    resized to (h, w) in f32: kernel B on the one scale's logits, or on the
    f32 total at its own size.  The sum is JAX's, scales in order (JAX adds
    the first to zeros: the same value)."""
    if len(scales) == 1:
        return resize_argmax(logits_at(scales[0]).contiguous(), (h, w), align_corners=True)
    total = None
    for scale in scales:
        up = _resize(logits_at(scale), h, w)
        total = up if total is None else total + up
    return resize_argmax(total, (h, w), align_corners=True)


def predict_city(
    net_process: Callable,
    image: torch.Tensor,
    classes: int,
    base_size: int,
    crop_h: int,
    crop_w: int,
    scales: Sequence[float],
) -> torch.Tensor:
    """Multi-scale crop-grid prediction -> uint8 (h, w) mask on the image's
    device (eval.py:268-283)."""
    _, h, w = image.shape

    def logits_at(scale):
        long_size = round(scale * base_size)
        new_h = new_w = long_size
        if h > w:
            new_w = round(long_size / float(h) * w)
        else:
            new_h = round(long_size / float(w) * h)
        scaled = _resize(image, new_h, new_w)
        return crop_grid_logits(net_process, scaled, classes, crop_h, crop_w)

    return _argmax_over_scales(scales, logits_at, h, w)


def predict_whole(
    net_process: Callable,
    image: torch.Tensor,
    classes: int,
    scales: Sequence[float],
) -> torch.Tensor:
    """Whole-image multi-scale prediction -> uint8 (h, w) mask on the
    image's device (eval.py:328-339)."""
    _, h, w = image.shape

    def logits_at(scale):
        return net_process(_resize(image, round(h * scale), round(w * scale))[None])[0]

    return _argmax_over_scales(scales, logits_at, h, w)

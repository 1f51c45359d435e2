"""Host-side geometric augmentation (numpy / cv2 / scipy; port of
u2pl_tpu/data/transforms.py).

The reference's transform stack (dataset/augmentation.py): normalize,
random resize (bilinear with half-pixel centres for images, cv2
INTER_LINEAR or the port's numpy resize, align_corners=False; floor-index
nearest for labels, torch mode="nearest"), random rotation, gaussian blur
(radius 2, sigma 0.3*(r-1)+0.8, zero padding; augmentation.py:325-346),
horizontal flip and crop-with-padding; the Cityscapes builder's host
`Cutout` and `Cutmix` come after the crop.

Kept quirk: `Crop` pads labels with 0, not ignore_label
(augmentation.py:242-243), as every published number was trained with it.

Randomness: python `random` (and numpy for Cutout / Cutmix), as the
reference draws it, so the same seed gives the same samples as the JAX
package.  `FusedNativeTransform` makes the same `random` calls in the same
order and does the arithmetic in one C++ pass (`data/native.py`); it is
taken wherever the JAX package takes it.
"""

from __future__ import annotations

import os
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from scipy.ndimage import convolve as nd_convolve
from scipy.ndimage import gaussian_filter

from u2pl_tpu_torch.config import SplitCfg
from u2pl_tpu_torch.ops.resize import _nearest_index_np, resize_bilinear_numpy

Sample = Tuple[np.ndarray, np.ndarray]  # (img HWC float32, label HW int32)


def _resize_img(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = int(size[0]), int(size[1])
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return resize_bilinear_numpy(img, (h, w), align_corners=False)


def _resize_label(label: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = int(size[0]), int(size[1])
    return label[_nearest_index_np(label.shape[0], h)][:, _nearest_index_np(label.shape[1], w)]


class Normalize:
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, label):
        return (img - self.mean) / self.std, label


class Resize:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, label):
        return _resize_img(img, self.size), _resize_label(label, self.size)


class RandResize:
    """augmentation.py:159-211: scale s_min + (1 - s_min) * u with p 0.5,
    else 1 + (s_max - 1) * u."""

    def __init__(self, scale, aspect_ratio=None):
        self.scale = scale
        self.aspect_ratio = aspect_ratio

    def __call__(self, img, label):
        if random.random() < 0.5:
            temp_scale = self.scale[0] + (1.0 - self.scale[0]) * random.random()
        else:
            temp_scale = 1.0 + (self.scale[1] - 1.0) * random.random()
        temp_ar = 1.0
        if self.aspect_ratio is not None:
            temp_ar = self.aspect_ratio[0] + (
                self.aspect_ratio[1] - self.aspect_ratio[0]
            ) * random.random()
            temp_ar = float(np.sqrt(temp_ar))
        h, w = img.shape[:2]
        new_w = int(w * temp_scale * temp_ar)
        new_h = int(h * temp_scale / temp_ar)
        return _resize_img(img, (new_h, new_w)), _resize_label(label, (new_h, new_w))


class RandRotate:
    """augmentation.py:269-296 (no shipped config uses it): rotate by a
    uniform angle; label pixels from outside the frame become ignore_label.
    Needs cv2 (without it the sample passes unrotated, as in the JAX
    package)."""

    def __init__(self, rotate, ignore_label=255):
        self.rotate = rotate
        self.ignore_label = ignore_label

    def __call__(self, img, label):
        angle = self.rotate[0] + (self.rotate[1] - self.rotate[0]) * random.random()
        h, w = img.shape[:2]
        if cv2 is None:
            return img, label
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1)
        img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR, borderValue=0.0)
        lab = cv2.warpAffine((label + 1).astype(np.float32), m, (w, h),
                             flags=cv2.INTER_NEAREST, borderValue=0.0)
        lab[lab == 0] = self.ignore_label + 1
        return img, (lab - 1).astype(label.dtype)


class RandomHorizontalFlip:
    def __call__(self, img, label):
        if random.random() < 0.5:
            return img[:, ::-1].copy(), label[:, ::-1].copy()
        return img, label


def gaussian_kernel(radius: int = 2) -> np.ndarray:
    """The reference's kernel: gaussian_filter of a delta on a (2r+1)^2
    grid, sigma = 0.3*(r-1)+0.8 (augmentation.py:329-343)."""
    k = 2 * radius + 1
    delta = np.zeros((k, k), np.float32)
    delta[radius, radius] = 1
    return gaussian_filter(delta, sigma=0.3 * (radius - 1) + 0.8).astype(np.float32)


class RandomGaussianBlur:
    def __init__(self, radius: int = 2):
        self.kernel = gaussian_kernel(radius)

    def __call__(self, img, label):
        if random.random() < 0.5:
            out = np.empty_like(img)
            for c in range(img.shape[2]):
                # zero padding, as torch conv2d(padding=radius) on the border
                out[:, :, c] = nd_convolve(img[:, :, c], self.kernel, mode="constant", cval=0.0)
            img = out
        return img, label


class Crop:
    """augmentation.py:214-266, with the label-pad-0 quirk (:242-243)."""

    def __init__(self, size, crop_type="center", ignore_label=255, pad_label_zero=True,
                 img_pad=None):
        self.ch, self.cw = (size, size) if isinstance(size, int) else size
        self.crop_type = crop_type
        self.pad_label = 0 if pad_label_zero else ignore_label
        self.img_pad = img_pad  # per-channel image pad (uint8 output); else 0

    def __call__(self, img, label):
        h, w = img.shape[:2]
        pad_h = max(self.ch - h, 0)
        pad_w = max(self.cw - w, 0)
        if pad_h > 0 or pad_w > 0:
            pads = ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))
            if self.img_pad is None:
                img = np.pad(img, pads + ((0, 0),), constant_values=0.0)
            else:
                img = np.stack([np.pad(img[:, :, c], pads, constant_values=self.img_pad[c])
                                for c in range(img.shape[2])], axis=-1)
            label = np.pad(label, pads, constant_values=self.pad_label)
        h, w = img.shape[:2]
        if self.crop_type == "rand":
            y0 = random.randint(0, h - self.ch)
            x0 = random.randint(0, w - self.cw)
        else:
            y0 = (h - self.ch) // 2
            x0 = (w - self.cw) // 2
        return (
            np.ascontiguousarray(img[y0 : y0 + self.ch, x0 : x0 + self.cw]),
            np.ascontiguousarray(label[y0 : y0 + self.ch, x0 : x0 + self.cw]),
        )


class Cutout:
    """Host cutout (augmentation.py:349-395) of the Cityscapes transform
    builder (cityscapes.py:70-72): returns the reference's 5-tuple
    (img_origin, label_origin, img, label, valid)."""

    def __init__(self, n_holes: int, length: int):
        self.n_holes = n_holes
        self.length = length

    def __call__(self, img, label):
        h, w = img.shape[:2]
        img_origin, label_origin = img.copy(), label.copy()
        mask = np.ones((h, w), np.float32)
        valid = np.zeros((h, w), np.float32)
        for _ in range(self.n_holes):
            y = np.random.randint(h)
            x = np.random.randint(w)
            y1, y2 = np.clip(y - self.length // 2, 0, h), np.clip(y + self.length // 2, 0, h)
            x1, x2 = np.clip(x - self.length // 2, 0, w), np.clip(x + self.length // 2, 0, w)
            mask[y1:y2, x1:x2] = 0.0
            valid[y1:y2, x1:x2] = 255
        return img_origin, label_origin, img * mask[:, :, None], label, valid


class Cutmix:
    """Host cutmix mask generator (augmentation.py:398-468): returns (img,
    label, masks) with box masks drawn from the prop_range area
    distribution."""

    def __init__(self, prop_range, n_holes: int = 1, random_aspect_ratio=True,
                 within_bounds=True):
        self.prop_range = (prop_range, prop_range) if isinstance(prop_range, float) else prop_range
        self.n_holes = n_holes
        self.random_aspect_ratio = random_aspect_ratio
        self.within_bounds = within_bounds

    def __call__(self, img, label):
        h, w = img.shape[:2]
        n_masks = 1
        props = np.random.uniform(*self.prop_range, size=(n_masks, self.n_holes))
        if self.random_aspect_ratio:
            y_props = np.exp(np.random.uniform(0, 1, (n_masks, self.n_holes)) * np.log(props))
            x_props = props / y_props
        else:
            y_props = x_props = np.sqrt(props)
        fac = np.sqrt(1.0 / self.n_holes)
        y_props, x_props = y_props * fac, x_props * fac
        sizes = np.round(np.stack([y_props, x_props], 2) * np.array((h, w))[None, None, :])
        positions = np.round((np.array((h, w)) - sizes) * np.random.uniform(0, 1, sizes.shape))
        rectangles = np.append(positions, positions + sizes, axis=2)
        masks = np.zeros((n_masks, 1, h, w), np.float32)
        for i, sample_rect in enumerate(rectangles):
            for y0, x0, y1, x1 in sample_rect:
                masks[i, 0, int(y0) : int(y1), int(x0) : int(x1)] = 1
        return img, label, masks


class FusedNativeTransform:
    """normalize -> rand_resize -> hflip -> crop-with-pad in one C++ pass
    (`data/native.py`), with the SAME python `random` calls as the
    sequential transforms, so the samples follow the numpy path's for a
    given seed (the image to float32 rounding of the resample)."""

    def __init__(self, split_cfg: SplitCfg, mean, std, output_u8: bool = False):
        self.rand_resize = split_cfg.rand_resize
        self.flip = split_cfg.flip
        assert split_cfg.crop is not None
        self.crop_h, self.crop_w = split_cfg.crop.size
        self.crop_rand = split_cfg.crop.type == "rand"
        self.output_u8 = output_u8
        if output_u8:  # the device normalizes: raw resampled bytes, padded with round(mean)
            self.pad_rgb = np.rint(np.asarray(mean, np.float32))
            self.mean = np.zeros(3, np.float32)
            self.std = np.ones(3, np.float32)
        else:
            self.pad_rgb = np.zeros(3, np.float32)
            self.mean = np.asarray(mean, np.float32)
            self.std = np.asarray(std, np.float32)
        self.pad_label = 0  # the reference quirk (augmentation.py:242-243)

    def __call__(self, img: np.ndarray, label: np.ndarray) -> Sample:
        from u2pl_tpu_torch.data import native

        h, w = img.shape[:2]
        if self.rand_resize:
            if random.random() < 0.5:
                s = self.rand_resize[0] + (1.0 - self.rand_resize[0]) * random.random()
            else:
                s = 1.0 + (self.rand_resize[1] - 1.0) * random.random()
            new_h, new_w = int(h * s), int(w * s)
        else:
            new_h, new_w = h, w
        flip = self.flip and random.random() < 0.5
        padded_h = max(new_h, self.crop_h)
        padded_w = max(new_w, self.crop_w)
        if self.crop_rand:
            off_y = random.randint(0, padded_h - self.crop_h)
            off_x = random.randint(0, padded_w - self.crop_w)
        else:
            off_y = (padded_h - self.crop_h) // 2
            off_x = (padded_w - self.crop_w) // 2
        out_img, out_lab = native.augment_sample(
            np.ascontiguousarray(img, np.uint8), np.ascontiguousarray(label, np.uint8),
            self.mean, self.std, new_h, new_w, flip, self.crop_h, self.crop_w, off_y, off_x,
            self.pad_label, self.pad_rgb,
        )
        if self.output_u8:
            out_img = np.clip(np.rint(out_img), 0, 255).astype(np.uint8)
        return out_img, out_lab


def native_fast_path_ok(split_cfg: SplitCfg) -> bool:
    """Whether the fused C++ path applies (transforms.py:370-385 of the JAX
    package): a crop, and no blur, rotation, fixed resize, cutout or
    cutmix.  U2PL_TPU_NO_NATIVE turns it off, as there.  The library is
    built at first use; a failed build raises, never falling back."""
    if os.environ.get("U2PL_TPU_NO_NATIVE") or split_cfg.crop is None:
        return False
    if split_cfg.gaussian_blur or split_cfg.rand_rotation or split_cfg.resize:
        return False
    return not (split_cfg.cutout or split_cfg.cutmix)


def build_transform(
    split_cfg: SplitCfg,
    mean: Sequence[float],
    std: Sequence[float],
    ignore_label: int,
    output_u8: bool = False,
) -> Callable[[np.ndarray, np.ndarray], Sample]:
    """The reference's build_transfrom (pascal_voc.py:48-71), fused in C++
    where `native_fast_path_ok`.  output_u8: raw uint8 crops, normalized on
    the device (`dataset.device_normalize`)."""
    if native_fast_path_ok(split_cfg):
        return FusedNativeTransform(split_cfg, mean, std, output_u8)
    ts: List[Callable] = [] if output_u8 else [Normalize(mean, std)]
    img_pad = tuple(float(v) for v in np.rint(np.asarray(mean))) if output_u8 else None
    if split_cfg.resize:
        ts.append(Resize(split_cfg.resize))
    if split_cfg.rand_resize:
        ts.append(RandResize(split_cfg.rand_resize))
    if split_cfg.rand_rotation:
        ts.append(RandRotate(split_cfg.rand_rotation, ignore_label))
    if split_cfg.gaussian_blur:
        ts.append(RandomGaussianBlur())
    if split_cfg.flip:
        ts.append(RandomHorizontalFlip())
    if split_cfg.crop:
        ts.append(Crop(split_cfg.crop.size, split_cfg.crop.type, ignore_label, img_pad=img_pad))
    # cutout / cutmix come after the crop, Cityscapes builder only (reference
    # cityscapes.py:70-78), and switch the output to the reference Compose's
    # 5-tuple / mask-triple protocol (augmentation.py:31-47)
    tail = None
    if split_cfg.cutout:
        tail = Cutout(split_cfg.cutout.n_holes, split_cfg.cutout.length)
    elif split_cfg.cutmix:
        tail = Cutmix(split_cfg.cutmix.prop_range, split_cfg.cutmix.n_holes)

    return Compose(ts, tail, output_u8)


class Compose:
    """The numpy pipeline: `ts` in order on (float32 image, int32 label),
    then the optional Cityscapes `tail`.  A plain object, so a process-mode
    loader can pickle it to its spawned workers."""

    def __init__(self, ts: List[Callable], tail: Optional[Callable], output_u8: bool):
        self.ts, self.tail, self.output_u8 = ts, tail, output_u8

    def __call__(self, img: np.ndarray, label: np.ndarray):
        img = img.astype(np.float32)
        label = label.astype(np.int32)
        for t in self.ts:
            img, label = t(img, label)
        if self.output_u8:
            img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        if self.tail is not None:
            return self.tail(img, label)
        return img, label

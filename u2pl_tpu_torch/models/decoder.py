"""ASPP + DeepLabv3(+) decoders and aux head (PyTorch / NCHW), port of
u2pl_tpu/models/decoder.py.

Module names follow the reference torch modules, i.e. the keys
`u2pl_tpu.utils.convert_torch._translate` emits (`aspp.conv1.{1,2}`,
`aspp.conv{2..}.{0,1}`, `low_conv.{0,1}`, `head.{0,1[,4]}`,
`classifier.{0,1,4,5,8}`, `representation.*`, `aux.{0,1,4}`).  Flax's
spatially broadcast Dropout is `Dropout2d`; it is active in train mode only
and draws its masks from the generator `SegModel.forward` hands it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from u2pl_tpu_torch.models.resnet import conv1x1, conv3x3, norm
from u2pl_tpu_torch.ops.resize import resize_bilinear


class Dropout2d(nn.Module):
    """`nn.Dropout2d` semantics (whole channels per sample, kept ones scaled
    by 1/(1-p)) with the mask drawn from `self.generator`, never from torch's
    global RNG.  `SegModel.forward(x, generator)` sets the generator for the
    length of one forward; in train mode with p > 0 and no generator it
    raises.  flax's `Dropout(broadcast_dims=(1, 2))` is the same function,
    `where(keep, x / (1 - p), 0)`."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise ValueError(
                "Dropout2d in train mode draws from a generator: call the model "
                "as model(x, generator=g)"
            )
        keep_p = 1.0 - self.p
        probs = torch.full(x.shape[:2] + (1, 1), keep_p, dtype=x.dtype, device=x.device)
        keep = torch.bernoulli(probs, generator=self.generator).bool()
        return torch.where(keep, x / keep_p, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


class ASPP(nn.Module):
    def __init__(self, in_planes: int, inner_planes=256, dilations=(12, 24, 36)):
        super().__init__()
        # image-pool branch: f32 mean -> 1x1 -> BN -> ReLU, broadcast back
        # (the reference's align-corners upsample of a 1x1 map)
        self.conv1 = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), conv1x1(in_planes, inner_planes),
            norm(inner_planes), nn.ReLU(),
        )
        self.conv2 = nn.Sequential(
            conv1x1(in_planes, inner_planes), norm(inner_planes), nn.ReLU()
        )
        for i, d in enumerate(dilations):
            self.add_module(
                f"conv{3 + i}",
                nn.Sequential(
                    conv3x3(in_planes, inner_planes, dilation=d),
                    norm(inner_planes), nn.ReLU(),
                ),
            )
        self.n_branches = 2 + len(dilations)
        self.out_planes = self.n_branches * inner_planes

    def forward(self, x):
        b, _, h, w = x.shape
        pooled = self.conv1(x)
        feats = [pooled.expand(b, pooled.shape[1], h, w)]
        feats += [getattr(self, f"conv{i}")(x) for i in range(2, self.n_branches + 1)]
        return torch.cat(feats, dim=1)


def _head_stack(in_planes: int, out_planes: int) -> nn.Sequential:
    """classifier / representation tower: two 3x3 conv+BN+ReLU+Dropout2d,
    then a 1x1 projection (reference decoder.py:82-106)."""
    return nn.Sequential(
        conv3x3(in_planes, 256, bias=True), norm(256), nn.ReLU(), Dropout2d(0.1),
        conv3x3(256, 256, bias=True), norm(256), nn.ReLU(), Dropout2d(0.1),
        conv1x1(256, out_planes, bias=True),
    )


class DeepLabV3Plus(nn.Module):
    def __init__(
        self,
        in_planes: int,
        low_planes: int,
        num_classes: int = 21,
        inner_planes: int = 256,
        dilations: Sequence[int] = (12, 24, 36),
        rep_head: bool = True,
    ):
        super().__init__()
        self.aspp = ASPP(in_planes, inner_planes, dilations)
        self.low_conv = nn.Sequential(
            conv1x1(low_planes, 256, bias=True), norm(256), nn.ReLU()
        )
        self.head = nn.Sequential(
            conv3x3(self.aspp.out_planes, 256), norm(256), nn.ReLU(),
            Dropout2d(0.1),
        )
        self.classifier = _head_stack(512, num_classes)
        self.representation = _head_stack(512, 256) if rep_head else None

    def forward(self, feats):
        x1, _, _, x4 = feats
        low = self.low_conv(x1)
        h = self.head(self.aspp(x4))
        # os8 -> os4 align-corners upsample: kernel A on the card
        h = resize_bilinear(h, low.shape[2:], align_corners=True)
        h = torch.cat([low, h], dim=1)
        out = {"pred": self.classifier(h)}
        if self.representation is not None:
            out["rep"] = self.representation(h)
        return out


class DeepLabV3(nn.Module):
    """Plain DeepLabv3 decoder: ASPP -> 3x3 head -> 1x1 logits."""

    def __init__(
        self,
        in_planes: int,
        num_classes: int = 19,
        inner_planes: int = 256,
        dilations: Sequence[int] = (12, 24, 36),
    ):
        super().__init__()
        self.aspp = ASPP(in_planes, inner_planes, dilations)
        self.head = nn.Sequential(
            conv3x3(self.aspp.out_planes, 256), norm(256), nn.ReLU(),
            Dropout2d(0.1), conv1x1(256, num_classes, bias=True),
        )

    def forward(self, feats):
        return {"pred": self.head(self.aspp(feats[-1]))}


class AuxHead(nn.Module):
    """3x3 conv -> BN -> ReLU -> Dropout2d -> 1x1 logits on the layer3
    feature (reference decoder.py:127-142)."""

    def __init__(self, in_planes: int, num_classes: int = 19):
        super().__init__()
        self.aux = nn.Sequential(
            conv3x3(in_planes, 256, bias=True), norm(256), nn.ReLU(),
            Dropout2d(0.1), conv1x1(256, num_classes, bias=True),
        )

    def forward(self, x):
        return self.aux(x)

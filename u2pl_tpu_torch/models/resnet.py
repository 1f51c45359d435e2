"""Deep-stem dilated ResNet encoder (PyTorch / NCHW), port of
u2pl_tpu/models/resnet.py.

Module names are the reference torch names (`conv1.{0,1,3,4,6}`, `bn1`,
`layer{1..4}.{i}.{conv,bn}{1,2,3}`, `downsample.{0,1}`), i.e. exactly the
keys `u2pl_tpu.utils.convert_torch._translate` emits, so reference `.pth`
checkpoints and `utils.convert_jax.flax_to_torch` output load strictly.

bfloat16 compute (`net.dtype: bfloat16`) follows the JAX package's flax
policy, not autocast: parameters stay float32; a `Conv2d` on a bf16 input
casts its kernel and bias to bf16, convolves to a bf16 output and adds the
bias to it apart, in bf16, as flax `Conv(dtype=bf16)` does; `BatchNorm2d`
takes its statistics and normalises in float32 and casts the result once
(flax 0.12.3 `_normalize`).  Each layer computes in its input's dtype, and
`SegModel` casts the image to its compute dtype; on a float32 input every
layer is its float32 self, bit for bit.

Not ported: the space-to-depth stem lowering (a TPU lane-filling rewrite
taken under bfloat16 only: the same linear map, summed in another order)
and the `valid_hw` masked forward (it exists to avoid XLA recompiles per
image size).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` on a float32 input; on a bf16 input flax's `Conv` under
    `dtype=bf16`: kernel and bias cast to bf16, the convolution's output in
    bf16, then the bias added to it (rounded again, unlike a fused bias)."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y


def conv3x3(cin: int, cout: int, stride: int = 1, dilation: int = 1, bias=False):
    return Conv2d(
        cin, cout, 3, stride=stride, padding=dilation, dilation=dilation, bias=bias
    )


def conv1x1(cin: int, cout: int, stride: int = 1, bias=False):
    return Conv2d(cin, cout, 1, stride=stride, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """flax `BatchNorm` semantics: in train mode the running variance moves
    towards the BIASED batch variance (flax, u2pl_tpu/models/resnet.py:45-63),
    where torch's `BatchNorm2d` takes the unbiased one, larger by n/(n-1) —
    14% at n = 8 in the ASPP image-pool BN of a 4+4 step.  Normalisation
    itself (by the biased batch variance) is torch's own.  A bf16 input is
    normalised in float32 (its statistics too) and the result cast back
    once, as flax's `_normalize` does under `dtype=bf16`."""

    def forward(self, x):
        if x.dtype != torch.float32:
            return self._forward_f32(x.float()).to(x.dtype)
        return self._forward_f32(x)

    def _forward_f32(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def norm(planes: int) -> BatchNorm2d:
    # flax momentum 0.9 on the running average == torch momentum 0.1
    return BatchNorm2d(planes, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        # like the JAX BasicBlock, both 3x3 convs are undilated
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = norm(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = norm(planes)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn2

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = conv1x1(inplanes, planes)
        self.bn1 = norm(planes)
        self.conv2 = conv3x3(planes, planes, stride, dilation)
        self.bn2 = norm(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = norm(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn3

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """Deep-stem ResNet; layers e.g. (3, 4, 23, 3) for ResNet-101.  Returns
    [x1, x2, x3, x4] (fpn) or [x3, x4]."""

    def __init__(
        self,
        layers: Sequence[int] = (3, 4, 23, 3),
        block: str = "bottleneck",
        replace_stride_with_dilation: Sequence[bool] = (False, True, True),
        multi_grid: bool = False,
        zero_init_residual: bool = False,
        fpn: bool = True,
    ):
        super().__init__()
        self.block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.zero_init_residual = zero_init_residual
        self.fpn = fpn
        # deep stem (reference resnet.py:178-191)
        self.conv1 = nn.Sequential(
            conv3x3(3, 64, stride=2), norm(64), nn.ReLU(),
            conv3x3(64, 64), norm(64), nn.ReLU(),
            conv3x3(64, 128),
        )
        self.bn1 = norm(128)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True)

        # stage plan replicating the JAX package's (and reference
        # _make_layer's) dilation bookkeeping, u2pl_tpu/models/resnet.py:352-389
        expansion = self.block_cls.expansion
        inplanes = 128
        dilation = 1
        for si, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            blocks = layers[si]
            dilate = si > 0 and replace_stride_with_dilation[si - 1]
            previous_dilation = dilation
            if dilate:
                dilation *= stride
                stride = 1
            grids = [2, 2, 4] if si == 3 and multi_grid else [1] * blocks
            stage: List[nn.Module] = []
            for bi in range(blocks):
                first = bi == 0
                downsample = None
                if first and (stride != 1 or inplanes != planes * expansion):
                    downsample = nn.Sequential(
                        conv1x1(inplanes, planes * expansion, stride),
                        norm(planes * expansion),
                    )
                stage.append(
                    self.block_cls(
                        inplanes if first else planes * expansion,
                        planes,
                        stride=stride if first else 1,
                        dilation=(previous_dilation if first else dilation)
                        * grids[bi],
                        downsample=downsample,
                    )
                )
            inplanes = planes * expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*stage))

    @property
    def out_planes(self) -> int:
        return 512 * self.block_cls.expansion

    @property
    def aux_planes(self) -> int:
        return 256 * self.block_cls.expansion

    @property
    def low_planes(self) -> int:
        return 64 * self.block_cls.expansion

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        return [x1, x2, x3, x4] if self.fpn else [x3, x4]


def resnet_spec(name: str) -> dict:
    """Layer/block spec by reference factory name (JAX resnet.py:404-418)."""
    specs = {
        # tiny variant (not in the reference) for tests
        "resnet10": dict(layers=(1, 1, 1, 1), block="bottleneck"),
        "resnet18": dict(layers=(2, 2, 2, 2), block="basic"),
        "resnet34": dict(layers=(3, 4, 6, 3), block="basic"),
        "resnet50": dict(layers=(3, 4, 6, 3), block="bottleneck"),
        "resnet101": dict(layers=(3, 4, 23, 3), block="bottleneck"),
        "resnet152": dict(layers=(3, 8, 36, 3), block="bottleneck"),
    }
    key = name.rsplit(".", 1)[-1]
    if key not in specs:
        raise ValueError(f"unknown encoder type {name!r}")
    return specs[key]

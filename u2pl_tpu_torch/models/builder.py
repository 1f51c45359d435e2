"""Model assembly from the reference net config (port of
u2pl_tpu/models/builder.py): the same YAML `type` strings, the same
{"pred", "rep"?, "aux"?} output dict, in NCHW.

The model's compute dtype is `net.dtype` (float32 or bfloat16), as the JAX
`build_model` takes it: float32 parameters, the image cast to the compute
dtype on entry, every layer computing in its input's dtype
(models/resnet.py), so the outputs come out in the compute dtype.  It is
not autocast: the rounding points are flax's, held by the layers.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch
from torch import nn

from u2pl_tpu_torch.config import NetCfg
from u2pl_tpu_torch.models.decoder import AuxHead, DeepLabV3, DeepLabV3Plus, Dropout2d
from u2pl_tpu_torch.models.resnet import BatchNorm2d, ResNet, resnet_spec


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: Union[str, torch.dtype]) -> torch.dtype:
    """The torch dtype of a `net.dtype` name (or a torch dtype)."""
    if isinstance(name, torch.dtype):
        dtype = name
    elif str(name) in COMPUTE_DTYPES:
        dtype = COMPUTE_DTYPES[str(name)]
    else:
        raise ValueError(f"net.dtype {name!r}: one of {sorted(COMPUTE_DTYPES)}")
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    return dtype


class SegModel(nn.Module):
    """Encoder + decoder (+ aux head).  Outputs are at output-stride 4 (v3+)
    / 8 (v3); upsampling to image size is the caller's (evallib/slide.py).
    `dtype` is the compute dtype (module docstring)."""

    def __init__(self, net: NetCfg, dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = compute_dtype_of(dtype)
        spec = resnet_spec(net.encoder.type)
        self.encoder = ResNet(
            layers=spec["layers"],
            block=spec["block"],
            replace_stride_with_dilation=net.encoder.replace_stride_with_dilation,
            multi_grid=net.encoder.multi_grid,
            zero_init_residual=net.encoder.zero_init_residual,
            fpn=net.encoder.fpn,
        )
        dec_key = net.decoder.type.rsplit(".", 1)[-1]
        if dec_key == "dec_deeplabv3_plus":
            self.decoder = DeepLabV3Plus(
                self.encoder.out_planes,
                self.encoder.low_planes,
                num_classes=net.num_classes,
                inner_planes=net.decoder.inner_planes,
                dilations=net.decoder.dilations,
                rep_head=net.decoder.rep_head,
            )
        elif dec_key == "dec_deeplabv3":
            self.decoder = DeepLabV3(
                self.encoder.out_planes,
                num_classes=net.num_classes,
                inner_planes=net.decoder.inner_planes,
                dilations=net.decoder.dilations,
            )
        else:
            raise ValueError(f"unknown decoder type {net.decoder.type!r}")
        # aux head on the layer3 feature (the second-to-last encoder output)
        self.auxor = (
            AuxHead(self.encoder.aux_planes, net.num_classes)
            if net.aux_loss is not None
            else None
        )

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """{"pred", "rep"?, "aux"?} of NCHW `x`, in the compute dtype.  In
        train mode the dropout masks are drawn from `generator` (required
        when dropout is on)."""
        drops = [m for m in self.modules() if isinstance(m, Dropout2d)]
        for m in drops:
            m.generator = generator
        try:
            feats = self.encoder(x.to(self.dtype))
            outs = self.decoder(feats)
            if self.auxor is not None:
                outs["aux"] = self.auxor(feats[-2])
        finally:
            for m in drops:
                m.generator = None
        return outs


def init_weights(model: SegModel, generator: torch.Generator) -> None:
    """The JAX package's init, drawn from `generator`: kaiming-normal
    (fan_out) conv kernels, zero conv biases, BN gamma 1 / beta 0 (gamma 0
    on each residual branch's last BN under zero_init_residual), running
    mean 0 / var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(
                    m.weight, mode="fan_out", nonlinearity="relu", generator=generator
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        if model.encoder.zero_init_residual:
            for stage in (model.encoder.layer1, model.encoder.layer2,
                          model.encoder.layer3, model.encoder.layer4):
                for blk in stage:
                    blk.last_bn().weight.zero_()


@contextlib.contextmanager
def computing_in(model: SegModel, dtype: torch.dtype) -> Iterator[SegModel]:
    """`model` with compute dtype `dtype` for the length of the block, as
    JAX builds a float32 `model_eval` beside a bf16 training model
    (train_semi.py:96-99): the same parameters, another forward."""
    saved, model.dtype = model.dtype, compute_dtype_of(dtype)
    try:
        yield model
    finally:
        model.dtype = saved


def build_model(
    net: NetCfg,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
    dtype: Union[str, torch.dtype, None] = None,
) -> SegModel:
    """SegModel on `device` (the card unless the caller names the CPU) with
    float32 parameters and compute dtype `dtype` (`net.dtype` by default,
    as the JAX `build_model`), initialised from `generator` (a fresh seed-0
    CPU generator by default).  Built on the meta device first, so no
    global RNG is drawn; weights are then drawn on the CPU and moved."""
    with torch.device("meta"):
        model = SegModel(net, net.dtype if dtype is None else dtype)
    model = model.to_empty(device="cpu")
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(device)


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Every BatchNorm of `model` (encoder, decoder and aux head, as the JAX
    `build_model` passes `axis_name` to each norm, builder.py:92-99) takes
    its train-mode statistics over `group` (a `dist.Group`; None: the
    local batch).  The caller gates it on `net.sync_bn`."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return model

"""Online hard-example-mining cross-entropy (port of u2pl_tpu/losses/ohem.py),
the supervised loss of every Cityscapes config (criterion.type: ohem,
thresh 0.7, min_kept 100000), on the main and aux heads.

The JAX loss takes logits already upsampled to label size; the port takes
NCHW logits at their own stride and upsamples inside, as
`losses/ce.py:upsample_cross_entropy` does:
  * p_y = the softmax probability of each pixel's target class, 1.0 at
    ignored pixels, and the count of valid pixels (kernel
    `ohem_target_prob`, a mode of kernel D's staged kernel in
    `kernels/csrc/upsample_ce.cu`, launched on C's forward plan);
  * kth = the min(n, min_kept)-th smallest p_y over all n pixels, ignored
    ones included (`ops/quantile.kth_smallest`, a radix selection);
  * when min_kept <= num_valid (and num_valid > 0) keep the pixels with
    p_y <= max(f32 thresh, kth), else every valid pixel; every other pixel
    becomes ignored (kernel `ohem_keep_labels`);
  * the mean CE over the kept labels, the main head optionally with the
    19-class weights (kernel C, forward and backward).
No gradient flows through the selection, as in JAX.  Nothing is read back
to the host.  On bf16 logits p_y is taken from the f32 cast of the
bf16-rounded upsample (ohem.py:66-75) and the CE is kernel C's bf16 mode.
On a CPU tensor `ohem_cross_entropy` is its plain version
(`ohem_cross_entropy_plain`); on the card each kernel launches or raises.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from u2pl_tpu_torch.losses import ce
from u2pl_tpu_torch.ops import quantile
from u2pl_tpu_torch.ops.resize import (
    F32_BF16,
    _check_cuda,
    _device_taps,
    _sm_count,
    resize_bilinear_plain,
)

# use_weight=True vector (reference loss_helper.py:464-486; the JAX
# package's CITYSCAPES_OHEM_WEIGHT, u2pl_tpu/losses/ohem.py:28)
CITYSCAPES_OHEM_WEIGHT = (
    0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489, 0.8786,
    1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955, 1.0865, 1.1529,
    1.0507,
)


def _target_prob(up: torch.Tensor, labels: torch.Tensor, ignore_label: int):
    valid = labels != ignore_label
    target = torch.where(valid, labels, torch.zeros_like(labels)).long()
    prob = torch.softmax(up.float(), dim=1)
    p_y = torch.gather(prob, 1, target[:, None])[:, 0]
    p_y = torch.where(valid, p_y, torch.ones_like(p_y))
    return p_y, valid.sum().to(torch.int32)


def ohem_target_prob_plain(
    logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `ohem_target_prob`: kernel A's plain resize,
    softmax and a gather (ohem.py:66-75)."""
    up = resize_bilinear_plain(logits, labels.shape[1:])
    return _target_prob(up, labels, ignore_label)


@torch.no_grad()
def ohem_target_prob(
    logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p_y (B, H, W) f32, num_valid 0-d int32) of (B, C, h, w) logits
    upsampled to the (B, H, W) labels' size: the target class's softmax
    probability, 1.0 at ignored pixels (kernel `ohem_target_prob`)."""
    if logits.dim() != 4 or labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"ohem_target_prob: logits {tuple(logits.shape)}, labels {tuple(labels.shape)}"
        )
    if logits.device.type == "cpu":
        return ohem_target_prob_plain(logits, labels, ignore_label)
    _check_cuda(logits, 4, "ohem_target_prob", F32_BF16)
    _check_labels(labels, logits.device, "ohem_target_prob")
    b, c, h, w = logits.shape
    oh, ow = labels.shape[1:]
    if b * c * oh * ow >= 2**31:
        raise ValueError("ohem_target_prob: the upsampled logits exceed the int32 sizes")
    dev = logits.device
    p_y = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    num_valid = torch.empty((), dtype=torch.int32, device=dev)
    if labels.numel() == 0:
        return p_y, num_valid.zero_()
    from u2pl_tpu_torch.kernels import TICKET_OHEM_PROB, check, load, tickets

    lib = load()
    plan = ce._stats_launch(b, c, h, w, oh, ow, logits.dtype, _sm_count(dev))
    idx_h, w_h = _device_taps(h, oh, True, dev)
    idx_w, w_w = _device_taps(w, ow, True, dev)
    with torch.cuda.device(dev):
        err = lib.u2pl_ohem_target_prob(
            logits.data_ptr(), labels.data_ptr(), p_y.data_ptr(), num_valid.data_ptr(),
            tickets(dev)[TICKET_OHEM_PROB].data_ptr(), idx_h.data_ptr(), w_h.data_ptr(),
            idx_w.data_ptr(), w_w.data_ptr(), b, c, h, w, oh, ow, int(ignore_label),
            *plan, ce.LOGIT_DTYPES[logits.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "ohem_target_prob launch")
    ohem_target_prob.launches += 1
    ohem_target_prob.shapes[(h, w)] += 1
    return p_y, num_valid


ohem_target_prob.launches = 0
ohem_target_prob.shapes = collections.Counter()  # launches per logits' (h, w): per head


def ohem_keep_labels_plain(
    labels: torch.Tensor,
    p_y: torch.Tensor,
    kth: torch.Tensor,
    num_valid: torch.Tensor,
    thresh: float,
    min_kept: int,
    ignore_label: int = 255,
) -> torch.Tensor:
    """Plain PyTorch version of `ohem_keep_labels` (ohem.py:76-82)."""
    threshold = torch.maximum(torch.tensor(thresh, dtype=torch.float32, device=p_y.device), kth)
    apply = (num_valid > 0) & (num_valid >= min_kept)
    kept = torch.where(apply, p_y <= threshold, torch.ones_like(p_y, dtype=torch.bool))
    keep = (labels != ignore_label) & kept
    return torch.where(keep, labels, torch.full_like(labels, ignore_label))


@torch.no_grad()
def ohem_keep_labels(
    labels: torch.Tensor,
    p_y: torch.Tensor,
    kth: torch.Tensor,
    num_valid: torch.Tensor,
    thresh: float,
    min_kept: int,
    ignore_label: int = 255,
) -> torch.Tensor:
    """The labels of the kept pixels, `ignore_label` elsewhere: with
    threshold = max(f32 thresh, kth) and apply = num_valid > 0 and
    min_kept <= num_valid, a valid pixel is kept when not apply or
    p_y <= threshold (kernel `ohem_keep_labels`; kth and num_valid are 0-d
    device tensors, never read on the host)."""
    if p_y.shape != labels.shape:
        raise ValueError(f"ohem_keep_labels: p_y {tuple(p_y.shape)}, labels {tuple(labels.shape)}")
    if labels.device.type == "cpu":
        return ohem_keep_labels_plain(labels, p_y, kth, num_valid, thresh, min_kept, ignore_label)
    _check_cuda(p_y, p_y.dim(), "ohem_keep_labels p_y")
    _check_labels(labels, p_y.device, "ohem_keep_labels")
    scalars_ok = (kth.numel() == num_valid.numel() == 1 and kth.dtype == torch.float32
                  and num_valid.dtype == torch.int32
                  and kth.device == num_valid.device == p_y.device)
    if not scalars_ok:
        raise TypeError("ohem_keep_labels: kth f32 and num_valid int32, one each, on the device")
    from u2pl_tpu_torch.kernels import check, load

    lib = load()
    dev = p_y.device
    out = torch.empty_like(labels)
    with torch.cuda.device(dev):
        err = lib.u2pl_ohem_keep_labels(
            labels.data_ptr(), p_y.data_ptr(), kth.data_ptr(), num_valid.data_ptr(),
            out.data_ptr(), labels.numel(), float(thresh), min(int(min_kept), 2**31 - 1),
            int(ignore_label), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(lib, err, "ohem_keep_labels launch")
    ohem_keep_labels.launches += 1
    return out


ohem_keep_labels.launches = 0


def _check_labels(labels: torch.Tensor, device: torch.device, name: str) -> None:
    if labels.device != device or labels.dtype != torch.int32 or not labels.is_contiguous():
        raise TypeError(f"{name}: labels must be contiguous int32 on {device}")


def _class_weight(use_weight: bool, device) -> Optional[torch.Tensor]:
    if not use_weight:
        return None
    return torch.tensor(CITYSCAPES_OHEM_WEIGHT, dtype=torch.float32, device=device)


def ohem_cross_entropy_plain(
    logits: torch.Tensor,
    labels: torch.Tensor,
    thresh: float = 0.7,
    min_kept: int = 100000,
    ignore_label: int = 255,
    use_weight: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of `ohem_cross_entropy`: kernel A's plain
    resize, softmax, gather, a sort and `cross_entropy_ignore`; the
    selection under no_grad, the CE differentiated by autograd."""
    up = resize_bilinear_plain(logits, labels.shape[1:])
    with torch.no_grad():
        p_y, num_valid = _target_prob(up, labels, ignore_label)
        kth = quantile.kth_smallest_plain(p_y, min(p_y.numel(), int(min_kept)))
        kept = ohem_keep_labels_plain(labels, p_y, kth, num_valid, thresh, min_kept, ignore_label)
    return ce.cross_entropy_ignore(up, kept, ignore_label, _class_weight(use_weight, up.device))


def ohem_kept_labels(
    logits: torch.Tensor,
    labels: torch.Tensor,
    thresh: float = 0.7,
    min_kept: int = 100000,
    ignore_label: int = 255,
) -> torch.Tensor:
    """The labels OHEM keeps for the CE of the (B, C, h, w) logits upsampled
    to the (B, H, W) labels' size, `ignore_label` at every other pixel (on
    the card: `ohem_target_prob`, `kth_smallest`, `ohem_keep_labels`)."""
    p_y, num_valid = ohem_target_prob(logits, labels, ignore_label)
    kth = quantile.kth_smallest(p_y, min(p_y.numel(), int(min_kept)))
    return ohem_keep_labels(labels, p_y, kth, num_valid, thresh, min_kept, ignore_label)


def ohem_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    thresh: float = 0.7,
    min_kept: int = 100000,
    ignore_label: int = 255,
    use_weight: bool = False,
) -> torch.Tensor:
    """The JAX `ohem_cross_entropy` of `resize_bilinear(logits, labels'
    (H, W))`: logits (B, C, h, w) float32 or bfloat16, labels (B, H, W)
    int32; a 0-d
    device tensor, differentiable in `logits` only."""
    if logits.dim() != 4 or labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"ohem_cross_entropy: logits {tuple(logits.shape)}, labels {tuple(labels.shape)}"
        )
    if logits.device.type == "cpu":
        return ohem_cross_entropy_plain(logits, labels, thresh, min_kept, ignore_label, use_weight)
    kept = ohem_kept_labels(logits.detach(), labels, thresh, min_kept, ignore_label)
    cw = _class_weight(use_weight, logits.device)
    return ce.upsample_cross_entropy(logits, kept, ignore_label, cw)


def ohem_supervised_loss(
    pred: torch.Tensor,
    labels: torch.Tensor,
    aux: Optional[torch.Tensor] = None,
    aux_weight: float = 0.0,
    thresh: float = 0.7,
    min_kept: int = 100000,
    ignore_label: int = 255,
    use_weight: bool = False,
) -> torch.Tensor:
    """`CriterionOhem` parity (u2pl_tpu/losses/ohem.py:89): OHEM on the main
    head (with `use_weight`), unweighted OHEM on the aux head, each at its
    own stride and upsampled inside."""
    loss = ohem_cross_entropy(pred, labels, thresh, min_kept, ignore_label, use_weight)
    if aux is not None and aux_weight > 0:
        loss = loss + aux_weight * ohem_cross_entropy(
            aux, labels, thresh, min_kept, ignore_label, False
        )
    return loss

"""Supervised and semi-supervised U²PL train steps (port of
u2pl_tpu/train/steps.py, one device).

Each maker returns a step that updates the `TrainState` in place and
returns its metrics as 0-d device tensors; nothing on a step reads a value
back to the host.  The anatomy follows the JAX steps line by line:

  semi step (steps.py:269-574): eval-mode teacher forward on the unlabeled
  batch -> max-prob / argmax pseudo-labels of the upsampled logits (kernel D)
  -> CutMix or Cutout (kernel K3) or ClassMix (kernel K3c) on a 50% coin,
  one coin for the batch ->
  train-mode teacher forward on labeled + mixed images (updates the
  teacher's BN statistics) -> entropy of its upsampled unlabeled logits
  (kernel D) -> the annealed drop percentile of that entropy over the valid
  pseudo-labels (kernel E; with `trainer.contrastive`, one call gives it and
  the low / high entropy thresholds) -> student forward on labeled + mixed
  images, sup CE + entropy-gated unsup CE of the upsampled logits (kernel C,
  forward and backward) + the contrastive memory-bank InfoNCE on the
  student's representation (kernels K4, K5, K6; the teacher's os4 softmax
  and representation pick the anchors, the negatives and the prototypes;
  `contrastive.select_keys: radix` selects the negative keys with K4r)
  -> optimizer step at the poly LR -> EMA of the teacher's parameters, with
  decay 0 in the first semi epoch.

  The supervised loss follows `criterion.type`: the CE of the upsampled
  logits (kernel C), or OHEM on the Cityscapes configs (`losses/ohem.py`:
  kernels K7 pick the hard pixels, kernel C takes their CE), each on the
  main head and, with `net.aux_loss`, the aux head.

`run_steps` sequences the warmup and semi steps by epoch, as
train_semi.py does; the CLIs (`u2pl_tpu_torch.train_semi`, `train_sup`)
drive it and `make_sup_step` from the data loaders.

Data-parallel (`group`, a `dist.Group` of W ranks, one process per card;
the JAX steps' `shard_map` over the "data" axis): each rank steps on its
own slice of the global batch with its own draws (`step_generator` with
the rank folded in, steps.py:121, :186, :276); the model's BatchNorm
syncs its statistics when `net.sync_bn` (`create_train_state`); the
gradients are averaged in one all_reduce before the optimizer step
(:88-90); the contrastive loss all-gathers the ranks' keys; the logged
losses are summed over the ranks, neg_cand is their max and the
thresholds their mean (:549-563).  The percentiles stay per rank (:365).
With no group every path is the one-process path; a group of one gives
its bits.

Dropout masks, the mix draws (the coin, and boxes or ClassMix uniforms)
and the contrastive draws (key priorities, or u32 keys under `select_keys:
radix`, anchor and bank draws) come from the `generator` passed to the
step; `mix=(coin, draws)` and `contra=(pri, u_anchor, u_neg)` inject them
instead.  Under `contrastive.anchor_ema` the loss takes `state.prototype`
and the device step and returns the new prototype, copied into the state
after the optimizer step (steps.py:477-483, :572); under a group each rank
keeps its own, as each device does under JAX's `shard_map` (the state's
P() spec with check_vma=False, :576-581): nothing exchanges it.

bfloat16 (`net.dtype: bfloat16`).  The JAX package's policy is not
autocast: it rounds at fixed points, and the port rounds where it does.
Read from the jaxprs of the JAX functions on bf16 inputs
(`jax.make_jaxpr(jax.vjp(...))`: the train-mode forward and its VJP, the
VJPs of `sup_tail` / `unsup_tail` (steps.py:417-428), of
`ohem_supervised_loss` and of `compute_contra_memobank_loss`), the
convert_element_type equations are:

  model (a resnet10 DeepLabv3+ with aux head; per flax layer):
    f32 -> bf16  the image, at the first conv;
    f32 -> bf16  each conv kernel (33) and each conv bias (9), the bias
                 then added to the bf16 conv output in bf16;
    bf16 -> f32  each BN input (x - mean promotes); the statistics and
                 (x - mean) * (rsqrt(var + eps) * scale) + bias in f32;
    f32 -> bf16  each BN output, once;
    f32 -> bf16  the ASPP image pool's f32 mean (decoder.py:55-59);
    bf16         Dropout2d's x / (1 - p), p's complement a bf16 constant;
    f32 <-> bf16 the wide resize's intermediate (decoder os8 -> os4);
    VJP: each BN's input cotangent computed in f32 and cast to bf16, the
    cotangents of a value used twice added in bf16 (add_any), each conv
    kernel's and bias's cotangent cast back to f32 for the f32 params.
  sup_tail / unsup_tail / OHEM (per head):
    bf16 -> f32 -> bf16  the narrow resize of the logits (f32 taps, one
                 rounding of each upsampled value);
    bf16 -> f32  the CE's / OHEM's logits (p_y from these f32 values);
    VJP: the full-resolution f32 cotangent cast to bf16; two CE terms on
    one head (use_weight) added in bf16; cast to f32 for the transposed
    einsums; the os4 gradient cast to bf16.
  semi step: the teacher's upsampled logits stay bf16 (narrow branch);
    max-prob from their f32 cast, the argmax on the bf16 values (exact ties
    to the first class); the teacher's pred / rep stay bf16, softmax on
    the f32 cast; the entropy from the bf16 upsample (steps.py:289-352).
  contrastive (bf16 rep and bank):
    bool -> bf16 the low-valid mask, a bf16 x bf16 prototype matmul with
                 f32 accumulation (exact products);
    bf16         the keys gathered, written to the bank in its dtype;
    bf16 -> f32  the anchor rows (:286); f32 -> bf16 again for the
                 dot-first cosine with bf16 negatives (f32 accumulation);
    VJP: each anchor row's f32 cotangent cast to bf16 and scatter-added in
    bf16, the rows in (C, Q) order, each add rounded.

The port holds these: the model's layers (models/resnet.py, decoder.py),
the bf16 modes of kernels A, A-bwd (ops/resize.py), C, D and K7 prob
(losses/ce.py, unsup.py, ohem.py), K5 (memobank.py) and K6
(losses/contrastive.py), and their plain versions.  Everything else here
is dtype-blind: the steps take the model's bf16 outputs where JAX takes
them, and the optimizer, the EMA and the checkpoints keep the float32
parameters.  Kept as divergence sources: the two use_weight CE terms are
added after their adjoints (bf16 at os4, not at full resolution); the
space-to-depth stem conv (the same map) is not ported; sums are taken in
another order than XLA's.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import torch

from u2pl_tpu_torch import dist
from u2pl_tpu_torch.config import Config
from u2pl_tpu_torch.losses import ce as ce_loss
from u2pl_tpu_torch.losses import contrastive, ohem, unsup
from u2pl_tpu_torch.ops import mixing, quantile
from u2pl_tpu_torch.ops.resize import resize_nearest
from u2pl_tpu_torch.train.lr import _div, lr_at
from u2pl_tpu_torch.train.state import TrainState, copy_student_to_teacher

Metrics = Dict[str, torch.Tensor]


def make_sup_loss_fn(cfg: Config) -> Callable:
    """sup_loss(pred, labels, aux) on the heads' own strides (os4 main, os8
    aux), upsampled inside the loss, with the config's criterion, aux weight,
    ignore label and use_weight (steps.py:51-66)."""
    crit = cfg.criterion
    aux_w = cfg.net.aux_loss.loss_weight if cfg.net.aux_loss else 0.0
    ign = cfg.dataset.ignore_label
    if crit.type == "ohem":
        return functools.partial(
            ohem.ohem_supervised_loss,
            aux_weight=aux_w,
            thresh=crit.thresh,
            min_kept=crit.min_kept,
            ignore_label=ign,
            use_weight=crit.use_weight,
        )
    return functools.partial(
        ce_loss.supervised_loss, aux_weight=aux_w, ignore_label=ign, use_weight=crit.use_weight
    )


def make_normalizer(cfg: Config) -> Callable:
    """uint8 NCHW batches -> (x - mean) / std per channel on the device;
    float batches pass through untouched (steps.py:73-84)."""
    mean = torch.tensor(cfg.dataset.mean, dtype=torch.float32)[:, None, None]
    std = torch.tensor(cfg.dataset.std, dtype=torch.float32)[:, None, None]

    def norm(img: torch.Tensor) -> torch.Tensor:
        if img.dtype == torch.uint8:
            return (img.float() - mean.to(img.device)) / std.to(img.device)
        return img

    return norm


def _update(cfg: Config, state: TrainState, max_iter: int, steps_per_epoch: int,
            group=None) -> torch.Tensor:
    """The gradients' mean over the ranks, then the optimizer step at the
    scheduled LR of `state.step` (steps.py:87-100)."""
    dist.mean_gradients(list(state.student.parameters()), group)
    lr = lr_at(
        cfg.trainer.lr_scheduler, cfg.trainer.optimizer.lr, state.step, max_iter,
        steps_per_epoch,
    )
    state.optimizer.step(lr)
    return lr


def _sup_forward_backward(state, sup_loss_fn, image, label, generator, has_aux):
    state.student.train()
    state.optimizer.zero_grad(set_to_none=True)
    outs = state.student(image, generator=generator)
    loss = sup_loss_fn(outs["pred"], label, outs["aux"] if has_aux else None)
    loss.backward()
    return loss.detach()


def make_sup_step(cfg: Config, steps_per_epoch: int, group=None) -> Callable:
    """Supervised baseline step (steps.py:103-162):
    step(state, image, label, generator=None) -> metrics; `group`: the
    data-parallel ranks (module docstring)."""
    max_iter = cfg.trainer.epochs * steps_per_epoch
    sup_loss_fn = make_sup_loss_fn(cfg)
    has_aux = cfg.net.aux_loss is not None
    normalize = make_normalizer(cfg)

    def step(state: TrainState, image, label, generator=None) -> Metrics:
        loss = _sup_forward_backward(state, sup_loss_fn, normalize(image), label, generator, has_aux)
        lr = _update(cfg, state, max_iter, steps_per_epoch, group)
        state.step += 1
        return {"sup_loss": dist.all_sum(loss, group), "lr": lr}

    return step


def make_semi_warmup_step(cfg: Config, steps_per_epoch: int, group=None) -> Callable:
    """Warmup branch of the semi trainer (steps.py:165-244): sup loss on the
    labeled batch + a train-mode teacher forward on it that only updates the
    teacher's BN statistics.
    step(state, image_l, label_l, image_u, generator=None) -> metrics."""
    max_iter = cfg.trainer.epochs * steps_per_epoch
    sup_loss_fn = make_sup_loss_fn(cfg)
    has_aux = cfg.net.aux_loss is not None
    normalize = make_normalizer(cfg)

    def step(state: TrainState, image_l, label_l, image_u, generator=None) -> Metrics:
        image_l = normalize(image_l)
        loss = _sup_forward_backward(state, sup_loss_fn, image_l, label_l, generator, has_aux)
        state.teacher.train()
        with torch.no_grad():
            state.teacher(image_l, generator=generator)
        lr = _update(cfg, state, max_iter, steps_per_epoch, group)
        state.step += 1
        zero = torch.zeros((), device=loss.device)
        return {"sup_loss": dist.all_sum(loss, group), "uns_loss": zero, "con_loss": zero,
                "lr": lr}

    return step


def epoch_scalars(
    step: torch.Tensor, steps_per_epoch: int, cfg: Config
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(drop_percent, ema_decay) of the device step, in the JAX float32
    arithmetic of steps.py:274, :356-359 and :520-541 (a 1-ulp difference
    in the percent would move the percentile's rank)."""
    tr = cfg.trainer
    epoch_i = torch.div(step, steps_per_epoch, rounding_mode="floor")
    epoch = epoch_i.to(torch.float32)
    percent_unreliable = (100.0 - tr.unsupervised.drop_percent) * (1.0 - _div(epoch, tr.epochs))
    drop_percent = 100.0 - percent_unreliable
    since = step.to(torch.float32) - float(steps_per_epoch * tr.sup_only_epoch) + 1.0
    decay = torch.minimum(
        1.0 - torch.full_like(since, 1.0) / since, torch.full_like(since, cfg.net.ema_decay)
    )
    decay = torch.where(epoch_i == tr.sup_only_epoch, torch.zeros_like(decay), decay)
    return drop_percent, decay


def contrastive_percents(
    step: torch.Tensor, steps_per_epoch: int, cfg: Config
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha_t, 100 - alpha_t): the percents of the low and high entropy
    thresholds of the contrastive masks, in the JAX float32 arithmetic of
    steps.py:364-369."""
    epoch = torch.div(step, steps_per_epoch, rounding_mode="floor").to(torch.float32)
    alpha_t = cfg.trainer.contrastive.low_entropy_threshold * (1.0 - _div(epoch, cfg.trainer.epochs))
    return alpha_t, 100.0 - alpha_t


def _contrastive_masks(cfg, label_l, label_u, entropy, valid_u, low_thresh, high_thresh, small_hw):
    """The contrastive loss's small labels and masks (steps.py:370-402):
    low / high entropy masks of the unlabeled pixels (the labeled ones: every
    valid pixel), nearest-resized with the labels to the representation's
    (h, w); the one-hot is taken inside the loss, after the resize, as JAX
    does."""
    ignore = cfg.dataset.ignore_label
    lab_valid = label_l != ignore
    low_u = (entropy <= low_thresh) & valid_u
    high_u = (entropy >= high_thresh) & valid_u
    if not cfg.trainer.contrastive.negative_high_entropy:
        high_u = torch.ones_like(high_u)
    low = resize_nearest(torch.cat([lab_valid, low_u]), small_hw)
    high = resize_nearest(torch.cat([lab_valid, high_u]), small_hw)
    return resize_nearest(label_l, small_hw), resize_nearest(label_u, small_hw), low, high


def draw_contrastive(generator: torch.Generator, cfg: Config, n_pixels: int):
    """The contrastive loss's draws from `generator`: (pri (C, N), u_anchor
    (C, Q), u_neg (C, Q * num_negatives)), float32 in [0, 1); under
    `select_keys: radix` pri is a (C, N) int32 block of u32 key bits."""
    c, contra = cfg.net.num_classes, cfg.trainer.contrastive
    q, m = contra.num_queries, contra.num_negatives
    dev = generator.device
    if contra.select_keys == "radix":
        pri = torch.randint(0, 2**32, (c, n_pixels), generator=generator, device=dev,
                            dtype=torch.int64).to(torch.int32)
    else:
        pri = torch.rand((c, n_pixels), generator=generator, device=dev)
    return (pri,) + tuple(
        torch.rand(shape, generator=generator, device=dev) for shape in ((c, q), (c, q * m))
    )


def make_semi_step(cfg: Config, steps_per_epoch: int, group=None) -> Callable:
    """The U²PL semi-supervised step (steps.py:247-583), over the ranks of
    `group` (module docstring).
    step(state, image_l, label_l, image_u, generator=None, mix=None,
    contra=None) -> metrics; `mix=(coin, draws)`: a 0-d bool and the mode's
    draws on the device ((B_u, 4) int32 boxes, or (B_u, C) f32 ClassMix
    uniforms), `contra=(pri, u_anchor, u_neg)` the contrastive draws
    (`draw_contrastive`), in place of the generator's."""
    max_iter = cfg.trainer.epochs * steps_per_epoch
    sup_loss_fn = make_sup_loss_fn(cfg)
    has_aux = cfg.net.aux_loss is not None
    ignore = cfg.dataset.ignore_label
    unsup_cfg = cfg.trainer.unsupervised
    contra_cfg = cfg.trainer.contrastive
    normalize = make_normalizer(cfg)
    if unsup_cfg.apply_aug:
        mixing.check_mode(unsup_cfg.apply_aug)

    def step(
        state: TrainState, image_l, label_l, image_u, generator=None,
        mix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        contra: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> Metrics:
        image_l, image_u = normalize(image_l), normalize(image_u)
        b_l, h, w = label_l.shape
        student, teacher = state.student, state.teacher
        drop_percent, ema_decay = epoch_scalars(state.step, steps_per_epoch, cfg)

        with torch.no_grad():
            # ---- 1. pseudo-labels from the eval-mode teacher (:283-301)
            teacher.eval()
            pred_u_teacher = teacher(image_u)["pred"]
            logits_u_aug, label_u_aug, _ = unsup.upsample_softmax_stats(
                pred_u_teacher, (h, w), outputs="prob")
            del pred_u_teacher

            # ---- 2. strong augmentation on a 50% coin (:303-319)
            image_u_aug = image_u
            if unsup_cfg.apply_aug:
                if mix is None:
                    if generator is None:
                        raise ValueError("the semi step draws its mix from a generator or `mix`")
                    coin = torch.rand((), generator=generator, device=generator.device) < 0.5
                    draws = mixing.draw_mix(generator, unsup_cfg.apply_aug, image_u.shape[0],
                                            h, w, cfg.net.num_classes)
                else:
                    coin, draws = mix
                aug_img, aug_lab, aug_log = mixing.generate_unsup_data(
                    image_u, label_u_aug, logits_u_aug, draws, unsup_cfg.apply_aug, ignore
                )
                image_u_aug = torch.where(coin, aug_img, image_u)
                label_u_aug = torch.where(coin, aug_lab, label_u_aug)
                del aug_img, aug_lab, aug_log, logits_u_aug
            image_all = torch.cat([image_l, image_u_aug], dim=0)

            # ---- teacher train-mode forward (:323-343): updates teacher BN
            teacher.train()
            t_out = teacher(image_all, generator=generator)
            _, _, entropy = unsup.upsample_softmax_stats(t_out["pred"][b_l:], (h, w),
                                                         outputs="entropy")

            # ---- the annealed drop percentile of the entropy, and the
            # contrastive thresholds with it, in one call (:352-406)
            valid_u = label_u_aug != ignore
            if contra_cfg is None:
                drop_thresh = quantile.masked_percentiles(entropy, valid_u, drop_percent.reshape(1))[0]
                del t_out
            else:
                alpha_t, alpha_hi = contrastive_percents(state.step, steps_per_epoch, cfg)
                percents = torch.stack([drop_percent, alpha_t, alpha_hi])
                drop_thresh, low_thresh, high_thresh = quantile.masked_percentiles(
                    entropy, valid_u, percents
                ).unbind()
                prob_teacher = torch.softmax(t_out["pred"].float(), dim=1)
                rep_teacher = t_out["rep"]
                del t_out
                small_hw = tuple(prob_teacher.shape[2:])
                contra_in = _contrastive_masks(
                    cfg, label_l, label_u_aug, entropy, valid_u, low_thresh, high_thresh, small_hw
                )
                if contra is None:
                    if generator is None:
                        raise ValueError("the semi step draws its contrastive draws from a "
                                         "generator or `contra`")
                    n_pixels = image_all.shape[0] * small_hw[0] * small_hw[1]
                    contra = draw_contrastive(generator, cfg, n_pixels)

        # ---- student forward / backward (:437-517)
        student.train()
        state.optimizer.zero_grad(set_to_none=True)
        outs = student(image_all, generator=generator)
        pred_all = outs["pred"]
        sup_loss = sup_loss_fn(pred_all[:b_l], label_l, outs["aux"][:b_l] if has_aux else None)
        unsup_loss = unsup.compute_unsupervised_loss(
            pred_all[b_l:], label_u_aug, entropy, drop_thresh, ignore
        ) * unsup_cfg.loss_weight
        con_loss = torch.zeros((), device=sup_loss.device)
        neg_cand = torch.zeros((cfg.net.num_classes,), dtype=torch.int32, device=sup_loss.device)
        new_proto = None
        if contra_cfg is not None:
            label_l_small, label_u_small, low_small, high_small = contra_in
            res = contrastive.compute_contra_memobank_loss(
                outs["rep"], label_l_small, label_u_small, prob_teacher[:b_l],
                prob_teacher[b_l:], low_small, high_small, contra_cfg, state.bank,
                rep_teacher, contra, ignore_label=ignore, return_info=True, group=group,
                prototype=state.prototype if contra_cfg.anchor_ema else None, i_iter=state.step,
            )
            if contra_cfg.anchor_ema:
                new_proto, _, con_loss, info = res
            else:
                _, con_loss, info = res
            con_loss = con_loss * contra_cfg.loss_weight
            neg_cand = info["neg_candidates"]
            del prob_teacher, rep_teacher, contra_in
        del outs, pred_all
        (sup_loss + unsup_loss + con_loss).backward()
        lr = _update(cfg, state, max_iter, steps_per_epoch, group)

        # ---- EMA of the teacher's parameters (:519-546)
        with torch.no_grad():
            t_params = list(teacher.parameters())
            s_params = list(student.parameters())
            blended = torch._foreach_add(
                torch._foreach_mul(t_params, ema_decay),
                torch._foreach_mul(s_params, 1.0 - ema_decay),
            )
            torch._foreach_copy_(t_params, blended)
            if new_proto is not None:
                state.prototype.copy_(new_proto)
        state.step += 1
        # the logged losses summed over the ranks, neg_cand their max, the
        # thresholds their mean (steps.py:549-563)
        metrics = {
            "sup_loss": dist.all_sum(sup_loss.detach(), group),
            "uns_loss": dist.all_sum(unsup_loss.detach(), group),
            "con_loss": dist.all_sum(con_loss.detach(), group),
            "lr": lr,
            "neg_cand": dist.all_max(neg_cand, group),
            "drop_thresh": dist.all_mean(drop_thresh, group),
        }
        if contra_cfg is not None:
            metrics["low_thresh"] = dist.all_mean(low_thresh, group)
            metrics["high_thresh"] = dist.all_mean(high_thresh, group)
        return metrics

    return step


def step_generator(seed: int, i_iter: int, device, rank: int = 0) -> torch.Generator:
    """The generator of global step `i_iter` of a run seeded `seed` on data-
    parallel rank `rank` (JAX: fold_in(fold_in(rng, i_iter), axis_index),
    steps.py:275-276): every draw of a step comes from it, so a resumed run
    takes the draws an uninterrupted one takes, and each rank its own; rank
    0's are the one-process run's."""
    if not 0 <= rank < 128:
        raise ValueError(f"step_generator: rank {rank} outside [0, 128)")
    return torch.Generator(device=device).manual_seed((((seed + 1) << 32) + i_iter) ^ (rank << 56))


def run_steps(
    state: TrainState,
    batches: Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    steps_per_epoch: int,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    start_iter: int = 0,
    mixes: Optional[Sequence] = None,
    contras: Optional[Sequence] = None,
    seed: Optional[int] = None,
    group=None,
) -> Iterator[Tuple[int, Metrics]]:
    """The semi trainer's step sequencing (train_semi.py:166-245; the CLI
    `u2pl_tpu_torch.train_semi` adds the data pipeline, validation and
    checkpoints around it): warmup
    steps while epoch < sup_only_epoch, the student -> teacher copy before
    every step of the first semi epoch (train_semi.py:233-237), semi steps
    after that.

    One step per (image_l, label_l, image_u) batch, from global iteration
    `start_iter` (the host's copy of `state.step`, so choosing the branch
    reads nothing back from the device); yields (i_iter, metrics) after each
    step.  `mixes[j]` and `contras[j]`, when given, are the semi step's
    injected (coin, draws) and contrastive draws for batch j.  With `seed`,
    each step draws from `step_generator(seed, i_iter, rank)` in place of
    `generator`.  `group`: the data-parallel ranks (module docstring)."""
    warmup = make_semi_warmup_step(cfg, steps_per_epoch, group)
    semi = make_semi_step(cfg, steps_per_epoch, group)
    sup_only_epoch = cfg.trainer.sup_only_epoch
    for j, (image_l, label_l, image_u) in enumerate(batches):
        i_iter = start_iter + j
        epoch = i_iter // steps_per_epoch
        if seed is not None:
            generator = step_generator(seed, i_iter, state.step.device, dist.rank(group))
        if epoch < sup_only_epoch:
            metrics = warmup(state, image_l, label_l, image_u, generator)
        else:
            if epoch == sup_only_epoch:
                copy_student_to_teacher(state)
            mix = mixes[j] if mixes is not None else None
            contra = contras[j] if contras is not None else None
            metrics = semi(state, image_l, label_l, image_u, generator, mix=mix, contra=contra)
        yield i_iter, metrics

"""Typed configuration parsed from the reference YAML surface (the port's
own copy of u2pl_tpu/config.py: stdlib + yaml, no JAX package import).

The public config schema is identical to the reference experiment YAMLs
(union of experiments/*/*/*/config.yaml).  Everything is parsed into frozen
dataclasses so that defaults live in ONE place; the port reads the same
YAML files as the JAX package and parses them to the same values
(tests/test_torch_config.py holds the two parsers together on every
experiment config).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import yaml


@dataclass(frozen=True)
class CropCfg:
    type: str = "rand"  # "rand" | "center"
    size: Tuple[int, int] = (513, 513)


@dataclass(frozen=True)
class CutoutCfg:
    """Host-pipeline cutout (reference cityscapes.py:70-72)."""

    n_holes: int = 3
    length: int = 32


@dataclass(frozen=True)
class CutmixCfg:
    """Host-pipeline cutmix mask generator (reference cityscapes.py:73-75)."""

    n_holes: int = 1
    prop_range: Tuple[float, float] = (0.25, 0.5)


@dataclass(frozen=True)
class SplitCfg:
    """Per-split (train/val) data config; inherits dataset-level keys."""

    data_root: str = ""
    data_list: str = ""
    flip: bool = False
    gaussian_blur: bool = False
    rand_resize: Optional[Tuple[float, float]] = None
    rand_rotation: Optional[Tuple[float, float]] = None
    resize: Optional[Tuple[int, int]] = None
    crop: Optional[CropCfg] = None
    # cutout/cutmix config entries exist only in the CITYSCAPES transforms
    # (reference cityscapes.py:70-78; the pascal transforms have no such
    # keys) and make the transform return the reference Compose 5-tuple /
    # mask-triple protocol (augmentation.py:31-47) for AEL-style consumers
    cutout: Optional[CutoutCfg] = None
    cutmix: Optional[CutmixCfg] = None


@dataclass(frozen=True)
class DatasetCfg:
    type: str = "pascal_semi"  # pascal | pascal_semi | cityscapes | cityscapes_semi
    train: SplitCfg = field(default_factory=SplitCfg)
    val: SplitCfg = field(default_factory=SplitCfg)
    batch_size: int = 4
    n_sup: int = 10582
    workers: int = 2
    # "thread" (in-process pool; fine for 1 chip/host) or "process"
    # (fork-based worker pool, the torch-DataLoader-style GIL escape —
    # required to feed multiple chips per host; see docs/PERF.md "Host
    # data-plane throughput" for the measured scaling and sizing rule).
    workers_mode: str = "thread"
    mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    ignore_label: int = 255
    noise_std: float = 0.1  # present in reference configs, unused there too
    pool_size_override: Optional[int] = None  # for tests/custom datasets
    # TPU-native addition: ship uint8 crops to the device and normalize
    # inside the compiled step (4x less H2D traffic than host-normalized
    # float32; sub-LSB quantization of resampled pixels).
    device_normalize: bool = False

    @property
    def pool_size(self) -> int:
        # full train-pool sizes used to derive the unlabeled n_sup
        # (reference: pascal_voc.py:109 `10582 - n_sup`, cityscapes.py:116)
        if self.pool_size_override is not None:
            return self.pool_size_override
        return 2975 if "cityscapes" in self.type else 10582

    @property
    def is_semi(self) -> bool:
        return self.type.endswith("_semi")


@dataclass(frozen=True)
class OptimizerCfg:
    type: str = "SGD"
    lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 0.0001
    nesterov: bool = False


@dataclass(frozen=True)
class LRSchedulerCfg:
    mode: str = "poly"  # poly | cosine | multistep
    power: float = 0.9
    targetlr: float = 0.0
    milestones: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class UnsupervisedCfg:
    drop_percent: float = 100.0
    apply_aug: Optional[str] = None  # cutout | cutmix | classmix | None
    loss_weight: float = 1.0
    tta: bool = False  # present in reference configs, unused there


@dataclass(frozen=True)
class ContrastiveCfg:
    enabled: bool = True
    negative_high_entropy: bool = True
    low_rank: int = 3
    high_rank: int = 20
    current_class_threshold: float = 0.3  # delta_p
    current_class_negative_threshold: float = 1.0  # delta_n
    low_entropy_threshold: float = 20.0  # alpha_t base percentile
    num_negatives: int = 50
    num_queries: int = 256
    temperature: float = 0.5
    loss_weight: float = 1.0
    anchor_ema: bool = False
    binary: bool = False  # reference's binary path is broken (undefined fn);
    # kept in the schema, rejected at parse time.
    unsupervised_entropy_ignore: float = 80.0  # unused (parity with reference)
    # TPU-native additions (fixed-shape queue exchange; not in the reference):
    # Default covers the p99 per-class candidate count measured with
    # tools/measure_bank_cap.py on worst-case (random-teacher) synthetic
    # steps: p99 5304 / max 7102 @ 513^2/21c bs4, p99 7073 / max 9287 @
    # 769^2/19c bs2 (docs/CONFIG.md). Raise to 12288 to also cover the
    # observed maxima (zero truncation in the worst measured case).
    max_keys_per_class_per_step: int = 8192  # per-device enqueue slab
    queue_dtype: str = "bfloat16"  # memory-bank storage dtype
    # enqueue-subset lowering: "argsort" (default, measured 9x faster at the
    # in-step shape) or "radix" (docs/PERF.md "Radix-select key selection").
    # A config field, not an env var: the choice is baked in at trace time,
    # and multi-host runs must trace identical programs on every host.
    select_keys: str = "argsort"


@dataclass(frozen=True)
class TrainerCfg:
    epochs: int = 80
    eval_on: bool = True
    sup_only_epoch: int = 1
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    lr_scheduler: LRSchedulerCfg = field(default_factory=LRSchedulerCfg)
    unsupervised: UnsupervisedCfg = field(default_factory=UnsupervisedCfg)
    contrastive: Optional[ContrastiveCfg] = None


@dataclass(frozen=True)
class SaverCfg:
    snapshot_dir: str = "checkpoints"
    auto_resume: bool = False
    pretrain: str = ""
    # persist the memory bank in checkpoints (improvement over the
    # reference, which restarts it cold on resume; disable to shrink
    # checkpoints by queue_size*256*num_classes entries)
    save_memobank: bool = True


@dataclass(frozen=True)
class CriterionCfg:
    type: str = "CELoss"  # CELoss | ohem
    use_weight: bool = False
    thresh: float = 0.7
    min_kept: int = 100000


@dataclass(frozen=True)
class AuxLossCfg:
    aux_plane: int = 1024
    loss_weight: float = 0.4


@dataclass(frozen=True)
class EncoderCfg:
    type: str = "u2pl.models.resnet.resnet101"
    multi_grid: bool = False
    zero_init_residual: bool = False
    fpn: bool = False
    replace_stride_with_dilation: Tuple[bool, bool, bool] = (False, False, False)
    # True -> load from models.resnet.model_urls[arch]; a string is an
    # explicit .pth path; False/None disables (reference resnet.py:380-402)
    pretrained: Union[bool, str] = True
    # Error (instead of warn) when the ImageNet checkpoint is missing.  The
    # shipped experiment YAMLs set this: they target published mIoU numbers
    # that are unreachable from random init, and a silent random-init start
    # burns a week of accelerator time.  U2PL_ALLOW_RANDOM_INIT=1 overrides
    # for weightless environments (CI, machines without the weights).  The reference
    # hard-fails the same way, inside torch.load (resnet.py:380-402).
    pretrained_required: bool = False
    # TPU-native addition: rematerialize residual blocks in the backward
    # pass (jax.checkpoint) to trade FLOPs for HBM when scaling batch/crop.
    remat: bool = False


@dataclass(frozen=True)
class DecoderCfg:
    type: str = "u2pl.models.decoder.dec_deeplabv3_plus"
    inner_planes: int = 256
    dilations: Tuple[int, ...] = (12, 24, 36)
    rep_head: bool = True


@dataclass(frozen=True)
class NetCfg:
    num_classes: int = 21
    sync_bn: bool = True
    ema_decay: float = 0.99
    aux_loss: Optional[AuxLossCfg] = None
    encoder: EncoderCfg = field(default_factory=EncoderCfg)
    decoder: DecoderCfg = field(default_factory=DecoderCfg)
    # TPU-native addition: conv/matmul compute dtype ("float32"|"bfloat16").
    # Params, BN statistics and all loss math stay float32.
    dtype: str = "float32"


@dataclass(frozen=True)
class Config:
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    trainer: TrainerCfg = field(default_factory=TrainerCfg)
    saver: SaverCfg = field(default_factory=SaverCfg)
    criterion: CriterionCfg = field(default_factory=CriterionCfg)
    net: NetCfg = field(default_factory=NetCfg)
    exp_path: str = ""

    @property
    def save_path(self) -> str:
        return os.path.join(self.exp_path, self.saver.snapshot_dir)


def _tup(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tup(x) for x in v)
    return v


def _crop(d: Optional[Dict[str, Any]]) -> Optional[CropCfg]:
    if not d:
        return None
    return CropCfg(type=d.get("type", "rand"), size=tuple(d["size"]))


def _split(dset: Dict[str, Any], split: str) -> SplitCfg:
    d = dict(dset)
    d.update(dset.get(split, {}) or {})
    # cutout/cutmix keys are honored only by the cityscapes transforms
    # (reference cityscapes.py:70-78 vs pascal_voc.py:48-71)
    is_city = str(dset.get("type", "")).startswith("cityscapes")
    cutout = cutmix = None
    if is_city and d.get("cutout"):
        c = d["cutout"]
        cutout = CutoutCfg(n_holes=int(c["n_holes"]), length=int(c["length"]))
    if is_city and d.get("cutmix"):
        c = d["cutmix"]
        pr = c["prop_range"]
        cutmix = CutmixCfg(
            n_holes=int(c.get("n_holes", 1)),
            prop_range=(pr, pr) if isinstance(pr, (int, float)) else tuple(pr),
        )
    return SplitCfg(
        data_root=d.get("data_root", ""),
        data_list=d.get("data_list", ""),
        flip=bool(d.get("flip", False)),
        gaussian_blur=bool(d.get("GaussianBlur", False)),
        rand_resize=_tup(d.get("rand_resize")) if d.get("rand_resize") else None,
        rand_rotation=_tup(d.get("rand_rotation")) if d.get("rand_rotation") else None,
        resize=_tup(d.get("resize")) if d.get("resize") else None,
        crop=_crop(d.get("crop")),
        cutout=cutout,
        cutmix=cutmix,
    )


def parse_config(raw: Dict[str, Any], exp_path: str = "") -> Config:
    """Parse a raw reference-schema YAML dict into a typed Config."""
    dset = raw.get("dataset", {}) or {}
    trainer = raw.get("trainer", {}) or {}
    saver = raw.get("saver", {}) or {}
    criterion = raw.get("criterion", {}) or {}
    net = raw.get("net", {}) or {}

    dataset_cfg = DatasetCfg(
        type=dset.get("type", "pascal_semi"),
        train=_split(dset, "train"),
        val=_split(dset, "val"),
        batch_size=int(dset.get("batch_size", 1)),
        n_sup=int(dset.get("n_sup", 10582)),
        workers=int(dset.get("workers", 2)),
        workers_mode=str(dset.get("workers_mode", "thread")),
        mean=tuple(dset.get("mean", (123.675, 116.28, 103.53))),
        std=tuple(dset.get("std", (58.395, 57.12, 57.375))),
        ignore_label=int(dset.get("ignore_label", 255)),
        noise_std=float(dset.get("noise_std", 0.1)),
        pool_size_override=(
            int(dset["pool_size"]) if dset.get("pool_size") else None
        ),
        device_normalize=bool(dset.get("device_normalize", False)),
    )

    opt = trainer.get("optimizer", {}) or {}
    opt_kwargs = opt.get("kwargs", {}) or {}
    optimizer_cfg = OptimizerCfg(
        type=opt.get("type", "SGD"),
        lr=float(opt_kwargs.get("lr", 0.001)),
        momentum=float(opt_kwargs.get("momentum", 0.9)),
        weight_decay=float(opt_kwargs.get("weight_decay", 0.0001)),
        nesterov=bool(opt_kwargs.get("nesterov", False)),
    )

    sched = trainer.get("lr_scheduler", {}) or {}
    sched_kwargs = sched.get("kwargs", {}) or {}
    lr_cfg = LRSchedulerCfg(
        mode=sched.get("mode", "poly"),
        power=float(sched_kwargs.get("power", 0.9)),
        targetlr=float(sched_kwargs.get("targetlr", 0.0)),
        milestones=_tup(sched_kwargs.get("milestones"))
        if sched_kwargs.get("milestones")
        else None,
    )

    unsup = trainer.get("unsupervised", {}) or {}
    unsup_cfg = UnsupervisedCfg(
        drop_percent=float(unsup.get("drop_percent", 100)),
        apply_aug=unsup.get("apply_aug") or None,
        loss_weight=float(unsup.get("loss_weight", 1)),
        tta=bool(unsup.get("TTA", False)),
    )

    contra_raw = trainer.get("contrastive", None)
    contra_cfg: Optional[ContrastiveCfg] = None
    if contra_raw:
        if contra_raw.get("binary", False):
            # reference: train_semi.py:469 calls compute_binary_memobank_loss
            # which is defined nowhere -> NameError. Fail loudly instead.
            raise ValueError(
                "contrastive.binary=true is a dead path in the reference "
                "(undefined compute_binary_memobank_loss); not supported."
            )
        contra_cfg = ContrastiveCfg(
            enabled=True,
            negative_high_entropy=bool(contra_raw.get("negative_high_entropy", True)),
            low_rank=int(contra_raw.get("low_rank", 3)),
            high_rank=int(contra_raw.get("high_rank", 20)),
            current_class_threshold=float(
                contra_raw.get("current_class_threshold", 0.3)
            ),
            current_class_negative_threshold=float(
                contra_raw.get("current_class_negative_threshold", 1)
            ),
            low_entropy_threshold=float(contra_raw.get("low_entropy_threshold", 20)),
            num_negatives=int(contra_raw.get("num_negatives", 50)),
            num_queries=int(contra_raw.get("num_queries", 256)),
            temperature=float(contra_raw.get("temperature", 0.5)),
            loss_weight=float(contra_raw.get("loss_weight", 1)),
            anchor_ema=bool(contra_raw.get("anchor_ema", False)),
            unsupervised_entropy_ignore=float(
                contra_raw.get("unsupervised_entropy_ignore", 80)
            ),
            max_keys_per_class_per_step=int(
                contra_raw.get("max_keys_per_class_per_step", 8192)
            ),
            queue_dtype=str(contra_raw.get("queue_dtype", "bfloat16")),
            select_keys=str(contra_raw.get("select_keys", "argsort")),
        )
        if contra_cfg.select_keys not in ("argsort", "radix"):
            raise ValueError(
                "contrastive.select_keys must be 'argsort' or 'radix', got "
                f"{contra_cfg.select_keys!r}"
            )

    trainer_cfg = TrainerCfg(
        epochs=int(trainer.get("epochs", 80)),
        eval_on=bool(trainer.get("eval_on", True)),
        sup_only_epoch=int(trainer.get("sup_only_epoch", 1)),
        optimizer=optimizer_cfg,
        lr_scheduler=lr_cfg,
        unsupervised=unsup_cfg,
        contrastive=contra_cfg,
    )

    saver_cfg = SaverCfg(
        snapshot_dir=saver.get("snapshot_dir", "checkpoints"),
        auto_resume=bool(saver.get("auto_resume", False)),
        pretrain=saver.get("pretrain", "") or "",
        save_memobank=bool(saver.get("save_memobank", True)),
    )

    crit_kwargs = criterion.get("kwargs", {}) or {}
    criterion_cfg = CriterionCfg(
        type=criterion.get("type", "CELoss"),
        use_weight=bool(crit_kwargs.get("use_weight", False)),
        thresh=float(crit_kwargs.get("thresh", 0.7)),
        min_kept=int(crit_kwargs.get("min_kept", 100000)),
    )

    aux_raw = net.get("aux_loss", None)
    aux_cfg = (
        AuxLossCfg(
            aux_plane=int(aux_raw.get("aux_plane", 1024)),
            loss_weight=float(aux_raw.get("loss_weight", 0.4)),
        )
        if aux_raw
        else None
    )

    enc = net.get("encoder", {}) or {}
    enc_kwargs = enc.get("kwargs", {}) or {}
    encoder_cfg = EncoderCfg(
        type=enc.get("type", "u2pl.models.resnet.resnet101"),
        multi_grid=bool(enc_kwargs.get("multi_grid", False)),
        zero_init_residual=bool(enc_kwargs.get("zero_init_residual", False)),
        fpn=bool(enc_kwargs.get("fpn", False)),
        replace_stride_with_dilation=tuple(
            enc_kwargs.get("replace_stride_with_dilation", (False, False, False))
        ),
        pretrained=enc_kwargs.get("pretrained", True),
        pretrained_required=bool(enc_kwargs.get("pretrained_required", False)),
        remat=bool(enc_kwargs.get("remat", False)),
    )

    dec = net.get("decoder", {}) or {}
    dec_kwargs = dec.get("kwargs", {}) or {}
    decoder_cfg = DecoderCfg(
        type=dec.get("type", "u2pl.models.decoder.dec_deeplabv3_plus"),
        inner_planes=int(dec_kwargs.get("inner_planes", 256)),
        dilations=tuple(dec_kwargs.get("dilations", (12, 24, 36))),
        rep_head=bool(dec_kwargs.get("rep_head", True)),
    )

    net_cfg = NetCfg(
        num_classes=int(net.get("num_classes", 21)),
        sync_bn=bool(net.get("sync_bn", True)),
        ema_decay=float(net.get("ema_decay", 0.99)),
        aux_loss=aux_cfg,
        encoder=encoder_cfg,
        decoder=decoder_cfg,
        dtype=str(net.get("dtype", "float32")),
    )

    return Config(
        dataset=dataset_cfg,
        trainer=trainer_cfg,
        saver=saver_cfg,
        criterion=criterion_cfg,
        net=net_cfg,
        exp_path=exp_path,
    )


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return parse_config(raw, exp_path=os.path.dirname(os.path.abspath(path)))


def head_lr_multiplier(cfg: Config) -> float:
    """Decoder/aux-head LR multiplier: x10 on pascal, x1 on cityscapes
    (reference: train_semi.py:100 `times = 10 if "pascal" in type else 1`)."""
    return 10.0 if "pascal" in cfg.dataset.type else 1.0

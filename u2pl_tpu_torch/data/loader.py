"""Dataset and prefetching batch loader of the host data pipeline (port of
u2pl_tpu/data/loader.py).

In place of torch's DataLoader / DistributedSampler (reference
pascal_voc.py:74-157): a worker pool decodes and augments the next batches
while the card computes the current step; the epoch's order is a
permutation seeded by (seed + epoch), as in the JAX package, so both give
the same batches of indices.  Data-parallel, `batch_size` is per rank (the
reference's per-GPU batch): the global batch is batch_size x
`process_count`, and rank `process_index` assembles its slice of each
(loader.py:104-200).

Two worker modes (`dataset.workers_mode`):
  thread   (the default) an in-process thread pool; the transforms draw
           from the global `random` as the reference does.
  process  a persistent process pool started with `spawn` (or `forkserver`
           from U2PL_LOADER_MP_CONTEXT), never `fork`: the parent has
           initialised CUDA, and a forked child of a CUDA process is not
           safe.  The dataset ships to each worker once (it is picklable:
           paths and plain transform objects), and every task reseeds
           `random` and `np.random` from (seed, epoch, batch), so the
           batches do not depend on scheduling, and a resumed run sees the
           batches an uninterrupted one would.
"""

from __future__ import annotations

import concurrent.futures as futures
import multiprocessing
import os
import queue as queue_mod
import random
from typing import Iterator, Optional, Tuple

import numpy as np

from u2pl_tpu_torch.config import Config
from u2pl_tpu_torch.data.splits import parse_split, subsample
from u2pl_tpu_torch.data.transforms import build_transform

START_METHODS = ("spawn", "forkserver")


class SegDataset:
    """Image / label pairs from a split file (reference voc_dset /
    city_dset)."""

    def __init__(self, data_root, data_list, transform, seed=0, n_sup=None, split="val"):
        pairs = parse_split(data_list)
        if n_sup is not None:
            pairs = subsample(pairs, n_sup, seed, split)
        self.pairs = pairs
        self.data_root = data_root
        self.transform = transform

    def __len__(self):
        return len(self.pairs)

    def load_raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        img_p = os.path.join(self.data_root, self.pairs[i][0])
        lab_p = os.path.join(self.data_root, self.pairs[i][1])
        # uint8: the fused native transform takes raw bytes; the numpy
        # pipeline converts to float32 itself
        with Image.open(img_p) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
        with Image.open(lab_p) as lb:
            lab = np.asarray(lb.convert("L"), np.uint8)
        return img, lab

    def __getitem__(self, i: int):
        return self.transform(*self.load_raw(i))


def epoch_indices(n: int, epoch: int, seed: int, shuffle: bool = True) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    return np.random.RandomState((seed + epoch) % (2**31)).permutation(n)


def _stack(samples):
    """Stack every component of the samples: (img, label) pairs, or the
    Cityscapes builder's cutout 5-tuples / cutmix triples."""
    return tuple(np.stack([s[k] for s in samples]) for k in range(len(samples[0])))


_WORKER_DATASET: Optional[SegDataset] = None


def _proc_worker_init(dataset: SegDataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _proc_assemble(indices: np.ndarray, task_seed: int):
    random.seed(task_seed)
    np.random.seed(task_seed)
    return _stack([_WORKER_DATASET[int(i)] for i in indices])


def task_seed(seed: int, epoch: int, batch: int) -> int:
    """The seed of process-mode batch `batch` of `epoch` (as in the JAX package)."""
    return (seed * 1000003 + epoch * 9973 + batch) % (2**31)


class EpochLoader:
    """Iterates one epoch's batches with background prefetch; drop_last as
    the reference's train loaders (pascal_voc.py:136-156).  One process
    feeds one card: `batch_size` is its share of a global batch of
    batch_size x process_count, whose slice `process_index` it assembles,
    each batch with the draws the JAX loader gives that slice; the epoch's
    length counts global batches."""

    def __init__(self, dataset: SegDataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True, workers: int = 2, prefetch: int = 2,
                 workers_mode: str = "thread", process_index: int = 0, process_count: int = 1):
        if workers_mode not in ("thread", "process"):
            raise ValueError(f"workers_mode must be thread|process, got {workers_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(workers, 1)
        self.prefetch = prefetch
        self.workers_mode = workers_mode
        self.process_index = process_index
        self.process_count = process_count
        self.global_batch = batch_size * process_count
        self._proc_pool: Optional[futures.ProcessPoolExecutor] = None

    def _get_proc_pool(self) -> futures.ProcessPoolExecutor:
        if self._proc_pool is None:
            method = os.environ.get("U2PL_LOADER_MP_CONTEXT", "spawn")
            if method not in START_METHODS:
                raise ValueError(f"U2PL_LOADER_MP_CONTEXT={method!r}: one of {START_METHODS} "
                                 "(the trainer's process has initialised CUDA, so no fork)")
            self._proc_pool = futures.ProcessPoolExecutor(
                max_workers=self.workers, mp_context=multiprocessing.get_context(method),
                initializer=_proc_worker_init, initargs=(self.dataset,),
            )
        return self._proc_pool

    def close(self) -> None:
        """Stop the persistent process pool (nothing to do in thread mode)."""
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True, cancel_futures=True)
            self._proc_pool = None

    def __len__(self):
        n, gb = len(self.dataset), self.global_batch
        return n // gb if self.drop_last else -(-n // gb)

    def epoch(self, epoch: int) -> Iterator[tuple]:
        idx = epoch_indices(len(self.dataset), epoch, self.seed, self.shuffle)
        gb = self.global_batch
        batches = [idx[i * gb : (i + 1) * gb] for i in range(len(self))]
        if self.process_count > 1:
            lo = self.process_index * self.batch_size
            # a ragged last batch (drop_last=False) may leave a later rank
            # nothing: that batch is skipped there
            batches = [b[lo : lo + self.batch_size] for b in batches]
            batches = [b for b in batches if len(b)]
        nb = len(batches)
        pending: "queue_mod.Queue" = queue_mod.Queue()
        if self.workers_mode == "process":
            ex = self._get_proc_pool()

            def submit(i, b):
                return ex.submit(_proc_assemble, b, task_seed(self.seed, epoch, i))
        else:
            ex = futures.ThreadPoolExecutor(max_workers=self.workers)

            def submit(i, b):
                # each worker assembles a whole batch; parallelism comes from
                # `workers` batches in flight
                return ex.submit(lambda: _stack([self.dataset[int(j)] for j in b]))

        try:
            depth = min(self.prefetch, nb)
            for i, b in enumerate(batches[:depth]):
                pending.put(submit(i, b))
            for i in range(nb):
                fut = pending.get()
                if i + depth < nb:
                    pending.put(submit(i + depth, batches[i + depth]))
                yield fut.result()
        finally:
            if self.workers_mode == "process":
                # the pool outlives the epoch: drop queued work only
                while not pending.empty():
                    pending.get().cancel()
            else:
                ex.shutdown(wait=False, cancel_futures=True)


def build_loaders(cfg: Config, seed: int = 0, process_index: int = 0, process_count: int = 1):
    """The reference's get_loader (dataset/builder.py:9-43): (sup, unsup,
    val) for the *_semi dataset types, else (sup, val); rank
    `process_index` of `process_count` assembles its slice of each batch.

    The unlabeled list is the labeled one with "labeled.txt" ->
    "unlabeled.txt" (pascal_voc.py:131), and both train loaders sample
    pool - n_sup pairs (pascal_voc.py:109) so they have the same length."""
    d = cfg.dataset

    def mk(split_cfg):
        return build_transform(split_cfg, d.mean, d.std, d.ignore_label,
                               output_u8=d.device_normalize)

    common = dict(workers=d.workers, workers_mode=d.workers_mode, process_index=process_index,
                  process_count=process_count)
    val_ds = SegDataset(d.val.data_root, d.val.data_list, mk(d.val), seed, None, "val")
    val_loader = EpochLoader(val_ds, d.batch_size, seed, shuffle=False, drop_last=False, **common)
    if d.is_semi:
        n_unsup = d.pool_size - d.n_sup
        sup_ds = SegDataset(d.train.data_root, d.train.data_list, mk(d.train), seed, n_unsup,
                            "train")
        unsup_list = d.train.data_list.replace("labeled.txt", "unlabeled.txt")
        unsup_ds = SegDataset(d.train.data_root, unsup_list, mk(d.train), seed, n_unsup, "train")
        return (EpochLoader(sup_ds, d.batch_size, seed, True, True, **common),
                EpochLoader(unsup_ds, d.batch_size, seed, True, True, **common), val_loader)
    sup_ds = SegDataset(d.train.data_root, d.train.data_list, mk(d.train), seed, d.n_sup, "train")
    return EpochLoader(sup_ds, d.batch_size, seed, True, True, **common), val_loader

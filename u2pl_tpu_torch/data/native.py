"""ctypes bindings of the host data plane (`data/csrc/augment.cc`; port of
u2pl_tpu/native).

Nothing is built when the module is imported: `load()` compiles the
library with g++ at first use into `u2pl_tpu_torch/kernels/build/` (beside
the CUDA library, named by a hash of the source and flags, so an edited
source is never run from a stale library) and binds it.  A failed build
raises: the fused path never quietly gives way to numpy.

    python -m u2pl_tpu_torch.data.native     # build now
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "csrc", "augment.cc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "kernels", "build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffast-math"]
_LOAD_LOCK = threading.Lock()  # the loader's threads reach `load` at once


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libu2pl_data_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile unless the library for the current source exists; its path."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a name of its own for each builder (threads of one process, or
    # spawned workers), then an atomic rename: a concurrent builder or
    # loader sees all of the library or none of it
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=os.path.basename(out) + ".", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The bound library (built first if needed); safe to call from several
    threads at once."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.u2pl_augment_sample.argtypes = [
        u8p, c, c, u8p, f32p, f32p, f32p, c, c, c, c, c, c, c, c, f32p, i32p,
    ]
    lib.u2pl_augment_sample.restype = None
    return lib


def augment_sample(
    img: np.ndarray,  # (h, w, 3) uint8
    label: np.ndarray,  # (h, w) uint8
    mean: np.ndarray,
    std: np.ndarray,
    new_h: int,
    new_w: int,
    flip: bool,
    crop_h: int,
    crop_w: int,
    off_y: int,
    off_x: int,
    pad_label: int,
    pad_rgb: np.ndarray,
):
    """One fused sample: ((crop_h, crop_w, 3) float32, (crop_h, crop_w) int32).
    new_h / new_w: the scaled size; off_y / off_x: the crop origin in the
    padded scaled image (padding centred, image pad `pad_rgb`, label pad
    `pad_label`)."""
    out_img = np.empty((crop_h, crop_w, 3), np.float32)
    out_lab = np.empty((crop_h, crop_w), np.int32)
    load().u2pl_augment_sample(
        np.ascontiguousarray(img), img.shape[0], img.shape[1], np.ascontiguousarray(label),
        np.ascontiguousarray(mean, dtype=np.float32), np.ascontiguousarray(std, dtype=np.float32),
        np.ascontiguousarray(pad_rgb, dtype=np.float32), int(new_h), int(new_w), int(bool(flip)),
        int(crop_h), int(crop_w), int(off_y), int(off_x), int(pad_label), out_img, out_lab,
    )
    return out_img, out_lab


if __name__ == "__main__":
    print(build())

"""Builds the CUDA kernels of `csrc/` into one shared library with nvcc.

The library has a plain C interface and is loaded with ctypes (see
`kernels/__init__.py`): no PyTorch headers are compiled, which keeps the
build to seconds.  Each `.cu` source is compiled by its own nvcc process,
all started together, and the objects are then linked.  The library is
built at first use into `kernels/build/`, named by a hash of the sources
and flags, so an edited source is never run from a stale library.

    python -m u2pl_tpu_torch.kernels.build     # build now, print the log
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")

# sm_90a: the Hopper target (H100/H200).  -Xptxas -v reports each kernel's
# registers, shared memory and spills in the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of u2pl_tpu_torch "
        "are compiled from source at first use"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libu2pl_kernels_{h.hexdigest()[:16]}.so")


def build() -> Tuple[str, float, str]:
    """Compile unless the library for the current sources exists.

    Returns (library path, build seconds (0.0 when it existed), nvcc log)."""
    out = library_path()
    if os.path.isfile(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out}.{os.getpid()}"
    cu = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(s)}.o" for s in cu]
    t0 = time.monotonic()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [src for src, p in zip(cu, procs) if p.returncode != 0]
    if not failed:
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", f"{tag}.tmp", *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = ["link"]
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.monotonic() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}\n{log}")
    os.replace(f"{tag}.tmp", out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds, log


if __name__ == "__main__":
    path, secs, log = build()
    print(log)
    print(f"{path} ({secs:.1f}s)")

"""Port resize ops (u2pl_tpu_torch/ops/resize.py) against the JAX package.

On the CPU the wrappers take their plain PyTorch versions, which are held
against the JAX functions here; the CUDA kernels are held against those
plain versions on the card in tests/test_torch_cuda.py.
"""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2pl_tpu.ops.resize import _interp_matrix_np as jax_interp_matrix
from u2pl_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from u2pl_tpu.ops.resize import resize_bilinear_numpy as jax_resize_numpy
from u2pl_tpu_torch.ops import resize as tr

# the (in, out) list of tests/test_ops.py:19-26
SIZES = [
    ((129, 129), (513, 513)),  # rep/logit upsample os4 -> crop
    ((513, 513), (129, 129)),
    ((97, 65), (513, 513)),
    ((7, 9), (33, 17)),
    ((33, 17), (7, 9)),
    ((1, 5), (4, 10)),
]

# (C, H, W) logits -> (h, w) mask, small enough that a near-tie between two
# classes (where f32 rounding order could flip the argmax) is improbable
ARGMAX_SHAPES = [
    ((21, 129, 129), (75, 100)),
    ((21, 33, 17), (7, 9)),
    ((21, 7, 9), (33, 17)),
    ((5, 1, 5), (4, 10)),
]


@pytest.mark.parametrize("insz,outsz", SIZES)
@pytest.mark.parametrize("align", [True, False])
def test_interp_matrix_is_the_jax_table(insz, outsz, align):
    for n_in, n_out in zip(insz, outsz):
        np.testing.assert_array_equal(
            tr._interp_matrix_np(n_in, n_out, align),
            jax_interp_matrix(n_in, n_out, align),
        )


@pytest.mark.parametrize("insz,outsz", SIZES)
@pytest.mark.parametrize("align", [True, False])
def test_resize_bilinear_plain_matches_jax(insz, outsz, align):
    x = np.random.RandomState(0).randn(2, insz[0], insz[1], 3).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), outsz, align_corners=align))
    got = tr.resize_bilinear_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), outsz, align
    )
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("insz,outsz", SIZES)
def test_resize_numpy_is_the_jax_host_copy(insz, outsz):
    x = np.random.RandomState(1).randn(insz[0], insz[1], 3).astype(np.float32)
    np.testing.assert_array_equal(
        tr.resize_bilinear_numpy(x, outsz), jax_resize_numpy(x, outsz)
    )


@pytest.mark.parametrize("chw,outsz", ARGMAX_SHAPES)
def test_resize_argmax_plain_matches_jax_numpy(chw, outsz):
    x = np.random.RandomState(2).randn(*chw).astype(np.float32)
    ref = jax_resize_numpy(x.transpose(1, 2, 0), outsz).argmax(-1).astype(np.uint8)
    got = tr.resize_argmax_plain(torch.from_numpy(x), outsz)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_argmax_keeps_first_maximum():
    x = torch.zeros(4, 3, 3)
    x[1] = 1.0
    x[3] = 1.0  # tie with class 1: the first maximum wins, as np.argmax
    assert (tr.resize_argmax_plain(x, (5, 5)) == 1).all()


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 7, 9).astype(np.float32))
    logits = torch.from_numpy(rng.randn(5, 7, 9).astype(np.float32))
    a0, b0 = tr.resize_bilinear.launches, tr.resize_argmax.launches
    assert torch.equal(tr.resize_bilinear(x, (33, 17)), tr.resize_bilinear_plain(x, (33, 17)))
    assert torch.equal(tr.resize_argmax(logits, (4, 10)), tr.resize_argmax_plain(logits, (4, 10)))
    assert tr.resize_bilinear(x, (7, 9)) is x  # same size: returned as is
    assert (tr.resize_bilinear.launches, tr.resize_argmax.launches) == (a0, b0) == (0, 0)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        tr.resize_bilinear(torch.zeros(3, 7, 9), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_argmax(torch.zeros(1, 3, 7, 9), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_argmax(torch.zeros(256, 2, 2), (4, 4))


def test_kernels_package_imports_without_nvcc():
    """Importing the kernels package and the resize ops needs no nvcc, no
    triton and no card: building and binding happen at the first launch."""
    code = (
        "import sys, u2pl_tpu_torch.kernels, u2pl_tpu_torch.kernels.build as b; "
        "import u2pl_tpu_torch.ops.resize; "
        "assert b.library_path().endswith('.so'); "
        "assert 'triton' not in sys.modules"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
    if shutil.which("nvcc") is None:
        import u2pl_tpu_torch.kernels as k

        assert k.load.cache_info().currsize == 0

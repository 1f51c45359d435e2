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


@pytest.mark.parametrize("insz,outsz", SIZES + [((1, 1), (6, 7)), ((9, 7), (13, 30))])
@pytest.mark.parametrize("align", [True, False])
def test_resize_bilinear_rounded_matches_jax(insz, outsz, align):
    """The rounded H-then-W formula that the card tests hold kernel A to,
    bit for bit, against the JAX function (and beside the plain version)."""
    x = np.random.RandomState(1).randn(2, insz[0], insz[1], 3).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), outsz, align_corners=align))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tr.resize_bilinear_rounded(xt, outsz, align)
    assert got.shape == (2, 3, *outsz)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
    plain = tr.resize_bilinear_plain(xt, outsz, align)
    assert (got - plain).abs().max().item() <= 1e-5


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


@pytest.mark.parametrize("shape", [(1, 9, 9, 64), (2, 9, 9, 64), (1, 17, 13, 64),
                                   (1, 5, 7, 256)])
def test_ordered_bf16_adjoint_is_the_jax_vjp(shape):
    """The ordered bf16 adjoint that the card holds A-bwd's wide 2x branch
    to (tests/test_torch_cuda.py:_ordered_adjoint_bf16, and the package's
    `resize_bilinear_bwd_ordered`), run on the CPU, bit-equal to `jax.vjp`
    of the JAX function on a bf16 NHWC input at an n -> 2n - 1 upsample."""
    import jax
    import ml_dtypes

    from test_torch_cuda import _ordered_adjoint_bf16

    b, h, w, c = shape
    size = (2 * h - 1, 2 * w - 1)
    rng = np.random.RandomState(b + h + w + c)
    x = rng.randn(*shape).astype(ml_dtypes.bfloat16)
    g = (rng.randn(b, *size, c) * 3).astype(ml_dtypes.bfloat16)
    _, vjp = jax.vjp(lambda a: jax_resize_bilinear(a, size), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    assert ref.dtype == jnp.bfloat16
    ref = np.moveaxis(np.asarray(ref.astype(jnp.float32)), -1, 1)
    gy = torch.from_numpy(np.moveaxis(g.astype(np.float32), -1, 1).copy()).to(torch.bfloat16)
    assert tr._wide(gy.dtype, c, (h, w), size, True)
    got = _ordered_adjoint_bf16(gy, h, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert torch.equal(tr.resize_bilinear_bwd_ordered(gy, (h, w)).view(torch.int16),
                       got.view(torch.int16))


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

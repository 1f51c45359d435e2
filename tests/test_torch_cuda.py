"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

(`--noconftest`: tests/conftest.py pins JAX to the CPU and imports it.)
"""

import pytest
import torch

from u2pl_tpu_torch.ops import resize as tr

pytestmark = pytest.mark.cuda

# the (in, out) list of tests/test_ops.py:19-26, plus the decoder's upsample
SIZES = [
    ((129, 129), (513, 513)),
    ((513, 513), (129, 129)),
    ((97, 65), (513, 513)),
    ((7, 9), (33, 17)),
    ((33, 17), (7, 9)),
    ((1, 5), (4, 10)),
    ((65, 65), (129, 129)),
]

ARGMAX_SHAPES = [
    ((21, 513, 513), (375, 500)),
    ((21, 513, 513), (500, 333)),
    ((21, 33, 17), (7, 9)),
    ((5, 1, 5), (4, 10)),
]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain version
    return torch.device("cuda")


@pytest.mark.parametrize("insz,outsz", SIZES)
@pytest.mark.parametrize("align", [True, False])
def test_kernel_a_matches_plain(insz, outsz, align):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 3, insz[0], insz[1], device=dev, generator=g)
    n = tr.resize_bilinear.launches
    got = tr.resize_bilinear(x, outsz, align)
    torch.cuda.synchronize()
    assert tr.resize_bilinear.launches == n + 1
    ref = tr.resize_bilinear_plain(x, outsz, align)
    # products and sums rounded one by one in both: only the matmul's
    # FMA/summation order differs, well inside 1e-5 for |x| < 6
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("chw,outsz", ARGMAX_SHAPES)
def test_kernel_b_matches_plain(chw, outsz):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*chw, device=dev, generator=g)
    n = tr.resize_argmax.launches
    got = tr.resize_argmax(x, outsz)
    torch.cuda.synchronize()
    assert tr.resize_argmax.launches == n + 1
    ref = tr.resize_argmax_plain(x, outsz)
    # labels may differ only where the two best classes are within f32
    # rounding of each other
    top2 = tr.resize_bilinear_plain(x[None], outsz)[0].topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * top2[0].abs().clamp(min=1.0)
    assert not ((got != ref) & ~near_tie).any()


def test_kernels_refuse_what_they_do_not_take():
    dev = _cuda()
    x = torch.randn(2, 3, 8, 8, device=dev)
    with pytest.raises(TypeError):
        tr.resize_bilinear(x.double(), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_bilinear(x.transpose(2, 3), (4, 4))
    with pytest.raises(TypeError):
        tr.resize_argmax(x[0].half(), (4, 4))
    with pytest.raises(ValueError):
        tr.resize_argmax(torch.randn(256, 4, 4, device=dev), (8, 8))

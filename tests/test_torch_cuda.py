"""The port's CUDA kernels against their plain torch versions, on an NVIDIA
GPU. Every test here carries the `cuda` marker and skips without a card; the
module imports neither jax nor the JAX package, so it also runs on a machine
that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
from paella_tpu_torch.kernels.resblock import fused_resblock, prepare_resblock_weights, resblock_plain
from paella_tpu_torch.kernels.sampling import (
    fused_head_categorical,
    gumbel_categorical,
    gumbel_categorical_plain,
    head_categorical_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    return torch.device("cuda")


def check_resblock(x, w, film, skip):
    got = fused_resblock(x, w, film=film, skip=skip).float()
    want = resblock_plain(x, w, film=film, skip=skip).float()
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    else:
        assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 5, 7, 64)])  # split fc2 / ragged M tile
def test_resblock_kernel_matches_plain(cuda, dtype, with_skip, shape):
    b, hh, ww, c = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_resblock_weights(
        r(c, 2 if with_skip else 1, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5),
        r(4 * c, std=0.1), r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5),
        r(c, std=0.1), dtype,
    )
    x = r(b, hh, ww, c, std=1.0).to(dtype)
    skip = r(b, hh, ww, c, std=1.0).to(dtype) if with_skip else None
    check_resblock(x, w, (r(b, 2 * c, std=0.2)).to(dtype), skip)


@pytest.mark.parametrize("with_cfg", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_kernel_matches_plain(cuda, dtype, with_cfg):
    g = torch.Generator(device=cuda).manual_seed(1)
    fc = torch.randn(2, 16, 16, 64, generator=g, device=cuda).to(dtype)
    fu = torch.randn(2, 16, 16, 64, generator=g, device=cuda).to(dtype) if with_cfg else None
    w_out = (torch.randn(512, 64, generator=g, device=cuda) * 0.3).to(dtype)
    seeds = torch.tensor(np.array([[1, 0xDEADBEEF], [0xFFFFFFFF, 7]], np.int64))
    args = (seeds, fc, fu, 3.0, w_out, 0.8)
    got, want = fused_head_categorical(*args), head_categorical_plain(*args)
    assert got.dtype == torch.int32 and got.shape == (2, 16, 16)
    assert (got == want).float().mean() >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 512), (3, 5, 7, 200)])  # two images / a ragged row count
def test_gumbel_kernel_matches_plain(cuda, dtype, shape):
    """The same hash bits and score rounding: tokens equal."""
    g = torch.Generator(device=cuda).manual_seed(2)
    logits = (torch.randn(*shape, generator=g, device=cuda) * 3.0).to(dtype)
    seeds = torch.tensor(np.array([[5, 0xDEADBEEF], [0xFFFFFFFF, 7], [1, 2]][: shape[0]], np.int64))
    got, want = gumbel_categorical(seeds, logits, 0.7), gumbel_categorical_plain(seeds, logits, 0.7)
    assert got.dtype == torch.int32 and got.shape == shape[:-1]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("m,k", [(4096, 8192), (1000, 300), (7, 1)])
def test_codebook_lookup_kernel_matches_plain(cuda, m, k):
    """Sequential round-to-nearest sums in both: indices equal."""
    g = torch.Generator(device=cuda).manual_seed(3)
    z = torch.randn(m, 4, generator=g, device=cuda)
    cb = torch.randn(k, 4, generator=g, device=cuda)
    got, want = fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb)
    assert got.dtype == torch.int32 and got.shape == (m,)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

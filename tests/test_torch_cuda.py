"""The port's CUDA kernels against their plain torch versions, on an NVIDIA
GPU. Every test here carries the `cuda` marker and skips without a card; the
module imports neither jax nor the JAX package, so it also runs on a machine
that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paella_tpu_torch.kernels.attention import attention_plain, fused_attention
from paella_tpu_torch.kernels.attn_block import attn_block_plain, fused_attn_block, prepare_attn_block_weights
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


def test_resblock_kernel_is_deterministic(cuda):
    """The GRN sums have a fixed order (no atomics): two runs at the
    flagship's level-0 shape are bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, hh, ww, c = 2, 32, 32, 640
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_resblock_weights(
        r(c, 1, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1),
        r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1), torch.bfloat16,
    )
    x = r(b, hh, ww, c, std=1.0).to(torch.bfloat16)
    film = r(b, 2 * c, std=0.2).to(torch.bfloat16)
    first = fused_resblock(x, w, film=film)
    assert torch.equal(fused_resblock(x, w, film=film), first)


def test_kernels_are_batch_invariant(cuda):
    """An image's output does not depend on its batchmates: K1 (its fc2 split
    count is chosen per CFG pair, not per batch), K5 and K6 give the first
    two batch items the same bits at batch 2 and at batch 8, as the server's
    micro-batches need."""
    g = torch.Generator(device=cuda).manual_seed(8)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    c = 1280
    w1 = prepare_resblock_weights(
        r(c, 1, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1),
        r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1), torch.bfloat16,
    )
    x = r(8, 8, 8, c, std=1.0).to(torch.bfloat16)
    film = r(8, 2 * c, std=0.2).to(torch.bfloat16)
    assert torch.equal(fused_resblock(x[:2], w1, film=film[:2]), fused_resblock(x, w1, film=film)[:2])
    q, k, v = (r(8, n, 16, 80, std=1.0).to(torch.bfloat16) for n in (64, 136, 136))
    assert torch.equal(fused_attention(q[:2], k[:2], v[:2]), fused_attention(q, k, v)[:2])
    w6 = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05), torch.bfloat16)
    kv = r(8, 72, c, std=1.0).to(torch.bfloat16)
    assert torch.equal(fused_attn_block(x[:2], kv[:2], w6, 16), fused_attn_block(x, kv, w6, 16)[:2])


def close_in_dtype(got, want):
    """f32: 1e-5 (the same f32 arithmetic in another summation order). bf16:
    two bf16 ulps of the largest output (the output is rounded to bf16, and a
    p or q/k/v value on a rounding boundary may round the other way)."""
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2 ** -7 * want.float().abs().max().item(), err


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 37, 4, 16), (2, 5, 70, 3, 80), (2, 256, 328, 16, 80)])
def test_attention_kernel_matches_plain(cuda, dtype, with_mask, shape):
    """(B, N, S, H, D): ragged query and key tiles, and the flagship's level 1."""
    b, n, s, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(b, length, h, d, generator=g, device=cuda).to(dtype) for length in (n, s, s))
    mask = torch.rand(b, s, generator=g, device=cuda) < 0.7 if with_mask else None
    got = fused_attention(q, k, v, mask)
    close_in_dtype(got, attention_plain(q, k, v, mask))
    assert torch.equal(fused_attention(q, k, v, mask), got)


def test_attention_kernel_takes_projection_halves(cuda):
    """k and v as the two halves of one (B, S, 2C) projection, as the
    module path hands them over."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(2, 64, 16, 80, generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn(2, 136, 2 * 1280, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (t.reshape(2, 136, 16, 80) for t in kv.split(1280, dim=-1))
    close_in_dtype(fused_attention(q, k, v), attention_plain(q, k.contiguous(), v.contiguous()))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 128, 4, 6), (2, 8, 640, 8, 9), (2, 16, 1280, 16, 72)])
def test_attn_block_kernel_matches_plain(cuda, dtype, with_mask, shape):
    """(B, HW, C, heads, S_cond): K6 against its plain version; f32 within
    1e-4 (products of depth C in another order), bf16 within 2e-2 of the
    largest output (q, k, v and a are rounded to bf16, so a value on a
    rounding boundary may round the other way, as in K1)."""
    b, hw, c, nhead, s_c = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05), dtype)
    x = r(b, hw, hw, c, std=1.0).to(dtype)
    kv = r(b, s_c, c, std=1.0).to(dtype)
    mask = None
    if with_mask:
        mask = torch.rand(b, s_c, generator=g, device=cuda) < 0.7
        mask[:, 0] = True
    got = fused_attn_block(x, kv, w, nhead, mask)
    want = attn_block_plain(x, kv, w, nhead, mask)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert (got.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()
    assert torch.equal(fused_attn_block(x, kv, w, nhead, mask), got)


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

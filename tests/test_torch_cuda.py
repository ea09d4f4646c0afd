"""The port's CUDA kernels against their plain torch versions, on an NVIDIA
GPU. Every test here carries the `cuda` marker and skips without a card; the
module imports neither jax nor the JAX package, so it also runs on a machine
that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paella_tpu_torch.kernels.attention import attention_plain, design_code, fused_attention
from paella_tpu_torch.kernels.attn_block import attn_block_plain, fused_attn_block, prepare_attn_block_weights
from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
from paella_tpu_torch.kernels.resblock import (
    fused_resblock,
    prepare_resblock_weights,
    resblock_plain,
)
from paella_tpu_torch.kernels.sampling import (
    draw_noise,
    fused_head_categorical,
    gumbel_categorical,
    gumbel_categorical_plain,
    head_categorical_plain,
    head_plan,
    uniform_from_bits,
)
from paella_tpu_torch.quant import quantize_dense_int8, w8a8_dot

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


def bf16_resblock(c: int, g, cpg: int = 1):
    r = lambda *s, std: torch.randn(*s, generator=g, device=g.device) * std  # noqa: E731
    return prepare_resblock_weights(
        r(c, cpg, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1),
        r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1), torch.bfloat16,
    )


@pytest.mark.parametrize("shape", [
    (3, 6, 10, 128),  # M 180: a ragged 128-row tile, tiles across images, hw not a multiple of 32
    (4, 4, 8, 128),  # hw 32: four images in one 128-row tile
    (2, 8, 8, 1280),  # the flagship's level 2: one tile holds both images, fc2 in 4 K splits
    (1, 5, 7, 64),  # M 35 < 128, 64-wide tiles
])
def test_resblock_wgmma_tiles_match_plain(cuda, shape):
    """The bf16 float mode's wgmma phases (128-row tiles, GRN partials per
    image a tile touches, split fc2) against the plain version, within 2e-2
    of the largest output, and bitwise equal on a second run."""
    b, hh, ww, c = shape
    g = torch.Generator(device=cuda).manual_seed(13)
    w = bf16_resblock(c, g)
    x = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(torch.bfloat16)
    film = (torch.randn(b, 2 * c, generator=g, device=cuda) * 0.2).to(torch.bfloat16)
    got = fused_resblock(x, w, film=film)
    check_resblock(x, w, film, None)
    assert torch.equal(fused_resblock(x, w, film=film), got)


FLAGSHIP_RESBLOCKS = [(2, 32, 32, 640, False), (2, 32, 32, 640, True), (2, 16, 16, 1280, False), (2, 8, 8, 1280, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLAGSHIP_RESBLOCKS)
def test_resblock_kernel_is_bitwise_repeatable_at_flagship_shapes(cuda, dtype, shape):
    """K1 + FiLM at the flagship's four CFG batch-2 ResBlock shapes against
    its plain version: finite, f32 (TF32 off) within 1e-3, bf16 within 2e-2
    of the largest output; two runs bitwise equal."""
    b, hh, ww, c, with_skip = shape
    w = seeded_resblock(np.random.default_rng(11), c, 2 if with_skip else 1, dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(dtype)
    skip = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(dtype) if with_skip else None
    film = (torch.randn(b, 2 * c, generator=g, device=cuda) * 0.2).to(dtype)
    got = fused_resblock(x, w, film=film, skip=skip)
    want = resblock_plain(x, w, film=film, skip=skip).float()
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want).abs().max().item()
    assert err <= (1e-3 if dtype == torch.float32 else 2e-2 * want.abs().max().item()), err
    assert torch.equal(fused_resblock(x, w, film=film, skip=skip), got)


@pytest.mark.parametrize("shape,mode,dtype", [(s, m, torch.bfloat16) for s in FLAGSHIP_RESBLOCKS for m in ("int8", "w8a8")]
                         + [((2, 16, 16, 1280, False), "int8", torch.float32)])
def test_resblock_int8_kernel_at_flagship_shapes(cuda, shape, mode, dtype):
    """K1b + FiLM at the flagship's four ResBlock shapes, both int8 modes in
    bf16 and weight-only in f32 at (2, 16, 16, 1280): finite; within 1e-3
    (f32) or 2e-2 of the largest output (bf16; in W8A8 an s8 code at a
    rounding tie may round the other way when the f32 values before it
    differ in their last ulp, moving its row by one quantization step), with
    99% of the elements equal to the plain version's in bf16; bitwise equal
    on a second run; an image's output at batch 2 equal to it at batch 8."""
    b, hh, ww, c, with_skip = shape
    w = seeded_resblock(np.random.default_rng(17), c, 2 if with_skip else 1, dtype, mode)
    g = torch.Generator(device=cuda).manual_seed(17)
    x8 = torch.randn(8, hh, ww, c, generator=g, device=cuda).to(dtype)
    skip8 = torch.randn(8, hh, ww, c, generator=g, device=cuda).to(dtype) if with_skip else None
    film8 = (torch.randn(8, 2 * c, generator=g, device=cuda) * 0.2).to(dtype)
    x, skip, film = x8[:b], None if skip8 is None else skip8[:b], film8[:b]
    got = fused_resblock(x, w, film=film, skip=skip)
    want = resblock_plain(x, w, film=film, skip=skip)
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (1e-3 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item()), err
    if dtype == torch.bfloat16:
        assert (got == want).float().mean().item() >= 0.99
    assert torch.equal(fused_resblock(x, w, film=film, skip=skip), got)
    assert torch.equal(fused_resblock(x8, w, film=film8, skip=skip8)[:b], got)


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
    w6 = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05), torch.bfloat16,
                                    16)
    kv = r(8, 72, c, std=1.0).to(torch.bfloat16)
    assert torch.equal(fused_attn_block(x[:2], kv[:2], w6, 16), fused_attn_block(x, kv, w6, 16)[:2])


def int8_resblock(c: int, cpg: int, dtype, g, act_quant: bool):
    """Random ResBlock weights with fc1/fc2 quantized as quantize_paella_int8 does."""
    r = lambda *s, std: torch.randn(*s, generator=g, device=g.device) * std  # noqa: E731
    q1, s1 = quantize_dense_int8(r(4 * c, c, std=c**-0.5))
    q2, s2 = quantize_dense_int8(r(c, 4 * c, std=(4 * c) ** -0.5))
    return prepare_resblock_weights(
        r(c, cpg, 3, 3, std=0.2), r(c, std=0.1), q1, r(4 * c, std=0.1), r(4 * c, std=0.2), r(4 * c, std=0.2),
        q2, r(c, std=0.1), dtype, fc1_scale=s1, fc2_scale=s2, act_quant=act_quant,
    )


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 5, 7, 64)])  # split fc2 / ragged M tile
def test_resblock_int8_kernel_matches_plain(cuda, dtype, with_skip, act_quant, shape):
    """K1b against its plain version. Weight-only: K1's tolerances. W8A8:
    within 2e-2 of the largest output (an s8 code at a rounding tie may round
    the other way when the f32 values before it differ in their last ulp,
    which moves its row by one quantization step, 1/127 of the row's
    scale), and 99% of elements within K1's tolerance."""
    b, hh, ww, c = shape
    g = torch.Generator(device=cuda).manual_seed(9)
    w = int8_resblock(c, 2 if with_skip else 1, dtype, g, act_quant)
    x = (torch.randn(b, hh, ww, c, generator=g, device=cuda)).to(dtype)
    skip = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(dtype) if with_skip else None
    film = (torch.randn(b, 2 * c, generator=g, device=cuda) * 0.2).to(dtype)
    got = fused_resblock(x, w, film=film, skip=skip, tile_n1=128)
    want = resblock_plain(x, w, film=film, skip=skip, tile_n1=128)
    assert torch.equal(fused_resblock(x, w, film=film, skip=skip, tile_n1=128), got)
    err, scale = (got.float() - want.float()).abs(), want.float().abs().max()
    tol = 1e-3 if dtype == torch.float32 else 2e-2 * scale
    if act_quant:
        assert err.max() <= 2e-2 * scale and (err <= tol).float().mean() >= 0.99, (err.max(), (err <= tol).float().mean())
    else:
        assert err.max() <= tol, err.max()


def test_resblock_int8_kernel_is_batch_invariant(cuda):
    """Both int8 modes give an image the same bits at batch 2 and 8."""
    g = torch.Generator(device=cuda).manual_seed(10)
    c = 1280
    x = torch.randn(8, 8, 8, c, generator=g, device=cuda).to(torch.bfloat16)
    film = (torch.randn(8, 2 * c, generator=g, device=cuda) * 0.2).to(torch.bfloat16)
    for act_quant in (False, True):
        w = int8_resblock(c, 1, torch.bfloat16, g, act_quant)
        assert torch.equal(fused_resblock(x[:2], w, film=film[:2]), fused_resblock(x, w, film=film)[:2])


@pytest.mark.parametrize("act_quant", [False, True])
def test_resblock_int8_kernel_split_k_at_width_640(cuda, act_quant):
    """K1b at (2, 8, 8, 640), the flagship's level 0 at a 64x64-pixel image:
    fc2 runs 8 K splits, each of whole 64-byte s8 tiles in W8A8 (K 2560 holds
    40 of them, 80 of the 32-deep float tiles). Within 2e-2 of the largest
    output, as test_resblock_int8_kernel_matches_plain at bf16, and in W8A8,
    whose s32 sums are exact, 99% of elements equal to the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(12)
    c = 640
    w = int8_resblock(c, 1, torch.bfloat16, g, act_quant)
    x = torch.randn(2, 8, 8, c, generator=g, device=cuda).to(torch.bfloat16)
    film = (torch.randn(2, 2 * c, generator=g, device=cuda) * 0.2).to(torch.bfloat16)
    got, want = fused_resblock(x, w, film=film).float(), resblock_plain(x, w, film=film).float()
    err = (got - want).abs().max()
    assert err <= 2e-2 * want.abs().max(), err
    if act_quant:
        assert (got == want).float().mean() >= 0.99, (got == want).float().mean()


@pytest.mark.parametrize("rows,k,n", [(64, 2560, 2048), (17, 64, 48), (10, 64, 48)])
def test_w8a8_dot_on_card_equals_cpu(cuda, rows, k, n):
    """quant.w8a8_dot (torch._int_mm) at ByT5-XL's widths, at cuBLASLt's
    smallest row count and below it (zero rows padded): the s32 sums are
    exact, so the card gives the CPU's values bit for bit."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(rows, k, generator=g)
    q, s = quantize_dense_int8(torch.randn(n, k, generator=g) * k**-0.5)
    want = w8a8_dot(x, q, s, torch.float32)
    torch.testing.assert_close(w8a8_dot(x.cuda(), q.cuda(), s.cuda(), torch.float32).cpu(), want, rtol=0, atol=0)


def close_in_dtype(got, want):
    """f32: 1e-5 (the same f32 arithmetic in another summation order). bf16:
    two bf16 ulps of the largest output (the output is rounded to bf16, and a
    p or q/k/v value on a rounding boundary may round the other way)."""
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2 ** -7 * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_mask", [(shape, m) for shape in [(2, 37, 37, 4, 16), (2, 5, 70, 3, 80),
                                                                      (2, 256, 328, 16, 80)] for m in (False, True)]
                         + [((2, 256, 328, 16, 80), "cfg")])
def test_attention_kernel_matches_plain(cuda, dtype, with_mask, shape):
    """(B, N, S, H, D): ragged query and key tiles, and the flagship's level 1,
    unmasked, under a random key mask and (level 1) under the CFG pair's."""
    b, n, s, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(b, length, h, d, generator=g, device=cuda).to(dtype) for length in (n, s, s))
    mask = torch.rand(b, s, generator=g, device=cuda) < 0.7 if with_mask else None
    if with_mask == "cfg":
        mask = cfg_pair_mask(b, n, s - n, cuda)
    got = fused_attention(q, k, v, mask)
    close_in_dtype(got, attention_plain(q, k, v, mask))
    assert torch.equal(fused_attention(q, k, v, mask), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_mask", [(shape, m) for shape in [
    (2, 256, 1036, 16, 80),  # conditioning of ~780 tokens: K and V stream through the ring
    (2, 8, 100, 4, 80),  # N < 16, S not a multiple of the 64-key tile
    (1, 200, 130, 2, 64),  # 4 query warps, key tiles split across 2 groups, a ragged last tile (bf16: also wgmma)
    (2, 64, 136, 16, 80),  # the flagship's level 2: 1 query warp, 3 key groups
] for m in (False, True)] + [((2, 64, 136, 16, 80), "cfg")])
def test_attention_kernel_paths(cuda, dtype, with_mask, shape):
    """K5's resident and streamed paths against the plain version, bitwise
    repeatable, and the first image's output equal alone and in the batch;
    the ring forced as well, where the policy picks the wgmma variant.
    Unmasked, under a random key mask and (level 2) under the CFG pair's."""
    from paella_tpu_torch.kernels.attention import _launch

    b, n, s, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v = (torch.randn(b, length, h, d, generator=g, device=cuda).to(dtype) for length in (n, s, s))
    mask = None
    if with_mask == "cfg":
        mask = cfg_pair_mask(b, n, s - n, cuda)
    elif with_mask:
        mask = torch.rand(b, s, generator=g, device=cuda) < 0.5
        mask[:, 0] = True
    got, want = fused_attention(q, k, v, mask), attention_plain(q, k, v, mask)
    close_in_dtype(got, want)
    assert torch.equal(fused_attention(q, k, v, mask), got)
    one = fused_attention(q[:1], k[:1], v[:1], None if mask is None else mask[:1])
    assert torch.equal(one, got[:1])
    ring = _launch(q, k, v, mask, None, None, 0)
    close_in_dtype(ring, want)
    assert torch.equal(_launch(q, k, v, mask, None, None, 0), ring)


def test_attention_kernel_takes_projection_halves(cuda):
    """k and v as the two halves of one (B, S, 2C) projection, as the
    module path hands them over."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(2, 64, 16, 80, generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn(2, 136, 2 * 1280, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (t.reshape(2, 136, 16, 80) for t in kv.split(1280, dim=-1))
    close_in_dtype(fused_attention(q, k, v), attention_plain(q, k.contiguous(), v.contiguous()))


def kv_views(g, b: int, s: int, h: int, d: int, dtype=torch.bfloat16) -> tuple:
    """k and v (B, S, H, D) as the two halves of one (B, S, 2C) projection."""
    kv = torch.randn(b, s, 2 * h * d, generator=g, device=g.device).to(dtype)
    return tuple(t.reshape(b, s, h, d) for t in kv.split(h * d, dim=-1))


def stage_c_attention(g, b: int, n: int, s_c: int, h: int, d: int, dtype=torch.bfloat16) -> tuple:
    """q, k, v as views of one (B, N, 3C) q|k|v product and k2, v2 of one
    (B, S_cond, 2C) cond cache entry, as StageC._attend hands them to K5."""
    c = h * d
    qkv = torch.randn(b, n, 3 * c, generator=g, device=g.device).to(dtype)
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(c, dim=-1))
    return (q, k, v, *kv_views(g, b, s_c, h, d, dtype))


def test_attention_wgmma_variant_at_stage_c_shape(cuda):
    """Stage C's AttnBlock (B 8, N 576, 576 + 85 keys from two sources, H 32,
    D 64, bf16) takes the wgmma variant: within two bf16 ulps of the largest
    output of the plain version (close_in_dtype), bitwise equal on two runs,
    and item 0 alone equals item 0 of the batch of 8."""
    from paella_tpu_torch.kernels.attention import attention_design

    assert attention_design(8, 576, 661, 32, 64, torch.bfloat16) == ("wgmma", 3)
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v, k2, v2 = stage_c_attention(g, 8, 576, 85, 32, 64)
    got = fused_attention(q, k, v, k2=k2, v2=v2)
    close_in_dtype(got, attention_plain(q, k, v, None, k2, v2))
    assert torch.equal(fused_attention(q, k, v, k2=k2, v2=v2), got)
    assert torch.equal(fused_attention(q[:1], k[:1], v[:1], k2=k2[:1], v2=v2[:1]), got[:1])


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape", [(2, 100, 64, 37, 2), (1, 200, 150, 70, 2), (2, 576, 576, 85, 4)])
def test_attention_designs_match_plain_with_two_sources(cuda, with_mask, shape):
    """(B, N, S1, S2, H) at D 64 bf16, keys from two sources (S1 and S2 not
    multiples of the 64-key chunk): the ring and the wgmma variant, each
    forced, against the plain version, with and without a key mask."""
    from paella_tpu_torch.kernels.attention import _launch

    b, n, s1, s2, h = shape
    g = torch.Generator(device=cuda).manual_seed(23)
    q = torch.randn(b, n, h, 64, generator=g, device=cuda).to(torch.bfloat16)
    (k, v), (k2, v2) = kv_views(g, b, s1, h, 64), kv_views(g, b, s2, h, 64)
    mask = None
    if with_mask:
        mask = torch.rand(b, s1 + s2, generator=g, device=cuda) < 0.6
        mask[:, 0] = True
    want = attention_plain(q, k, v, mask, k2, v2)
    for design in (0, 1, 3):  # the ring; the wgmma variant with 1 and 3 query tiles a block
        got = _launch(q, k, v, mask, k2, v2, design)
        close_in_dtype(got, want)
        assert torch.equal(_launch(q, k, v, mask, k2, v2, design), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 80])
def test_attention_ring_with_two_sources(cuda, dtype, d):
    """The ring (f32, and bf16 at head dims the variant does not take) reads
    k2 and v2 as keys past S1, as the plain version's concatenation does."""
    g = torch.Generator(device=cuda).manual_seed(24)
    q, k, v, k2, v2 = stage_c_attention(g, 2, 50, 21, 4, d, dtype)
    got = fused_attention(q, k, v, k2=k2, v2=v2)
    close_in_dtype(got, attention_plain(q, torch.cat([k, k2], 1), torch.cat([v, v2], 1)))
    assert torch.equal(fused_attention(q, k, v, k2=k2, v2=v2), got)


def test_attention_policy_keeps_paella_shapes_on_the_ring(cuda):
    """Paella's attention-config shapes (D 80: N 256 / S 328, N 64 / S 136 at
    B 2, H 16, and the streamed S 1036) take the ring: the policy says so,
    and their outputs are bit for bit the ring's forced."""
    from paella_tpu_torch.kernels.attention import _launch, attention_design

    g = torch.Generator(device=cuda).manual_seed(25)
    for n, s in ((256, 328), (64, 136), (256, 1036)):
        assert attention_design(2, n, s, 16, 80, torch.bfloat16) == ("ring", 0)
        q, k, v = (torch.randn(2, ln, 16, 80, generator=g, device=cuda).to(torch.bfloat16) for ln in (n, s, s))
        assert torch.equal(fused_attention(q, k, v), _launch(q, k, v, None, None, None, 0))
    assert attention_design(8, 576, 661, 32, 64, torch.float32) == ("ring", 0)
    assert attention_design(2, 576, 661, 16, 64, torch.bfloat16) == ("wgmma", 1)  # 32 pairs: a block a tile
    assert attention_design(8, 16, 40, 32, 64, torch.bfloat16) == ("wgmma", 1)  # every bf16 head of 64 that fits
    # K and V too long to stay resident together: K stays, V streams (2 x 16 pairs of 2 tiles: a block a tile)
    assert attention_design(2, 256, 1036, 16, 64, torch.bfloat16) == ("streamed", 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch(q, k, v, None, None, None, 1)  # D 80: the variant refuses


def test_attention_ring_at_stage_c_shape(cuda):
    """The ring forced at Stage C's AttnBlock shape (B 8, N 576, 576 + 85
    keys from two sources, H 32, D 64, bf16), where the policy picks the
    wgmma variant: within two bf16 ulps of the plain version's largest
    output (close_in_dtype)."""
    from paella_tpu_torch.kernels.attention import _launch

    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, k2, v2 = stage_c_attention(g, 8, 576, 85, 32, 64)
    close_in_dtype(_launch(q, k, v, None, k2, v2, 0), attention_plain(q, k, v, None, k2, v2))


# K5 by the policy, and the wgmma variant's streamed form forced with one and
# with two query tiles a block
STREAMED_FORMS = [-1, design_code("streamed", 1), design_code("streamed", 2)]


@pytest.mark.parametrize("with_mask", [False, True])
def test_attention_streamed_form_at_stage_b_level2(cuda, with_mask):
    """Stage B's level 2 (B 4, N 1024, 1024 + 4 keys from two sources, H 20,
    D 64, bf16) takes the streamed form, two query tiles a block: by the
    policy and forced with one and two, within two bf16 ulps of the largest
    output of the plain version, all the same bits, bitwise equal on two
    runs, and item 0 alone (one tile a block) equal to item 0 of the batch."""
    from paella_tpu_torch.kernels.attention import _launch, attention_design

    assert attention_design(4, 1024, 1028, 20, 64, torch.bfloat16) == ("streamed", 2)
    assert attention_design(1, 1024, 1028, 20, 64, torch.bfloat16) == ("streamed", 1)
    g = torch.Generator(device=cuda).manual_seed(26)
    q, k, v, k2, v2 = stage_c_attention(g, 4, 1024, 4, 20, 64)
    mask = None
    if with_mask:
        mask = torch.rand(4, 1028, generator=g, device=cuda) < 0.6
        mask[:, 0] = True
    want = attention_plain(q, k, v, mask, k2, v2)
    got = [_launch(q, k, v, mask, k2, v2, design) for design in STREAMED_FORMS]
    close_in_dtype(got[0], want)
    for other in got[1:]:
        assert torch.equal(other, got[0])
    assert torch.equal(fused_attention(q, k, v, mask, k2=k2, v2=v2), got[0])
    one = fused_attention(q[:1], k[:1], v[:1], None if mask is None else mask[:1], k2=k2[:1], v2=v2[:1])
    assert torch.equal(one, got[0][:1])


@pytest.mark.parametrize("s", [769, 937, 1536])
def test_attention_streamed_form_past_768_keys(cuda, s):
    """Key counts just past the resident form's 768, one not a multiple of
    the 64-key chunk, and the longest K that stays resident beside the V ring
    (1536): the policy takes the streamed form, which matches the plain
    version under a key mask with one and two query tiles a block, in the
    same bits."""
    from paella_tpu_torch.kernels.attention import _launch, attention_design

    b, n, h = 2, 300, 8
    assert attention_design(b, n, s, h, 64, torch.bfloat16) == ("streamed", 1)
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, ln, h, 64, generator=g, device=cuda).to(torch.bfloat16) for ln in (n, s, s))
    mask = torch.rand(b, s, generator=g, device=cuda) < 0.8
    mask[:, 0] = True
    want = attention_plain(q, k, v, mask)
    got = [_launch(q, k, v, mask, None, None, design) for design in STREAMED_FORMS]
    close_in_dtype(got[0], want)
    for other in got[1:]:
        assert torch.equal(other, got[0])
    assert torch.equal(_launch(q, k, v, mask, None, None, -1), got[0])


def test_attention_past_the_resident_k_limit_takes_the_ring(cuda):
    """1537 keys: K no longer stays resident beside the V ring, so the
    policy returns to the ring, the streamed form refuses the shape, and the
    output is the ring's, within two bf16 ulps of the plain version."""
    from paella_tpu_torch.kernels.attention import _launch, attention_design

    assert attention_design(2, 256, 1537, 8, 64, torch.bfloat16) == ("ring", 0)
    g = torch.Generator(device=cuda).manual_seed(27)
    q, k, v = (torch.randn(2, ln, 8, 64, generator=g, device=cuda).to(torch.bfloat16) for ln in (256, 1537, 1537))
    got = fused_attention(q, k, v)
    assert torch.equal(got, _launch(q, k, v, None, None, None, 0))
    close_in_dtype(got, attention_plain(q, k, v))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch(q, k, v, None, None, None, design_code("streamed", 1))


@pytest.mark.parametrize("shape", [(8, 576, 576, 85, 32), (1, 200, 150, 70, 2)])
def test_attention_streamed_form_gives_the_resident_bits(cuda, shape):
    """(B, N, S1, S2, H) at D 64 where K and V stay resident (Stage C's
    shape, and a ragged one with S1 off the 64-key chunk under a key mask):
    the streamed form forced, with one or every query tile a block, gives
    the resident form's bits."""
    from paella_tpu_torch.kernels.attention import _launch

    b, n, s1, s2, h = shape
    g = torch.Generator(device=cuda).manual_seed(28)
    q = torch.randn(b, n, h, 64, generator=g, device=cuda).to(torch.bfloat16)
    (k, v), (k2, v2) = kv_views(g, b, s1, h, 64), kv_views(g, b, s2, h, 64)
    mask = torch.rand(b, s1 + s2, generator=g, device=cuda) < 0.7
    mask[:, 0] = True
    resident = _launch(q, k, v, mask, k2, v2, design_code("wgmma", 1))
    close_in_dtype(resident, attention_plain(q, k, v, mask, k2, v2))
    for qtiles in (1, -(-n // 192)):
        assert torch.equal(_launch(q, k, v, mask, k2, v2, design_code("streamed", qtiles)), resident), qtiles


# (N, S) at D 64 bf16 and (B, H) over which chip_smoke.py times both K5 designs
K5_SWEEP = [(16, 40), (64, 136), (200, 130), (576, 661)]
K5_PAIRS = [(8, 32), (4, 32), (2, 16), (1, 2)]  # Stage C at batch 4 and 2 (CFG), Paella's pair, one item


@pytest.mark.parametrize("b,h", K5_PAIRS)
@pytest.mark.parametrize("n,s", K5_SWEEP)
def test_attention_designs_match_plain_over_the_sweep(cuda, n, s, b, h):
    """Both K5 designs forced (the ring; the wgmma variant with one query
    tile a block and with one a 192-row share of N) at D 64 bf16, one source,
    no mask: within two bf16 ulps of the plain version's largest output."""
    from paella_tpu_torch.kernels.attention import _launch

    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v = (torch.randn(b, ln, h, 64, generator=g, device=cuda).to(torch.bfloat16) for ln in (n, s, s))
    want = attention_plain(q, k, v)
    for design in sorted({0, 1, -(-n // 192)}):
        close_in_dtype(_launch(q, k, v, None, None, None, design), want)


def cfg_pair_mask(b: int, n: int, s_c: int, device):
    """A CFG pair's K5 mask over [pixels ; cond] (n 0: the cond mask K6
    takes): the conditional half attends to every token, the unconditional
    half to its first two ByT5 tokens and its CLIP-text tokens
    (merge_cfg_pair masks the rest)."""
    cmask = torch.ones(b, s_c, dtype=torch.bool, device=device)
    cmask[b // 2 :, 2:64] = False
    cmask[b // 2 :, 68:] = False
    return torch.cat([torch.ones(b, n, dtype=torch.bool, device=device), cmask], dim=1)


@pytest.mark.parametrize("shape", ["level1", "level2", "stage_c"])
def test_sdpa_computes_the_function_k5_is_timed_against(cuda, shape):
    """F.scaled_dot_product_attention, which chip_smoke.py times beside K5 as
    one PyTorch call of the same function, is within two bf16 ulps of the
    largest output of K5's plain version: at Paella's attention levels 1 and
    2 (B 2, 16 heads of 80, S_cond 72, the CFG pair's mask as an additive
    -1e9) and at Stage C's shape (keys from two sources, concatenated)."""
    import torch.nn.functional as F

    g = torch.Generator(device=cuda).manual_seed(15)
    if shape == "stage_c":
        q, k, v, k2, v2 = stage_c_attention(g, 8, 576, 85, 32, 64)
        want = attention_plain(q, k, v, None, k2, v2)
        k, v, add = torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1), None
    else:
        b, n, s_c, h, d = (2, 256, 72, 16, 80) if shape == "level1" else (2, 64, 72, 16, 80)
        mask = cfg_pair_mask(b, n, s_c, cuda)
        q, k, v = (torch.randn(b, ln, h, d, generator=g, device=cuda).to(torch.bfloat16) for ln in (n, n + s_c, n + s_c))
        want = attention_plain(q, k, v, mask)
        add = torch.zeros(b, 1, 1, n + s_c, device=cuda, dtype=torch.bfloat16).masked_fill(~mask[:, None, None, :], -1e9)
    got = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=add)
    close_in_dtype(got.transpose(1, 2), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_mask", [(shape, m) for shape in [
    (2, 4, 128, 4, 6), (2, 8, 640, 8, 9), (2, 16, 1280, 16, 72), (2, 8, 1280, 16, 72), (2, 9, 1280, 16, 7), (2, 5, 96, 4, 9),
    (2, 6, 160, 4, 5), (2, 7, 576, 8, 11)] for m in (False, True)]
    + [((2, 16, 1280, 16, 72), "cfg"), ((2, 8, 1280, 16, 72), "cfg")])
def test_attn_block_kernel_matches_plain(cuda, dtype, with_mask, shape):
    """(B, HW, C, heads, S_cond): K6 against its plain version at the
    flagship's levels 1 and 2, a ragged N (81, not a multiple of 64) with an
    odd S_cond, and the narrow head dims 24, 40 and 72, unmasked, under a
    random cond mask and (levels 1 and 2) under the CFG pair's; f32 within
    1e-4 (products of depth C in another order), bf16 within 2e-2 of the
    largest output (q, k, v and a are rounded to bf16, so a value on a
    rounding boundary may round the other way, as in K1)."""
    b, hw, c, nhead, s_c = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05), dtype,
                                   nhead)
    x = r(b, hw, hw, c, std=1.0).to(dtype)
    kv = r(b, s_c, c, std=1.0).to(dtype)
    mask = None
    if with_mask == "cfg":
        mask = cfg_pair_mask(b, 0, s_c, cuda)
    elif with_mask:
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


def sampler_batch(pool_cond, pool_uncond, b):
    """The sampler's CFG batch of b requests: [cond_0..cond_b-1 ;
    uncond_0..uncond_b-1] (sampling/sampler.py), so request 0's uncond image
    sits at index b."""
    return torch.cat([pool_cond[:b], pool_uncond[:b]])


@pytest.mark.parametrize("mode,dtype,c", [("float", torch.bfloat16, 1280), ("float", torch.float32, 128),
                                          ("int8", torch.bfloat16, 128), ("w8a8", torch.bfloat16, 128)])
@pytest.mark.parametrize("hw", [(8, 12), (12, 12)])
def test_resblock_uncond_image_does_not_depend_on_batch(cuda, mode, dtype, c, hw):
    """K1 and K1b at hw 96 and 144 (level 2 of 256x384 and 384x384
    canvases, whose fc1 tiles do not divide the image): request 0's uncond
    image gets the same bits at batch 1, 2 and 4, as a server's micro-batch
    needs."""
    g = torch.Generator(device=cuda).manual_seed(21)
    hh, ww = hw
    w = bf16_resblock(c, g) if dtype == torch.bfloat16 else None
    if mode != "float":
        w = int8_resblock(c, 1, dtype, g, mode == "w8a8")
    elif dtype == torch.float32:
        r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
        w = prepare_resblock_weights(
            r(c, 1, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1), r(4 * c, std=0.2),
            r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1), dtype,
        )
    xs = [torch.randn(4, hh, ww, c, generator=g, device=cuda).to(dtype) for _ in range(2)]
    fs = [(torch.randn(4, 2 * c, generator=g, device=cuda) * 0.2).to(dtype) for _ in range(2)]
    outs = [fused_resblock(sampler_batch(*xs, b), w, film=sampler_batch(*fs, b))[b] for b in (1, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_attn_block_uncond_image_does_not_depend_on_batch(cuda):
    """K6 at hw 96 (level 2 of a 256x384 canvas) with the CFG cond mask:
    request 0's uncond image gets the same bits at batch 1, 2 and 4."""
    g = torch.Generator(device=cuda).manual_seed(22)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    c = 1280
    w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05),
                                   torch.bfloat16, 16)
    xs = [r(4, 8, 12, c, std=1.0).to(torch.bfloat16) for _ in range(2)]
    kvs = [r(4, 72, c, std=1.0).to(torch.bfloat16) for _ in range(2)]
    masks = [torch.ones(4, 72, dtype=torch.bool, device=cuda), torch.rand(4, 72, generator=g, device=cuda) < 0.3]
    outs = [fused_attn_block(sampler_batch(*xs, b), sampler_batch(*kvs, b), w, 16, sampler_batch(*masks, b))[b]
            for b in (1, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 6, 10, 96), (1, 5, 7, 40)])
def test_resblock_narrow_widths_match_plain(cuda, dtype, with_skip, shape):
    """K1 at widths that are multiples of 8 but not of 64 (PaellaConfig.tiny()'s
    32): a ragged K tile, a ragged column tile in both products."""
    b, hh, ww, c = shape
    g = torch.Generator(device=cuda).manual_seed(23)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_resblock_weights(
        r(c, 2 if with_skip else 1, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5),
        r(4 * c, std=0.1), r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5),
        r(c, std=0.1), dtype,
    )
    x = r(b, hh, ww, c, std=1.0).to(dtype)
    skip = r(b, hh, ww, c, std=1.0).to(dtype) if with_skip else None
    film = r(b, 2 * c, std=0.2).to(dtype)
    check_resblock(x, w, film, skip)
    assert torch.equal(fused_resblock(x, w, film=film, skip=skip), fused_resblock(x, w, film=film, skip=skip))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 40, 72])
def test_attention_narrow_head_dims_match_plain(cuda, dtype, d):
    """K5 at head dims that are multiples of 8 but not of 16: bf16 pads the
    head to the next multiple of 16 in shared memory only."""
    g = torch.Generator(device=cuda).manual_seed(24)
    b, n, s, h = 2, 70, 133, 3
    q, k, v = (torch.randn(b, length, h, d, generator=g, device=cuda).to(dtype) for length in (n, s, s))
    mask = torch.rand(b, s, generator=g, device=cuda) < 0.6
    mask[:, 0] = True
    got = fused_attention(q, k, v, mask)
    close_in_dtype(got, attention_plain(q, k, v, mask))
    assert torch.equal(fused_attention(q, k, v, mask), got)


@pytest.mark.parametrize("hw,s_c", [((16, 16), 72), ((8, 8), 72), ((9, 9), 7), ((4, 4), 9)])
def test_attn_block_every_plan_matches_plain(cuda, hw, s_c):
    """K6's bf16 products at the C 1280 shapes where `attn_block_plan`
    picks each of its tilings on an H100's 132 SMs (q|k|v 128 wide unsplit
    or 64 wide split in 2, o 64 wide unsplit or split in 2 or 4; pinned by
    tests/test_torch_attn_block.py::test_attn_block_plan), against the plain
    version, masked, and bitwise repeatable."""
    c = 1280
    g = torch.Generator(device=cuda).manual_seed(25)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05),
                                   torch.bfloat16, 16)
    x, kv = r(2, *hw, c, std=1.0).to(torch.bfloat16), r(2, s_c, c, std=1.0).to(torch.bfloat16)
    mask = torch.rand(2, s_c, generator=g, device=cuda) < 0.7
    mask[:, 0] = True
    got = fused_attn_block(x, kv, w, 16, mask)
    want = attn_block_plain(x, kv, w, 16, mask)
    assert (got.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()
    assert torch.equal(fused_attn_block(x, kv, w, 16, mask), got)


K6_TILINGS = [(bn, splits) for bn in (128, 64) for splits in (1, 2, 4)]  # (tile width, K splits)


@pytest.mark.parametrize("i", range(len(K6_TILINGS)))
@pytest.mark.parametrize("hw", [(16, 16), (8, 8), (8, 12), (12, 12)])
def test_attn_block_every_tiling_matches_plain(cuda, hw, i):
    """Each of K6's bf16 tilings for the q|k|v product, with the next one in
    K6_TILINGS for the o-projection (the pairs chip_smoke.py's tiling sweep
    times), at the flagship's attention levels 1 and 2 and the level 2 of
    256x384 and 384x384 canvases (CFG batch 2, S_cond 72, 16 heads of 80, a
    random cond mask): within 2e-2 of the plain version's largest output."""
    from paella_tpu_torch.kernels.attn_block import AttnBlockPlan, _launch

    c, s_c = 1280, 72
    g = torch.Generator(device=cuda).manual_seed(62)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05),
                                   torch.bfloat16, 16)
    x, kv = r(2, *hw, c, std=1.0).to(torch.bfloat16), r(2, s_c, c, std=1.0).to(torch.bfloat16)
    mask = torch.rand(2, s_c, generator=g, device=cuda) < 0.7
    mask[:, 0] = True
    want = attn_block_plain(x, kv, w, 16, mask).float()
    plan = AttnBlockPlan(*K6_TILINGS[i], *K6_TILINGS[(i + 1) % len(K6_TILINGS)])
    assert (_launch(x, kv, w, 16, mask, plan).float() - want).abs().max() <= 2e-2 * want.abs().max()


# K5's outputs on seeded numpy inputs, as SHA-256 digests of their bytes,
# recorded on an H100 80GB HBM3 from the kernel as it stood before its move
# into csrc/attention.cuh (key prefix, padded heads): any card and torch
# version draws the same inputs
K5_CASES = {  # name: (B, N, S, H, D, dtype, masked)
    "level1_bf16": (2, 256, 328, 16, 80, torch.bfloat16, True),
    "level2_bf16": (2, 64, 136, 16, 80, torch.bfloat16, True),
    "streamed_bf16": (2, 256, 1036, 16, 80, torch.bfloat16, True),
    "level2_f32": (2, 64, 136, 16, 80, torch.float32, True),
    "ragged_bf16": (1, 200, 130, 2, 64, torch.bfloat16, False),
}
K5_DIGESTS = {
    "level1_bf16": "1664802a69fac1c1df6fc959652e4702845aeb33f5e54b25883254cb9ce83506",
    "level2_bf16": "4998ba47f87d85ca83e9ed609b348cf7d2b5691aab49efbe7f5ff759c8b75a22",
    "streamed_bf16": "6369d7d908496cad8ed91376da01458a9579af7fd2993f1a4e20b65b1e6172a1",
    "level2_f32": "d41f202d9e2a74fdfec7198f6b0af30c73c238f4f67b6020a509f62421a305b6",
    "ragged_bf16": "57d178f2ab1a25e111f294301a0c207011a8f13d66887b164151ed912d71a830",
}


def k5_digests() -> dict:
    import hashlib

    out = {}
    for i, (name, (b, n, s, h, d, dtype, masked)) in enumerate(K5_CASES.items()):
        rng = np.random.default_rng(100 + i)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, ln, h, d)).astype(np.float32)).to(dtype).cuda()
                   for ln in (n, s, s))
        mask = None
        if masked:
            m = rng.uniform(size=(b, s)) < 0.7
            m[:, 0] = True
            mask = torch.from_numpy(m).cuda()
        o = fused_attention(q, k, v, mask).cpu()
        raw = o.view(torch.int16) if dtype == torch.bfloat16 else o.view(torch.int32)
        out[name] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    return out


def test_attention_outputs_keep_their_bits(cuda):
    """K5 (D 80, the flagship's, and D 64) gives the same bits as before its
    kernel moved into attention.cuh and took a key prefix and padded heads."""
    assert k5_digests() == K5_DIGESTS


def seeded_resblock(rng, c: int, cpg: int, dtype, mode: str = "float"):
    """ResBlock weights drawn with numpy (the same on any card and torch
    version), quantized as quantize_paella_int8 does for an int8 mode."""
    n = lambda *s, std: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32))  # noqa: E731
    dw, dw_b, w1, b1 = n(c, cpg, 3, 3, std=0.2), n(c, std=0.1), n(4 * c, c, std=c**-0.5), n(4 * c, std=0.1)
    gamma, beta, w2, b2 = n(4 * c, std=0.2), n(4 * c, std=0.2), n(c, 4 * c, std=(4 * c) ** -0.5), n(c, std=0.1)
    scales = {}
    if mode != "float":
        (w1, s1), (w2, s2) = quantize_dense_int8(w1), quantize_dense_int8(w2)
        scales = dict(fc1_scale=s1.cuda(), fc2_scale=s2.cuda(), act_quant=mode == "w8a8")
    return prepare_resblock_weights(*(t.cuda() for t in (dw, dw_b, w1, b1, gamma, beta, w2, b2)), dtype, **scales)


def digest(t: torch.Tensor) -> str:
    import hashlib

    t = t.cpu()
    return hashlib.sha256(t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy().tobytes()).hexdigest()


# K1 at the flagship's four ResBlock shapes (bf16 + FiLM) and f32 at level 1,
# and K6 at attention levels 1 and 2 (bf16, the CFG cond mask), on seeded
# numpy inputs, as SHA-256 digests of their bytes, recorded on an H100 80GB
# HBM3 from the kernels as they stood before the widths C % 8 != 0 and head
# dims past 128 were taken (K1b's redesign left K1's bits alone)
K1_CASES = {  # name: (B, H, W, C, skip, dtype)
    "level0": (2, 32, 32, 640, False, torch.bfloat16),
    "level0_skip": (2, 32, 32, 640, True, torch.bfloat16),
    "level1": (2, 16, 16, 1280, False, torch.bfloat16),
    "level2": (2, 8, 8, 1280, False, torch.bfloat16),
    "level1_f32": (2, 16, 16, 1280, False, torch.float32),
}
K1_DIGESTS = {
    "level0": "bb07faedf00d03829545c5b49d76f54a1ea9cd6601300760bafe6cb49cc41101",
    "level0_skip": "d0b10dd256c76f0ad63faffc1d13cbc9ff10cd16e3d8bdbb7f66a5edc3225592",
    "level1": "f24fab50e8cc67b384544db9d36159f09d2ce231a6795d2497a69b29ff7ce785",
    "level2": "0ebcab9ee10e33e2ce750a93e74876aaf9e1fa0ef9ab39687474fb864c4c3958",
    "level1_f32": "00f23e99be4b322d0497a83a0b8f72ca7fa661e1125c7bf252e78f3f416f317d",
}
K6_CASES = {"level1": (2, 16, 16, 72, 16, 80), "level2": (2, 8, 8, 72, 16, 80)}  # name: (B, H, W, S_cond, heads, D)
K6_DIGESTS = {
    "level1": "f7280203b1d32dd73c31e3598070d1aef6fc31e367c5f83af85d7d4f4285b54c",
    "level2": "7f7e61c5b27e722ad3264633c238db225966c3d278980bbd718d03987d56555f",
}


def k1_digests() -> dict:
    out = {}
    for i, (name, (b, hh, ww, c, with_skip, dtype)) in enumerate(K1_CASES.items()):
        rng = np.random.default_rng(200 + i)
        w = seeded_resblock(rng, c, 2 if with_skip else 1, dtype)
        n = lambda *s, std: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32)).to(dtype).cuda()  # noqa: E731
        x, skip, film = n(b, hh, ww, c, std=1.0), n(b, hh, ww, c, std=1.0), n(b, 2 * c, std=0.2)
        out[name] = digest(fused_resblock(x, w, film=film, skip=skip if with_skip else None))
    return out


def k6_digests() -> dict:
    out = {}
    for i, (name, (b, hh, ww, s_c, h, d)) in enumerate(K6_CASES.items()):
        rng = np.random.default_rng(300 + i)
        c = h * d
        n = lambda *s, std: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32)).cuda()  # noqa: E731
        w = prepare_attn_block_weights(n(3 * c, c, std=c**-0.5), n(3 * c, std=0.05), n(c, c, std=c**-0.5),
                                       n(c, std=0.05), torch.bfloat16, h)
        x, kv = n(b, hh, ww, c, std=1.0).to(torch.bfloat16), n(b, s_c, c, std=1.0).to(torch.bfloat16)
        cmask = torch.ones(b, s_c, dtype=torch.bool, device="cuda")
        cmask[b // 2 :, 2:64] = False
        cmask[b // 2 :, 68:] = False
        out[name] = digest(fused_attn_block(x, kv, w, h, cmask))
    return out


def test_resblock_and_attn_block_outputs_keep_their_bits(cuda):
    """K1 at the flagship's shapes and K6 at its attention levels give the
    same bits as before the any-width repair (padded pitches, the scalar
    epilogue, wide heads) and K1b's move onto wgmma."""
    assert k1_digests() == K1_DIGESTS
    assert k6_digests() == K6_DIGESTS


def check_int8(got, want, mode: str):
    """K1b against its plain version at bf16: within 2e-2 of the largest
    output, and in W8A8 (an s8 code at a rounding tie may round the other way
    when the f32 values before it differ in their last ulp, moving its row by
    one quantization step) 99% of elements equal to the plain version's;
    weight-only, whose products are exact, within K1's tolerance everywhere."""
    err, scale = (got.float() - want.float()).abs(), want.float().abs().max()
    assert err.max() <= 2e-2 * scale, (mode, err.max(), scale)
    if mode == "w8a8":
        assert (got == want).float().mean() >= 0.99, (got == want).float().mean()


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
@pytest.mark.parametrize("shape", [
    (3, 6, 10, 128, False),  # M 180: a ragged 128-row tile, tiles across images
    (4, 4, 8, 128, True),  # hw 32: four images in one 128-row tile
    (2, 8, 8, 1280, False),  # fc2 in 4 K splits
    (1, 5, 7, 64, False),  # M 35, C 64: W8A8's K a half step of 128 codes
    (2, 32, 32, 640, False), (2, 32, 32, 640, True), (2, 16, 16, 1280, False),  # the flagship's shapes
])
def test_resblock_int8_wgmma_matches_plain(cuda, mode, shape):
    """K1b on the wgmma tiles (W8A8 on s8 x s8 -> s32; weight-only on the
    bf16 ring with the codes widened in the kernel) against its plain
    version, and bitwise equal on a second run."""
    b, hh, ww, c, with_skip = shape
    rng = np.random.default_rng(31)
    w = seeded_resblock(rng, c, 2 if with_skip else 1, torch.bfloat16, mode)
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(torch.bfloat16)
    skip = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(torch.bfloat16) if with_skip else None
    film = (torch.randn(b, 2 * c, generator=g, device=cuda) * 0.2).to(torch.bfloat16)
    tile_n1 = min(512, 4 * c // 2)  # W8A8's h-code groups: at C 64, two of 128
    got = fused_resblock(x, w, film=film, skip=skip, tile_n1=tile_n1)
    check_int8(got, resblock_plain(x, w, film=film, skip=skip, tile_n1=tile_n1), mode)
    assert torch.equal(fused_resblock(x, w, film=film, skip=skip, tile_n1=tile_n1), got)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
@pytest.mark.parametrize("hw", [(8, 8), (8, 12), (12, 12)])
def test_resblock_int8_batch_invariance_at_every_batch(cuda, mode, hw):
    """K1b gives request 0's cond and uncond images the same bits at batch
    1, 2, 4 and 8 of the sampler's CFG batch, at hw 64 (the flagship's level
    2) and hw 96 and 144 (256x384 and 384x384 canvases)."""
    rng = np.random.default_rng(32)
    c = 128 if hw != (8, 8) else 1280
    w = seeded_resblock(rng, c, 1, torch.bfloat16, mode)
    g = torch.Generator(device=cuda).manual_seed(32)
    xs = [torch.randn(8, *hw, c, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2)]
    fs = [(torch.randn(8, 2 * c, generator=g, device=cuda) * 0.2).to(torch.bfloat16) for _ in range(2)]
    outs = [fused_resblock(sampler_batch(*xs, b), w, film=sampler_batch(*fs, b)) for b in (1, 2, 4, 8)]
    for b, out in zip((2, 4, 8), outs[1:]):
        assert torch.equal(out[0], outs[0][0]) and torch.equal(out[b], outs[0][1]), b


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 36), (2, 6, 10, 60), (1, 5, 7, 15), (3, 4, 4, 100)])
def test_resblock_any_width_matches_plain(cuda, dtype, with_skip, shape):
    """K1 at widths that are not multiples of 8 (C 36 and 60; C 15, whose 4C
    is not either; C 100, whose fc2 K splits): xn, h and the weights at a
    padded pitch, x and out at the true one. Against the plain version, and
    bitwise equal on a second run."""
    b, hh, ww, c = shape
    rng = np.random.default_rng(33)
    w = seeded_resblock(rng, c, 2 if with_skip else 1, dtype)
    g = torch.Generator(device=cuda).manual_seed(33)
    x = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(dtype)
    skip = torch.randn(b, hh, ww, c, generator=g, device=cuda).to(dtype) if with_skip else None
    film = (torch.randn(b, 2 * c, generator=g, device=cuda) * 0.2).to(dtype)
    check_resblock(x, w, film, skip)
    assert torch.equal(fused_resblock(x, w, film=film, skip=skip), fused_resblock(x, w, film=film, skip=skip))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 15, 160, 256, 200])
def test_attention_any_head_dim_matches_plain(cuda, dtype, with_mask, d):
    """K5 at head dims that are not multiples of 8 (12, 15: padded by the
    wrapper) and past 128 (160, 200, 256: output columns in 128-wide chunks,
    16-key tiles), resident and streamed (S 300), against the plain version
    and bitwise equal on a second run."""
    g = torch.Generator(device=cuda).manual_seed(34)
    for b, n, s, h in ((2, 70, 133, 3), (1, 130, 300, 2)):
        q, k, v = (torch.randn(b, length, h, d, generator=g, device=cuda).to(dtype) for length in (n, s, s))
        mask = None
        if with_mask:
            mask = torch.rand(b, s, generator=g, device=cuda) < 0.6
            mask[:, 0] = True
        got = fused_attention(q, k, v, mask)
        close_in_dtype(got, attention_plain(q, k, v, mask))
        assert torch.equal(fused_attention(q, k, v, mask), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 48, 4, 7), (2, 5, 60, 4, 9), (2, 8, 320, 2, 9), (2, 4, 512, 2, 5),
                                   (2, 6, 36, 3, 6)])
def test_attn_block_any_width_matches_plain(cuda, dtype, shape):
    """(B, HW, C, heads, S_cond): K6 at head dims 12, 15, 160, 256 and 12
    again with C 36 (C and D not multiples of 8: padded weights, the scalar
    o-projection epilogue; D past 128: K5's wide heads), masked, against its
    plain version and bitwise equal on a second run."""
    b, hw, c, nhead, s_c = shape
    g = torch.Generator(device=cuda).manual_seed(35)
    r = lambda *s, std: torch.randn(*s, generator=g, device=cuda) * std  # noqa: E731
    w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05),
                                   dtype, nhead)
    x, kv = r(b, hw, hw, c, std=1.0).to(dtype), r(b, s_c, c, std=1.0).to(dtype)
    mask = torch.rand(b, s_c, generator=g, device=cuda) < 0.7
    mask[:, 0] = True
    got = fused_attn_block(x, kv, w, nhead, mask)
    want = attn_block_plain(x, kv, w, nhead, mask)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert (got.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()
    assert torch.equal(fused_attn_block(x, kv, w, nhead, mask), got)


def head_call(g, b: int, hh: int, ww: int, c: int, k: int, dtype, with_cfg: bool = True):
    """Seeds (on the card, as the sampler holds them), features and a head
    weight for one fused-head call of b images of hh x ww rows."""
    seeds = torch.tensor(np.array([[5 + i, 0xDEADBEEF - 3 * i] for i in range(b)], np.int64), device="cuda")
    fc = torch.randn(b, hh, ww, c, generator=g, device="cuda").to(dtype)
    fu = torch.randn(b, hh, ww, c, generator=g, device="cuda").to(dtype) if with_cfg else None
    w_out = (torch.randn(k, c, generator=g, device="cuda") * c**-0.5).to(dtype)
    return seeds, fc, fu, 3.0, w_out, 0.8


@pytest.mark.parametrize("rows,agree", [((3, 12, 11), 0.995), ((3, 5, 7), 0.99)])
@pytest.mark.parametrize("with_cfg", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,k", [(16, 128), (20, 200), (300, 8190), (520, 300), (256, 8192)])
def test_head_kernel_any_width_matches_plain(cuda, dtype, with_cfg, c, k, rows, agree):
    """K2 at widths off the wgmma path's 64-wide steps (C 16, 20, 300: zero
    columns to the 16-wide slice, element-staged weights; K 128, 200, 8190:
    a ragged last label tile), bf16 past the resident-A limit (C 520: the
    SIMT kernel), and the flagship's widths, at ragged row counts (3 images
    of 12x11 = 396 rows: a partial 128-row tile, images meeting inside a
    tile; 3 images of 5x7 = 105 rows: one ragged row tile), with and without
    CFG: tokens agree with the plain version on at least 99.5% of 396 rows
    and 99% of 105 (f32 sums in another order flip only near-ties; one flip
    in 105 is 0.0095), and two runs are bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(40)
    args = head_call(g, *rows, c, k, dtype, with_cfg)
    got = fused_head_categorical(*args)
    assert got.dtype == torch.int32 and got.shape == rows
    assert bool(((got >= 0) & (got < k)).all())
    assert (got == head_categorical_plain(*args)).float().mean() >= agree
    assert torch.equal(fused_head_categorical(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,k", [(256, 8192), (20, 200)])
def test_head_kernel_is_batch_invariant(cuda, dtype, c, k):
    """An image's tokens at B = 1 (M 4096: on the wgmma path the labels split
    among more blocks) equal its tokens as the middle image of B = 3 (M 12288:
    fewer), and two runs are bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(41)
    seeds, fc, fu, cw, w_out, temp = head_call(g, 3, 64, 64, c, k, dtype)
    solo = fused_head_categorical(seeds[1:2], fc[1:2], fu[1:2], cw, w_out, temp)
    trio = fused_head_categorical(seeds, fc, fu, cw, w_out, temp)
    assert torch.equal(trio[1:2], solo)
    assert torch.equal(fused_head_categorical(seeds[1:2], fc[1:2], fu[1:2], cw, w_out, temp), solo)
    plans = head_plan(4096, c, k, dtype), head_plan(3 * 4096, c, k, dtype)
    if dtype == torch.bfloat16:
        assert plans[0] > plans[1] >= 1, plans
    else:
        assert plans == (0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8])
def test_head_kernel_at_the_flagship_step(cuda, b, dtype):
    """K2 at the flagship's head (features (B, 64, 64, 256) x2 and W_out
    (8192, 256), CFG 8, T 0.7; seeds on the card, as the sampler holds them)
    at B 1 (M 4096) and 8 (M 32768): tokens in range, agreeing with the plain
    version on 99.9% of rows and bitwise equal on two runs; at B 1 with W_out
    = 0 (tokens from the hash alone), agreeing on 99.99%."""
    g = torch.Generator(device=cuda).manual_seed(12)
    seeds = torch.tensor([[0x9E3779B9 + 7 * i, 12345 + i] for i in range(b)], dtype=torch.int64, device=cuda)
    fc, fu = (torch.randn(b, 64, 64, 256, generator=g, device=cuda).to(dtype) for _ in range(2))
    w_out = (torch.randn(8192, 256, generator=g, device=cuda) * (1.0 / 8192) ** 0.5).to(dtype)
    args = (seeds, fc, fu, 8.0, w_out, 0.7)
    got = fused_head_categorical(*args)
    assert bool(((got >= 0) & (got < 8192)).all())
    assert (got == head_categorical_plain(*args)).float().mean().item() >= 0.999
    assert torch.equal(fused_head_categorical(*args), got)
    if b == 1:
        args = (seeds, fc, fu, 8.0, torch.zeros_like(w_out), 0.7)
        assert (fused_head_categorical(*args) == head_categorical_plain(*args)).float().mean().item() >= 0.9999


def test_tiny_config_samples_through_the_fused_head(cuda):
    """PaellaConfig.tiny() (c_out 16, 128 labels) with categorical_impl
    "pallas": K2 on the card, once a step, tokens against the same weights'
    sampling on the CPU (the plain versions; features differ in f32
    rounding, so near-ties may flip)."""
    from paella_tpu_torch.config import PaellaConfig, SampleConfig
    from paella_tpu_torch.kernels import sampling as ksamp
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import Conditioning, sample

    cfg = PaellaConfig.tiny()
    gen = torch.Generator().manual_seed(42)
    cpu = Paella(cfg)
    cpu.reset_parameters(gen)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    dev = Paella(cfg).cuda()
    dev.load_state_dict(cpu.state_dict())
    cond = Conditioning(torch.randn(2, 6, cfg.byt5_embd, generator=gen), torch.randn(2, cfg.clip_embd, generator=gen),
                        torch.randn(2, cfg.clip_embd, generator=gen))
    uncond = Conditioning(torch.randn(2, 3, cfg.byt5_embd, generator=gen), torch.randn(2, cfg.clip_embd, generator=gen))
    seeds = torch.tensor([[1, 2], [3, 4]])
    s_cfg = SampleConfig(steps=4, temperature=(1.0, 0.5), cfg=(3.0, 3.0), categorical_impl="pallas")
    want = sample(cpu, seeds, cond, (2, 16, 16), uncond, s_cfg)
    before = ksamp.fused_head_categorical.launches
    got = sample(dev, seeds, cond.to("cuda"), (2, 16, 16), uncond.to("cuda"), s_cfg).cpu()
    # a new model: the graph's warm-up launches once a step, its capture once more
    assert ksamp.fused_head_categorical.launches - before == 2 * 4
    assert (got == want).float().mean() >= 0.95


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8190, 201, 8192])
def test_gumbel_kernel_any_width_and_alignment(cuda, dtype, k, aligned):
    """K3 at K off the 16-byte vector (8190, 201: a scalar tail) and on a
    view one element off 16-byte alignment (a scalar head, then vectors),
    3 images of 5x7 rows: tokens equal the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(43)
    logits = (torch.randn(3, 5, 7, k, generator=g, device=cuda) * 3.0).to(dtype)
    if not aligned:
        buf = torch.empty(logits.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(logits.shape)
        view.copy_(logits)
        logits = view
        assert logits.data_ptr() % 16
    seeds = torch.tensor(np.array([[5, 0xDEADBEEF], [0xFFFFFFFF, 7], [1, 2]], np.int64))
    torch.testing.assert_close(gumbel_categorical(seeds, logits, 0.7), gumbel_categorical_plain(seeds, logits, 0.7),
                               rtol=0, atol=0)


def test_gumbel_kernel_takes_a_row_strided_view(cuda):
    """Logits whose rows are a strided slice of a wider tensor (K 300 of
    320): tokens equal the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(44)
    wide = (torch.randn(2, 6, 320, generator=g, device=cuda) * 3.0).to(torch.bfloat16)
    logits = wide[..., 10:310]
    seeds = torch.tensor(np.array([[9, 8], [7, 6]], np.int64))
    torch.testing.assert_close(gumbel_categorical(seeds, logits, 0.9), gumbel_categorical_plain(seeds, logits, 0.9),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gumbel_kernel_at_flagship_logits(cuda, dtype):
    """K3 over the flagship's logits (1, 64, 64, 8192), T 0.7, seeds on the
    card: tokens in range and equal to the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(13)
    seeds = torch.tensor([[0x9E3779B9, 54321]], dtype=torch.int64, device=cuda)
    logits = (torch.randn(1, 64, 64, 8192, generator=g, device=cuda) * 2.0).to(dtype)
    got = gumbel_categorical(seeds, logits, 0.7)
    assert bool(((got >= 0) & (got < 8192)).all())
    torch.testing.assert_close(got, gumbel_categorical_plain(seeds, logits, 0.7), rtol=0, atol=0)


@pytest.mark.parametrize("c", [12, 33])
def test_codebook_lookup_kernel_any_latent_width(cuda, c):
    """K4 at latent widths past the 8 held in registers (the wide variant):
    indices equal the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(45)
    z = torch.randn(3, 16, 16, c, generator=g, device=cuda)
    cb = torch.randn(1000, c, generator=g, device=cuda)
    torch.testing.assert_close(fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb), rtol=0, atol=0)


def test_shared_draw_noise_is_torch_bit_for_bit_for_every_u(cuda):
    """The kernels' shared draw (common.cuh::gumbel_noise: u, then logf's
    operations without its branches for arguments the draw never sees)
    against the plain versions' -log(-log u) on the card, over all 2^24
    values of u, bit for bit: +inf at u = 1.0 and -0 at -log u = 1.0
    included."""
    bits = (torch.arange(2**24, device=cuda, dtype=torch.int64) << 8) | 0x5A
    want = -torch.log(-torch.log(uniform_from_bits(bits)))
    assert torch.equal(draw_noise(bits).view(torch.int32), want.view(torch.int32))


def kernel_launches(fn) -> dict:
    """{kernel name: launches} in one fn() call, from torch.profiler (three
    tries: the card's tracer now and then catches nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = {e.key: e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}
        if got:
            return got
    pytest.fail("torch.profiler traced no device activity")


@pytest.mark.parametrize("m,k,c,ties,codebook", [
    (4096, 8192, 4, False, "normal"),  # the codec's encode: 8 row tiles x 16 splits
    (4096, 8192, 4, False, "near-ties"),  # the encode against U(-1/8192, 1/8192) codes: near-ties everywhere
    (32768, 8192, 4, False, "normal"),  # an 8-frame interpolation
    (4097, 8192, 4, False, "normal"),  # an odd M: a row tile of one token
    (4096, 8191, 4, False, "normal"),  # a K no split divides
    (4096, 8192, 4, True, "normal"),  # every code twice: exact ties across splits and halves
    (1000, 8192, 3, False, "normal"), (1000, 8192, 12, False, "normal"),  # narrow and wide widths
    (4096, 8192, 12, False, "normal"),  # the wide width at the encode's M
])
def test_codebook_lookup_kernel_is_exact_in_one_launch(cuda, m, k, c, ties, codebook):
    """K4: indices bit for bit the plain version's (the lowest index on exact ties), from one kernel launch
    a call (no memset, no pack kernel); codes N(0, 1) or U(-1/8192, 1/8192)."""
    g = torch.Generator(device=cuda).manual_seed(46)
    z = torch.randn(m, c, generator=g, device=cuda)
    if codebook == "normal":
        cb = torch.randn(k, c, generator=g, device=cuda)
    else:
        cb = (torch.rand(k, c, generator=g, device=cuda) * 2 - 1) / 8192
    if ties:
        cb[k // 2 :] = cb[: k - k // 2]
    got = fused_codebook_lookup(z, cb)
    want = codebook_lookup_plain(z, cb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if ties:
        assert bool((got < k // 2).all())
    launched = kernel_launches(lambda: fused_codebook_lookup(z, cb))
    assert list(launched.values()) == [1] and "lookup_kernel" in next(iter(launched)), launched


@pytest.mark.parametrize("m,k,c,codes", [
    (4096, 8192, 4, "rand"), (1000, 17, 4, "rand"), (1000, 8192, 3, "rand"), (1000, 8192, 12, "rand"),
    # the encode's shapes, codes |.| + 0.5 of its N(0, 1) and U(-1/8192, 1/8192) codebooks (near-ties everywhere)
    (4096, 8192, 4, "near-ties"), (32768, 8192, 4, "normal"), (4096, 8192, 12, "normal"),
])
def test_codebook_lookup_kernel_gives_an_index_in_range_where_no_distance_is_finite(cuda, m, k, c, codes):
    """A NaN latent (every distance NaN) and a latent whose every distance
    overflows to +inf (-3e38 against a codebook of codes >= 0.5: every dot
    -inf) get index 0, as the plain version's argmin gives, beside finite
    tokens that keep theirs; K 17 leaves splits with no code. Codes 0.5 +
    U(0, 1), |N(0, 1)| or |U(-1/8192, 1/8192)|."""
    g = torch.Generator(device=cuda).manual_seed(47)
    z = torch.randn(m, c, generator=g, device=cuda)
    if codes == "rand":
        cb = torch.rand(k, c, generator=g, device=cuda) + 0.5
    elif codes == "normal":
        cb = torch.randn(k, c, generator=g, device=cuda).abs() + 0.5
    else:
        cb = ((torch.rand(k, c, generator=g, device=cuda) * 2 - 1) / 8192).abs() + 0.5
    z[5] = float("nan")
    z[m - 1] = -3e38
    got, want = fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb)
    assert int(want[5]) == 0 and int(want[m - 1]) == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def tiny_on_card(seed: int, dtype: str = "float32"):
    """PaellaConfig.tiny() with seeded, perturbed weights on the card, its
    conditioning for 3 images, seeds, editing inputs and a reweight."""
    import dataclasses

    from paella_tpu_torch.config import PaellaConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import Conditioning

    cfg = dataclasses.replace(PaellaConfig.tiny(), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    model = Paella(cfg)
    model.reset_parameters(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    model = model.cuda().eval()
    n = lambda *s: torch.randn(*s, generator=gen).cuda()  # noqa: E731
    cond = Conditioning(n(3, 6, cfg.byt5_embd), n(3, cfg.clip_embd), n(3, cfg.clip_embd))
    uncond = Conditioning(n(3, 2, cfg.byt5_embd), n(3, cfg.clip_embd))
    seeds = torch.tensor([[11, 12], [13, 14], [15, 16]])
    init_x = torch.randint(0, cfg.num_labels, (3, 16, 16), generator=gen).cuda()
    keep = torch.zeros(3, 16, 16, dtype=torch.bool, device="cuda")
    keep[:, :, :5] = True
    rew = torch.ones(1, 14, device="cuda")
    rew[0, 1:4] = 3.0
    return model, cond, uncond, seeds, dict(init_x=init_x, fixed_mask=keep, fixed_tokens=init_x.flip(0), cond_reweight=rew)


def batch_of(b: int, cond, uncond, seeds, extra):
    from paella_tpu_torch.sampling import Conditioning

    cut = lambda c: Conditioning(*(None if v is None else v[:b] for v in (c.byt5, c.clip, c.clip_image)))  # noqa: E731
    return cut(cond), cut(uncond), seeds[:b], {k: v if k == "cond_reweight" else v[:b] for k, v in extra.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("editing", [False, True])
def test_graph_replay_equals_eager(cuda, impl, b, editing):
    """sample's captured graph gives the eager body's tokens bit for bit, at
    batch 1 and 3, on both routes, with CFG and a conditional cutoff, and
    with init_x, a fixed mask and cond_reweight."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import graph, sample, sample_eager

    model, cond, uncond, seeds, extra = tiny_on_card(50)
    cond, uncond, seeds, extra = batch_of(b, cond, uncond, seeds, extra)
    extra = extra if editing else {}
    s_cfg = SampleConfig(steps=4, cfg=(3.0, 5.0), temperature=(1.0, 0.4), sampling_conditional_steps=3,
                         t_start=0.8 if editing else 1.0, categorical_impl=impl)
    want = sample_eager(model, seeds, cond, (b, 16, 16), uncond, s_cfg, **extra)
    captured = graph.captures
    assert torch.equal(sample(model, seeds, cond, (b, 16, 16), uncond, s_cfg, **extra), want)  # the warm-up's answer
    assert graph.captures == captured + 1
    got = sample(model, seeds, cond, (b, 16, 16), uncond, s_cfg, **extra)  # a replay
    assert graph.captures == captured + 1
    assert torch.equal(got, want)
    if editing:
        assert torch.equal(got[extra["fixed_mask"]], extra["fixed_tokens"][extra["fixed_mask"]])


def test_graph_takes_new_schedule_values_without_a_capture(cuda):
    """Another cfg, temperature, t span and renoise count replay the graph
    already captured and give the eager body's tokens at those values."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import graph, sample, sample_eager

    model, cond, uncond, seeds, _ = tiny_on_card(51)
    first = SampleConfig(steps=4, cfg=(3.0, 3.0))
    sample(model, seeds, cond, (3, 16, 16), uncond, first)
    captured = graph.captures
    for s_cfg in (SampleConfig(steps=4, cfg=(6.0, 2.0), temperature=(0.5, 0.2), t_start=0.7, renoise_steps=1),
                  SampleConfig(steps=4, cfg=(1.5, 1.5), temperature=(1.2, 1.2), t_end=0.2, renoise_steps=0)):
        got = sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg)
        assert torch.equal(got, sample_eager(model, seeds, cond, (3, 16, 16), uncond, s_cfg))
    assert graph.captures == captured


def test_drop_derived_forces_a_recapture(cuda):
    """After the weights change in place and drop_derived, the next call
    captures anew and gives the eager body's tokens for the new weights."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import graph, sample, sample_eager

    model, cond, uncond, seeds, _ = tiny_on_card(52)
    s_cfg = SampleConfig(steps=3, cfg=(3.0, 3.0))
    old = sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    model.drop_derived()
    captured = graph.captures
    want = sample_eager(model, seeds, cond, (3, 16, 16), uncond, s_cfg)
    assert torch.equal(sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg), want)
    assert graph.captures == captured + 1
    got = sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg)  # a replay of the new capture
    assert graph.captures == captured + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, old)


def test_a_new_config_recaptures(cuda):
    """The same model object with its config replaced (the attention
    kernels switched on) captures anew and gives the eager body's tokens
    under the new config."""
    import dataclasses

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import graph, sample, sample_eager

    model, cond, uncond, seeds, _ = tiny_on_card(55)
    s_cfg = SampleConfig(steps=3, cfg=(3.0, 3.0))
    for _ in range(2):
        sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg)
    model.config = dataclasses.replace(model.config, attention_impl="pallas", attn_block_kernel=True)
    want = sample_eager(model, seeds, cond, (3, 16, 16), uncond, s_cfg)
    captured = graph.captures
    for _ in range(2):
        assert torch.equal(sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg), want)
    assert graph.captures == captured + 1


def test_two_graphs_keep_their_results_apart(cuda):
    """Two structures (batch 1 and 3, two routes) replayed in turns: each
    call gives its own eager tokens."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import sample, sample_eager

    model, cond, uncond, seeds, _ = tiny_on_card(53)
    calls = [(1, SampleConfig(steps=3, cfg=(3.0, 3.0))), (3, SampleConfig(steps=3, cfg=(4.0, 4.0), categorical_impl="pallas"))]
    want = {}
    for b, s_cfg in calls:
        c, u, sd, _ = batch_of(b, cond, uncond, seeds, {})
        want[b] = sample_eager(model, sd, c, (b, 16, 16), u, s_cfg)
    for _ in range(3):
        for b, s_cfg in calls:
            c, u, sd, _ = batch_of(b, cond, uncond, seeds, {})
            assert torch.equal(sample(model, sd, c, (b, 16, 16), u, s_cfg), want[b])


def test_f32_decode_ignores_the_callers_tf32(cuda):
    """Fault C5: an f32 VQConfig.tiny() decode (and encode) is bit-equal
    with the caller's TF32 on and off: the codec pins IEEE float32 itself
    (nn/functional.py::exact_f32), and leaves the caller's flags as set."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import VQConfig

    with torch.device(cuda):
        vq = VQModel(VQConfig.tiny())
    vq.reset_parameters(torch.Generator(device=cuda).manual_seed(60))
    with torch.no_grad():
        for p in vq.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator(device=cuda).manual_seed(61), device=cuda) * 0.1)
    idx = torch.randint(0, 128, (2, 16, 16), generator=torch.Generator(device=cuda).manual_seed(62), device=cuda)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    outs = []
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            image = vq.decode_indices(idx)
            outs.append((image, vq.encode(image)[1]))
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (tf32, tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])

"""K6's plain version (paella_tpu_torch/kernels/attn_block.py::attn_block_plain)
against the JAX package's Pallas kernel (`fused_attn_block_stacked`) in
interpret mode, and the port's denoiser in the attention configuration
(attention_impl="pallas", attn_block_kernel=True) against the JAX denoiser in
the same configuration with fused_blocks=True, on the CPU in f32.

Tolerances: the block at 3e-5 (tests/test_attn_block_kernel.py's, the same f32
arithmetic in another order); the model at 5e-4
(tests/test_resblock_kernel.py::test_fused_blocks_model_parity's, errors of
that size carried through a dozen blocks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paella_tpu.kernels.attn_block import fused_attn_block_stacked, pad_attn_weights
from paella_tpu_torch.config import PaellaConfig
from paella_tpu_torch.kernels.attention import attention_plain
from paella_tpu_torch.kernels import attn_block as kblk
from paella_tpu_torch.kernels import resblock as kres
from paella_tpu_torch.kernels.attn_block import attn_block_plain, prepare_attn_block_weights
from paella_tpu_torch.models import Paella
from paella_tpu_torch.nn.blocks import AttnBlock
from tests.test_torch_denoiser import make_paella

# test_resblock_kernel.py::test_fused_blocks_model_parity's config
ATTN_CFG = dataclasses.replace(
    PaellaConfig.tiny(), c_hidden=(128, 128), nhead=(-1, 4), blocks=(2, 3),
    level_config=("CT", "CTA"), dropout=(0.0, 0.0),
)
FLAGS = dict(attention_impl="pallas", attn_block_kernel=True)


def block_case(c: int, s_c: int, seed: int, with_mask: bool):
    """x (2, 4, 4, C), kv (2, S_cond, C), torch-layout weights and a cond
    mask, from numpy."""
    b, hh = 2, 4
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, hh, hh, c)) * 0.5).astype(np.float32)
    kv = (rng.standard_normal((b, s_c, c)) * 0.5).astype(np.float32)
    wqkv = (rng.standard_normal((3 * c, c)) * c**-0.5).astype(np.float32)  # torch (out, in)
    bqkv = (rng.standard_normal(3 * c) * 0.05).astype(np.float32)
    wo = (rng.standard_normal((c, c)) * c**-0.5).astype(np.float32)
    bo = (rng.standard_normal(c) * 0.05).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.uniform(size=(b, s_c)) < 0.7
        mask[:, 0] = True
    return x, kv, wqkv, bqkv, wo, bo, mask


def port_block(case, nhead: int) -> np.ndarray:
    x, kv, wqkv, bqkv, wo, bo, mask = case
    t = torch.from_numpy
    w = prepare_attn_block_weights(t(wqkv), t(bqkv), t(wo), t(bo), torch.float32, nhead)
    return attn_block_plain(t(x), t(kv), w, nhead, None if mask is None else t(mask)).numpy()


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("c,nhead,s_c", [(128, 4, 6), (640, 8, 9), (96, 4, 7)])
def test_attn_block_plain_matches_jax_kernel(c, nhead, s_c, with_mask):
    """C 96 with 4 heads is head dim 24, a narrow width the CUDA kernel takes
    (D % 8 == 0, padded to 32 in shared memory); JAX's tile_o must divide C."""
    x, kv, wqkv, bqkv, wo, bo, mask = case = block_case(c, s_c, c + with_mask, with_mask)
    wqkv_p, bqkv_p, wo_p = pad_attn_weights(jnp.asarray(wqkv.T)[None], jnp.asarray(bqkv)[None], jnp.asarray(wo.T)[None], nhead)
    want = fused_attn_block_stacked(
        jnp.asarray(x), jnp.asarray(kv)[None], wqkv_p, bqkv_p, wo_p, jnp.asarray(bo)[None], 0, nhead,
        cond_mask=None if mask is None else jnp.asarray(mask), head_chunk=2, tile_qkv=128, tile_o=min(c, 128),
        interpret=True,
    )
    np.testing.assert_allclose(port_block(case, nhead), np.asarray(want), rtol=3e-5, atol=3e-5)


def jax_xla_block(case, nhead: int) -> np.ndarray:
    """The block in the JAX package's XLA ops: its layer_norm, the q|k|v and
    o projections as f32 dots, and nn/attention.py::dot_product_attention."""
    from paella_tpu.nn.attention import dot_product_attention
    from paella_tpu.nn.functional import layer_norm

    x, kv, wqkv, bqkv, wo, bo, mask = case
    b, hh, ww, c = x.shape
    n, d = hh * ww, c // nhead
    t = layer_norm(jnp.asarray(x)).reshape(b, n, c)
    rows = jnp.concatenate([t, jnp.asarray(kv)], axis=1)
    q = (t @ wqkv[:c].T + bqkv[:c]).reshape(b, n, nhead, d)
    kvp = rows @ wqkv[c:].T + bqkv[c:]
    k, v = (a.reshape(b, n + kv.shape[1], nhead, d) for a in jnp.split(kvp, 2, axis=-1))
    kv_mask = None if mask is None else jnp.concatenate([jnp.ones((b, n), bool), jnp.asarray(mask)], axis=1)
    a = dot_product_attention(q, k, v, kv_mask=kv_mask).reshape(b, n, c)
    return np.asarray((a @ wo.T + bo).reshape(x.shape) + x)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("c,nhead", [(48, 4), (320, 2), (512, 2)])
def test_attn_block_plain_at_any_head_dim(c, nhead, with_mask):
    """Head dims the CUDA kernel takes since the any-width repair: 12 (not a
    multiple of 8), 160 and 256 (past 128). At 12 the reference is JAX's
    kernel in interpret mode. JAX's kernel pads each head to 128 lanes in its
    weights (pad_attn_weights, HD_PAD), so it refuses heads past 128: at 160
    and 256 the reference is the block in the JAX package's XLA ops
    (jax_xla_block), within the same 3e-5."""
    x, kv, wqkv, bqkv, wo, bo, mask = case = block_case(c, 7, c + with_mask, with_mask)
    if c // nhead <= 128:
        wqkv_p, bqkv_p, wo_p = pad_attn_weights(jnp.asarray(wqkv.T)[None], jnp.asarray(bqkv)[None],
                                                jnp.asarray(wo.T)[None], nhead)
        want = fused_attn_block_stacked(
            jnp.asarray(x), jnp.asarray(kv)[None], wqkv_p, bqkv_p, wo_p, jnp.asarray(bo)[None], 0, nhead,
            cond_mask=None if mask is None else jnp.asarray(mask), head_chunk=2, tile_qkv=128, tile_o=c,
            interpret=True,
        )
    else:
        with pytest.raises(Exception):  # the head does not fit its 128 lanes
            pad_attn_weights(jnp.asarray(wqkv.T)[None], jnp.asarray(bqkv)[None], jnp.asarray(wo.T)[None], nhead)
        want = jax_xla_block(case, nhead)
    np.testing.assert_allclose(port_block(case, nhead), np.asarray(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("c,nhead", [(60, 4), (36, 3), (320, 2)])
def test_padded_attn_block_weights(c, nhead):
    """Where C or the head dim is not a multiple of 8, the kernel's weights
    are padded once: each row of Wqkv to round8(C) columns and each head to
    round8(D) rows of q, k and v (Wo's columns to match), with zeros; the
    plain version drops the padding again and gives, bit for bit, its output
    on the unpadded weights. Widths that need no padding are left as they
    are."""
    x, kv, wqkv, bqkv, wo, bo, mask = block_case(c, 5, c, True)
    t = torch.from_numpy
    w = prepare_attn_block_weights(t(wqkv), t(bqkv), t(wo), t(bo), torch.float32, nhead)
    cp, d8 = kblk.padded_widths(c, nhead)
    d = c // nhead
    assert w.wqkv.shape == (3 * nhead * d8, cp) and w.wo.shape == (c, nhead * d8) and w.bqkv.shape == (3 * nhead * d8,)
    heads = w.wqkv.reshape(3, nhead, d8, cp)
    assert not heads[:, :, d:].any() and not heads[..., c:].any() and not w.wo.reshape(c, nhead, d8)[..., d:].any()
    true = kblk.true_weights(w, c, nhead)
    for got, want in zip(true, (wqkv, bqkv, wo, bo)):
        assert torch.equal(got, t(want))
    plain = kblk.AttnBlockWeights(*(t(a) for a in (wqkv, bqkv, wo, bo)))
    args = (t(x), t(kv))
    assert torch.equal(attn_block_plain(*args, w, nhead, t(mask)), attn_block_plain(*args, plain, nhead, t(mask)))
    if (cp, d8) == (c, d):
        assert all(torch.equal(a, t(b)) for a, b in zip(w, (wqkv, bqkv, wo, bo)))


@pytest.fixture(scope="module")
def attn_models():
    """The port in the attention configuration and the JAX model with
    fused_blocks, attn_block_kernel and attention_impl="pallas", holding the
    same weights."""
    model, jmodel, jparams = make_paella(dataclasses.replace(ATTN_CFG, **FLAGS), seed=20)
    from paella_tpu.config import PaellaConfig as JaxPaellaConfig
    from paella_tpu.models import Paella as JaxPaella

    jcfg = JaxPaellaConfig(**{**dataclasses.asdict(model.config), "fused_blocks": True})
    # device arrays: the JAX scan indexes the stacked weights with a traced index
    return model, JaxPaella(jcfg), jax.tree_util.tree_map(jnp.asarray, jparams)


def model_inputs(seed: int = 21):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, ATTN_CFG.num_labels, (2, 16, 16)).astype(np.int32)
    r = np.array([0.3, 0.8], np.float32)
    byt5 = rng.standard_normal((2, 5, ATTN_CFG.byt5_embd)).astype(np.float32)
    clip = rng.standard_normal((2, ATTN_CFG.clip_embd)).astype(np.float32)
    return x, r, byt5, clip


@pytest.mark.parametrize("edit", [False, True])
def test_attention_config_model_matches_jax(attn_models, edit):
    """The whole forward with both flags; `edit` adds a byt5 mask and a
    cond_reweight, which move every attention block to the plain path in
    both packages."""
    model, jmodel, jparams = attn_models
    x, r, byt5, clip = model_inputs()
    kw = {}
    if edit:
        s_cond = 5 + ATTN_CFG.clip_seq_len
        kw = dict(
            byt5_mask=np.array([[True] * 5, [True, True, True, False, False]]),
            cond_reweight=np.linspace(0.5, 1.5, 2 * s_cond, dtype=np.float32).reshape(2, s_cond),
        )
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.apply({"params": jparams}, x, r, byt5, clip, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = model(
        torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(byt5), torch.from_numpy(clip),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3, "vacuous comparison"
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize(
    "flags,k5,k6",
    [
        (FLAGS, 2, 4),  # repetition 0 of each direction -> K5, repetitions 1, 2 -> K6
        (dict(attention_impl="pallas"), 2, 0),  # later repetitions stay plain, as in JAX
        (dict(attn_block_kernel=True), 0, 4),
        ({}, 0, 0),
    ],
)
def test_attention_routes(flags, k5, k6):
    """The routes counted by the plain versions' launch counters on the CPU,
    with the cond cache (K6 reads each block's kv from it) and without; a
    cond_reweight moves every block to the plain module path."""
    model = Paella(dataclasses.replace(ATTN_CFG, **flags))
    model.reset_parameters(torch.Generator().manual_seed(0))
    x, r, byt5, clip = (torch.from_numpy(a) for a in model_inputs())
    cache = model.gen_cond_cache(byt5, clip)
    for kw in (dict(cond_cache=cache), dict(byt5=byt5, clip=clip)):
        attention_plain.launches = attn_block_plain.launches = 0
        model(x, r, **kw)
        assert (attention_plain.launches, attn_block_plain.launches) == (k5, k6)
    attention_plain.launches = attn_block_plain.launches = 0
    model(x, r, cond_cache=cache, cond_reweight=torch.ones(1, 5 + ATTN_CFG.clip_seq_len))
    assert (attention_plain.launches, attn_block_plain.launches) == (0, 0)


# PaellaConfig.tiny() at widths the CUDA kernels take since the any-width
# repair (chip_smoke.py phase 8 runs the same two on the card)
TINY_VARIANTS = {
    "odd widths": dict(c_hidden=(36, 60, 60), nhead=(-1, 4, 4)),  # C % 8 != 0, head dim 15
    "wide heads": dict(c_hidden=(32, 320, 320), nhead=(-1, 2, 2)),  # head dim 160
}


@pytest.mark.parametrize("flags", [{}, FLAGS], ids=["default", "attention"])
@pytest.mark.parametrize("variant", list(TINY_VARIANTS))
def test_tiny_variants_match_jax(variant, flags):
    """The two variants against the JAX model on the same weights, in the
    default configuration and in the attention configuration (K5 and K6
    routes; JAX with fused_blocks, whose ResBlock and attention-block kernels
    stay on XLA at widths off its 128-lane tiling), at the tiny parity test's
    tolerance (tests/test_torch_denoiser.py, 1e-4)."""
    from paella_tpu.config import PaellaConfig as JaxPaellaConfig
    from paella_tpu.models import Paella as JaxPaella

    cfg = dataclasses.replace(PaellaConfig.tiny(), **TINY_VARIANTS[variant], **flags)
    model, jmodel, jparams = make_paella(cfg, seed=50)
    if flags:
        jmodel = JaxPaella(JaxPaellaConfig(**{**dataclasses.asdict(cfg), "fused_blocks": True}))
        jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    x, r, byt5, clip = model_inputs(51)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply({"params": jparams}, x, r, byt5, clip))
    got = model(*(torch.from_numpy(a) for a in (x, r, byt5, clip))).numpy()
    assert np.abs(want).max() > 1e-3, "vacuous comparison"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_attn_block_routes_fixed_at_build():
    blocks = [m for m in Paella(dataclasses.replace(ATTN_CFG, **FLAGS)).modules() if isinstance(m, AttnBlock)]
    assert [b.kernel for b in blocks] == ["attention", "attn_block", "attn_block"] * 2
    assert AttnBlock(128, 32, 4, self_attn=False, kernel="attn_block").kernel is None
    with pytest.raises(ValueError, match="kernel"):
        AttnBlock(128, 32, 4, kernel="flash")
    with pytest.raises(ValueError, match="attention_impl"):
        Paella(dataclasses.replace(ATTN_CFG, attention_impl="triton"))


K6_PLANS = {  # (N, S_cond, C, heads): the bf16 plan on an H100's 132 SMs
    (256, 72, 1280, 16): (128, 1, 64, 1),  # the flagship's level 1
    (64, 72, 1280, 16): (128, 1, 64, 4),  # level 2: o has one 128-row tile
    (96, 72, 1280, 16): (128, 1, 64, 2),  # level 2 of a 256x384 canvas
    (81, 7, 1280, 16): (64, 1, 64, 2),  # chip_smoke.py's ragged case
    (16, 9, 1280, 16): (64, 2, 64, 4),
    (64, 9, 64, 4): (64, 1, 64, 1),  # K = 64: one step, no split
    (16, 9, 96, 4): (64, 1, 64, 1),
}


@pytest.mark.parametrize("n,s_c,c,nhead", list(K6_PLANS))
def test_attn_block_plan(n, s_c, c, nhead):
    """K6's bf16 plan is a function of one CFG pair's shapes and the card,
    never of the batch (the signature takes none): K1's rule
    (`resblock.gemm_tiles`) for each product, pinned on an H100's 132 SMs.
    Each product's K splits cover K = C in whole 64-deep steps."""
    import inspect

    assert "b" not in inspect.signature(kblk.attn_block_plan).parameters
    plan = kblk.attn_block_plan(n, s_c, c, nhead, torch.bfloat16, 132)
    assert plan == kblk.AttnBlockPlan(*K6_PLANS[n, s_c, c, nhead])
    assert plan[:2] == kres.gemm_tiles(2 * (n + s_c), 3 * c, c, 132) and plan[2:] == kres.gemm_tiles(2 * n, c, c, 132)
    for splits in (plan.splits_qkv, plan.splits_o):
        assert splits == 1 or (c % (64 * splits) == 0 and c // (64 * splits) >= 4)
    assert kblk.attn_block_plan(n, s_c, c, nhead, torch.float32, 132) == kblk.AttnBlockPlan(0, 1, 0, 1)

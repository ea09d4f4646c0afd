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


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("c,nhead,s_c", [(128, 4, 6), (640, 8, 9), (96, 4, 7)])
def test_attn_block_plain_matches_jax_kernel(c, nhead, s_c, with_mask):
    """C 96 with 4 heads is head dim 24, a narrow width the CUDA kernel takes
    (D % 8 == 0, padded to 32 in shared memory); JAX's tile_o must divide C."""
    b, hh = 2, 4
    rng = np.random.default_rng(c + with_mask)
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

    wqkv_p, bqkv_p, wo_p = pad_attn_weights(jnp.asarray(wqkv.T)[None], jnp.asarray(bqkv)[None], jnp.asarray(wo.T)[None], nhead)
    want = fused_attn_block_stacked(
        jnp.asarray(x), jnp.asarray(kv)[None], wqkv_p, bqkv_p, wo_p, jnp.asarray(bo)[None], 0, nhead,
        cond_mask=None if mask is None else jnp.asarray(mask), head_chunk=2, tile_qkv=128, tile_o=min(c, 128),
        interpret=True,
    )
    t = torch.from_numpy
    w = prepare_attn_block_weights(t(wqkv), t(bqkv), t(wo), t(bo), torch.float32)
    got = attn_block_plain(t(x), t(kv), w, nhead, None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


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

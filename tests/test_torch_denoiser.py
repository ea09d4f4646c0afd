"""The PyTorch port's denoiser against the JAX package's, at the tiny config
in f32 on the CPU: the same weights (the port's seeded init perturbed with
numpy noise, carried to JAX by paella_tpu.convert.convert_paella) and the
same numpy inputs go through both.

Also home of the shared helpers the other test_torch_* files import.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.config import PaellaConfig as JaxPaellaConfig
from paella_tpu.convert import convert_paella, export_paella
from paella_tpu.models import Paella as JaxPaella
from paella_tpu.nn import functional as jf
from paella_tpu.nn.blocks import GlobalResponseNorm as JaxGRN
from paella_tpu.nn.attention import dot_product_attention as jax_attention
from paella_tpu_torch.config import PaellaConfig
from paella_tpu_torch.convert import paella_state_dict_from_jax
from paella_tpu_torch.models import Paella
from paella_tpu_torch.nn import functional as tf
from paella_tpu_torch.nn.attention import dot_product_attention
from paella_tpu_torch.nn.blocks import FeedForwardBlock, GlobalResponseNorm

TOL = dict(rtol=1e-4, atol=1e-4)


def perturbed_state_dict(module: torch.nn.Module, seed: int, scale: float = 0.05) -> dict:
    """The module's parameters plus scale * N(0, 1) numpy noise: the
    zero-initialized clf, FiLM mappers and GRN would otherwise make the
    comparison vacuous. Loads the result into the module and returns it as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    sd = {
        k: (v.numpy() + scale * rng.standard_normal(v.shape)).astype(np.float32)
        if v.is_floating_point() else v.numpy()
        for k, v in module.state_dict().items()
    }
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return sd


def make_paella(cfg: PaellaConfig = PaellaConfig.tiny(), seed: int = 0):
    """(port model, JAX model, JAX params) holding the same perturbed weights."""
    model = Paella(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    sd = perturbed_state_dict(model, seed + 1)
    jcfg = JaxPaellaConfig(**dataclasses.asdict(cfg))
    return model, JaxPaella(jcfg), convert_paella(sd, jcfg)


def conditioning_inputs(cfg, b: int = 2, s: int = 5, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        byt5=rng.standard_normal((b, s, cfg.byt5_embd)).astype(np.float32),
        clip=rng.standard_normal((b, cfg.clip_embd)).astype(np.float32),
        clip_image=rng.standard_normal((b, cfg.clip_embd)).astype(np.float32),
        byt5_mask=np.arange(s)[None, :] < rng.integers(1, s + 1, (b, 1)),
        clip_mask=np.array([True, False] * (b // 2) + [True] * (b % 2)),
    )


def to_torch(d: dict) -> dict:
    return {k: None if v is None else torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def paella():
    return make_paella()


@pytest.fixture(scope="module")
def inputs():
    cfg = PaellaConfig.tiny()
    rng = np.random.default_rng(7)
    x = rng.integers(0, cfg.num_labels, (2, 8, 8)).astype(np.int32)
    r = rng.uniform(0.05, 1.0, (2,)).astype(np.float32)
    return x, r, conditioning_inputs(cfg)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("return_features", [False, True])
def test_paella_matches_jax(paella, inputs, cached, return_features):
    model, jmodel, jparams = paella
    x, r, cond = inputs
    want = jmodel.apply(
        {"params": jparams}, x, r, cond["byt5"], cond["clip"], cond["clip_image"],
        byt5_mask=cond["byt5_mask"], clip_mask=cond["clip_mask"], return_features=return_features,
    )
    tc = to_torch(cond)
    if cached:
        cache = model.gen_cond_cache(
            tc["byt5"], tc["clip"], tc["clip_image"], byt5_mask=tc["byt5_mask"], clip_mask=tc["clip_mask"]
        )
        got = model(torch.from_numpy(x), torch.from_numpy(r), return_features=return_features, cond_cache=cache)
    else:
        got = model(
            torch.from_numpy(x), torch.from_numpy(r), tc["byt5"], tc["clip"], tc["clip_image"],
            byt5_mask=tc["byt5_mask"], clip_mask=tc["clip_mask"], return_features=return_features,
        )
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(want).max() > 1e-3, "vacuous comparison"
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paella_multi_image_and_reweight_match_jax(paella, inputs):
    """(B, K, clip_embd) image conditioning with a per-image mask, x_cat and a
    post-softmax cond_reweight, through both packages."""
    model, jmodel, jparams = paella
    x, r, cond = inputs
    cfg = PaellaConfig.tiny()
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((2, 2, cfg.clip_embd)).astype(np.float32)
    img_mask = np.array([[True, False], [True, True]])
    x_cat = rng.integers(0, cfg.num_labels, (2, 8, 8)).astype(np.int32)
    s_cond = cond["byt5"].shape[1] + cfg.clip_seq_len * 3
    rew = rng.uniform(0.5, 2.0, (2, s_cond)).astype(np.float32)
    want = jmodel.apply(
        {"params": jparams}, x, r, cond["byt5"], cond["clip"], imgs, x_cat=x_cat,
        byt5_mask=cond["byt5_mask"], clip_image_mask=img_mask, cond_reweight=rew,
    )
    tc = to_torch(cond)
    got = model(
        torch.from_numpy(x), torch.from_numpy(r), tc["byt5"], tc["clip"], torch.from_numpy(imgs),
        x_cat=torch.from_numpy(x_cat), byt5_mask=tc["byt5_mask"],
        clip_image_mask=torch.from_numpy(img_mask), cond_reweight=torch.from_numpy(rew),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_feed_forward_levels_match_jax(inputs):
    """A tiny config with "F" (FeedForwardBlock: LN, the channelwise MLP,
    the residual) at levels 0 and 1, in a level's first repetition and in
    the repetitions JAX scans: the port's forward against JAX's, f32."""
    cfg = dataclasses.replace(PaellaConfig.tiny(), level_config=("CTF", "CTAF", "CTA"))
    model, jmodel, jparams = make_paella(cfg, seed=3)
    assert sum(isinstance(m, FeedForwardBlock) for m in model.modules()) == 6  # (1 + 2 repetitions) x (down + up)
    x, r, cond = inputs
    want = np.asarray(jmodel.apply({"params": jparams}, x, r, cond["byt5"], cond["clip"], byt5_mask=cond["byt5_mask"]))
    tc = to_torch(cond)
    got = model(torch.from_numpy(x), torch.from_numpy(r), tc["byt5"], tc["clip"], byt5_mask=tc["byt5_mask"])
    assert np.abs(want).max() > 1e-3, "vacuous comparison"
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert sorted(paella_state_dict_from_jax(jparams, cfg)) == sorted(model.state_dict())


def test_state_dict_from_jax_equals_export_paella(paella):
    """The numpy converter equals the JAX package's exporter key for key and
    value for value (repetitions unstacked from the nn.scan layout), and the
    result loads into the port with strict=True."""
    _, _, jparams = paella
    cfg = PaellaConfig.tiny()
    want = export_paella(jparams, JaxPaellaConfig.tiny())
    got = paella_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    fresh = Paella(cfg)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)


def test_init_scheme():
    """Zero-initialized FiLM and clf, the output head tied to the embedding,
    and the ResBlock fc2 rescale, as the reference's init (and the JAX
    package's) does."""
    cfg = PaellaConfig.tiny()
    m = Paella(cfg)
    m.reset_parameters(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert torch.equal(sd["out_mapper.1.weight"][:, :, 0, 0], sd["in_mapper.0.weight"])
    assert not sd["clf.1.weight"].any() and not sd["down_blocks.0.1.mapper.weight"].any()
    bound = (6.0 / (4 * 32 + 32)) ** 0.5 * (1.0 / sum(cfg.blocks)) ** 0.5
    fc2 = sd["down_blocks.0.0.channelwise.4.weight"]
    assert 0.8 * bound < fc2.abs().max() <= bound
    emb_std = sd["in_mapper.0.weight"].std().item()
    assert abs(emb_std - cfg.num_labels**-0.5) < 0.2 * cfg.num_labels**-0.5


@pytest.mark.parametrize(
    "name",
    ["layer_norm", "gelu", "silu", "space_to_depth", "depth_to_space", "replication_pad_2d", "sinusoidal_embedding"],
)
def test_functional_matches_jax(name):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 6, 8)) * 3 + 1).astype(np.float32)
    if name == "sinusoidal_embedding":
        r = rng.uniform(0, 1, (3,)).astype(np.float32)
        want, got = jf.sinusoidal_embedding(jnp.asarray(r), 17), tf.sinusoidal_embedding(torch.from_numpy(r), 17)
    elif name in ("space_to_depth", "depth_to_space", "replication_pad_2d"):
        arg = 2 if name != "replication_pad_2d" else 1
        want, got = getattr(jf, name)(jnp.asarray(x), arg), getattr(tf, name)(torch.from_numpy(x), arg)
    else:
        want, got = getattr(jf, name)(jnp.asarray(x)), getattr(tf, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_mask_and_reweight_match_jax():
    """A masked key acts exactly like an absent one; reweight multiplies the
    post-softmax probabilities."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 5, 2, 8)).astype(np.float32) for _ in range(3))
    mask = np.array([[True] * 5, [True, True, True, False, False]])
    rew = rng.uniform(0.5, 2, (2, 1, 1, 5)).astype(np.float32)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask), reweight=jnp.asarray(rew))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = dot_product_attention(t(q), t(k), t(v), kv_mask=t(mask), reweight=t(rew))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    absent = dot_product_attention(t(q[1:]), t(k[1:, :3]), t(v[1:, :3]))
    masked = dot_product_attention(t(q[1:]), t(k[1:]), t(v[1:]), kv_mask=t(mask[1:]))
    torch.testing.assert_close(masked, absent, rtol=0, atol=1e-6)


def test_global_response_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    gamma, beta = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    want = JaxGRN(16).apply({"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x))
    grn = GlobalResponseNorm(16)
    grn.load_state_dict({"gamma": torch.from_numpy(gamma).reshape(1, 1, 1, -1), "beta": torch.from_numpy(beta).reshape(1, 1, 1, -1)})
    np.testing.assert_allclose(grn(torch.from_numpy(x)).detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

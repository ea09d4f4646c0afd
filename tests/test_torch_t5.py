"""The port's ByT5 encoder (paella_tpu_torch/cond/t5.py) and its int8 modes
against the JAX package's T5Encoder, on the CPU in f32 at T5Config.tiny():
the same numpy weights (a JAX param tree carried over by
convert.t5_state_dict_from_jax) and the same token ids through both.

Tolerances:
- relative_position_bucket: exact.
- float and int8 weight-only: 1e-5 (f32 arithmetic in another order).
- W8A8: rtol 1e-4 (atol 1e-5): the s32 sums are exact, and the f32 values
  around them differ in their last ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu import quant as jquant
from paella_tpu.cond.t5 import T5Config as JaxT5Config
from paella_tpu.cond.t5 import T5Encoder as JaxT5Encoder
from paella_tpu.cond.t5 import relative_position_bucket as jax_bucket
from paella_tpu_torch import PaellaPipeline, quant
from paella_tpu_torch.codec import VQModel
from paella_tpu_torch.cond import T5Config, T5Encoder, byt5_batch_encode, pad_bucket
from paella_tpu_torch.cond.t5 import relative_position_bucket
from paella_tpu_torch.config import PaellaConfig, SampleConfig, VQConfig
from paella_tpu_torch.convert import t5_state_dict_from_jax
from paella_tpu_torch.models import Paella

CFG = T5Config.tiny()
TOL = dict(rtol=1e-5, atol=1e-5)


def jax_params(cfg: T5Config, seed: int = 0) -> dict:
    """A JAX T5Encoder tree from numpy: N(0, 1) embedding and bias table,
    N(0, 1/fan_in) kernels (in, out), norms near one."""
    rng = np.random.default_rng(seed)
    n = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    d, inner, ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    dense = lambda i, o: {"kernel": n(i, o, std=i**-0.5)}  # noqa: E731
    p = {
        "token_embedding": n(cfg.vocab_size, d, std=1.0),
        "relative_attention_bias": n(cfg.relative_attention_num_buckets, cfg.num_heads, std=1.0),
        "final_norm": 1 + n(d, std=0.1),
    }
    for i in range(cfg.num_layers):
        p[f"block_{i}"] = {
            "attn_norm": 1 + n(d, std=0.1),
            "ff_norm": 1 + n(d, std=0.1),
            "attention": {"q": dense(d, inner), "k": dense(d, inner), "v": dense(d, inner), "o": dense(inner, d)},
            "wi_0": dense(d, ff),
            "wi_1": dense(d, ff),
            "wo": dense(ff, d),
        }
    return p


def ids_and_mask(seed: int = 1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, (2, 7)).astype(np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0, 0]], bool)
    return ids, mask


def port_encoder(params: dict, cfg: T5Config = CFG, int8: bool = False) -> T5Encoder:
    enc = T5Encoder(cfg)
    if int8:
        enc = quant.quantize_t5_int8(enc)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t5_state_dict_from_jax(params, cfg).items()}
    enc.load_state_dict(sd, strict=True)
    return enc


def run_both(params: dict, act_quant: bool = False, int8: bool = False):
    ids, mask = ids_and_mask()
    jcfg = dataclasses.replace(JaxT5Config.tiny(), act_quant=act_quant)
    jp = jquant.quantize_t5_int8(params) if int8 else params
    want = np.asarray(JaxT5Encoder(jcfg).apply({"params": jp}, jnp.asarray(ids), jnp.asarray(mask)))
    enc = port_encoder(jax.tree_util.tree_map(np.asarray, jp), dataclasses.replace(CFG, act_quant=act_quant), int8)
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    return got, want


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_equals_jax(num_buckets, max_distance):
    rel = np.arange(-300, 301, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), num_buckets, max_distance))
    got = relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_config_fields_equal_jax():
    for name in ("tiny", "byt5_xl", "byt5_small_like"):
        assert dataclasses.asdict(getattr(T5Config, name)()) == dataclasses.asdict(getattr(JaxT5Config, name)()), name


def test_t5_encoder_matches_jax():
    got, want = run_both(jax_params(CFG))
    assert got.shape == (2, 7, CFG.d_model)
    np.testing.assert_allclose(got, want, **TOL)


def test_t5_state_dict_is_hf_layout():
    """The converted tree loads with strict=True under the HF
    T5EncoderModel names; HF's tied `encoder.embed_tokens.weight` is
    accepted and dropped."""
    sd = t5_state_dict_from_jax(jax_params(CFG), CFG)
    enc = T5Encoder(CFG)
    assert sorted(sd) == sorted(enc.state_dict())
    assert "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight" in sd
    assert "encoder.block.1.layer.1.DenseReluDense.wi_0.weight" in sd and "encoder.final_layer_norm.weight" in sd
    tied = {**sd, "encoder.embed_tokens.weight": sd["shared.weight"]}
    enc.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tied.items()}, strict=True)


def test_t5_int8_weight_only_matches_jax():
    """quantize_t5_int8 gives JAX's codes and scales bit for bit, leaves the
    embedding, norms and bias table float, and the encoder matches JAX's
    weight-only forward."""
    params = jax_params(CFG)
    enc = port_encoder(params)
    q = quant.quantize_t5_int8(enc)
    want_sd = t5_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jquant.quantize_t5_int8(params)), CFG)
    got_sd = q.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    n_int8 = sum(v.dtype == torch.int8 for v in got_sd.values())
    assert n_int8 == 7 * CFG.num_layers
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    assert enc.encoder.block[0].layer[0].SelfAttention.q.weight.dtype == torch.float32  # the float model kept
    got, want = run_both(params, int8=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_t5_w8a8_matches_jax():
    got, want = run_both(jax_params(CFG), act_quant=True, int8=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_t5_act_quant_is_inert_on_float_weights():
    params = jax_params(CFG)
    ids, mask = (torch.from_numpy(a) for a in ids_and_mask())
    plain = port_encoder(params)(ids, mask)
    flagged = port_encoder(params, dataclasses.replace(CFG, act_quant=True))(ids, mask)
    assert torch.equal(plain, flagged)


def test_t5_int8_state_loads_only_into_int8_encoder():
    params = jax_params(CFG)
    sd = quant.quantize_t5_int8(port_encoder(params)).state_dict()
    with pytest.raises(ValueError, match="int8"):
        T5Encoder(CFG).load_state_dict(sd)
    again = quant.quantize_t5_int8(T5Encoder(CFG))
    again.load_state_dict(sd, strict=True)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def pipeline_parts(t5_cfg: T5Config):
    cfg = dataclasses.replace(PaellaConfig.tiny(), byt5_embd=t5_cfg.d_model)
    model, vq = Paella(cfg), VQModel(VQConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(0))
    vq.reset_parameters(torch.Generator().manual_seed(1))
    return model.eval(), vq.eval()


def test_t5_encoder_is_the_pipelines_byt5_encode_fn():
    """The W8A8 ByT5 encoder plugs into PaellaPipeline as byt5_encode_fn:
    the conditioning states are the encoder's output on the prompt's ids."""
    enc = quant.quantize_t5_int8(port_encoder(jax_params(CFG)))
    enc.config = dataclasses.replace(CFG, act_quant=True)
    model, vq = pipeline_parts(CFG)
    pipe = PaellaPipeline(model, vq, enc)
    states, mask = pipe.encode_text(["a corgi"])
    ids, want_mask = byt5_batch_encode(["a corgi"], max_length=pipe.byt5_max_length)
    pad = ((0, 0), (0, pad_bucket(ids.shape[1]) - ids.shape[1]))
    ids, want_mask = torch.from_numpy(np.pad(ids, pad)), torch.from_numpy(np.pad(want_mask, pad))
    assert torch.equal(mask, want_mask) and int(mask.sum()) == len("a corgi") + 1
    assert torch.equal(states, enc(ids, want_mask))
    img = pipe.text_to_image(["a corgi"], torch.tensor([[1, 2]]), image_hw=(32, 32), config=SampleConfig(steps=2))
    assert img.shape == (1, 32, 32, 3) and torch.isfinite(img).all()


def test_t5_w8a8_quality_proxy_rows():
    """Finite rows, small drift at these near-identity weights, and a
    width mismatch refused."""
    enc = port_encoder(jax_params(CFG))
    model, _ = pipeline_parts(CFG)
    with torch.no_grad():
        for p in model.parameters():  # the zero-initialized mappers would make every logit equal
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.02)
    model.drop_derived()
    rows = quant.t5_w8a8_quality_proxy(enc, model, torch.Generator().manual_seed(3), t_values=(0.9, 0.3), latent_hw=(8, 8))
    assert [r["t"] for r in rows] == [0.9, 0.3]
    for r in rows:
        assert np.isfinite([r["kl"], r["flip"], r["rel"]]).all() and 0 <= r["kl"] < 0.05 and 0 <= r["flip"] <= 1, r
    other = Paella(dataclasses.replace(model.config, byt5_embd=CFG.d_model + 8))
    with pytest.raises(ValueError, match="byt5_embd"):
        quant.t5_w8a8_quality_proxy(enc, other, torch.Generator().manual_seed(3))

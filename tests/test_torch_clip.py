"""The port's CLIP towers, resize, clip_preprocess and CLIP BPE tokenizer
(paella_tpu_torch/cond/clip.py, nn/functional.py::resize,
cond/tokenizers.py) against the JAX package's, on the CPU at the tiny
configs: the same numpy weights (an open_clip state dict, converted to a JAX
tree by the JAX package and carried back by
convert.clip_*_state_dict_from_jax) and the same numpy inputs through both.

Tolerances:
- towers in float32: rtol = atol = 1e-5; in bfloat16: 2% of the largest
  output (each framework rounds inside the tower on its own).
- towers loaded from HF transformers models: 2e-3, as the JAX tests allow.
- resize: atol 1e-5 in float32; clip_preprocess: the same, divided by
  the smallest CLIP std (it scales the resized image by 1 / std).
- tokenizer: token for token.
"""
import dataclasses
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
from paella_tpu.cond import clip as jclip
from paella_tpu.cond import tokenizers as jax_tok
from paella_tpu_torch.cond import tokenizers as tok
from paella_tpu_torch.cond.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    CLIP_STD,
    clip_preprocess,
    convert_hf_clip_text,
    convert_hf_clip_vision,
    split_open_clip,
)
from paella_tpu_torch.convert import clip_text_state_dict_from_jax, clip_vision_state_dict_from_jax
from paella_tpu_torch.nn.functional import resize
from tests.test_loader import synth_open_clip_state_dict
from tests.test_tokenizers import MERGES, SAFE_PROMPTS

TOL = dict(rtol=1e-5, atol=1e-5)
TOWERS = {
    "text": (CLIPTextConfig, CLIPTextEncoder, jclip.CLIPTextConfig, jclip.CLIPTextEncoder),
    "vision": (CLIPVisionConfig, CLIPVisionEncoder, jclip.CLIPVisionConfig, jclip.CLIPVisionEncoder),
}


def open_clip_state_dict(seed: int = 0) -> dict:
    """The JAX tests' synthetic open_clip checkpoint (both tiny towers) with
    every entry moved by N(0, 0.05) noise: non-zero biases and LayerNorms
    away from the identity."""
    sd = synth_open_clip_state_dict(jclip.CLIPTextConfig.tiny(), jclip.CLIPVisionConfig.tiny(), seed=seed)
    rng = np.random.default_rng(seed + 1)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in sd.items()}


def tower_inputs(kind: str, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "text":
        ids = rng.integers(0, 60, (2, 16)).astype(np.int32)
        ids[0, 6], ids[1, 11] = 63, 62  # each sequence's EOT is its highest id
        return ids
    return rng.standard_normal((2, 32, 32, 3)).astype(np.float32)


def to_torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def port_tower(kind: str, jax_params: dict, dtype: str = "float32"):
    cfg_cls, enc_cls, _, _ = TOWERS[kind]
    cfg = dataclasses.replace(cfg_cls.tiny(), dtype=dtype)
    from_jax = clip_text_state_dict_from_jax if kind == "text" else clip_vision_state_dict_from_jax
    tower = enc_cls(cfg)
    tower.load_state_dict(to_torch_sd(from_jax(jax_params, cfg)), strict=True)
    return tower.cast_products()


def jax_tree(kind: str, sd: dict) -> dict:
    if kind == "text":
        return jclip.convert_open_clip_text(sd, jclip.CLIPTextConfig.tiny())
    return jclip.convert_open_clip_vision(sd, jclip.CLIPVisionConfig.tiny())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["text", "vision"])
def test_tower_matches_jax(kind, dtype):
    _, _, jcfg_cls, jenc_cls = TOWERS[kind]
    params = jax_tree(kind, open_clip_state_dict())
    x = tower_inputs(kind)
    want = np.asarray(
        jenc_cls(dataclasses.replace(jcfg_cls.tiny(), dtype=dtype)).apply({"params": params}, jnp.asarray(x)), np.float32
    )
    got = port_tower(kind, params, dtype)(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape == (2, 24)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["text", "vision"])
def test_open_clip_layout_loads_strict(kind):
    """An open_clip checkpoint (with its logit_scale) splits into the two
    towers' state dicts, each loading with strict=True; those are exactly
    what the JAX tree converts back to, and give the same features."""
    sd = open_clip_state_dict()
    text_sd, vision_sd = split_open_clip({**sd, "logit_scale": np.float32(4.6)})
    own = text_sd if kind == "text" else vision_sd
    cfg_cls, enc_cls, _, _ = TOWERS[kind]
    tower = enc_cls(cfg_cls.tiny())
    tower.load_state_dict(to_torch_sd(own), strict=True)
    params = jax_tree(kind, sd)
    from_jax = clip_text_state_dict_from_jax if kind == "text" else clip_vision_state_dict_from_jax
    back = from_jax(jax.tree_util.tree_map(np.asarray, params), cfg_cls.tiny())
    assert sorted(back) == sorted(own) == sorted(tower.state_dict())
    for k, v in own.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    x = torch.from_numpy(tower_inputs(kind))
    torch.testing.assert_close(tower(x), port_tower(kind, params)(x), rtol=0, atol=0)


def test_text_tower_loads_hf_weights():
    from transformers import CLIPTextConfig as HFCfg, CLIPTextModelWithProjection

    cfg = CLIPTextConfig.tiny()
    hf_cfg = HFCfg(
        vocab_size=cfg.vocab_size, hidden_size=cfg.width, num_attention_heads=cfg.heads,
        num_hidden_layers=cfg.layers, intermediate_size=cfg.width * 4, max_position_embeddings=cfg.context_length,
        projection_dim=cfg.embed_dim, hidden_act="gelu", eos_token_id=cfg.vocab_size - 1, bos_token_id=0,
        attention_dropout=0.0,
    )
    torch.manual_seed(1)
    hf = CLIPTextModelWithProjection(hf_cfg).eval()
    ids = np.array([[0, 5, 9, cfg.vocab_size - 1, 2, 2], [0, 11, 12, 13, 14, cfg.vocab_size - 1]], np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids)).text_embeds.numpy()
    tower = CLIPTextEncoder(cfg)
    sd = convert_hf_clip_text({k: v.numpy() for k, v in hf.state_dict().items()}, cfg)
    tower.load_state_dict(to_torch_sd(sd), strict=True)
    np.testing.assert_allclose(tower(torch.from_numpy(ids)).numpy(), want, rtol=2e-3, atol=2e-3)


def test_vision_tower_loads_hf_weights():
    from transformers import CLIPVisionConfig as HFCfg, CLIPVisionModelWithProjection

    cfg = CLIPVisionConfig.tiny()
    hf_cfg = HFCfg(
        image_size=cfg.image_size, patch_size=cfg.patch_size, hidden_size=cfg.width,
        num_attention_heads=cfg.heads, num_hidden_layers=cfg.layers, intermediate_size=cfg.width * 4,
        projection_dim=cfg.embed_dim, hidden_act="gelu", attention_dropout=0.0,
    )
    torch.manual_seed(2)
    hf = CLIPVisionModelWithProjection(hf_cfg).eval()
    img = tower_inputs("vision", seed=3)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(img.transpose(0, 3, 1, 2))).image_embeds.numpy()
    tower = CLIPVisionEncoder(cfg)
    sd = convert_hf_clip_vision({k: v.numpy() for k, v in hf.state_dict().items()}, cfg)
    tower.load_state_dict(to_torch_sd(sd), strict=True)
    np.testing.assert_allclose(tower(torch.from_numpy(img)).numpy(), want, rtol=2e-3, atol=2e-3)


def test_config_fields_equal_jax():
    for cfg_cls, _, jcfg_cls, _ in TOWERS.values():
        for name in ("tiny", "vit_h_14"):
            assert dataclasses.asdict(getattr(cfg_cls, name)()) == dataclasses.asdict(getattr(jcfg_cls, name)()), name


RESIZES = [((2, 16, 16, 3), 32), ((2, 48, 40, 3), 32), ((1, 64, 64, 3), 299)]


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape,out", RESIZES)
def test_resize_matches_jax_image_resize(shape, out, method):
    x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], out, out, 3), method=method))
    got = resize(torch.from_numpy(x), (out, out), method)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_interpolate_is_not_jax_resize_when_downsampling(method):
    """F.interpolate (a = -0.75 bicubic, clamped borders, no antialiasing)
    is not a stand-in for the resize: at the downsampling shape it misses
    the tolerance the port's resize holds."""
    x = np.random.default_rng(5).uniform(0, 1, (2, 48, 40, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 32, 3), method=method))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(32, 32), mode=method, align_corners=False)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("side", [224, 256, 48])
def test_clip_preprocess_matches_jax(side):
    x = np.random.default_rng(side).uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    want = np.asarray(jclip.clip_preprocess(jnp.asarray(x), 224))
    got = clip_preprocess(torch.from_numpy(x), 224)
    assert tuple(got.shape) == (2, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 / min(CLIP_STD))


# ---------------------------------------------------------------------------
# the CLIP BPE tokenizer, a copy of the JAX package's
# ---------------------------------------------------------------------------

OPEN_CLIP_PROMPTS = ["don't", "it's a cat!!", "The CAT", "crème brûlée &amp; café", "東京の夜", "a  photo\nof  19200 cats"]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "merges.txt")
    tok.write_merges_file(MERGES, path)
    return tok.CLIPTokenizer(path, num_merges=len(MERGES)), jax_tok.CLIPTokenizer(path, num_merges=len(MERGES))


def test_clip_tokenizer_matches_jax_token_for_token(tokenizers):
    port, ref = tokenizers
    prompts = SAFE_PROMPTS + OPEN_CLIP_PROMPTS
    assert port.vocab_size == ref.vocab_size and port.encoder == ref.encoder
    for p in prompts:
        assert port.encode(p) == ref.encode(p), p
        assert port.decode(port.encode(p)) == ref.decode(ref.encode(p))
    np.testing.assert_array_equal(port(prompts), ref(prompts))
    np.testing.assert_array_equal(port("a cat", context_length=16), ref("a cat", context_length=16))


def test_clip_tokenizer_truncates_at_77_with_eot(tokenizers):
    port, ref = tokenizers
    ids = port(["cat " * 200, "a cat"])
    assert ids.shape == (2, 77) and ids.dtype == np.int32
    assert ids[0, -1] == port.eot_token_id and ids[0, 0] == port.sot_token_id and (ids[0] != 0).all()
    np.testing.assert_array_equal(ids, ref(["cat " * 200, "a cat"]))


def test_clip_tokenizer_copy_equals_the_original(tmp_path):
    assert tok.DEFAULT_NUM_MERGES == jax_tok.DEFAULT_NUM_MERGES == 48894
    assert tok.bytes_to_unicode() == jax_tok.bytes_to_unicode()
    assert tok._PAT.pattern == jax_tok._PAT.pattern and tok._PAT.flags == jax_tok._PAT.flags
    tok.write_merges_file(MERGES, str(tmp_path / "a.txt"), header="#version: 0.2")
    jax_tok.write_merges_file(MERGES, str(tmp_path / "b.txt"), header="#version: 0.2")
    assert filecmp.cmp(tmp_path / "a.txt", tmp_path / "b.txt", shallow=False)
    for text in ("  Hello\tWORLD  ", "&amp;lt;b&amp;gt;"):
        assert tok._whitespace_clean(tok._basic_clean(text)) == jax_tok._whitespace_clean(jax_tok._basic_clean(text))

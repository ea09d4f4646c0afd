"""The port's PaellaPipeline against the JAX package's, at the tiny configs in
f32 on the CPU: both pipelines hold the same weights (the denoiser and codec
helpers of the other test_torch_* files) and the same numpy stand-ins for the
text and image towers, and take the same (B, 2) uint32 seed pairs.

To compare tokens, `_decode_clipped` is replaced by the identity on both
pipeline instances, so each generation entry point returns its token grid.
One sampling step is held at an agreement share of 0.995 and a multi-step
run at 0.95, as in test_torch_slice.py. Also here: the ByT5 tokenizer and the
editing helpers the port copies, and the CLIP score.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.cond import tokenizers as jax_tok
from paella_tpu.eval.metrics import clip_score as jax_clip_score
from paella_tpu.pipeline import PaellaPipeline as JaxPipeline
from paella_tpu.config import SampleConfig as JaxSampleConfig
from paella_tpu.sampling import editing as jax_editing
from paella_tpu_torch import PaellaPipeline
from paella_tpu_torch.cond import tokenizers as tok
from paella_tpu_torch.config import SampleConfig
from paella_tpu_torch.eval import clip_score
from paella_tpu_torch.sampling import editing
from tests.test_torch_codec import make_codec
from tests.test_torch_denoiser import make_paella
from tests.test_torch_sampling import seed_pairs

PROMPTS = ["a red car on a beach", "ein Hund im Schnee"]
IMAGE_HW = (32, 32)  # latent 8x8 with the tiny codec's f4
KW = dict(steps=3, temperature=(1.0, 0.6), cfg=(3.0, 3.0))


class Towers:
    """Numpy stand-ins for the text and image towers, one call for each
    package: ByT5 states from a table over byte ids, CLIP-text features
    from each prompt's bytes, CLIP-image features from a projection."""

    def __init__(self, byt5_embd: int, clip_embd: int, seed: int = 50):
        rng = np.random.default_rng(seed)
        self.table = rng.standard_normal((260, byt5_embd)).astype(np.float32)
        self.text_proj = rng.standard_normal((256, clip_embd)).astype(np.float32)
        self.image_proj = rng.standard_normal((128, clip_embd)).astype(np.float32)
        self.byt5_calls = 0

    def text(self, prompts) -> np.ndarray:
        out = np.zeros((len(prompts), self.text_proj.shape[1]), np.float32)
        for i, p in enumerate(prompts):
            for b in p.encode("utf-8"):
                out[i] += self.text_proj[b]
        return out / 8.0 + 0.1

    def image(self, x: np.ndarray) -> np.ndarray:
        """From token grids (the identity decode) or images (B, H, W, 3)."""
        if x.ndim == 3:
            return self.image_proj[x.astype(np.int64)].mean(axis=(1, 2))
        return x.reshape(x.shape[0], -1)[:, :128] @ self.image_proj

    def jax_byt5(self, ids, mask):
        self.byt5_calls += 1
        return jnp.asarray(self.table)[ids]

    def torch_byt5(self, ids, mask):
        self.byt5_calls += 1
        return torch.from_numpy(self.table)[ids.long()]


def make_pipelines(identity_decode: bool):
    model, jmodel, jparams = make_paella(seed=40)
    vq, jvq, jvars = make_codec(seed=41)
    towers = Towers(model.config.byt5_embd, model.config.clip_embd)
    port = PaellaPipeline(
        model, vq, towers.torch_byt5,
        clip_text_fn=lambda p: torch.from_numpy(towers.text(p)),
        clip_image_fn=lambda x: torch.from_numpy(towers.image(np.asarray(x))),
    )
    ref = JaxPipeline(
        jmodel, jparams, jvq, jvars, towers.jax_byt5,
        clip_text_fn=lambda p: jnp.asarray(towers.text(p)),
        clip_image_fn=lambda x: jnp.asarray(towers.image(np.asarray(x))),
    )
    if identity_decode:
        port._decode_clipped = lambda t: t
        ref._decode_clipped = lambda t: t
    return port, ref, towers


@pytest.fixture(scope="module")
def token_pipes():
    return make_pipelines(identity_decode=True)


@pytest.fixture(scope="module")
def pipes():
    return make_pipelines(identity_decode=False)


def images(b: int = 2, seed: int = 60) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b,) + IMAGE_HW + (3,)).astype(np.float32)


def seeds_for(b: int, seed: int):
    s = seed_pairs(b, seed=seed)
    return torch.from_numpy(s.astype(np.int64)), jnp.asarray(s)


def agree(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32
    return float((got == want).mean())


@pytest.mark.parametrize("negative", [False, True])
def test_text_to_image_tokens_match_jax(token_pipes, negative):
    port, ref, _ = token_pipes
    ts, js = seeds_for(2, 61)
    neg = ["blurry", "dark"] if negative else None
    got = port.text_to_image(PROMPTS, ts, IMAGE_HW, SampleConfig(**KW), negative_prompts=neg)
    want = ref.text_to_image(PROMPTS, js, IMAGE_HW, JaxSampleConfig(**KW), negative_prompts=neg)
    assert got.shape == (2, 8, 8)
    assert agree(got, want) >= 0.95


def test_one_step_text_to_image_matches_jax(token_pipes):
    port, ref, _ = token_pipes
    ts, js = seeds_for(2, 62)
    kw = dict(steps=1, temperature=(0.9, 0.9), cfg=(3.0, 3.0))
    got = port.text_to_image(PROMPTS, ts, IMAGE_HW, SampleConfig(**kw))
    assert agree(got, ref.text_to_image(PROMPTS, js, IMAGE_HW, JaxSampleConfig(**kw))) >= 0.995


def test_text_to_image_with_phrase_reweight_matches_jax(token_pipes):
    """cond_reweight from reweight_for_phrase over the bucket-padded ByT5
    length (64) and the CLIP-text tokens (4)."""
    port, ref, _ = token_pipes
    ts, js = seeds_for(1, 63)
    rew = editing.reweight_for_phrase(PROMPTS[0], "red", 3.0, byt5_len=64)
    got = port.text_to_image(PROMPTS[:1], ts, IMAGE_HW, SampleConfig(**KW), cond_reweight=torch.from_numpy(rew))
    want = ref.text_to_image(PROMPTS[:1], js, IMAGE_HW, JaxSampleConfig(**KW), cond_reweight=jnp.asarray(rew))
    assert agree(got, want) >= 0.95


def test_img2img_tokens_match_jax(token_pipes):
    port, ref, _ = token_pipes
    ts, js = seeds_for(2, 64)
    x = images()
    got = port.img2img(PROMPTS, torch.from_numpy(x), ts, 0.8, SampleConfig(**KW))
    want = ref.img2img(PROMPTS, jnp.asarray(x), js, 0.8, JaxSampleConfig(**KW))
    assert agree(got, want) >= 0.95


def test_inpaint_tokens_match_jax(token_pipes):
    port, ref, _ = token_pipes
    ts, js = seeds_for(2, 65)
    x = images(seed=66)
    keep = np.zeros((2, 8, 8), bool)
    keep[:, :, :4] = True  # keep the left half
    got = port.inpaint(PROMPTS, torch.from_numpy(x), torch.from_numpy(keep), ts, SampleConfig(**KW))
    want = ref.inpaint(PROMPTS, jnp.asarray(x), jnp.asarray(keep), js, JaxSampleConfig(**KW))
    tokens0 = port.encode_image_tokens(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.numpy()[keep], tokens0[keep])
    np.testing.assert_array_equal(np.asarray(want)[keep], tokens0[keep])
    assert agree(got, want) >= 0.95


def test_interpolate_matches_jax(token_pipes):
    port, ref, _ = token_pipes
    x = images(seed=67)
    got = port.interpolate(torch.from_numpy(x[0]), torch.from_numpy(x[1]), 4, decode=False)
    want = ref.interpolate(jnp.asarray(x[0]), jnp.asarray(x[1]), 4, decode=False)
    assert got.shape == (4, 8, 8)
    tokens0 = port.encode_image_tokens(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.numpy()[[0, -1]], tokens0)
    assert agree(got, want) >= 0.99


def test_encode_image_tokens_and_decode_match_jax(pipes):
    port, ref, _ = pipes
    x = images(seed=68)
    got = port.encode_image_tokens(torch.from_numpy(x))
    want = ref.encode_image_tokens(jnp.asarray(x))
    assert got.shape == (2, 8, 8) and agree(got, want) >= 0.99
    np.testing.assert_allclose(port.decode(got).numpy(), np.asarray(ref.decode(jnp.asarray(got.numpy()))), rtol=1e-4, atol=1e-4)


def test_outpaint_places_and_pins_the_image(token_pipes, pipes):
    """32x32 images onto a 32x64 canvas at offset (0, 16): latent 8x16 with
    the encoded tokens pinned at columns 4..12. (The canvas's random tokens
    come from the seed pairs, not from JAX's stream, so no token parity.)"""
    port, _, _ = token_pipes
    ts, _ = seeds_for(2, 69)
    x = torch.from_numpy(images(seed=70))
    tokens = port.outpaint(PROMPTS, x, (32, 64), (0, 16), ts, SampleConfig(**KW))
    assert tokens.shape == (2, 8, 16) and tokens.dtype == torch.int32
    torch.testing.assert_close(tokens[:, :, 4:12], port.encode_image_tokens(x), rtol=0, atol=0)
    assert bool(((tokens >= 0) & (tokens < port.model.config.num_labels)).all())
    image = pipes[0].outpaint(PROMPTS, x, (32, 64), (0, 16), ts, SampleConfig(**KW))
    assert image.shape == (2, 32, 64, 3) and bool(torch.isfinite(image).all())
    assert float(image.min()) >= 0.0 and float(image.max()) <= 1.0


def test_text_to_image_best_of_matches_jax(token_pipes):
    """Two prompts, three candidates each, scored by the stand-in towers:
    the same scores and the same pick."""
    port, ref, _ = token_pipes
    ts, js = seeds_for(6, 71)
    got, got_scores = port.text_to_image_best_of(PROMPTS, ts, 3, IMAGE_HW, SampleConfig(**KW), return_scores=True)
    want, want_scores = ref.text_to_image_best_of(PROMPTS, js, 3, IMAGE_HW, JaxSampleConfig(**KW), return_scores=True)
    assert got_scores.shape == (2, 3) and got.shape == (2, 8, 8)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_scores.argmax(1).numpy(), np.asarray(want_scores).argmax(1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generated_images_are_clipped(pipes):
    port, _, _ = pipes
    ts, _ = seeds_for(1, 72)
    img = port.text_to_image(PROMPTS[:1], ts, IMAGE_HW, SampleConfig(steps=2))
    assert img.shape == (1, 32, 32, 3) and img.dtype == torch.float32
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_text_conditioning_is_cached(pipes):
    """A repeated prompt reuses its ByT5 states: the text tower runs once."""
    port, _, towers = pipes
    before = towers.byt5_calls
    first = port.conditioning(["a corgi in space"])
    second = port.conditioning(["a corgi in space"])
    assert second is first and towers.byt5_calls == before + 1
    states, mask = port.encode_text(["a corgi in space"])
    assert towers.byt5_calls == before + 1
    assert states.shape == (1, 64, port.model.config.byt5_embd) and int(mask.sum()) == len("a corgi in space") + 1
    assert port.null_conditioning(3) is port.null_conditioning(3)


def test_clip_score_matches_jax():
    rng = np.random.default_rng(73)
    t, v = (rng.standard_normal((5, 16)).astype(np.float32) for _ in range(2))
    v[0] = -t[0]  # negative cosine clips to 0
    got = clip_score(torch.from_numpy(t), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_clip_score(jnp.asarray(t), jnp.asarray(v))), rtol=1e-5, atol=1e-5)
    assert got[0] == 0.0


TEXTS = ["a red car on a beach", "", "crème brûlée, 東京の夜", "x" * 900]


def test_byt5_tokenizer_copy_equals_the_original():
    for t in TEXTS:
        assert tok.byt5_encode(t) == jax_tok.byt5_encode(t)
        assert tok.byt5_encode(t, max_length=16) == jax_tok.byt5_encode(t, max_length=16)
        assert tok.byt5_decode(tok.byt5_encode(t)) == jax_tok.byt5_decode(jax_tok.byt5_encode(t)) == t
    for kw in ({}, {"max_length": 32}, {"pad_to": 64}, {"max_length": None}):
        for a, b in zip(tok.byt5_batch_encode(TEXTS, **kw), jax_tok.byt5_batch_encode(TEXTS, **kw)):
            np.testing.assert_array_equal(a, b)
    for n in (1, 64, 65, 700, 769, 1000):
        assert tok.pad_bucket(n) == jax_tok.pad_bucket(n)


def test_editing_copy_equals_the_original():
    for prompt, phrase in (("a red car on a beach", "red"), ("crème brûlée, 東京の夜", "東京"), ("abc", "zzz")):
        assert editing.phrase_byte_span(prompt, phrase) == jax_editing.phrase_byte_span(prompt, phrase)
        kw = dict(byt5_len=64, has_clip=True, has_clip_image=True)
        if editing.phrase_byte_span(prompt, phrase) is None:
            with pytest.raises(ValueError):
                editing.reweight_for_phrase(prompt, phrase, 2.0, **kw)
            continue
        np.testing.assert_array_equal(
            editing.reweight_for_phrase(prompt, phrase, 2.0, **kw), jax_editing.reweight_for_phrase(prompt, phrase, 2.0, **kw)
        )
    spans = [(0, 3, 2.0), (10, 12, 0.5)]
    np.testing.assert_array_equal(
        editing.build_cond_reweight(32, spans, has_clip_image=True, clip_image_weight=0.3, base=0.9),
        jax_editing.build_cond_reweight(32, spans, has_clip_image=True, clip_image_weight=0.3, base=0.9),
    )

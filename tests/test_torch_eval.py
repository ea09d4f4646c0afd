"""The port's eval harness (paella_tpu_torch/eval/) against the JAX
package's, on the CPU: InceptionV3 pool3 in both variants on
tests/test_inception.py's synthetic state dict, the FID preprocess, the
float64 Fréchet distance on seeded features, and the CLIP featurizer and
score over the tiny towers (the weights of tests/test_torch_clip.py).

Tolerances: pool3 5e-3 (as tests/test_inception.py holds the JAX network
to torch), the preprocess 1e-5 (the resize's), the Fréchet distance and FID
rtol 1e-10 (the same float64 numpy), the CLIP features and scores 1e-5
(float32 towers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from paella_tpu.cond import clip as jclip
from paella_tpu.eval import inception as jinc
from paella_tpu.eval import metrics as jmetrics
from paella_tpu_torch.eval import (
    clip_image_features,
    clip_score_images,
    convert_inception,
    feature_stats,
    features_over_batches,
    fid_from_features,
    frechet_distance,
    inception_features,
    inception_pool3,
    inception_preprocess,
    load_inception,
)
from tests.test_inception import synth_inception_state_dict
from tests.test_torch_clip import jax_tree, open_clip_state_dict, port_tower


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs its files in parallel workers, and torch's intra-op pool
    takes one thread a core in each: oversubscribed so, the 299x299
    Inception forwards of test_classic_fid_over_batches took ~40 s where
    they take under a second alone. One thread for this module's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inception_sd():
    return synth_inception_state_dict()


@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_inception_pool3_matches_jax(inception_sd, variant):
    x = np.random.default_rng(5).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, jinc.convert_inception(inception_sd))
    want = np.asarray(jinc.inception_pool3(params, jnp.asarray(x), variant))
    got = inception_pool3(convert_inception(inception_sd), torch.from_numpy(x), variant)
    assert tuple(got.shape) == (2, 2048) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("uint8", [False, True])
def test_inception_preprocess_matches_jax(uint8):
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    if uint8:
        x = (x * 255).astype(np.uint8)
    want = np.asarray(jinc.inception_preprocess(jnp.asarray(x)))
    got = inception_preprocess(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_classic_fid_over_batches(inception_sd, tmp_path):
    """features_over_batches over the port's featurizer, loaded from a torch
    checkpoint on disk (load_inception, on the CPU): identical sets give an
    FID of ~0, a noisier set a positive one, as in the JAX test."""
    path = tmp_path / "pt_inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in inception_sd.items()}, str(path))
    extract = load_inception(str(path), device="cpu")
    rng = np.random.default_rng(7)
    real = rng.uniform(0, 1, (4, 48, 48, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.3, real.shape), 0, 1).astype(np.float32)
    f_real = features_over_batches(extract, [real[:2], real[2:]])
    assert f_real.shape == (4, 2048) and f_real.dtype == np.float32
    assert fid_from_features(f_real, f_real) < 1e-6
    assert fid_from_features(f_real, features_over_batches(extract, [fake])) > 1e-3
    with pytest.raises(ValueError, match="no image batches"):
        features_over_batches(extract, [])


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((64, 16))
    b = rng.standard_normal((48, 16)) @ rng.standard_normal((16, 16)) * 0.5 + 0.3
    for got, want in zip(feature_stats(a), jmetrics.feature_stats(a)):
        np.testing.assert_allclose(got, want, rtol=1e-10)
    got = frechet_distance(*feature_stats(a), *feature_stats(b))
    assert got == pytest.approx(jmetrics.frechet_distance(*jmetrics.feature_stats(a), *jmetrics.feature_stats(b)), rel=1e-10)
    assert fid_from_features(a, b) == pytest.approx(jmetrics.fid_from_features(a, b), rel=1e-10)
    assert fid_from_features(a, b) > 1.0 and fid_from_features(a, a) < 1e-9
    with pytest.raises(ValueError):
        feature_stats(a[:1])


@pytest.fixture(scope="module")
def towers():
    sd = open_clip_state_dict(seed=9)
    jt, jv = jax_tree("text", sd), jax_tree("vision", sd)
    return (port_tower("text", jt), port_tower("vision", jv),
            jclip.CLIPTextEncoder(jclip.CLIPTextConfig.tiny()), jt, jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig.tiny()), jv)


@pytest.mark.parametrize("uint8", [False, True])
def test_clip_image_features_match_jax(towers, uint8):
    _, vision, _, _, jvision, jv = towers
    x = np.random.default_rng(10).uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    if uint8:
        x = (x * 255).astype(np.uint8)
    want = np.asarray(jmetrics.clip_image_features(jvision, jv)(jnp.asarray(x)))
    got = clip_image_features(vision)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_clip_score_images_matches_jax(towers):
    text, vision, jtext, jt, jvision, jv = towers
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 60, (3, 16)).astype(np.int32)
    ids[:, 9] = 63
    x = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmetrics.clip_score_images(jtext, jt, jvision, jv, jnp.asarray(ids), jnp.asarray(x)))
    got = clip_score_images(text, vision, ids, torch.from_numpy(x))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_convert_inception_walks_the_jax_keys_and_checks_shapes(inception_sd):
    from paella_tpu_torch.eval.inception import INCEPTION_SHAPES

    assert {b: None if None in u else list(u) for b, u in INCEPTION_SHAPES.items()} == jinc.INCEPTION_UNITS
    bad = {**inception_sd, "Mixed_6e.branch7x7_2.conv.weight": np.zeros((192, 192, 7, 1), np.float32)}
    with pytest.raises(ValueError, match="Mixed_6e.branch7x7_2"):
        convert_inception(bad)

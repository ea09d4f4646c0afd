"""The port's checkpoint loader (paella_tpu_torch/cond/loader.py) against the
JAX package's, on the CPU: both packages' load_conditional_models read the
same files, written with torch.save by tests/test_loader.py's fixture (a
tiny VQGAN, a tiny HF ByT5, tiny open_clip towers and a synthetic merge
table), and their decoders and encoders take the same numpy inputs.

Tolerances, those of the other port tests at these configs: the codec
1e-4 (test_torch_codec.py), ByT5 float and int8 weight-only 1e-5 and W8A8
rtol 1e-4 / atol 1e-5 (test_torch_t5.py), the CLIP towers 1e-5
(test_torch_clip.py).
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.codec import VQModel as JaxVQModel
from paella_tpu.cond.loader import load_byt5 as jax_load_byt5
from paella_tpu.cond.loader import load_conditional_models as jax_load_conditional_models
from paella_tpu.config import VQConfig as JaxVQConfig
from paella_tpu_torch.cond import loader
from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPVisionConfig
from paella_tpu_torch.cond.t5 import T5Config
from paella_tpu_torch.cond.tokenizers import byt5_batch_encode
from paella_tpu_torch.config import VQConfig
from tests.test_loader import checkpoints  # noqa: F401  (the files, a module-scoped fixture)

PROMPTS = ["a red cat", "the catcat sat", ""]


def load_both(c, **kw):
    """(port models on the CPU, JAX models) from the fixture's files."""
    port = loader.load_conditional_models(
        c["vqgan"], byt5_path=c["byt5"], byt5_cfg=T5Config(**dataclasses.asdict(c["byt5_cfg"])),
        clip_path=c["clip"], clip_bpe_path=c["bpe"],
        clip_text_cfg=CLIPTextConfig(**dataclasses.asdict(c["tcfg"])),
        clip_vision_cfg=CLIPVisionConfig(**dataclasses.asdict(c["vcfg"])),
        vq_cfg=VQConfig.tiny(), device="cpu", **kw,
    )
    ref = jax_load_conditional_models(
        c["vqgan"], byt5_path=c["byt5"], byt5_cfg=c["byt5_cfg"], clip_path=c["clip"], clip_bpe_path=c["bpe"],
        clip_text_cfg=c["tcfg"], clip_vision_cfg=c["vcfg"], vq_cfg=JaxVQConfig.tiny(), **kw,
    )
    return port, ref


@pytest.fixture(scope="module")
def models(checkpoints):  # noqa: F811
    return load_both(checkpoints)


def test_vqgan_decodes_as_jax(models):
    port, ref = models
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    _, _, idx, _ = ref.vq.apply(ref.vq_vars, jnp.asarray(x), method=JaxVQModel.encode)
    want = np.asarray(ref.vq.apply(ref.vq_vars, idx, method=JaxVQModel.decode_indices))
    got = port.vq.decode_indices(torch.from_numpy(np.array(idx)))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_byt5_states_match_jax(models):
    port, ref = models
    ids, mask = byt5_batch_encode(PROMPTS)
    want = np.asarray(ref.byt5_encode(jnp.asarray(ids), jnp.asarray(mask)))
    got = port.byt5_encode(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (3, ids.shape[1], 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_byt5_int8_modes_match_jax(checkpoints, mode):  # noqa: F811
    c = checkpoints
    jcfg = dataclasses.replace(c["byt5_cfg"], act_quant=mode == "w8a8")
    enc = loader.load_byt5(c["byt5"], T5Config(**dataclasses.asdict(jcfg)), int8_weights=True, device="cpu")
    assert enc.encoder.block[0].layer[0].SelfAttention.q.weight.dtype == torch.int8
    ids, mask = byt5_batch_encode(PROMPTS)
    want = np.asarray(jax_load_byt5(c["byt5"], jcfg, int8_weights=True)(jnp.asarray(ids), jnp.asarray(mask)))
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    tol = dict(rtol=1e-4, atol=1e-5) if mode == "w8a8" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_clip_text_features_match_jax(models):
    port, ref = models
    want = np.asarray(ref.clip_text_encode(PROMPTS))
    got = port.clip_text_encode(PROMPTS)
    assert got.shape == (3, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_clip_image_features_match_jax(models):
    """Images at 48x48, which the preprocess resizes to the tower's 32x32."""
    port, ref = models
    x = np.random.default_rng(1).uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    want = np.asarray(ref.clip_image_encode(jnp.asarray(x)))
    got = port.clip_image_encode(torch.from_numpy(x))
    assert got.shape == (2, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_clip_needs_a_tokenizer(checkpoints):  # noqa: F811
    c = checkpoints
    with pytest.raises(ValueError, match="tokenizer"):
        loader.load_conditional_models(
            c["vqgan"], clip_path=c["clip"], clip_text_cfg=CLIPTextConfig(**dataclasses.asdict(c["tcfg"])),
            clip_vision_cfg=CLIPVisionConfig(**dataclasses.asdict(c["vcfg"])), vq_cfg=VQConfig.tiny(), device="cpu",
        )
    # a tokenizer= override stands in for the merge table
    ids = np.zeros((1, 77), np.int64)
    ids[:, 0] = 1
    text_encode, _ = loader.load_open_clip(
        c["clip"], CLIPTextConfig(**dataclasses.asdict(c["tcfg"])), CLIPVisionConfig(**dataclasses.asdict(c["vcfg"])),
        tokenizer=lambda prompts: ids, device="cpu",
    )
    assert text_encode(["whatever"]).shape == (1, 24)


def test_act_quant_needs_int8_weights(checkpoints):  # noqa: F811
    c = checkpoints
    cfg = dataclasses.replace(T5Config(**dataclasses.asdict(c["byt5_cfg"])), act_quant=True)
    with pytest.raises(ValueError, match="int8_weights"):
        loader.load_byt5(c["byt5"], cfg, device="cpu")


def test_device_defaults_to_cuda_and_has_no_cpu_fallback(checkpoints):  # noqa: F811
    for fn in (loader.load_vqgan, loader.load_byt5, loader.load_open_clip, loader.load_conditional_models):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_conditional_models(checkpoints["vqgan"], vq_cfg=VQConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.resolve_device("cuda:0")
    assert loader.resolve_device("cpu") == torch.device("cpu")


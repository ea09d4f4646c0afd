"""The port's codec (encoder, encode, decode, decode_indices) against the JAX
package's VQModel at VQConfig.tiny() in f32 on the CPU, with non-zero gammas
(the blocks are the identity at init) and BatchNorm running statistics away
from (0, 1), and the numpy codec converter against export_vqgan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.codec import VQModel as JaxVQModel
from paella_tpu.codec import VQResBlock as JaxVQResBlock
from paella_tpu.config import VQConfig as JaxVQConfig
from paella_tpu.convert import convert_vqgan, export_vqgan
from paella_tpu_torch.codec import VQModel, VQResBlock
from paella_tpu_torch.config import VQConfig
from paella_tpu_torch.convert import vqgan_state_dict_from_jax
from tests.test_torch_denoiser import perturbed_state_dict
from tests.test_torch_quantize import assert_near_ties_only

TOL = dict(rtol=1e-4, atol=1e-4)


def make_codec(seed: int = 0):
    """(port codec, JAX codec, JAX variables) with the same perturbed weights."""
    vq = VQModel(VQConfig.tiny())
    vq.reset_parameters(torch.Generator().manual_seed(seed))
    sd = perturbed_state_dict(vq, seed + 1, scale=0.1)
    rng = np.random.default_rng(seed + 2)
    c = VQConfig.tiny().c_latent
    sd["down_blocks.3.1.running_mean"] = (rng.standard_normal(c) * 0.5).astype(np.float32)
    sd["down_blocks.3.1.running_var"] = rng.uniform(0.3, 3.0, c).astype(np.float32)
    vq.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return vq, JaxVQModel(JaxVQConfig.tiny()), convert_vqgan(sd, JaxVQConfig.tiny())


@pytest.fixture(scope="module")
def codec():
    return make_codec()


def test_decode_indices_matches_jax(codec):
    vq, jvq, jvars = codec
    idx = np.random.default_rng(0).integers(0, VQConfig.tiny().codebook_size, (2, 8, 8)).astype(np.int32)
    want = np.asarray(jvq.apply(jvars, jnp.asarray(idx), method=JaxVQModel.decode_indices))
    got = vq.decode_indices(torch.from_numpy(idx))
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert np.abs(np.asarray(jvars["params"]["up_res_0_0"]["gammas"])).min() > 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vq_resblock_matches_jax():
    rng = np.random.default_rng(1)
    blk = VQResBlock(16, 64)
    blk.reset_parameters(torch.Generator().manual_seed(1))
    sd = perturbed_state_dict(blk, 2, scale=0.2)
    p = {
        "gammas": sd["gammas"],
        "depthwise": {"kernel": sd["depthwise.1.weight"].transpose(2, 3, 1, 0), "bias": sd["depthwise.1.bias"]},
        "fc1": {"kernel": sd["channelwise.0.weight"].T, "bias": sd["channelwise.0.bias"]},
        "fc2": {"kernel": sd["channelwise.2.weight"].T, "bias": sd["channelwise.2.bias"]},
    }
    x = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
    want = JaxVQResBlock(16, 64).apply({"params": p}, jnp.asarray(x))
    np.testing.assert_allclose(blk(torch.from_numpy(x)).detach().numpy(), np.asarray(want), **TOL)


def test_state_dict_from_jax_equals_export_vqgan(codec):
    """Key for key and value for value export_vqgan's, plus the BatchNorm
    counter torch's state dict carries; loads with strict=True."""
    _, _, jvars = codec
    want = export_vqgan(jvars, JaxVQConfig.tiny())
    got = vqgan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars), VQConfig.tiny())
    extra = set(got) - set(want)
    assert len(extra) == 1 and next(iter(extra)).endswith("num_batches_tracked")
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    VQModel(VQConfig.tiny()).load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in got.items()}, strict=True)


def images(b: int = 2, hw: int = 32, seed: int = 20) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b, hw, hw, 3)).astype(np.float32)


def test_encoder_matches_jax(codec):
    vq, jvq, jvars = codec
    x = images()
    want = np.asarray(jvq.apply(jvars, jnp.asarray(x), method=JaxVQModel.encoder))
    got = vq.encoder(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 8, 8, 4)
    assert np.abs(want.mean(axis=(0, 1, 2))).max() > 0.1, "BatchNorm statistics should shift the latents"
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encode_matches_jax(codec):
    """All four outputs: qe / s, z / s, indices (up to near-ties) and loss."""
    vq, jvq, jvars = codec
    x = images(seed=21)
    want = jvq.apply(jvars, jnp.asarray(x), method=JaxVQModel.encode)
    got = vq.encode(torch.from_numpy(x))
    z = got[1].numpy() * VQConfig.tiny().scale_factor
    cb = vq.vquantizer.codebook.weight.detach().numpy()
    n_bad = assert_near_ties_only(got[2].numpy(), np.asarray(want[2]), z, cb)
    assert n_bad <= 1 and got[2].dtype == torch.int32
    ok = got[2].numpy() == np.asarray(want[2])
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok], **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[3].item(), float(want[3]), **TOL)


def test_decode_matches_jax(codec):
    """decode multiplies the (scaled) latents by scale_factor; decode_indices does not."""
    vq, jvq, jvars = codec
    z = np.random.default_rng(22).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jvq.apply(jvars, jnp.asarray(z), method=JaxVQModel.decode))
    got = vq.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encoder_init_follows_jax():
    """The encoder gets the JAX package's init, not torch's defaults: the
    stride-2 conv's bias bound is 1/sqrt(c_in * 16), BatchNorm is (1, 0)
    with running statistics (0, 1), and the codebook is U(+-1/K)."""
    cfg = VQConfig.tiny()
    vq = VQModel(cfg)
    vq.reset_parameters(torch.Generator().manual_seed(0))
    conv = vq.down_blocks[1]
    bound = 1.0 / (conv.in_channels * 16) ** 0.5
    assert 0.5 * bound < conv.bias.abs().max() <= bound
    norm = vq.down_blocks[-1][1]
    assert torch.equal(norm.weight, torch.ones(4)) and torch.equal(norm.running_var, torch.ones(4))
    assert not norm.bias.any() and not norm.running_mean.any()
    assert vq.vquantizer.codebook.weight.abs().max() <= 1.0 / cfg.codebook_size
    assert not vq.down_blocks[0].gammas.any()


@pytest.mark.parametrize("caller_tf32", [False, True])
def test_f32_forwards_pin_ieee_and_leave_the_flags(codec, monkeypatch, caller_tf32):
    """Fault C5: the float32 encoder, decoder and Inception featurizer run
    every convolution and product with cuDNN's and cuBLAS's TF32 off and
    cuDNN's deterministic algorithms, whatever the caller set, and the
    caller's flags are as they were after each call. (On the CPU the flags change nothing; on the card
    tests/test_torch_cuda.py::test_f32_decode_ignores_the_callers_tf32 holds
    the decode bit-equal under both settings.)"""
    from paella_tpu_torch.eval import convert_inception, inception_features
    from tests.test_inception import synth_inception_state_dict

    F = torch.nn.functional
    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.deterministic))
            return fn(*args, **kwargs)
        return wrapped

    for name in ("conv2d", "conv_transpose2d", "linear"):
        monkeypatch.setattr(F, name, spy(getattr(F, name)))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = caller_tf32
    torch.backends.cudnn.deterministic = False
    try:
        vq, _, _ = codec
        extract = inception_features(convert_inception(synth_inception_state_dict()))
        for call in (lambda: vq.encode(torch.from_numpy(images(b=1))),
                     lambda: vq.decode_indices(torch.zeros(1, 4, 4, dtype=torch.int32)),
                     lambda: extract(torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0)))):
            seen.clear()
            call()
            assert seen and all(s == (False, False, True) for s in seen), seen
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.deterministic) == (caller_tf32, caller_tf32, False)
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags

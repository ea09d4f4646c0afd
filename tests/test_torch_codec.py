"""The port's codec decoder against the JAX package's VQModel at
VQConfig.tiny() in f32 on the CPU, with non-zero gammas (the blocks are the
identity at init), and the numpy codec converter against export_vqgan."""
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

TOL = dict(rtol=1e-4, atol=1e-4)


def make_codec(seed: int = 0):
    """(port codec, JAX codec, JAX variables) with the same perturbed weights."""
    vq = VQModel(VQConfig.tiny())
    vq.reset_parameters(torch.Generator().manual_seed(seed))
    sd = perturbed_state_dict(vq, seed + 1, scale=0.1)
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


def test_encode_is_not_ported_yet(codec):
    with pytest.raises(NotImplementedError, match="A4"):
        codec[0].encode(torch.zeros(1, 32, 32, 3))

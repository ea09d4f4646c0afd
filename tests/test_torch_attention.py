"""K5's plain version (paella_tpu_torch/kernels/attention.py::attention_plain)
against the JAX package's Pallas kernel (`fused_attention`) in interpret mode,
on the CPU: the same numpy inputs go through both.

Shapes: B 2, H 4, head dims 16 and 80, 24 queries and 37 keys (no multiple of
any tile of either kernel), with and without a key mask. f32 within 1e-5 (the
same f32 arithmetic, summed in another order). bf16 within 2^-7 of the
largest output: both round p to bf16 and the output to bf16, and a p that
the two frameworks compute an ulp apart in f32 may round to neighbouring
bf16 values, which moves an output by up to about one bf16 ulp.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paella_tpu.kernels.attention import fused_attention as jax_fused_attention
from paella_tpu.nn.attention import dot_product_attention as jax_dot_product_attention
from paella_tpu_torch.kernels.attention import attention_plain, fused_attention
from paella_tpu_torch.nn.attention import dot_product_attention

B, N, S, H = 2, 24, 37, 4


def inputs(d: int, with_mask: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, length, H, d)).astype(np.float32) for length in (N, S, S))
    mask = None
    if with_mask:
        mask = rng.uniform(size=(B, S)) < 0.6
        mask[:, 0] = True
    return q, k, v, mask


def to_dtype(a: np.ndarray, dtype: str):
    """The same values in both frameworks: numpy bf16 (ml_dtypes) bits."""
    if dtype == "float32":
        return jnp.asarray(a), torch.from_numpy(a)
    b = a.astype(ml_dtypes.bfloat16)
    return jnp.asarray(b), torch.from_numpy(b.view(np.uint16).astype(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_jax_kernel(dtype, d, with_mask):
    q, k, v, mask = inputs(d, with_mask)
    (jq, tq), (jk, tk), (jv, tv) = (to_dtype(a, dtype) for a in (q, k, v))
    want = jax_fused_attention(jq, jk, jv, kv_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    got = attention_plain(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    assert str(got.dtype) == f"torch.{dtype}" and got.shape == (B, N, H, d)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2**-7 * np.abs(want).max()


def test_masked_key_acts_like_absent_key():
    """A masked key gets -1e9, so it carries weight exactly 0."""
    q, k, v, _ = inputs(16, False, seed=1)
    t = torch.from_numpy
    mask = np.ones((B, S), bool)
    mask[:, 20:] = False
    masked = attention_plain(t(q), t(k), t(v), t(mask))
    absent = attention_plain(t(q), t(k[:, :20]), t(v[:, :20]))
    torch.testing.assert_close(masked, absent, rtol=0, atol=1e-6)


def test_reweight_goes_to_dot_product_attention():
    """In both packages a call with `reweight` is dot_product_attention's,
    decided from the arguments: the port's plain version is not run."""
    q, k, v, mask = inputs(16, True, seed=2)
    rew = np.random.default_rng(3).uniform(0.5, 2.0, (B, 1, 1, S)).astype(np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_fused = jax_fused_attention(*jargs, kv_mask=jnp.asarray(mask), reweight=jnp.asarray(rew), interpret=True)
    j_plain = jax_dot_product_attention(*jargs, kv_mask=jnp.asarray(mask), reweight=jnp.asarray(rew))
    np.testing.assert_array_equal(np.asarray(j_fused), np.asarray(j_plain))

    t = torch.from_numpy
    attention_plain.launches = 0
    got = fused_attention(t(q), t(k), t(v), t(mask), reweight=t(rew))
    assert attention_plain.launches == 0
    torch.testing.assert_close(got, dot_product_attention(t(q), t(k), t(v), kv_mask=t(mask), reweight=t(rew)), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_plain), rtol=1e-5, atol=1e-5)
    assert fused_attention(t(q), t(k), t(v), t(mask)).shape == got.shape
    assert attention_plain.launches == 1  # without reweight, the kernel's route


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU, non-CUDA tensor or a head dim the kernel cannot tile never
    falls back to the plain version: the wrapper raises."""
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_attention(q, q, q)

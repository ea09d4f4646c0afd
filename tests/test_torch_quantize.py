"""The port's codebook lookup (kernels/quantize.py), vector quantizer
(codec/quantize.py) and latent interpolation against the JAX package's, on
the CPU.

The plain lookup forms norms and dots as sequential f32 sums; the JAX XLA
lookup takes a dot that may sum in another order, and the JAX Pallas kernel
(run here in interpret mode) pads the width to 128 lanes. Their distances
can therefore differ in the last bit, which changes an index only where two
codes are within that rounding of each other: a near-tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.codec.quantize import VectorQuantize as JaxVectorQuantize
from paella_tpu.codec.quantize import codebook_lookup
from paella_tpu.kernels.quantize import fused_codebook_lookup as jax_fused_lookup
from paella_tpu.sampling.sampler import interpolate_latents as jax_interpolate_latents
from paella_tpu_torch.codec import VectorQuantize
from paella_tpu_torch.kernels import quantize as kquant
from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
from paella_tpu_torch.sampling import interpolate_latents


def assert_near_ties_only(got, want, z, codebook, rel: float = 1e-6) -> int:
    """Indices equal, or else each mismatch a near-tie: the two codes'
    distances |e|^2 - 2 z.e (in float64) within rel * max(1, |d|). Returns
    the number of mismatches."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    bad = np.flatnonzero(got != want)
    if bad.size:
        zz = np.asarray(z, np.float64).reshape(-1, np.shape(codebook)[-1])[bad]
        cb = np.asarray(codebook, np.float64)

        def dist(idx):
            e = cb[idx]
            return (e * e).sum(-1) - 2 * (zz * e).sum(-1)

        d_got, d_want = dist(got[bad]), dist(want[bad])
        assert np.all(np.abs(d_got - d_want) <= rel * np.maximum(1.0, np.abs(d_want))), (
            f"{bad.size} mismatches, not all near-ties"
        )
    return int(bad.size)


def lookup_inputs(lead, k, c, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(lead + (c,)).astype(np.float32), rng.standard_normal((k, c)).astype(np.float32)


@pytest.mark.parametrize("lead,k,c", [((100,), 64, 4), ((1000,), 300, 4), ((2, 8, 8), 128, 4)])
def test_lookup_matches_jax_and_pallas_kernel(lead, k, c):
    z, cb = lookup_inputs(lead, k, c, seed=k)
    got = codebook_lookup_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    assert got.dtype == np.int32 and got.shape == lead
    np.testing.assert_array_equal(got, np.asarray(codebook_lookup(jnp.asarray(z), jnp.asarray(cb))))
    fused = jax_fused_lookup(jnp.asarray(z), jnp.asarray(cb), tile_m=64, tile_k=128, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(fused))


@pytest.mark.parametrize("codebook_init", ["uniform", "normal"])
def test_lookup_at_flagship_size_differs_only_at_near_ties(codebook_init):
    """4096 tokens against 8192 codes of width 4: the codec's encode at
    256x256. The init codebook U(+-1/8192) and an N(0, 1) one."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4096, 4)).astype(np.float32)
    if codebook_init == "uniform":
        cb = rng.uniform(-1 / 8192, 1 / 8192, (8192, 4)).astype(np.float32)
    else:
        cb = rng.standard_normal((8192, 4)).astype(np.float32)
    got = codebook_lookup_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    want = np.asarray(codebook_lookup(jnp.asarray(z), jnp.asarray(cb)))
    n = assert_near_ties_only(got, want, z, cb)
    print(f"{codebook_init} codebook: {n} near-tie mismatches of 4096")
    assert len(np.unique(got)) > 100


def test_vector_quantize_matches_jax():
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((128, 4)).astype(np.float32)
    z = (rng.standard_normal((2, 8, 8, 4)) * 1.5).astype(np.float32)
    want_q, (want_vq, want_commit), want_idx = JaxVectorQuantize(4, 128).apply(
        {"params": {"codebook": jnp.asarray(cb)}}, jnp.asarray(z), method=JaxVectorQuantize.quantize
    )
    vq = VectorQuantize(4, 128)
    vq.codebook.weight.data.copy_(torch.from_numpy(cb))
    got_q, (got_vq, got_commit), got_idx = vq.quantize(torch.from_numpy(z))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_vq.item(), float(want_vq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_commit.item(), float(want_commit), rtol=0, atol=1e-6)
    torch.testing.assert_close(vq.idx2vq(got_idx), torch.from_numpy(cb)[got_idx.long()])


def test_interpolate_latents_matches_jax():
    """The blends are bit-equal in both packages; the re-quantization agrees
    up to near-ties (this seed has one: two codes 4e-8 apart at |d| 2.2)."""
    rng = np.random.default_rng(4)
    cb = rng.standard_normal((128, 4)).astype(np.float32)
    ia, ib = (rng.integers(0, 128, (8, 8)).astype(np.int32) for _ in range(2))
    alphas = np.linspace(0, 1, 5, dtype=np.float32)
    want = np.asarray(jax_interpolate_latents(jnp.asarray(ia), jnp.asarray(ib), jnp.asarray(cb), jnp.asarray(alphas)))
    got = interpolate_latents(torch.from_numpy(ia), torch.from_numpy(ib), torch.from_numpy(cb), torch.from_numpy(alphas))
    assert got.dtype == torch.int32 and got.shape == (5, 8, 8)
    a = alphas[:, None, None, None]
    blends = cb[ia][None] * (1 - a) + cb[ib][None] * a
    assert assert_near_ties_only(got.numpy(), want, blends, cb) <= 1
    np.testing.assert_array_equal(got[0].numpy(), ia)
    np.testing.assert_array_equal(got[-1].numpy(), ib)


def test_cpu_wrapper_counts_the_plain_version_only():
    z, cb = lookup_inputs((16,), 32, 4, seed=6)
    k0, p0 = kquant.fused_codebook_lookup.launches, kquant.codebook_lookup_plain.launches
    fused_codebook_lookup(torch.from_numpy(z), torch.from_numpy(cb))
    assert (kquant.fused_codebook_lookup.launches, kquant.codebook_lookup_plain.launches) == (k0, p0 + 1)
    with pytest.raises(ValueError, match="no kernel"):
        fused_codebook_lookup(torch.from_numpy(z).to("meta"), torch.from_numpy(cb).to("meta"))

"""The port's fused ResBlock(+FiLM) (kernels/resblock.py) against the JAX
package's Pallas kernel, run as its own tests run it on the CPU
(interpret=True), at c=128 in f32. On the CPU the wrapper takes the plain
version; the CUDA kernel itself is compared with it on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.kernels.resblock import fused_resblock as jax_fused_resblock
from paella_tpu_torch.kernels import resblock as kres
from paella_tpu_torch.kernels.resblock import fused_resblock, prepare_resblock_weights
from paella_tpu_torch.nn.blocks import ResBlock

TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX kernel tests' own tolerance


def make_inputs(seed: int, b: int = 2, hw: int = 8, c: int = 128, cpg: int = 1):
    """JAX-layout inputs from numpy, as tests/test_resblock_kernel.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    c4 = 4 * c
    return dict(
        x=n(b, hw, hw, c, std=0.5),
        dw_k=n(3, 3, cpg, c, std=0.1),
        dw_b=n(c, std=0.1),
        w1=n(c, c4, std=c**-0.5),
        b1=n(c4, std=0.1),
        gamma=n(c4, std=0.1),
        beta=n(c4, std=0.1),
        w2=n(c4, c, std=c4**-0.5),
        b2=n(c, std=0.1),
        film=n(b, 2 * c, std=0.2),
        skip=n(b, hw, hw, c, std=0.5),
    )


def port_weights(a: dict, dtype=torch.float32):
    """The same weights in the torch layouts, through the port's derivation."""
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    return prepare_resblock_weights(
        t(a["dw_k"].transpose(3, 2, 0, 1)), t(a["dw_b"]), t(a["w1"].T), t(a["b1"]),
        t(a["gamma"]), t(a["beta"]), t(a["w2"].T), t(a["b2"]), dtype,
    )


def run_both(a: dict, with_film: bool, with_skip: bool, **jax_kw):
    film = a["film"] if with_film else None
    skip = a["skip"] if with_skip else None
    want = jax_fused_resblock(
        jnp.asarray(a["x"]), a["dw_k"], a["dw_b"], a["w1"], a["b1"], a["gamma"], a["beta"],
        a["w2"], a["b2"], film_ab=film, skip=None if skip is None else jnp.asarray(skip),
        interpret=True, **jax_kw,
    )
    got = fused_resblock(
        torch.from_numpy(a["x"]), port_weights(a),
        film=None if film is None else torch.from_numpy(film),
        skip=None if skip is None else torch.from_numpy(skip),
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("with_film", [False, True])
def test_matches_pallas_kernel(with_film):
    got, want = run_both(make_inputs(0), with_film, False, tile_n1=128, tile_n2=64)
    np.testing.assert_allclose(got, want, **TOL)


def test_skip_concat_matches_pallas_kernel():
    """The skip-concat variant: groups read concat channels (2g, 2g+1)."""
    got, want = run_both(make_inputs(3, cpg=2), True, True, tile_n1=128, tile_n2=64)
    np.testing.assert_allclose(got, want, **TOL)


def test_single_tile_matches_pallas_kernel():
    """One tile per phase (b=1, 4x4) in the JAX kernel."""
    got, want = run_both(make_inputs(1, b=1, hw=4), True, False, tile_n1=512, tile_n2=128)
    np.testing.assert_allclose(got, want, **TOL)


def test_resblock_module_uses_kernel_weights_and_counts_plain():
    """The ResBlock module derives its kernel weights once, from parameters
    in the reference layout; on a CPU tensor only the plain version runs."""
    a = make_inputs(2, cpg=2)
    blk = ResBlock(128, c_skip=128)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    blk.load_state_dict({
        "depthwise.weight": t(a["dw_k"].transpose(3, 2, 0, 1)), "depthwise.bias": t(a["dw_b"]),
        "channelwise.0.weight": t(a["w1"].T), "channelwise.0.bias": t(a["b1"]),
        "channelwise.2.gamma": t(a["gamma"].reshape(1, 1, 1, -1)),
        "channelwise.2.beta": t(a["beta"].reshape(1, 1, 1, -1)),
        "channelwise.4.weight": t(a["w2"].T), "channelwise.4.bias": t(a["b2"]),
    })
    k0, p0 = kres.fused_resblock.launches, kres.resblock_plain.launches
    got = blk(t(a["x"]), t(a["film"]), t(a["skip"]))
    assert blk.kernel_weights() is blk.kernel_weights()
    assert (kres.fused_resblock.launches, kres.resblock_plain.launches) == (k0, p0 + 1)
    _, want = run_both(a, True, True, tile_n1=128, tile_n2=64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fc2_split_policy():
    """The fc2 phase's K splits at the flagship's shapes on an H100 (132 SMs):
    none where the grid already fills the card, more as M shrinks."""
    assert [kres.fc2_splits(m, c, 132) for m, c in ((2048, 640), (512, 1280), (128, 1280))] == [1, 2, 8]
    assert kres.fc2_splits(64, 64, 132) == 2  # K = 256: 8 tiles, at least 4 per split


def test_grn_slots():
    """How many batch items one 64-row M-tile of fc1 touches, the slots per
    tile of the kernel's GRN partials: one at the flagship's shapes (tiles
    never straddle two images), more where hw is not a multiple of 64."""
    assert [kres.grn_slots(2, hw) for hw in (1024, 256, 64)] == [1, 1, 1]
    assert [kres.grn_slots(*a) for a in ((1, 35), (3, 35), (2, 16), (16, 4))] == [1, 2, 2, 16]


def test_wrapper_refuses_devices_without_a_kernel():
    a = make_inputs(0, b=1, hw=4)
    with pytest.raises(ValueError, match="no kernel"):
        fused_resblock(torch.from_numpy(a["x"]).to("meta"), port_weights(a))

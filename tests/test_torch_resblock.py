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


def test_wgmma_tile_policy():
    """The bf16 float mode's wgmma tiling at the flagship's shapes on an H100
    (132 SMs), from one CFG pair's M: fc1 128 wide where that fills the
    card (64 at M 128); fc2 128 wide only at M 2048, split in 4 only at M
    128, each split whole 64-deep K steps; narrow widths take 64-wide tiles."""
    flagship = [kres.wgmma_tiles(m, c, 132) for m, c in ((2048, 640), (512, 1280), (128, 1280))]
    assert flagship == [(128, 128, 1), (128, 64, 1), (64, 64, 4)]
    assert kres.wgmma_tiles(128, 128, 132) == (64, 64, 2)  # K = 512: 8 steps, at least 4 a split
    assert kres.wgmma_tiles(70, 64, 132) == (64, 64, 1)
    for m, c in ((2048, 640), (512, 1280), (128, 1280), (128, 128), (70, 64)):
        bn1, bn2, s = kres.wgmma_tiles(m, c, 132)
        assert (4 * c) % bn1 == 0 and c % bn2 == 0 and (4 * c // s) % 64 == 0
        assert (bn1, bn2, s) == (kres.gemm_tiles(m, 4 * c, c, 132)[0], *kres.gemm_tiles(m, c, 4 * c, 132))


def test_grn_slots_of_128_row_tiles():
    """A 128-row fc1 tile spans two images at hw 64 (the flagship's level 2),
    so its GRN partials need two slots there; one at hw 1024 and 256."""
    assert [kres.grn_slots(2, hw, 128) for hw in (1024, 256, 64)] == [1, 1, 2]
    assert [kres.grn_slots(8, hw, 128) for hw in (1024, 256, 64)] == [1, 1, 2]
    assert [kres.grn_slots(*a) for a in ((3, 60, 128), (4, 32, 128), (1, 35, 128))] == [3, 4, 1]


@pytest.mark.parametrize("mode,dtype", [("float", torch.bfloat16), ("float", torch.float32), ("int8", torch.bfloat16),
                                        ("w8a8", torch.bfloat16)])
def test_launch_plan_does_not_depend_on_batch(mode, dtype):
    """Tile rows, tile widths and fc2 splits at the flagship's shapes are the
    same at batch 2 and 8 (an image's bits must not depend on its
    batchmates); 128-row tiles only in the bf16 float mode."""
    for hw, c in ((1024, 640), (256, 1280), (64, 1280)):
        two, eight = (kres.launch_plan(b, hw, c, mode, dtype, 132) for b in (2, 8))
        assert two[:4] == eight[:4] and two.slots == eight.slots
        assert two.bm == (128 if dtype == torch.bfloat16 or mode == "w8a8" else 64)


@pytest.mark.parametrize("mode,dtype", [("float", torch.bfloat16), ("float", torch.float32), ("int8", torch.bfloat16)])
@pytest.mark.parametrize("hw", [64, 96, 144, 256])
def test_grn_partition_does_not_depend_on_batch_position(mode, dtype, hw):
    """An image's GRN sums are cut into the same image-relative rows wherever
    it sits in the batch: request 0's uncond image at index B of the
    sampler's batch [cond_0..cond_B-1 ; uncond_0..uncond_B-1] at B = 1, 2 and
    4, and the cond image 0. What the kernel receives, `launch_plan`'s tile
    rows bm and tiles per image, is the same at every B; hw 96 and 144
    (level 2 of 256x384 and 384x384 canvases) take ceil(hw / bm) tiles per
    image, where absolute tiles would cut the image differently at each B.
    Inside a tile fc1 sums 32-row segments, which start on image rows that
    are multiples of 32 wherever a tile holds several images."""

    def cuts(plan, image):  # image-relative rows where fc1's M-tiles cut it (csrc/resblock.cu::tile_rows)
        if plan.tiles_per_image:
            return [t * plan.bm for t in range(1, plan.tiles_per_image)]
        return [m - image * hw for m in range(0, (image + 1) * hw, plan.bm) if m > image * hw]

    plans = [kres.launch_plan(2 * b, hw, 128, mode, dtype, 132) for b in (1, 2, 4)]
    assert len({p._replace(slots=0) for p in plans}) == 1
    plan = plans[0]
    bm = 128 if dtype == torch.bfloat16 or mode == "w8a8" else 64
    assert (plan.bm, plan.tiles_per_image) == (bm, {96: -(-96 // bm), 144: -(-144 // bm)}.get(hw, 0))
    for b, p in zip((1, 2, 4), plans):
        assert cuts(p, b) == cuts(plans[0], 1) and cuts(p, 0) == cuts(plans[0], 0)
    if plan.tiles_per_image:
        assert (plan.tiles_per_image - 1) * bm < hw  # no tile past the image's rows
        absolute = plan._replace(tiles_per_image=0)
        assert cuts(absolute, 1) != cuts(absolute, 2)
    else:
        assert hw % bm == 0 or (bm % hw == 0 and hw % 32 == 0)


def test_narrow_widths_plan():
    """C % 8 widths (PaellaConfig.tiny()'s 32): no fc2 split where 4C is not
    a whole number of 64-deep steps, and fc2's grid counts a ragged column
    tile."""
    assert kres.wgmma_tiles(2 * 256, 32, 132)[2] == 1
    assert kres.wgmma_tiles(2 * 64, 40, 132)[2] == 1  # 4C = 160: 2.5 steps
    assert kres.fc2_splits(128, 96, 132) >= 1
    for c in (32, 40, 96):
        bn1, bn2, s = kres.wgmma_tiles(128, c, 132)
        assert s == 1 or (4 * c // s) % 64 == 0


def test_xla_route_differs_from_kernel_by_a_bounded_gap():
    """Where JAX's VMEM gate refuses the fused kernel, JAX runs its XLA
    ResBlock + TimestepBlock modules and the port runs K1: a difference by
    design (ROADMAP §C). fuse_mode refuses the level-0 up-path skip block of
    a 256x384 canvas (hw 1536, C 640, bf16) and every level-0 block at
    384x384 (hw 2304), while the port plans a K1 launch for each. At a small
    bf16 shape the two routes, on the same weights, differ (they round at
    other points) by at most 3% of the largest output."""
    from paella_tpu.kernels.resblock import fuse_mode
    from paella_tpu.nn.blocks import ResBlock as JaxResBlock
    from paella_tpu.nn.blocks import TimestepBlock as JaxTimestepBlock

    for shape, skip in (((2, 32, 48, 640), True), ((2, 48, 48, 640), False), ((2, 48, 48, 640), True)):
        assert fuse_mode(shape, jnp.bfloat16, 640, 3, with_skip=skip) is None
        b, hh, ww, c = shape
        assert kres.launch_plan(b, hh * ww, c, "float", torch.bfloat16, 132).bn1 in (64, 128)
    assert fuse_mode((2, 32, 32, 640), jnp.bfloat16, 640, 3, with_skip=True) == "batch"  # the 256^2 flagship fuses

    a = make_inputs(5, hw=8, c=128)
    c, c_r = 128, 16
    rng = np.random.default_rng(6)
    r_embed = rng.standard_normal((2, c_r)).astype(np.float32)
    wm, bm = (rng.standard_normal((c_r, 2 * c)) * 0.1).astype(np.float32), (rng.standard_normal(2 * c) * 0.1).astype(np.float32)
    params = {
        "depthwise": {"kernel": a["dw_k"], "bias": a["dw_b"]},
        "channelwise": {"fc1": {"kernel": a["w1"], "bias": a["b1"]}, "grn": {"gamma": a["gamma"], "beta": a["beta"]},
                        "fc2": {"kernel": a["w2"], "bias": a["b2"]}},
    }
    x = jnp.asarray(a["x"]).astype(jnp.bfloat16)
    h = JaxResBlock(c, dtype=jnp.bfloat16).apply({"params": params}, x)
    want = JaxTimestepBlock(c, c_r, dtype=jnp.bfloat16).apply({"params": {"mapper": {"kernel": wm, "bias": bm}}},
                                                             h, jnp.asarray(r_embed))
    want = np.asarray(want.astype(jnp.float32))
    t = torch.from_numpy
    film = torch.nn.functional.linear(t(r_embed).bfloat16(), t(wm.T.copy()).bfloat16(), t(bm).bfloat16())
    got = fused_resblock(t(a["x"]).bfloat16(), port_weights(a, torch.bfloat16), film=film).float().numpy()
    gap = np.abs(got - want).max()
    assert 0 < gap <= 0.03 * np.abs(want).max(), (gap, np.abs(want).max())


@pytest.mark.parametrize("mode,dtype,bk", [("int8", torch.bfloat16, 64), ("w8a8", torch.bfloat16, 128),
                                           ("w8a8", torch.float32, 128)])
def test_int8_modes_take_the_wgmma_plan(mode, dtype, bk):
    """K1b's plan on an H100 (132 SMs): 128-row fc1 tiles, the tile widths
    and fc2 splits of `gemm_tiles` over K steps of one 128-byte row (64 bf16
    values, or 128 s8 codes in W8A8), from one CFG pair's M whatever the
    batch; the flagship's three level shapes take the bf16 float mode's
    tilings, and hw 96 and 144 take one fc1 tile per image."""
    for b in (2, 4, 8):
        for hw, c in ((1024, 640), (256, 1280), (64, 1280), (96, 1280), (144, 640)):
            plan = kres.launch_plan(b, hw, c, mode, dtype, 132)
            bn1 = kres.gemm_tiles(2 * hw, 4 * c, c, 132, bk)[0]
            assert plan[:4] == (128, bn1, *kres.gemm_tiles(2 * hw, c, 4 * c, 132, bk)), (b, hw, c, plan)
            assert plan.tiles_per_image == {96: 1, 144: 2}.get(hw, 0)
            assert plan.splits == 1 or (4 * c // plan.splits) % bk == 0
    flagship = [kres.launch_plan(2, hw, c, mode, dtype, 132)[1:4] for hw, c in ((1024, 640), (256, 1280), (64, 1280))]
    assert flagship == [(128, 128, 1), (128, 64, 1), (64, 64, 4)]


def unpadded(w: kres.ResBlockWeights, c: int) -> kres.ResBlockWeights:
    return w._replace(w1=w.w1[:, :c].contiguous(), w2=w.w2[:, : 4 * c].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [36, 60, 15])
def test_padded_pitch_weights_give_the_plain_output(c, dtype):
    """Float weights at C % 8 != 0 take the kernel's padded pitch: W1
    (4C, round8(C)) and W2 (C, round8(4C)) with zero pad columns, the rest as
    derived before. The plain version on them gives, bit for bit, its output
    on the same weights at the true widths, with and without skip."""
    for cpg in (1, 2):
        a = make_inputs(40 + c, b=2, hw=5, c=c, cpg=cpg)
        w = port_weights(a, dtype)
        k1, k2 = kres.round8(c), kres.round8(4 * c)
        assert w.w1.shape == (4 * c, k1) and w.w2.shape == (c, k2)
        assert not w.w1[:, c:].any() and not w.w2[:, 4 * c:].any()
        assert torch.equal(w.w1[:, :c], torch.from_numpy(a["w1"].T.copy()).to(dtype))
        assert torch.equal(w.w2[:, : 4 * c], torch.from_numpy(a["w2"].T.copy()).to(dtype))
        x, film = torch.from_numpy(a["x"]).to(dtype), torch.from_numpy(a["film"]).to(dtype)
        skip = torch.from_numpy(a["skip"]).to(dtype) if cpg == 2 else None
        got = fused_resblock(x, w, film=film, skip=skip)
        assert torch.equal(got, kres.resblock_plain(x, unpadded(w, c), film=film, skip=skip))

"""The port's int8 inference path (paella_tpu_torch/quant.py, kernel K1b's
plain version, the quantized denoiser) against the JAX package's, on the CPU
in f32: the same numpy weights and inputs through both.

Tolerances:
- int8 codes and scales: exact (the same f32 division and round half to even).
- w8a8_dot: rtol 1e-6 (the s32 sums are exact; one f32 rescale).
- K1b weight-only: 1e-5 (tests/test_torch_resblock.py's f32 arithmetic in
  another order). W8A8: at least 99.9% of elements within 1e-5 and the rest
  within one quantization step of the output, sh2_max * s2_max * 127: an h
  code can flip at a rounding tie when the f32 sums before it differ in
  their last ulp (the JAX kernel's erf is an A&S approximation, the port's
  is exact).
- The model, weight-only: 5e-4 (the float model's,
  tests/test_torch_attn_block.py).
- The model, W8A8: every ResBlock call along the port's forward against the
  JAX kernel on the same inputs and weights, at K1b's W8A8 tolerance above,
  and the logits within a relative L2 distance of 3e-2 of JAX's with at
  least 95% of their argmaxes equal. W8A8 requantizes every row of every
  block from its own max, so the whole forward is discontinuous: a change
  of 1e-7 in the noise level alone moves the port's logits by ~2e-2
  (relative L2), as far as the JAX forward lies from it, and the W8A8
  rounding itself moves them by ~2.4e-2 from the weight-only forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paella_tpu import quant as jquant
from paella_tpu.kernels import resblock as jres
from paella_tpu.config import PaellaConfig as JaxPaellaConfig
from paella_tpu.kernels.resblock import fused_resblock as jax_fused_resblock
from paella_tpu.models import Paella as JaxPaella
from paella_tpu_torch import quant
from paella_tpu_torch.config import PaellaConfig
from paella_tpu_torch.convert import paella_state_dict_from_jax
from paella_tpu_torch.kernels import resblock as kres
from paella_tpu_torch.kernels.resblock import prepare_resblock_weights, resblock_plain
from paella_tpu_torch.models import Paella
from paella_tpu_torch.nn.blocks import ResBlock
from tests.test_torch_denoiser import make_paella
from tests.test_torch_resblock import make_inputs

# tests/test_quant.py's quantized-model config
QCFG = dataclasses.replace(
    PaellaConfig.tiny(), c_hidden=(128, 128), nhead=(-1, 4), blocks=(2, 3),
    level_config=("CT", "CTA"), dropout=(0.0, 0.0),
)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_quantize_dense_int8_equals_jax():
    """Codes and scales bit for bit, ties at x.5 included, and a zero column
    (scale floor 1e-8 / 127)."""
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((96, 40)) * 0.1).astype(np.float32)  # JAX (in, out)
    k[:, 3] = 0.0
    k[:4, 5] = [127.0, 0.5, 1.5, -2.5]  # scale 1: exact ties round half to even
    jq, js = jquant.quantize_dense_int8(jnp.asarray(k))
    q, s = quant.quantize_dense_int8(t(k.T))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_dense_int8(q, s).numpy(), np.asarray(jquant.dequantize_dense_int8(jq, js)).T
    )


def test_w8a8_dot_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    k = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    jq, js = jquant.quantize_dense_int8(jnp.asarray(k))
    want = np.asarray(jquant.w8a8_dot(jnp.asarray(x), jq, js, jnp.float32))
    got = quant.w8a8_dot(t(x), t(np.asarray(jq).T), t(js), torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def k1b_both(a: dict, act_quant: bool, with_skip: bool):
    """The JAX kernel in interpret mode and the port's plain version on the
    same int8 codes (quantized by each package's quantize_dense_int8)."""
    q1, s1 = jquant.quantize_dense_int8(jnp.asarray(a["w1"]))
    q2, s2 = jquant.quantize_dense_int8(jnp.asarray(a["w2"]))
    beta_w2 = (jnp.asarray(a["beta"]) @ q2.astype(jnp.float32)) * s2 if act_quant else None
    skip = a["skip"] if with_skip else None
    want = jax_fused_resblock(
        jnp.asarray(a["x"]), a["dw_k"], a["dw_b"], q1, a["b1"], a["gamma"], a["beta"], q2, a["b2"],
        film_ab=a["film"], fc1_scale=s1, fc2_scale=s2, act_quant=act_quant, beta_w2=beta_w2,
        tile_n1=128, tile_n2=64, skip=None if skip is None else jnp.asarray(skip), interpret=True,
    )
    tq1, ts1 = quant.quantize_dense_int8(t(a["w1"].T))
    tq2, ts2 = quant.quantize_dense_int8(t(a["w2"].T))
    w = prepare_resblock_weights(
        t(a["dw_k"].transpose(3, 2, 0, 1)), t(a["dw_b"]), tq1, t(a["b1"]), t(a["gamma"]), t(a["beta"]),
        tq2, t(a["b2"]), torch.float32, fc1_scale=ts1, fc2_scale=ts2, act_quant=act_quant,
    )
    got = kres.fused_resblock(t(a["x"]), w, film=t(a["film"]), skip=None if skip is None else t(skip), tile_n1=128)
    return got.numpy(), np.asarray(want), w


@pytest.mark.parametrize("with_skip", [False, True])
def test_k1b_weight_only_matches_pallas_kernel(with_skip):
    got, want, _ = k1b_both(make_inputs(10 + with_skip, cpg=2 if with_skip else 1), False, with_skip)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_skip", [False, True])
def test_k1b_w8a8_matches_pallas_kernel(with_skip, monkeypatch):
    scales = []  # quantize_rows' scales, call by call; the last call gives sh2
    quantize_rows = kres.quantize_rows
    monkeypatch.setattr(kres, "quantize_rows", lambda v: scales.append(quantize_rows(v)[1]) or quantize_rows(v))
    got, want, w = k1b_both(make_inputs(12 + with_skip, cpg=2 if with_skip else 1), True, with_skip)
    err = np.abs(got - want)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    # one h code more or less moves an output by at most sh2 * s2 * 127
    step = float(scales[-1].max() * w.s2.max()) * 127
    assert err.max() <= step, (err.max(), step)


def test_k1b_modes_and_refusals():
    """The weights carry their mode and their beta@W2; the one wrapper takes
    every mode (on a CPU tensor, the plain version) and refuses a device it
    has no kernel for, and W8A8 needs int8 weights with scales."""
    a = make_inputs(14, b=1, hw=4)
    q1, s1 = quant.quantize_dense_int8(t(a["w1"].T))
    q2, s2 = quant.quantize_dense_int8(t(a["w2"].T))
    args = (t(a["dw_k"].transpose(3, 2, 0, 1)), t(a["dw_b"]), q1, t(a["b1"]), t(a["gamma"]), t(a["beta"]), q2, t(a["b2"]))
    wo = prepare_resblock_weights(*args, torch.float32, fc1_scale=s1, fc2_scale=s2)
    aq = prepare_resblock_weights(*args, torch.bfloat16, fc1_scale=s1, fc2_scale=s2, act_quant=True)
    assert (wo.mode, aq.mode, wo.w1.dtype, aq.b1.dtype) == ("int8", "w8a8", torch.int8, torch.bfloat16)
    # weight-only beta@W2 before the scale (dtype-rounded beta); W8A8 after it (f32 beta)
    beta = t(a["beta"])
    torch.testing.assert_close(wo.bw2, q2.float() @ beta, rtol=0, atol=0)
    torch.testing.assert_close(aq.bw2, (q2.float() @ beta) * s2, rtol=0, atol=0)
    x = t(a["x"])
    k0, by_mode, p0 = kres.fused_resblock.launches, dict(kres.fused_resblock.launches_by_mode), kres.resblock_plain.launches
    assert kres.fused_resblock(x, wo).shape == x.shape
    assert (kres.fused_resblock.launches, kres.fused_resblock.launches_by_mode) == (k0, by_mode)
    assert kres.resblock_plain.launches == p0 + 1
    with pytest.raises(ValueError, match="no kernel"):
        kres.fused_resblock(x.to("meta"), wo)
    with pytest.raises(ValueError, match="act_quant"):
        prepare_resblock_weights(*args[:2], t(a["w1"].T), *args[3:6], t(a["w2"].T), args[7], torch.float32, act_quant=True)
    # the TPU kernel holds at most 16 h-code groups a row (n_t1 <= 16): 4C 512 in groups of 16 is 32
    with pytest.raises(ValueError, match="16 groups"):
        kres.fused_resblock(x.bfloat16(), aq, tile_n1=16)


def test_fc2_splits_cover_whole_k_tiles():
    """Each fc2 split of the kernel covers a whole number of its K steps: 32
    deep on the FMA tiles (f32 activations), and on the wgmma path one
    128-byte row, 64 bf16 values or 128 s8 codes in W8A8, also at widths 128
    x odd at small H*W (C 640 at 8x8: 4 W8A8 splits of 640 codes, not 8 of
    320)."""
    for c in (64, 128, 384, 640, 1280, 1920):
        for hw in (1, 16, 64, 256, 1024, 4096):
            s = kres.fc2_splits(2 * hw, c, 132)
            assert (4 * c) % s == 0 and (4 * c // s) % 32 == 0, (c, hw, s)
            for mode, dtype, bk in (("int8", torch.bfloat16, 64), ("w8a8", torch.bfloat16, 128),
                                    ("w8a8", torch.float32, 128)):
                plan = kres.launch_plan(2, hw, c, mode, dtype, 132)
                assert (4 * c) % plan.splits == 0 and (4 * c // plan.splits) % bk == 0, (c, hw, mode, plan)
                assert plan.splits == 1 or 4 * c // plan.splits // bk >= 4
    assert kres.launch_plan(2, 64, 640, "w8a8", torch.bfloat16, 132).splits == 4
    assert kres.launch_plan(2, 64, 640, "int8", torch.bfloat16, 132).splits == 8


@pytest.fixture(scope="module")
def qmodels():
    """(port float model, JAX float params, JAX fused-blocks config) on the
    same perturbed weights at QCFG."""
    model, _, jparams = make_paella(QCFG, seed=30)
    jcfg = JaxPaellaConfig(**{**dataclasses.asdict(QCFG), "fused_blocks": True})
    return model, jax.tree_util.tree_map(np.asarray, jparams), jcfg


def quantized_pair(qmodels, levels, include_first, **flags):
    """The JAX-quantized tree and the port model loaded from its converted
    state dict (structure from the port's quantize_paella_int8)."""
    model, jparams, jcfg = qmodels
    jq = jax.tree_util.tree_map(np.asarray, jquant.quantize_paella_int8(jparams, levels=levels, include_first=include_first))
    cfg = dataclasses.replace(QCFG, **flags)
    port = quant.quantize_paella_int8(Paella(cfg), levels=levels, include_first=include_first)
    port.load_state_dict({k: t(v) for k, v in paella_state_dict_from_jax(jq, cfg).items()}, strict=True)
    return port, jq, dataclasses.replace(jcfg, **flags)


@pytest.mark.parametrize("include_first", [False, True])
@pytest.mark.parametrize("levels", [(1,), (0, 1)])
def test_quantized_state_dict_equals_jax(qmodels, levels, include_first):
    """The port's quantize_paella_int8 on the float model gives, key for key
    and bit for bit, the converted JAX-quantized tree, and the float model is
    left as it was."""
    model, jparams, _ = qmodels
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = quant.quantize_paella_int8(model, levels=levels, include_first=include_first).state_dict()
    want = paella_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jquant.quantize_paella_int8(jparams, levels=levels, include_first=include_first)),
        QCFG,
    )
    assert sorted(got) == sorted(want)
    n_int8 = sum(v.dtype == torch.int8 for v in got.values())
    assert n_int8 == 2 * sum((QCFG.blocks[i] - (0 if include_first else 1)) for i in levels) * 2
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def model_inputs(seed: int = 32):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, QCFG.num_labels, (2, 8, 8)).astype(np.int32)
    r = np.array([0.3, 0.8], np.float32)
    byt5 = rng.standard_normal((2, 5, QCFG.byt5_embd)).astype(np.float32)
    clip = rng.standard_normal((2, QCFG.clip_embd)).astype(np.float32)
    return x, r, byt5, clip


def jax_modes(jcfg, jq, x, r, byt5, clip, monkeypatch):
    """The JAX forward under interpret mode, and the mode of each ResBlock it
    runs, in order, from the arguments its kernel calls receive: a stacked
    call of R repetitions (a scan traces its body once) stands for R
    blocks."""
    modes = []
    stacked = jres.fused_resblock_stacked

    def spy(*args, **kw):
        mode = "float" if kw.get("fc1_scale") is None else "w8a8" if kw.get("act_quant") else "int8"
        modes.extend([mode] * args[3].shape[0])  # fc1 kernels (R, C, 4C)
        return stacked(*args, **kw)

    with monkeypatch.context() as m, pltpu.force_tpu_interpret_mode():
        m.setattr(jres, "fused_resblock_stacked", spy)
        out = JaxPaella(jcfg).apply({"params": jax.tree_util.tree_map(jnp.asarray, jq)}, x, r, byt5, clip)
    return np.asarray(out), modes


def record_calls(monkeypatch) -> list:
    """(block, x, film, skip, act_quant, output) of every ResBlock call."""
    calls = []
    forward = ResBlock.forward

    def spy(blk, x, film=None, skip=None, act_quant=False):
        out = forward(blk, x, film, skip, act_quant=act_quant)
        calls.append((blk, x, film, skip, act_quant, out))
        return out

    monkeypatch.setattr(ResBlock, "forward", spy)
    return calls


def assert_block_matches_jax(blk, x, film, skip, act_quant, out) -> None:
    """One quantized ResBlock call against the JAX kernel (interpret mode, its
    default tiles, as the JAX model calls it) on the same inputs and weights."""
    fc1, grn, fc2 = blk.channelwise[0], blk.channelwise[2], blk.channelwise[4]
    n = lambda v: v.detach().reshape(v.shape).numpy()  # noqa: E731
    q2, s2, beta = n(fc2.weight).T, n(fc2.weight_scale), n(grn.beta).reshape(-1)
    want = np.asarray(jax_fused_resblock(
        jnp.asarray(n(x)), n(blk.depthwise.weight).transpose(2, 3, 1, 0), n(blk.depthwise.bias), n(fc1.weight).T,
        n(fc1.bias), n(grn.gamma).reshape(-1), beta, q2, n(fc2.bias),
        film_ab=None if film is None else jnp.asarray(n(film)), fc1_scale=n(fc1.weight_scale), fc2_scale=s2,
        act_quant=act_quant, beta_w2=(jnp.asarray(beta) @ q2.astype(np.float32)) * s2 if act_quant else None,
        skip=None if skip is None else jnp.asarray(n(skip)), interpret=True,
    ))
    err = np.abs(n(out) - want)
    assert (err <= 1e-5).mean() >= 0.999, (blk.level, blk.rep, (err <= 1e-5).mean())
    assert err.max() <= np.abs(want).max() / 127, (blk.level, blk.rep, err.max())  # a flipped code's worth


@pytest.mark.parametrize(
    "flags,rest_level1",
    [
        ({}, "int8"),
        (dict(act_quant=True), "w8a8"),
        # JAX's attention-block route calls the ResBlock kernel without
        # act_quant: level 1's repetitions >= 1 stay weight-only
        (dict(act_quant=True, attn_block_kernel=True), "int8"),
    ],
)
def test_quantized_model_matches_jax(qmodels, monkeypatch, flags, rest_level1):
    port, jq, jcfg = quantized_pair(qmodels, (0, 1), True, **flags)
    x, r, byt5, clip = model_inputs()
    want, want_modes = jax_modes(jcfg, jq, x, r, byt5, clip, monkeypatch)
    calls = record_calls(monkeypatch)
    got = port(t(x), t(r), t(byt5), t(clip)).numpy()
    modes = [blk.kernel_weights(aq).mode for blk, *_, aq, _ in calls]
    rep0 = "w8a8" if flags.get("act_quant") else "int8"
    # call order: down level 0 (reps 0, 1), down level 1 (0, 1, 2), up level 1, up level 0
    assert modes == [rep0, rep0, rep0, rest_level1, rest_level1, rep0, rest_level1, rest_level1, rep0, rep0]
    assert modes == want_modes  # the route the JAX forward took, block by block
    assert np.abs(want).max() > 1e-3, "vacuous comparison"
    if not flags.get("act_quant"):
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
        return
    for call in calls:  # see the module docstring
        assert_block_matches_jax(*call)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert rel <= 3e-2 and agree >= 0.95, (rel, agree)


def test_int8_refused_at_unaligned_width():
    """A level of width 64 cannot run int8 codes (c % 128): both packages raise."""
    cfg = dataclasses.replace(QCFG, c_hidden=(64, 128))
    model, _, jparams = make_paella(cfg, seed=32)
    jcfg = JaxPaellaConfig(**{**dataclasses.asdict(cfg), "fused_blocks": True})
    jq = jquant.quantize_paella_int8(jax.tree_util.tree_map(jnp.asarray, jparams), levels=(0,), include_first=True)
    x, r, byt5, clip = model_inputs()
    with pytest.raises(ValueError, match="int8"), pltpu.force_tpu_interpret_mode():
        JaxPaella(jcfg).apply({"params": jq}, x, r, byt5, clip)
    port = quant.quantize_paella_int8(model, levels=(0,), include_first=True)
    with pytest.raises(ValueError, match="int8"):
        port(t(x), t(r), t(byt5), t(clip))
    assert quant.fuse_eligible_levels(cfg) == jquant.fuse_eligible_levels(cfg) == (1,)
    assert quant.fuse_eligible_levels(PaellaConfig.v1_byt5_xl()) == (0, 1, 2)


def test_int8_state_loads_only_into_quantized_models(qmodels):
    """A quantized state dict round-trips with strict=True; loading it into
    a float model, or a float one into a quantized model, raises instead of
    copying codes as floats. A dtype cast keeps codes int8 and scales f32."""
    model = qmodels[0]
    q = quant.quantize_paella_int8(model, levels=(1,))
    sd = q.state_dict()
    again = quant.quantize_paella_int8(Paella(QCFG), levels=(1,))
    again.load_state_dict(sd, strict=True)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    with pytest.raises(ValueError, match="int8"):
        Paella(QCFG).load_state_dict(sd, strict=False)
    with pytest.raises(ValueError, match="int8"):
        again.load_state_dict(model.state_dict(), strict=False)
    lin = q.down_blocks[1][4].channelwise[0]  # level 1, repetition 1
    assert isinstance(lin, quant.Int8Linear) and not lin.weight.requires_grad
    bf = q.to(torch.bfloat16)
    assert (lin.weight.dtype, lin.weight_scale.dtype, lin.bias.dtype) == (torch.int8, torch.float32, torch.bfloat16)
    assert torch.equal(lin.weight_scale, sd["down_blocks.1.4.channelwise.0.weight_scale"])
    x = torch.randn(3, QCFG.c_hidden[1])
    torch.testing.assert_close(lin.float()(x), x @ quant.dequantize_dense_int8(lin.weight, lin.weight_scale).t() + lin.bias.float())
    assert bf is q


def test_w8a8_quality_proxy_rows_and_verdict(qmodels):
    """Finite rows with a small drift on the perturbed weights (the int8
    rounding is near the identity), and verdict strings equal to JAX's on
    the same rows."""
    model = qmodels[0]
    rows = quant.w8a8_quality_proxy(model, torch.Generator().manual_seed(1), t_values=(0.8, 0.3), latent_hw=(8, 8))
    assert [r["t"] for r in rows] == [0.8, 0.3]
    for r in rows:
        assert np.isfinite([r["kl"], r["flip"], r["rel"]]).all()
        assert 0 <= r["kl"] < 0.05 and 0 <= r["flip"] <= 1 and r["rel"] < 0.1, r
    bad = [{"t": 0.5, "kl": 1.0, "flip": 0.5, "rel": 0.3}]
    for case in (rows, bad, [{"t": 0.1, "kl": 0.01, "flip": 0.2, "rel": 0.0}]):
        assert quant.w8a8_proxy_verdict(case) == jquant.w8a8_proxy_verdict(case)
    assert (quant.W8A8_PROXY_MAX_KL, quant.W8A8_PROXY_MAX_FLIP) == (jquant.W8A8_PROXY_MAX_KL, jquant.W8A8_PROXY_MAX_FLIP)


def test_inject_weight_outliers_scales_reduction_channels():
    """Only float dense/conv kernels change, each by exactly `scale` on a
    subset of its input (reduction-axis) channels; biases, norms,
    embeddings, GRN and int8 codes stay; the model passed in is untouched."""
    q8, s8 = quant.quantize_dense_int8(torch.randn(8, 16))
    m = torch.nn.ModuleDict({
        "dense": torch.nn.Linear(64, 8),
        "conv": torch.nn.Conv2d(32, 8, 3),
        "convt": torch.nn.ConvTranspose2d(16, 4, 2),
        "emb": torch.nn.Embedding(10, 8),
        "codes": quant.Int8Linear(q8, s8),
    })
    for p in m.parameters():
        if p.is_floating_point():
            torch.nn.init.constant_(p, 1.0)
    out = quant.inject_weight_outliers(m, torch.Generator().manual_seed(0), frac=0.25, scale=7.0)
    for name, axis in (("dense", 1), ("conv", 1), ("convt", 0)):
        w = out[name].weight
        per = w.transpose(0, axis).reshape(w.shape[axis], -1)
        assert set(per.unique().tolist()) <= {1.0, 7.0} and (per == 7).any() and (per == 1).any(), name
        assert (per == per[:, :1]).all(), name  # whole channels
    for name in ("dense", "conv"):
        assert (out[name].bias == 1).all()
    assert (out["emb"].weight == 1).all() and torch.equal(out["codes"].weight, q8)
    assert all((p == 1).all() for p in m.parameters() if p.is_floating_point())

"""The port's training side against the JAX package's at the tiny configs on
the CPU: the training forward (`Paella.forward_train`) and every parameter's
gradient against `jax.grad` of the JAX model at fused_blocks=False, dropout
and remat, the routes it refuses, `models/noise.py`, the loss, conditioning
dropout, the optimizer against optax, and whole train steps against JAX's
`make_train_step` with JAX's draws fed to the port.

The JAX references that need a compile are made once per module in
fixtures (`forward_refs`, `jax_steps`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paella_tpu.config import TrainConfig as JaxTrainConfig
from paella_tpu.models.noise import add_noise as jax_add_noise
from paella_tpu.models.noise import get_loss_weight as jax_get_loss_weight
from paella_tpu.train import Batch as JaxBatch
from paella_tpu.train import NullCond as JaxNullCond
from paella_tpu.train import apply_cond_dropout as jax_apply_cond_dropout
from paella_tpu.train import create_train_state as jax_create_train_state
from paella_tpu.train import make_train_step as jax_make_train_step
from paella_tpu.train import smoothed_weighted_ce as jax_smoothed_ce
from paella_tpu.train.trainer import make_optimizer as jax_make_optimizer
from paella_tpu_torch.config import PaellaConfig, TrainConfig
from paella_tpu_torch.convert import paella_state_dict_from_jax
from paella_tpu_torch.models import Paella, add_noise, get_loss_weight
from paella_tpu_torch.nn.attention import dot_product_attention
from paella_tpu_torch.nn.blocks import DropoutMasks, dropout
from paella_tpu_torch.quant import quantize_paella_int8
from paella_tpu_torch.train import (
    AdamW,
    Batch,
    Draws,
    NullCond,
    apply_cond_dropout,
    create_train_state,
    make_train_step,
    smoothed_weighted_ce,
)
from tests.test_torch_codec import make_codec
from tests.test_torch_denoiser import conditioning_inputs, make_paella, to_torch

CFG = PaellaConfig.tiny()
IMG = 64  # 16x16 tokens through the f4 codec


def forward_inputs(seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, CFG.num_labels, (2, 16, 16)).astype(np.int32)
    r = rng.uniform(0.05, 1.0, (2,)).astype(np.float32)
    probe = rng.standard_normal((2, 16, 16, CFG.num_labels)).astype(np.float32)
    return x, r, conditioning_inputs(CFG), probe


def port_loss(model, x, r, cond, probe, dropout_seed=None):
    """sum(logits * probe) of the training forward: its gradient reaches
    every parameter through every logit."""
    tc = to_torch(cond)
    logits = model.forward_train(
        torch.from_numpy(x), torch.from_numpy(r), tc["byt5"], tc["clip"], tc["clip_image"],
        byt5_mask=tc["byt5_mask"], clip_mask=tc["clip_mask"], dropout_seed=dropout_seed,
    )
    return logits, (logits.float() * torch.from_numpy(probe)).sum()


@pytest.fixture(scope="module")
def forward_refs():
    """The perturbed tiny weights, and per compute dtype the JAX model's
    logits (fused_blocks=False, deterministic=True) and jax.grad of
    sum(logits * probe), mapped to the port's parameter names."""
    model, jmodel, jparams = make_paella(CFG, seed=0)
    x, r, cond, probe = forward_inputs()
    refs = {}
    for dt in ("float32", "bfloat16"):
        jm = type(jmodel)(dataclasses.replace(jmodel.config, dtype=dt))
        assert not jm.config.fused_blocks

        def loss(p, jm=jm):
            lg = jm.apply({"params": p}, x, r, cond["byt5"], cond["clip"], cond["clip_image"],
                          byt5_mask=cond["byt5_mask"], clip_mask=cond["clip_mask"], deterministic=True)
            return jnp.sum(lg.astype(jnp.float32) * probe), lg

        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
        grads = paella_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), CFG)
        refs[dt] = (np.asarray(logits.astype(jnp.float32)), grads)
    return model.state_dict(), (x, r, cond, probe), refs


# f32: logits to 1e-5 absolute (they reach ~1.7), every gradient within
# 1e-5 of its tensor's largest entry (measured: 1.9e-6 and 1.8e-6). bf16: the
# two packages round the same bf16 values at slightly different points
# (torch's fused bias add, reduction orders), so logits within 5% of their
# largest and each gradient within 8% of its largest entry and 5% in norm
# (measured: 2.5%, 3.9% and 2.7%).
@pytest.mark.parametrize("dtype,logit_tol,max_tol,norm_tol", [("float32", 1e-5, 1e-5, 1e-5),
                                                              ("bfloat16", 0.05, 0.08, 0.05)])
def test_training_forward_and_grads_match_jax(forward_refs, dtype, logit_tol, max_tol, norm_tol):
    sd, (x, r, cond, probe), refs = forward_refs
    want_logits, want_grads = refs[dtype]
    model = Paella(dataclasses.replace(CFG, dtype=dtype))
    model.load_state_dict(sd)
    logits, loss = port_loss(model, x, r, cond, probe)
    loss.backward()
    scale = np.abs(want_logits).max()
    assert scale > 1e-3, "vacuous comparison"
    assert np.abs(logits.detach().float().numpy() - want_logits).max() <= logit_tol * max(1.0, scale)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want_grads)
    for name, p in model.named_parameters():
        want, got = want_grads[name], p.grad.numpy()
        peak = np.abs(want).max()
        assert peak > 0, f"{name}: zero gradient, vacuous"
        assert np.abs(got - want).max() <= max_tol * peak, (name, np.abs(got - want).max(), peak)
        assert np.linalg.norm(got - want) <= norm_tol * np.linalg.norm(want), name


def test_inference_forward_is_unchanged_by_the_training_route(forward_refs):
    """The no-grad kernel route (K1's rounding) and the training route see
    the same weights; the inference forward still builds no graph."""
    sd, (x, r, cond, _), refs = forward_refs
    model = Paella(CFG)
    model.load_state_dict(sd)
    tc = to_torch(cond)
    args = (torch.from_numpy(x), torch.from_numpy(r), tc["byt5"], tc["clip"], tc["clip_image"])
    inference = model(*args, byt5_mask=tc["byt5_mask"], clip_mask=tc["clip_mask"])
    assert not inference.requires_grad
    np.testing.assert_allclose(inference.numpy(), refs["float32"][0], rtol=1e-4, atol=1e-4)


def test_dropout_rate_scale_and_repeat():
    """Kept with probability 1 - p (within 4 sigma over 2^18 draws), kept
    values scaled by 1 / (1 - p), the same mask for the same seed, and the
    identity at p = 0 or without a mask source; attention's dropout likewise
    on the probabilities."""
    x = torch.ones(1 << 18)
    site = lambda seed, p: DropoutMasks(seed).site(0, 0, p)  # noqa: E731
    for p in (0.1, 0.5):
        y = dropout(x, p, site(3, p))
        kept = y != 0
        share = kept.float().mean().item()
        assert abs(share - (1 - p)) <= 4 * (p * (1 - p) / x.numel()) ** 0.5, (p, share)
        assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
        assert torch.equal(y, dropout(x, p, site(3, p)))
        assert not torch.equal(y, dropout(x, p, site(4, p)))
    assert dropout(x, 0.0, site(3, 0.1)) is x and dropout(x, 0.3, None) is x
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32)) for _ in range(3))
    plain = dot_product_attention(q, k, v)
    assert torch.equal(dot_product_attention(q, k, v, dropout_rate=0.5), plain)
    assert torch.equal(dot_product_attention(q, k, v, dropout_rate=0.0, dropout_keep=site(1, 0.5)), plain)
    dropped = dot_product_attention(q, k, v, dropout_rate=0.5, dropout_keep=site(1, 0.5))
    again = dot_product_attention(q, k, v, dropout_rate=0.5, dropout_keep=site(1, 0.5))
    assert torch.equal(dropped, again) and not torch.allclose(dropped, plain)


@pytest.mark.parametrize("remat", [dict(remat=True), dict(remat=True, remat_levels=(True, False, True))])
def test_remat_gives_the_same_loss_and_grads_with_dropout(forward_refs, remat):
    """Recomputed repetitions draw the same dropout masks (a generator per
    block, seeded by the dropout seed and the block's place): loss and every
    gradient equal to the run without remat, bit for bit
    (tests/test_train.py:225 checks this in JAX)."""
    sd, (x, r, cond, probe), _ = forward_refs
    cfg = dataclasses.replace(CFG, dropout=(0.1, 0.1, 0.1))
    runs = {}
    for name, c in (("none", cfg), ("remat", dataclasses.replace(cfg, **remat))):
        model = Paella(c)
        model.load_state_dict(sd)
        _, loss = port_loss(model, x, r, cond, probe, dropout_seed=11)
        loss.backward()
        runs[name] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    assert runs["remat"][0] == runs["none"][0]
    for n, g in runs["none"][1].items():
        assert torch.equal(runs["remat"][1][n], g), n
    model = Paella(cfg)
    model.load_state_dict(sd)
    assert port_loss(model, x, r, cond, probe, dropout_seed=None)[1].item() != runs["none"][0], "dropout inert"


def test_training_route_refuses_int8_and_kernel_attention():
    """An int8 model has no training route (JAX refuses int8 codes off its
    fused kernel); the kernel attention routes K5 / K6 have no backward, and
    neither has JAX's Pallas attention: jax.grad refuses it (checked here in
    interpret mode), and at deterministic=False JAX runs XLA attention in
    their place, which the port does not do silently."""
    from paella_tpu.kernels.attention import fused_attention_interpret

    model, _, _ = make_paella(CFG, seed=2)
    x, r, cond, probe = forward_inputs()
    with pytest.raises(ValueError, match="int8"):
        port_loss(quantize_paella_int8(model, levels=(1,)), x, r, cond, probe)
    for flags in (dict(attention_impl="pallas"), dict(attn_block_kernel=True)):
        m = Paella(dataclasses.replace(CFG, **flags))
        m.load_state_dict(model.state_dict())
        with pytest.raises(ValueError, match="K5 / K6"):
            port_loss(m, x, r, cond, probe)
    q = jnp.asarray(np.random.default_rng(0).standard_normal((1, 8, 2, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="reverse-mode"):
        jax.grad(lambda q: fused_attention_interpret(q, q, q).sum())(q)


def test_add_noise_and_loss_weight_match_jax():
    """Exact with pinned mask and ids; in rate and range when drawn."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 128, (3, 8, 8)).astype(np.int32)
    t = np.array([0.001, 0.4, 1.0], np.float32)
    mask = (rng.uniform(size=x.shape) < 0.5).astype(np.int32)
    rand_x = rng.integers(0, 128, x.shape).astype(np.int32)
    want_n, want_m = jax_add_noise(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), 128,
                                   mask=jnp.asarray(mask), random_x=jnp.asarray(rand_x))
    got_n, got_m = add_noise(torch.from_numpy(x), torch.from_numpy(t), 128, mask=torch.from_numpy(mask),
                             random_x=torch.from_numpy(rand_x))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(get_loss_weight(torch.from_numpy(t), got_m, 0.3).numpy(),
                                  np.asarray(jax_get_loss_weight(jnp.asarray(t), want_m, 0.3)))
    big = torch.zeros(4, 128, 128, dtype=torch.int32)
    tb = torch.tensor([0.0, 0.3, 0.7, 1.0])
    noised, m = add_noise(big, tb, 8192, torch.Generator().manual_seed(5))
    share = m.float().mean(dim=(1, 2))
    assert share[0] == 0 and share[3] == 1 and abs(share[1] - 0.3) < 0.02 and abs(share[2] - 0.7) < 0.02
    ids = noised[3]
    assert ids.dtype == torch.int32 and 0 <= ids.min() and ids.max() < 8192 and len(ids.unique()) > 6000


def test_smoothed_ce_matches_jax_torch_and_autograd():
    """The value against JAX's and torch's CrossEntropyLoss(label_smoothing=
    0.1) with the per-image weights (tests/test_train.py:53), to 1e-5; the
    custom backward against autograd of that plain form, to 1e-6 relative
    (f32 logits) and as the same bf16 values (bf16 logits)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 4, 4, 16), dtype=np.float32) * 3
    labels = rng.integers(0, 16, (2, 4, 4))
    weight = rng.uniform(0.3, 1.0, (2, 4, 4)).astype(np.float32)
    want = float(jax_smoothed_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight), 0.1))

    def plain(lg):
        per = torch.nn.CrossEntropyLoss(label_smoothing=0.1, reduction="none")(
            lg.float().permute(0, 3, 1, 2), torch.from_numpy(labels))
        w = torch.from_numpy(weight)
        return ((per * w).sum(dim=(1, 2)) / w.sum(dim=(1, 2))).mean()

    for dt in (torch.float32, torch.bfloat16):
        lg = torch.from_numpy(logits).to(dt).requires_grad_()
        got = smoothed_weighted_ce(lg, torch.from_numpy(labels), torch.from_numpy(weight), 0.1)
        ref_lg = lg.detach().clone().requires_grad_()
        ref = plain(ref_lg)
        assert abs(got.item() - ref.item()) < 1e-5
        if dt == torch.float32:
            assert abs(got.item() - want) < 1e-5
        (got * 3).backward()
        (ref * 3).backward()
        assert lg.grad.dtype == dt
        if dt == torch.float32:
            torch.testing.assert_close(lg.grad, ref_lg.grad, rtol=1e-6, atol=1e-7)
        else:
            torch.testing.assert_close(lg.grad.float(), ref_lg.grad.float(), rtol=2**-8, atol=1e-6)


def test_cond_dropout_matches_jax_and_rates():
    """Given JAX's coins the port swaps the same tensors in (the null ByT5
    padded to S, or cut when it is longer); drawn, the rates are ~5 / 90 /
    90% (tests/test_train.py:116's bounds)."""
    cfg = TrainConfig()
    rng = np.random.default_rng(5)
    b = 6
    for s, s0 in ((5, 3), (3, 5)):
        jb = JaxBatch(images=jnp.zeros((b, 8, 8, 3)), byt5=jnp.asarray(rng.standard_normal((b, s, 4)), jnp.float32),
                      byt5_mask=jnp.asarray(rng.uniform(size=(b, s)) < 0.7), clip=jnp.asarray(rng.standard_normal((b, 3)), jnp.float32),
                      clip_image=jnp.asarray(rng.standard_normal((b, 3)), jnp.float32))
        jn = JaxNullCond(byt5=jnp.asarray(rng.standard_normal((1, s0, 4)), jnp.float32),
                         byt5_mask=jnp.asarray(rng.uniform(size=(1, s0)) < 0.7), clip=jnp.asarray(rng.standard_normal((1, 3)), jnp.float32))
        key = jax.random.PRNGKey(s)
        want = jax_apply_cond_dropout(JaxTrainConfig(byt5_drop_prob=0.5, clip_text_drop_prob=0.5, clip_image_drop_prob=0.5),
                                      key, jb, jn)
        k1, k2, k3 = jax.random.split(key, 3)
        coins = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (b,)))) for k in (k1, k2, k3)]
        assert any(c.any() and not c.all() for c in coins)
        tb = Batch(*(torch.from_numpy(np.array(a)) for a in (jb.images, jb.byt5, jb.byt5_mask, jb.clip, jb.clip_image)))
        tn = NullCond(*(torch.from_numpy(np.array(a)) for a in (jn.byt5, jn.byt5_mask, jn.clip)))
        got = apply_cond_dropout(cfg, tb, tn, Draws(drop_byt5=coins[0], drop_clip=coins[1], drop_image=coins[2]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = 4096
    tb = Batch(torch.zeros(n, 8, 8, 3), torch.ones(n, 4, 2), torch.ones(n, 4, dtype=torch.bool), torch.ones(n, 3),
               torch.ones(n, 3))
    tn = NullCond(torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool), torch.zeros(1, 3))
    byt5, _, clip, _, image_mask = apply_cond_dropout(cfg, tb, tn, Draws(), torch.Generator().manual_seed(0))
    assert 0.01 < (byt5[:, 0, 0] == 0).float().mean() < 0.12
    assert 0.85 < (clip[:, 0] == 0).float().mean() < 0.95
    assert 0.85 < 1 - image_mask.float().mean() < 0.95


def optimizer_case(seed: int = 7):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((64, 32)).astype(np.float32), "b": rng.standard_normal(128).astype(np.float32)}
    # gradient norms around the clip: 0.5 (kept) and 3 (clipped) in turns
    grads = [{k: (rng.standard_normal(v.shape) * (0.5 if i % 2 else 3.0) / np.sqrt(64 * 32 + 128)).astype(np.float32)
              for k, v in params.items()} for i in range(4)]
    return params, grads


def run_both(cfg: TrainConfig, params, grads):
    tx = jax_make_optimizer(JaxTrainConfig(**dataclasses.asdict(cfg)))
    jp, state = params, tx.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(tp.values(), cfg)
    for g in grads:
        u, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return jp, state, tp, opt


def test_adamw_matches_optax_f32_and_bf16_moments():
    """f32 moments: the parameters after four updates (two clipped) equal
    optax's within 2e-7 absolute (lr 1e-4, so 0.2% of an update); bf16
    moments (stored bf16, f32 math): within 2e-7 of the JAX bf16-moment
    optimizer and within 2e-5 of f32 (tests/test_train.py:143, 177)."""
    params, grads = optimizer_case()
    outs = {}
    for md in ("float32", "bfloat16"):
        cfg = TrainConfig(warmup_updates=3, adam_moment_dtype=md)
        jp, state, tp, opt = run_both(cfg, params, grads)
        assert opt.count == 4
        for k, p in tp.items():
            assert opt.state[p]["mu"].dtype == opt.state[p]["nu"].dtype == getattr(torch, md)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=2e-7)
            assert np.abs(p.detach().numpy() - params[k]).max() > 1e-5, "no update"
        outs[md] = {k: p.detach().numpy() for k, p in tp.items()}
    for k in params:
        np.testing.assert_allclose(outs["bfloat16"][k], outs["float32"][k], rtol=0, atol=2e-5)


def test_adamw_first_update_has_lr_zero_and_nonfinite_skips():
    """optax.linear_schedule(0, lr, warmup) gives the first update lr 0: the
    parameters move by nothing, though the moments and count advance. A
    non-finite gradient leaves parameters, moments and count untouched and
    counts a skip (optax.apply_if_finite; tests/test_train.py:258)."""
    params, grads = optimizer_case(8)
    cfg = TrainConfig(warmup_updates=2)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(tp.values(), cfg)
    assert opt.learning_rate(0) == 0.0 and opt.learning_rate(1) == pytest.approx(cfg.lr / 2)
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[0][k])
    opt.step()
    assert opt.count == 1 and all(torch.equal(p.detach(), torch.from_numpy(params[k])) for k, p in tp.items())
    before = {k: (p.detach().clone(), opt.state[p]["mu"].clone(), opt.state[p]["nu"].clone()) for k, p in tp.items()}
    tp["a"].grad = tp["a"].grad.clone()
    tp["a"].grad[3, 4] = float("nan")
    out = opt.step()
    assert out["skipped"] and opt.nonfinite_skips == 1 and opt.count == 1
    for k, p in tp.items():
        assert all(torch.equal(a, b) for a, b in zip(before[k], (p.detach(), opt.state[p]["mu"], opt.state[p]["nu"])))
    tp["a"].grad = torch.from_numpy(grads[1]["a"])
    assert not opt.step()["skipped"] and opt.count == 2 and opt.nonfinite_skips == 1
    assert not torch.equal(tp["a"].detach(), before["a"][0])
    # the same sequence through optax: its count also stays at 1 on the skip
    jcfg = JaxTrainConfig(warmup_updates=2)
    tx = jax_make_optimizer(jcfg)
    state = tx.init(params)
    _, state = tx.update(grads[0], state, params)
    bad = dict(grads[0], a=np.where(np.arange(grads[0]["a"].size).reshape(64, 32) == 3 * 32 + 4, np.nan, grads[0]["a"]))
    _, state = tx.update(bad, state, params)
    assert int(state.total_notfinite) == 1 and int(state.inner_state[1][0].count) == 1


@pytest.fixture(scope="module")
def jax_steps():
    """Two of JAX's make_train_step steps (TrainConfig(warmup_updates=1)) on
    the port's perturbed tiny weights and codec, with the draws JAX's step
    makes from its key, rebuilt here from the same key."""
    model, jmodel, jparams = make_paella(CFG, seed=4)
    vq, jvq, jvars = make_codec(seed=5)
    cfg = TrainConfig(warmup_updates=1)
    rng = np.random.default_rng(9)
    b, s = 2, 6
    arrays = dict(images=rng.uniform(0, 1, (b, IMG, IMG, 3)).astype(np.float32),
                  byt5=rng.standard_normal((b, s, CFG.byt5_embd)).astype(np.float32),
                  byt5_mask=np.arange(s)[None, :] < np.array([[6], [3]]),
                  clip=rng.standard_normal((b, CFG.clip_embd)).astype(np.float32),
                  clip_image=rng.standard_normal((b, CFG.clip_embd)).astype(np.float32))
    null_arrays = dict(byt5=rng.standard_normal((1, 2, CFG.byt5_embd)).astype(np.float32),
                       byt5_mask=np.ones((1, 2), bool), clip=rng.standard_normal((1, CFG.clip_embd)).astype(np.float32))
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jnull = JaxNullCond(**{k: jnp.asarray(v) for k, v in null_arrays.items()})
    jcfg = JaxTrainConfig(warmup_updates=1)
    key = jax.random.PRNGKey(3)
    step = jax.jit(jax_make_train_step(jmodel, jvq, jcfg))
    state = jax_create_train_state(jparams, jcfg)
    from paella_tpu.codec import VQModel as JaxVQModel

    latents = np.asarray(jvq.apply(jvars, jbatch.images, method=JaxVQModel.encode)[2])
    steps = []
    for i in range(2):
        state, metrics = step(state, jvars, jbatch, jnull, key)
        # the draws of trainer.py:loss_fn under the step's folded key
        k_drop, k_t, k_noise, _ = jax.random.split(jax.random.fold_in(key, i), 4)
        coins = [jax.random.bernoulli(k, p, (b,)) for k, p in zip(jax.random.split(k_drop, 3), (0.05, 0.9, 0.9))]
        u = jax.random.uniform(k_t, (b,))
        t = jnp.clip(1.0 - u + jcfg.t_min, jcfg.t_min, 1.0)
        k_mask, k_rand = jax.random.split(k_noise)
        mask = (jax.random.uniform(k_mask, latents.shape) <= t[:, None, None]).astype(jnp.int32)
        rand_x = jax.random.randint(k_rand, latents.shape, 0, CFG.num_labels, jnp.int32)
        draws = Draws(*(torch.from_numpy(np.array(c)) for c in coins), u=torch.from_numpy(np.array(u)),
                      noise_mask=torch.from_numpy(np.array(mask)), random_x=torch.from_numpy(np.array(rand_x)),
                      dropout_seed=0)
        params = paella_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params), CFG)
        steps.append((draws, {k: float(v) for k, v in metrics.items()}, params))
    batch = Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    null = NullCond(**{k: torch.from_numpy(v) for k, v in null_arrays.items()})
    return model, vq, cfg, batch, null, latents, steps


def test_train_step_matches_jax(jax_steps):
    """Two steps from the same weights on JAX's draws. Loss and acc to 1e-5
    relative, grad_norm to 5e-5 (measured 1.0e-5: f32 summation order over
    ~70k gradients). Step 1 has lr 0, so both packages leave the parameters
    bit for bit as they were. After step 2 (lr 1e-4, clipped gradients)
    each parameter is held to lr * (2e-3 + 5e-4 / r) beyond two float32
    ulps of its value, r being the smaller over the two steps of its
    gradient's magnitude over its tensor's largest: Adam divides a gradient
    by its own size, so the packages' gradient difference, a fixed share of
    a tensor's largest entry (~1e-5, summation order), moves the update of a
    small gradient by ~1/r as much, and where r is ~0 Adam's sign is decided
    by rounding (no element moves more than 2.1 lr either way). Measured:
    1.7e-3 lr at r >= 0.1, 0.018 at r >= 0.01, 0.17 below; the median
    parameter within 1e-3 lr."""
    model, vq, cfg, batch, null, latents, steps = jax_steps
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    assert np.array_equal(vq.encode(batch.images)[2].numpy(), latents), "the frozen encodes differ"
    state = create_train_state(model, cfg)
    train_step = make_train_step(model, vq, cfg)
    grads = []
    for i, (draws, want, want_params) in enumerate(steps):
        got = train_step(state, batch, null, [dataclasses.replace(draws)])
        grads.append({n: p.grad.abs().numpy() for n, p in model.named_parameters()})
        for k, rel in (("loss", 1e-5), ("acc", 1e-5), ("grad_norm", 5e-5)):
            assert float(got[k]) == pytest.approx(want[k], rel=rel, abs=1e-6), (i, k, float(got[k]), want[k])
        assert got["nonfinite_skips"] == want["nonfinite_skips"] == 0
        if i == 0:
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), sd0[n]), n
                np.testing.assert_array_equal(want_params[n], sd0[n].numpy(), err_msg=n)
    assert state.step == 2 and state.optimizer.count == 2
    want_params, lr = steps[1][2], cfg.lr
    errs, moved = [], []
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        moved.append(np.abs(got - sd0[n].numpy()).reshape(-1) > 0.5 * lr)
        r = np.minimum(*(g[n] / max(g[n].max(), 1e-30) for g in grads))
        err = np.abs(got - want_params[n]) - 2 * np.spacing(np.abs(want_params[n]))
        assert np.all(err <= lr * np.minimum(2e-3 + 5e-4 / np.maximum(r, 1e-30), 2.1)), n
        errs.append(err.reshape(-1) / lr)
    assert np.median(np.concatenate(errs)) <= 1e-3
    assert np.concatenate(moved).mean() > 0.5, "the update is vacuous"


def test_grad_accum_matches_full_batch(jax_steps):
    """grad_accum_steps=2 over the batch split in two, on the same pinned
    draws split the same way: loss, acc, grad_norm and every averaged
    gradient as the full batch's (tests/test_train.py:97), to 1e-5."""
    model, vq, _, batch, null, _, steps = jax_steps
    draws = steps[0][0]
    full_batch = Batch(*(torch.cat([t, t.flip(0)]) for t in dataclasses.astuple(batch)))
    full_draws = Draws(*(torch.cat([t, t.flip(0)]) for t in dataclasses.astuple(draws)[:-1]), dropout_seed=0)
    out = {}
    for n in (1, 2):
        m = Paella(CFG)
        m.load_state_dict(model.state_dict())
        cfg = TrainConfig(warmup_updates=1, grad_accum_steps=n)
        state = create_train_state(m, cfg)
        d = [full_draws] if n == 1 else [
            Draws(*(t[i * 2:(i + 1) * 2] for t in dataclasses.astuple(full_draws)[:-1]), dropout_seed=0) for i in range(2)]
        metrics = make_train_step(m, vq, cfg)(state, full_batch, null, d)
        assert state.optimizer.count == 1
        out[n] = metrics, {k: p.grad.clone() for k, p in m.named_parameters()}
    for k in ("loss", "acc", "grad_norm"):
        assert float(out[2][0][k]) == pytest.approx(float(out[1][0][k]), rel=1e-5)
    for k, g in out[1][1].items():
        torch.testing.assert_close(out[2][1][k], g, rtol=1e-5, atol=1e-5 * g.abs().max().item())

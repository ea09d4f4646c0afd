"""The port's codec trainer (codec/trainer.py) and Discriminator against the
JAX package's at VQConfig.tiny() with a (c_hidden 32, depth 4)
discriminator on the CPU: two steps of make_codec_train_step from the same
weights, spectral-norm state and images, with the revival rows JAX draws
pinned into the port's step; the discriminator forward and its converter;
the codebook's exemption from weight decay."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.codec import Discriminator as JaxDiscriminator
from paella_tpu.codec.trainer import CodecTrainConfig as JaxCodecTrainConfig
from paella_tpu.codec.trainer import create_codec_train_state as jax_create_state
from paella_tpu.codec.trainer import make_codec_train_step as jax_make_step
from paella_tpu_torch.codec import (
    CodecTrainConfig,
    Discriminator,
    create_codec_train_state,
    make_codec_train_step,
)
from paella_tpu_torch.config import VQConfig
from paella_tpu_torch.convert import discriminator_state_dict_from_jax, vqgan_state_dict_from_jax
from tests.test_torch_codec import make_codec

DISC = dict(c_hidden=32, depth=4)
IMG, B = 32, 4
LR = 1e-3  # large enough that one update is far above the packages' rounding gap


def make_disc(seed: int):
    """(port Discriminator, JAX variables) with the same seeded weights and
    spectral-norm u (perturbed sigma, which only the update overwrites)."""
    disc = Discriminator(**DISC)
    disc.reset_parameters(torch.Generator().manual_seed(seed))
    sd = {k: v.numpy().copy() for k, v in disc.state_dict().items()}
    params, stats = {}, {}
    for i in range(len(disc.convs)):
        params[f"Conv_{i}"] = {"kernel": sd[f"convs.{i}.weight"].transpose(2, 3, 1, 0), "bias": sd[f"convs.{i}.bias"]}
        stats[f"SpectralNorm_{i}"] = {f"Conv_{i}/kernel/u": sd[f"convs.{i}.u"],
                                      f"Conv_{i}/kernel/sigma": sd[f"convs.{i}.sigma"] * 0 + 2.5}
    params["shuffle"] = {"kernel": sd["shuffle.weight"].T, "bias": sd["shuffle.bias"]}
    jvars = {"params": params, "batch_stats": stats}
    disc.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in discriminator_state_dict_from_jax(jvars).items()}, strict=True)
    return disc, jvars


def disc_input(seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("update_stats", [False, True])
def test_discriminator_matches_jax(update_stats):
    """The patch map to 1e-5, and the spectral-norm u and sigma stored only
    under update_stats (flax nn.SpectralNorm, one power iteration)."""
    disc, jvars = make_disc(1)
    x = disc_input()
    jd = JaxDiscriminator(**DISC)
    want, new = jd.apply(jvars, jnp.asarray(x), update_stats=update_stats, mutable=["batch_stats"])
    u_before = [c.u.clone() for c in disc.convs]
    got = disc(torch.from_numpy(x), update_stats=update_stats)
    assert got.shape == want.shape == (B, 2, 2, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for i, c in enumerate(disc.convs):
        st = new["batch_stats"][f"SpectralNorm_{i}"]
        np.testing.assert_allclose(c.u.numpy(), np.asarray(st[f"Conv_{i}/kernel/u"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(c.sigma.numpy(), np.asarray(st[f"Conv_{i}/kernel/sigma"]), rtol=1e-5)
        assert torch.equal(c.u, u_before[i]) != update_stats


def test_discriminator_converter_round_trips():
    disc, jvars = make_disc(2)
    sd = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars))
    assert set(sd) == set(disc.state_dict())
    for k, v in disc.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)


def revive_rows(step: int, k: int, n: int) -> np.ndarray:
    """The rows the JAX step revives from (codec/trainer.py:156-157)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), jnp.int32(step))
    return np.asarray(jax.random.randint(key, (k,), 0, n))


@pytest.fixture(scope="module")
def codec_steps():
    """Two JAX codec steps (revive_after=1: every code unused in a step is
    revived, so the pinned rows matter) and two port steps from the same
    weights; each step's metrics and the state after it, in both."""
    vq, jvq, jvars = make_codec(seed=6)
    disc, jdvars = make_disc(7)
    cfg = CodecTrainConfig(lr=LR, disc_lr=LR, revive_after=1)
    jcfg = JaxCodecTrainConfig(**dataclasses.asdict(cfg))
    jdisc = JaxDiscriminator(**DISC)
    jstate = jax_create_state(jvq, jdisc, jax.random.PRNGKey(0), image_size=IMG, cfg=jcfg)
    jstate = jstate.replace(gen_vars=jvars, gen_opt=jstate.gen_tx.init(jvars["params"]),
                            disc_vars=jdvars, disc_opt=jstate.disc_tx.init(jdvars["params"]))
    jstep = jax.jit(jax_make_step(jvq, jdisc, jcfg))
    images = disc_input(8)
    k, n = VQConfig.tiny().codebook_size, B * (IMG // 4) ** 2
    state = create_codec_train_state(vq, disc, cfg)
    step = make_codec_train_step(vq, disc, cfg)
    start = ({key: v.detach().clone() for key, v in vq.state_dict().items()},
             {key: v.detach().clone() for key, v in disc.state_dict().items()})
    out = []
    for i in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images))
        m = step(state, torch.from_numpy(images), torch.from_numpy(revive_rows(i, k, n).copy()))
        out.append(({key: float(v) for key, v in jm.items()}, {key: float(v) for key, v in m.items()},
                    vqgan_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.gen_vars), VQConfig.tiny()),
                    discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.disc_vars)),
                    {key: v.detach().clone() for key, v in vq.state_dict().items()},
                    {key: v.detach().clone() for key, v in disc.state_dict().items()},
                    np.asarray(jstate.code_age), state.code_age.clone()))
    return out, state, start


def test_codec_step_metrics_match_jax(codec_steps):
    """Losses and patch means to 1e-5 relative; codes used and revived
    exactly (the encodes agree on every index)."""
    out, state, _ = codec_steps
    assert state.step == 2
    for i, (want, got, *_rest, jage, age) in enumerate(out):
        for key in ("g_loss", "d_loss", "recon_l1", "vq_loss", "d_real", "d_fake"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), (i, key, got[key], want[key])
        assert got["codes_used_batch"] == want["codes_used_batch"] > 0
        assert got["codes_revived"] == want["codes_revived"] > 0, "revival not exercised"
        np.testing.assert_array_equal(age.numpy(), jage)


# biases whose gradient is zero in exact arithmetic, a normalization right
# after cancelling them: the discriminator's convs before InstanceNorm, and
# the encoder's last fc2 bias before to_latent and train-mode BatchNorm
CANCELLED = ("convs.1.bias", "convs.2.bias", "convs.3.bias", "down_blocks.2.channelwise.2.bias")


def update_error(name: str, got: np.ndarray, want: np.ndarray, steps: int, lr: float) -> np.ndarray:
    """An updated parameter's distance from JAX's beyond two float32 ulps,
    in units of lr. Adam normalizes each gradient by its own size, so the
    packages' rounding gap, a fixed share of a tensor's largest gradient,
    moves a small gradient's step the most; every element is held to 2.1
    lr a step (a sign decided by rounding), and a CANCELLED bias (its
    gradient rounding noise near Adam's eps) to nothing tighter."""
    err = (np.abs(got - want) - 2 * np.spacing(np.abs(want).astype(np.float32))) / lr
    assert err.max() <= 2.1 * steps, (name, err.max())
    return err.reshape(-1)


def test_codec_step_updates_match_jax(codec_steps):
    """After each step: every codec parameter (the revived codebook rows
    included) and discriminator parameter within 2.1 lr a step of JAX's,
    99.9% of the elements of the tensors that are not CANCELLED within
    0.02 lr and their median within 1e-3 lr (measured after step 2: 0.0012
    lr at the 99.9th percentile, 0.046 lr at most); the BatchNorm running
    statistics and the spectral-norm u (a unit vector) and sigma to 1e-5
    absolute and 1e-4 relative (step 2's power iteration reads kernels up
    to ~5e-5 apart; measured 4.5e-6)."""
    out, _, start = codec_steps
    for steps, (want_gen, want_disc, gen, disc) in enumerate(((o[2], o[3], o[4], o[5]) for o in out), 1):
        assert set(want_gen) == set(gen) and set(want_disc) == set(disc)
        errs = []
        for key, v in [*gen.items(), *disc.items()]:
            want = want_gen[key] if key in want_gen else want_disc[key]
            if key.endswith("num_batches_tracked"):
                continue
            if key.endswith(("running_mean", "running_var", ".u", ".sigma")):
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=key)
            else:
                err = update_error(key, v.numpy(), want, steps, LR)
                if key not in CANCELLED:
                    errs.append(err)
                    s0 = (start[0] if key in start[0] else start[1])[key].numpy()
                    assert np.abs(want - s0).max() >= 0.5 * LR, f"{key}: the update is vacuous"
        errs = np.concatenate(errs)
        assert np.quantile(errs, 0.999) <= 0.02 and np.median(errs) <= 1e-3
    # the running statistics moved off the converted ones, and u changed
    for i, key in ((4, "down_blocks.3.1.running_var"), (5, "convs.0.u")):
        assert not np.allclose(out[1][i][key].numpy(), out[0][i][key].numpy()), key


def test_codebook_is_exempt_from_weight_decay():
    """With revival off, a code no latent picked gets a zero gradient, so its
    Adam update is zero: it stays bit for bit where it was, where decay
    (optax.adamw's default 1e-4) would shrink it. Every other parameter
    decays: the gen optimizer's groups are (1e-4, 0). (codec_steps holds the
    codebook's updates to JAX's, the mask included.)"""
    vq, _, _ = make_codec(seed=9)
    disc, _ = make_disc(10)
    cfg = CodecTrainConfig(lr=LR, disc_lr=LR, revive_after=0)
    state = create_codec_train_state(vq, disc, cfg)
    groups = state.gen_opt.param_groups
    assert [g["weight_decay"] for g in groups] == [1e-4, 0.0]
    assert groups[1]["params"] == [vq.vquantizer.codebook.weight]
    assert state.disc_opt.param_groups[0]["weight_decay"] == 1e-4
    before = vq.vquantizer.codebook.weight.detach().clone()
    images = disc_input(11)
    used = np.zeros(VQConfig.tiny().codebook_size, bool)
    used[copy.deepcopy(vq).encode_train(torch.from_numpy(images))[2].reshape(-1).numpy()] = True
    m = make_codec_train_step(vq, disc, cfg)(state, torch.from_numpy(images))
    after = vq.vquantizer.codebook.weight.detach()
    assert int(m["codes_revived"]) == 0 and int(state.code_age.sum()) == 0
    assert 0 < used.sum() < len(used)
    assert torch.equal(after[~used], before[~used])

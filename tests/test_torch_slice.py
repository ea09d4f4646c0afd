"""The port's sampler as a whole against the JAX package's, at the tiny
config on the CPU: CFG sampling from the same weights, conditioning and
(B, 2) uint32 seed pairs, with and without the editing inputs, then decoding.

Both sides run categorical_impl="xla" (the default): the head product in the
compute dtype, then the Gumbel argmax over the same hash bits. Tokens can
still differ where two scores tie within rounding (the port's Gumbel kernel
multiplies by f32(1/T) where the JAX XLA route divides by T), and one flip
changes every later step's input, so a single step is held at an agreement
share of 0.995 (0.99 at bf16) and a four-step run at 0.95.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu.codec import VQModel as JaxVQModel
from paella_tpu.config import SampleConfig as JaxSampleConfig
from paella_tpu.sampling import Conditioning as JaxConditioning
from paella_tpu.sampling import sample as jax_sample
from paella_tpu_torch.config import PaellaConfig, SampleConfig
from paella_tpu_torch.sampling import Conditioning, sample
from tests.test_torch_codec import make_codec
from tests.test_torch_denoiser import make_paella
from tests.test_torch_sampling import seed_pairs

REPO = Path(__file__).resolve().parents[1]
LATENT = (2, 16, 16)


@pytest.fixture(scope="module")
def setup():
    model, jmodel, jparams = make_paella(seed=10)
    cfg = model.config
    rng = np.random.default_rng(11)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cond = dict(byt5=n(2, 6, cfg.byt5_embd), clip=n(2, cfg.clip_embd), clip_image=n(2, cfg.clip_embd))
    uncond = dict(byt5=n(2, 2, cfg.byt5_embd), clip=n(2, cfg.clip_embd))
    return model, jmodel, jparams, cond, uncond, seed_pairs(2, seed=12)


def run_both(setup, extra: dict | None = None, **sample_kw):
    """Tokens of the port and of the JAX sampler (categorical_impl "xla") from
    the same inputs; `extra` holds numpy sampler arguments (init_x,
    fixed_mask, ...) for both."""
    model, jmodel, jparams, cond, uncond, seeds = setup
    extra = extra or {}
    j = lambda d: JaxConditioning(**{k: jnp.asarray(v) for k, v in d.items()})  # noqa: E731
    t = lambda d: Conditioning(**{k: torch.from_numpy(v) for k, v in d.items()})  # noqa: E731
    want = jax_sample(
        jmodel, jparams, jnp.asarray(seeds), j(cond), LATENT, j(uncond),
        JaxSampleConfig(**{**sample_kw, "categorical_impl": "xla"}), **{k: jnp.asarray(v) for k, v in extra.items()},
    )
    got = sample(
        model, torch.from_numpy(seeds.astype(np.int64)), t(cond), LATENT, t(uncond), SampleConfig(**sample_kw),
        **{k: torch.from_numpy(v) for k, v in extra.items()},
    )
    return got.numpy(), np.asarray(want)


def test_one_cfg_step_matches_jax(setup):
    got, want = run_both(setup, steps=1, temperature=(0.9, 0.9), cfg=(3.0, 3.0))
    assert got.shape == want.shape == LATENT and got.dtype == np.int32
    assert (got == want).mean() >= 0.995
    assert len(np.unique(got)) > 10


def test_four_step_cfg_sample_matches_jax(setup):
    got, want = run_both(setup, steps=4, temperature=(1.0, 0.5), cfg=(3.0, 5.0))
    share = (got == want).mean()
    print(f"4-step CFG sample: port and JAX tokens agree on {share:.4f}")
    assert share >= 0.95


def test_fused_head_route_matches_jax(setup):
    """categorical_impl="pallas": the fused head on both sides (the JAX
    Pallas kernel in interpret mode)."""
    model, jmodel, jparams, cond, uncond, seeds = setup
    j = lambda d: JaxConditioning(**{k: jnp.asarray(v) for k, v in d.items()})  # noqa: E731
    t = lambda d: Conditioning(**{k: torch.from_numpy(v) for k, v in d.items()})  # noqa: E731
    kw = dict(steps=1, temperature=(0.9, 0.9), cfg=(3.0, 3.0), categorical_impl="pallas")
    from paella_tpu.kernels import sampling as jax_ksamp

    head = jax_ksamp.fused_head_categorical
    try:  # the Pallas kernel runs in interpret mode on the CPU
        jax_ksamp.fused_head_categorical = lambda *a, **k: head(*a, **k, interpret=True)
        want = jax_sample(jmodel, jparams, jnp.asarray(seeds), j(cond), LATENT, j(uncond), JaxSampleConfig(**kw))
    finally:
        jax_ksamp.fused_head_categorical = head
    got = sample(model, torch.from_numpy(seeds.astype(np.int64)), t(cond), LATENT, t(uncond), SampleConfig(**kw))
    assert (got.numpy() == np.asarray(want)).mean() >= 0.995


def test_init_x_matches_jax(setup):
    """img2img: sampling starts from given tokens at t_start 0.6."""
    x0 = np.random.default_rng(30).integers(0, PaellaConfig.tiny().num_labels, LATENT).astype(np.int32)
    got, want = run_both(setup, extra=dict(init_x=x0), steps=4, t_start=0.6, cfg=(3.0, 3.0))
    share = (got == want).mean()
    print(f"init_x, 4 steps: agree {share:.4f}")
    assert share >= 0.95


def test_fixed_mask_pins_tokens_and_matches_jax(setup):
    rng = np.random.default_rng(31)
    keep = np.zeros(LATENT, bool)
    keep[:, :, :8] = True
    fixed = rng.integers(0, PaellaConfig.tiny().num_labels, LATENT).astype(np.int32)
    got, want = run_both(setup, extra=dict(fixed_mask=keep, fixed_tokens=fixed), steps=4, cfg=(3.0, 3.0))
    np.testing.assert_array_equal(got[keep], fixed[keep])
    np.testing.assert_array_equal(want[keep], fixed[keep])
    share = (got[~keep] == want[~keep]).mean()
    print(f"fixed_mask, 4 steps: free tokens agree {share:.4f}")
    assert share >= 0.95


def test_conditional_cutoff_matches_jax(setup):
    """sampling_conditional_steps=2 of 4: two CFG steps, then two steps of the
    conditional forward alone (batch B, its own cond cache)."""
    got, want = run_both(setup, steps=4, sampling_conditional_steps=2, temperature=(1.0, 0.5), cfg=(3.0, 3.0))
    share = (got == want).mean()
    print(f"cutoff 2 of 4: agree {share:.4f}")
    assert share >= 0.95


def test_cond_reweight_matches_jax(setup):
    """A (1, S_cond) reweight over byt5 (6, padded) + clip (4) + clip_image (4)."""
    rew = np.ones((1, 14), np.float32)
    rew[0, 1:4] = 3.0
    rew[0, 6:10] = 0.5
    got, want = run_both(setup, extra=dict(cond_reweight=rew), steps=1, temperature=(0.9, 0.9), cfg=(3.0, 3.0))
    assert (got == want).mean() >= 0.995
    plain, _ = run_both(setup, steps=1, temperature=(0.9, 0.9), cfg=(3.0, 3.0))
    assert (got != plain).any(), "the reweight should change some tokens"


@pytest.fixture(scope="module")
def setup_bf16():
    model, jmodel, jparams = make_paella(dataclasses.replace(PaellaConfig.tiny(), dtype="bfloat16"), seed=14)
    rng = np.random.default_rng(15)
    cfg = model.config
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cond = dict(byt5=n(2, 6, cfg.byt5_embd), clip=n(2, cfg.clip_embd))
    uncond = dict(byt5=n(2, 2, cfg.byt5_embd), clip=n(2, cfg.clip_embd))
    return model, jmodel, jparams, cond, uncond, seed_pairs(2, seed=16)


def test_bf16_xla_route_matches_jax(setup_bf16):
    """At bf16 the JAX default route draws from logits rounded to bf16, and so
    does the port's "xla" route. Here the two models' bf16 features differ too
    (each framework rounds inside the network on its own), which flips about
    as many tokens as the logits' rounding point does; the head alone is held
    in test_torch_sampling.py::test_xla_route_draws_from_logits_rounded_like_jax."""
    kw = dict(steps=1, temperature=(0.9, 0.9), cfg=(3.0, 3.0))
    got, want = run_both(setup_bf16, **kw)
    share = (got == want).mean()
    fused, _ = run_both(setup_bf16, **kw, categorical_impl="pallas")
    print(f"bf16, one CFG step against JAX xla: port xla {share:.4f}, port fused head {(fused == want).mean():.4f}")
    assert share >= 0.99


@pytest.mark.parametrize("given", ["fixed_mask", "fixed_tokens"])
def test_fixed_mask_and_tokens_go_together(setup, given):
    model, _, _, cond, _, seeds = setup
    t = Conditioning(**{k: torch.from_numpy(v) for k, v in cond.items()})
    arg = torch.zeros(LATENT, dtype=torch.bool if given == "fixed_mask" else torch.int32)
    with pytest.raises(ValueError, match="together"):
        sample(model, torch.from_numpy(seeds.astype(np.int64)), t, LATENT, None, SampleConfig(steps=1), **{given: arg})


def test_decode_of_sampled_tokens_matches_jax(setup):
    got, _ = run_both(setup, steps=2)
    vq, jvq, jvars = make_codec(seed=13)
    idx = got % vq.config.codebook_size
    want = np.asarray(jvq.apply(jvars, jnp.asarray(idx), method=JaxVQModel.decode_indices))
    np.testing.assert_allclose(vq.decode_indices(torch.from_numpy(idx)).numpy(), want, rtol=1e-4, atol=1e-4)


def test_port_imports_no_jax():
    """Every module of the port, the entry points under
    paella_tpu_torch/scripts/ included, imports nothing of JAX, the JAX
    package or the tests."""
    code = (
        "import sys, importlib, pkgutil, paella_tpu_torch\n"
        "for m in pkgutil.walk_packages(paella_tpu_torch.__path__, 'paella_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'paella_tpu', 'tests')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result when there is no
    CUDA device, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present: chip_smoke.py would run the port")
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

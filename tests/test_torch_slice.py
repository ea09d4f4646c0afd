"""The port's main path as a whole against the JAX package's, at the tiny
config in f32 on the CPU: CFG sampling from the same weights, conditioning
and (B, 2) uint32 seed pairs, then decoding.

The JAX side runs its per-image mode with categorical_impl="xla": at f32 its
head's logits are f32 like the port's fused head (the JAX Pallas head and the
XLA head differ only in rounding logits to the compute dtype), so both draw
from the same hash bits. Tokens can still differ where two scores tie within
f32 rounding, and one flip changes every later step's input, so a single step
is held strictly and a whole run by its agreement share.
"""
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
from paella_tpu_torch.config import SampleConfig
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


def run_both(setup, **sample_kw):
    model, jmodel, jparams, cond, uncond, seeds = setup
    j = lambda d: JaxConditioning(**{k: jnp.asarray(v) for k, v in d.items()})  # noqa: E731
    t = lambda d: Conditioning(**{k: torch.from_numpy(v) for k, v in d.items()})  # noqa: E731
    want = jax_sample(
        jmodel, jparams, jnp.asarray(seeds), j(cond), LATENT, j(uncond),
        JaxSampleConfig(categorical_impl="xla", **sample_kw),
    )
    got = sample(model, torch.from_numpy(seeds.astype(np.int64)), t(cond), LATENT, t(uncond), SampleConfig(**sample_kw))
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


def test_sampler_refuses_what_is_not_ported(setup):
    model, _, _, cond, uncond, seeds = setup
    t = lambda d: Conditioning(**{k: torch.from_numpy(v) for k, v in d.items()})  # noqa: E731
    s = torch.from_numpy(seeds.astype(np.int64))
    zeros = torch.zeros(LATENT, dtype=torch.int32)
    for kw in (dict(init_x=zeros), dict(fixed_mask=zeros.bool(), fixed_tokens=zeros),
               dict(cond_reweight=torch.ones(2, 14))):
        with pytest.raises(NotImplementedError):
            sample(model, s, t(cond), LATENT, t(uncond), SampleConfig(steps=2), **kw)
    with pytest.raises(NotImplementedError):
        sample(model, s, t(cond), LATENT, t(uncond), SampleConfig(steps=4, sampling_conditional_steps=2))


def test_decode_of_sampled_tokens_matches_jax(setup):
    got, _ = run_both(setup, steps=2)
    vq, jvq, jvars = make_codec(seed=13)
    idx = got % vq.config.codebook_size
    want = np.asarray(jvq.apply(jvars, jnp.asarray(idx), method=JaxVQModel.decode_indices))
    np.testing.assert_allclose(vq.decode_indices(torch.from_numpy(idx)).numpy(), want, rtol=1e-4, atol=1e-4)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, paella_tpu_torch\n"
        "for m in pkgutil.walk_packages(paella_tpu_torch.__path__, 'paella_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'paella_tpu')]\n"
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

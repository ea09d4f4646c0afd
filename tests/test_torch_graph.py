"""The sampler's split into a host half and a device body, and the structure
key of its captured CUDA graphs (sampling/graph.py), on the CPU.

The key mirrors what the JAX package's single jit `_sample_jit` compiles
for (tests/test_sampler.py: a new cfg, temperature, t span or renoise
count compiles nothing new): schedule values never enter it, while the step
count, the conditional cutoff, the categorical route, the latent shape and a
modality's presence do. The device body, fed its schedules as f32 tensors,
gives the JAX sampler's tokens for the same variants, and the kernels'
plain versions give the same bits with tensor step scalars as with floats.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paella_tpu_torch.config import PaellaConfig, SampleConfig
from paella_tpu_torch.kernels import sampling as ksamp
from paella_tpu_torch.models import Paella
from paella_tpu_torch.nn.blocks import DerivedWeights
from paella_tpu_torch.sampling import Conditioning, graph
from paella_tpu_torch.sampling.sampler import prepare_sample, sample_body
from tests.test_torch_sampling import seed_pairs
from tests.test_torch_slice import run_both, setup  # noqa: F401  (setup: the module-scoped fixture)

LATENT = (2, 16, 16)
BASE = dict(steps=4, cfg=(3.0, 3.0), temperature=(1.0, 0.5))


@pytest.fixture(scope="module")
def tiny():
    model = Paella(PaellaConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    cfg = model.config
    cond = Conditioning(torch.randn(2, 6, cfg.byt5_embd, generator=g), torch.randn(2, cfg.clip_embd, generator=g),
                        torch.randn(2, cfg.clip_embd, generator=g))
    uncond = Conditioning(torch.randn(2, 3, cfg.byt5_embd, generator=g), torch.randn(2, cfg.clip_embd, generator=g))
    return model, cond, uncond


def key_of(tiny, latent=LATENT, uncond=True, **kw):
    model, cond, unc = tiny
    seeds = torch.from_numpy(seed_pairs(latent[0], seed=5).astype(np.int64))
    if latent[0] != cond.batch:
        cond = Conditioning(*(None if v is None else v[: latent[0]] for v in dataclasses.astuple(cond)))
        unc = Conditioning(*(None if v is None else v[: latent[0]] for v in dataclasses.astuple(unc)))
    structure, inputs = prepare_sample(model, seeds, cond, latent, unc if uncond else None, SampleConfig(**{**BASE, **kw}))
    return graph.graph_key(model, structure, inputs)


@pytest.mark.parametrize("change", [
    dict(cfg=(7.0, 2.0)), dict(temperature=(0.3, 0.1)), dict(t_start=0.6), dict(t_end=0.1), dict(renoise_steps=1),
])
def test_schedule_values_share_one_graph(tiny, change):
    """cfg, temperature, the t span and the renoise count are values in the
    graph's input buffers, not part of its key."""
    assert key_of(tiny, **change) == key_of(tiny)


@pytest.mark.parametrize("change", [
    dict(steps=5), dict(sampling_conditional_steps=2), dict(categorical_impl="pallas"), dict(latent=(1, 16, 16)),
    dict(latent=(2, 16, 32)), dict(uncond=False), dict(cfg=None),
])
def test_structure_changes_the_graph(tiny, change):
    assert key_of(tiny, **change) != key_of(tiny)


def test_a_missing_modality_changes_the_graph(tiny):
    model, cond, uncond = tiny
    seeds = torch.from_numpy(seed_pairs(2, seed=5).astype(np.int64))
    keys = []
    for c in (cond, dataclasses.replace(cond, clip_image=None), dataclasses.replace(cond, clip_mask=torch.ones(2, dtype=torch.bool))):
        structure, inputs = prepare_sample(model, seeds, c, LATENT, uncond, SampleConfig(**BASE))
        keys.append(graph.graph_key(model, structure, inputs))
    assert len(set(keys)) == 3


@pytest.mark.parametrize("drop", ["drop_derived", "to", "load_state_dict"])
def test_dropping_derived_weights_changes_the_graph(tiny, drop):
    """A captured graph holds the addresses of the weights it read: every
    way of dropping derived weights moves the generation in its key."""
    model = tiny[0]
    before, gen = key_of(tiny), DerivedWeights.generation
    if drop == "drop_derived":
        model.drop_derived()
    elif drop == "to":
        model.to(torch.float32)
    else:
        model.load_state_dict(model.state_dict())
    assert DerivedWeights.generation > gen
    assert key_of(tiny) != before


@pytest.mark.parametrize("change", [dict(act_quant=True), dict(attention_impl="pallas"), dict(attn_block_kernel=True)])
def test_a_new_config_on_the_same_model_changes_the_graph(tiny, change):
    """The forward reads model.config on every call (act_quant, the
    attention kernels), and quant.py replaces it in place: a graph captured
    under the old config must not replay under the new one."""
    model = tiny[0]
    before, old = key_of(tiny), model.config
    try:
        model.config = dataclasses.replace(old, **change)
        assert key_of(tiny) != before
    finally:
        model.config = old
    assert key_of(tiny) == before


def test_schedule_is_computed_on_the_host_in_f32(tiny):
    model, cond, uncond = tiny
    seeds = torch.from_numpy(seed_pairs(2, seed=5).astype(np.int64))
    cfg = SampleConfig(steps=4, cfg=(3.0, 5.0), temperature=(1.0, 0.5), t_start=0.9, renoise_steps=2)
    _, inputs = prepare_sample(model, seeds, cond, LATENT, uncond, cfg)
    sched = inputs["schedule"]
    assert sched.dtype == torch.float32 and sched.shape == (4, 5)
    np.testing.assert_array_equal(sched[0].numpy(), np.linspace(np.float32(0.9), np.float32(0.0), 5, dtype=np.float64).astype(np.float32))
    np.testing.assert_array_equal(sched[2, :4].numpy(), np.float32([3.0, 3.0 + 2 / 3, 3.0 + 4 / 3, 5.0]))
    np.testing.assert_array_equal(sched[3, :4].numpy(), [1.0, 1.0, 0.0, 0.0])
    assert inputs["uncond.byt5"] is not None
    _, no_cfg = prepare_sample(model, seeds, cond, LATENT, uncond, dataclasses.replace(cfg, cfg=None))
    assert all(no_cfg[f"uncond.{f}"] is None for f in ("byt5", "clip", "clip_image"))


@pytest.mark.parametrize("kw", [
    dict(steps=4, cfg=(5.0, 2.0), temperature=(0.8, 0.3)),
    dict(steps=4, cfg=(3.0, 3.0), t_start=0.8, t_end=0.1),
    dict(steps=4, cfg=(3.0, 3.0), renoise_steps=2),
])
def test_device_body_with_tensor_schedules_matches_jax(setup, kw):  # noqa: F811
    """The port's sample (on the CPU: prepare_sample, then sample_body with
    its schedules as f32 tensors) against the JAX sampler for the values
    that share one graph."""
    got, want = run_both(setup, **kw)
    share = (got == want).mean()
    print(f"{kw}: agree {share:.4f}")
    assert share >= 0.95


def test_sample_body_is_sample(tiny):
    """sample on the CPU is prepare_sample then sample_body, and sample_eager
    gives the same tokens."""
    from paella_tpu_torch.sampling import sample, sample_eager

    model, cond, uncond = tiny
    seeds = torch.from_numpy(seed_pairs(2, seed=6).astype(np.int64))
    cfg = SampleConfig(steps=3, cfg=(3.0, 4.0), temperature=(0.9, 0.4))
    got = sample(model, seeds, cond, LATENT, uncond, cfg)
    assert torch.equal(sample_eager(model, seeds, cond, LATENT, uncond, cfg), got)
    assert torch.equal(sample_body(model, *prepare_sample(model, seeds, cond, LATENT, uncond, cfg)), got)


def test_plain_versions_take_tensor_scalars_bit_for_bit():
    """head_categorical_plain and gumbel_categorical_plain give the same
    tokens with the step scalars as 0-d and 1-element f32 tensors as with
    floats, and form 1 - w and 1 / T as correctly rounded f32 arithmetic,
    the JAX kernels' arithmetic on their f32 scalars."""
    rng = np.random.default_rng(7)
    seeds = torch.from_numpy(seed_pairs(2, seed=7).astype(np.int64))
    fc = torch.from_numpy(rng.standard_normal((2, 8, 8, 32)).astype(np.float32))
    fu = torch.from_numpy(rng.standard_normal((2, 8, 8, 32)).astype(np.float32))
    w_out = torch.from_numpy((rng.standard_normal((300, 32)) * 0.3).astype(np.float32))
    logits = torch.from_numpy((rng.standard_normal((2, 8, 8, 300)) * 3).astype(np.float32))
    for cw, temp in ((3.0, 0.8), (7.3, 0.37), (1.0 / 3.0, 1.7)):
        for as_t in (lambda v: torch.tensor(v, dtype=torch.float32), lambda v: torch.tensor([v], dtype=torch.float32)):
            want = ksamp.head_categorical_plain(seeds, fc, fu, cw, w_out, temp)
            assert torch.equal(ksamp.head_categorical_plain(seeds, fc, fu, as_t(cw), w_out, as_t(temp)), want)
            want = ksamp.gumbel_categorical_plain(seeds, logits, temp)
            assert torch.equal(ksamp.gumbel_categorical_plain(seeds, logits, as_t(temp)), want)
        w, t = np.float32(cw), np.float32(temp)
        sw, st = ksamp.step_scalar(cw, torch.device("cpu")), ksamp.step_scalar(temp, torch.device("cpu"))
        assert (sw.item(), (1.0 - sw).item(), st.reciprocal().item()) == (w, np.float32(1) - w, np.float32(1) / t)
    with pytest.raises(ValueError, match="one float32"):
        ksamp.step_scalar(torch.ones(2), torch.device("cpu"))

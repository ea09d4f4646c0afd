"""The port's training driver (train/driver.py), checkpoints
(train/checkpoints.py) and logging (utils/logging.py) at the tiny configs on
the CPU, with the behaviours tests/test_driver.py checks in JAX: a run
resumes and ends where an uninterrupted run ends, encode prefetch changes
nothing, a checkpoint round-trips (bf16 moments, update count, the draw
generator), SIGTERM saves and the run resumes from it, the eval grid has its
five rows, and rotation keeps max_to_keep (against orbax's manager). Also
fault C6: an inference forward and `sample` after a train step read the new
parameters, not stale derived weights."""
import dataclasses
import itertools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu_torch.codec import VQModel
from paella_tpu_torch.config import PaellaConfig, SampleConfig, TrainConfig, VQConfig
from paella_tpu_torch.models import Paella
from paella_tpu_torch.sampling import Conditioning, sample
from paella_tpu_torch.train import (
    CheckpointManager,
    DriverConfig,
    create_train_state,
    load_params_npz,
    make_synthetic_encode_fn,
    make_train_step,
    run_training,
    save_params_npz,
)
from paella_tpu_torch.train.driver import _eval_grid, checkpoint_state, eval_seeds, restore_checkpoint
from paella_tpu_torch.utils.logging import MetricLogger, StepTimer, save_image_grid
from tests.test_torch_denoiser import perturbed_state_dict

CFG = PaellaConfig.tiny()


def tiny_models(seed: int = 0):
    """A perturbed tiny denoiser (its clf is zero at init) and a tiny codec."""
    model, vq = Paella(CFG), VQModel(VQConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(seed))
    perturbed_state_dict(model, seed + 1)
    vq.reset_parameters(torch.Generator().manual_seed(seed + 2))
    return model, vq


def encoder():
    return make_synthetic_encode_fn(CFG.byt5_embd, CFG.clip_embd, seq_len=8, device="cpu")


def one_batch(b: int = 4, seed: int = 0):
    images = np.random.default_rng(seed).uniform(size=(b, 64, 64, 3)).astype(np.float32)
    return images, [f"caption {i}" for i in range(b)]


def params_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_inference_after_a_train_step_reads_the_new_parameters():
    """Fault C6: DerivedWeights cached the kernel layouts of the first
    forward, and AdamW updates the parameters in place. After two steps (the
    first at lr 0) the inference forward and an 8-step `sample` equal a fresh
    model's loaded from the stepped state dict, bit for bit."""
    model, vq = tiny_models(3)
    enc, null = encoder()
    batch = enc(*one_batch())
    x = torch.randint(0, CFG.num_labels, (2, 16, 16), generator=torch.Generator().manual_seed(4))
    r = torch.tensor([0.3, 0.8])
    args = (x, r, batch.byt5[:2], batch.clip[:2], batch.clip_image[:2])
    before = model(*args, byt5_mask=batch.byt5_mask[:2])  # fills the derived weights
    cfg = TrainConfig(warmup_updates=1, lr=1e-2)
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg)
    for _ in range(2):
        step(state, batch, null)
    fresh = Paella(CFG)
    fresh.load_state_dict(model.state_dict())
    want = fresh(*args, byt5_mask=batch.byt5_mask[:2])
    got = model(*args, byt5_mask=batch.byt5_mask[:2])
    assert (want - before).abs().max() > 1e-3, "the update is vacuous"
    assert torch.equal(got, want)
    cond = Conditioning(byt5=batch.byt5[:2], clip=batch.clip[:2], byt5_mask=batch.byt5_mask[:2])
    uncond = Conditioning(byt5=null.byt5.expand(2, -1, -1), clip=null.clip.expand(2, -1), byt5_mask=null.byt5_mask.expand(2, -1))
    seeds = eval_seeds(5, 2)
    s_cfg = SampleConfig(steps=8)
    assert torch.equal(sample(model, seeds, cond, (2, 16, 16), uncond, s_cfg),
                       sample(fresh, seeds, cond, (2, 16, 16), uncond, s_cfg))


def driver_cfg(workdir, **kw) -> DriverConfig:
    return DriverConfig(workdir=str(workdir), **{**dict(total_steps=4, log_every=1, eval_every=2, eval_steps=2), **kw})


def run(workdir, model, vq, data, t_cfg=TrainConfig(warmup_updates=1, lr=1e-3), sample_eval=False, **kw):
    enc, null = encoder()
    return run_training(model, vq, data, enc, null, t_cfg, driver_cfg(workdir, **kw), sample_eval=sample_eval)


def losses(workdir) -> list:
    with open(os.path.join(workdir, "metrics.jsonl")) as fh:
        return [(r["step"], r["loss"]) for r in map(json.loads, fh) if "loss" in r]


def test_run_resumes_and_ends_as_an_uninterrupted_run(tmp_path):
    """Four steps in one run against two runs of two steps, the second from
    fresh objects (other weights) resuming the first's step-2 checkpoint:
    the same parameters bit for bit, the same losses for steps 3 and 4, and
    the step count. The data repeats one batch, so both runs see the same
    batches; the eval grids draw from generators of their own."""
    images, captions = one_batch()
    model, vq = tiny_models()
    full = run(tmp_path / "full", model, vq, itertools.repeat((images, captions)), sample_eval=True)
    assert full.step == 4 and sorted(os.listdir(tmp_path / "full" / "checkpoints")) == ["2", "4"]
    first, vq1 = tiny_models()
    assert run(tmp_path / "split", first, vq1, itertools.repeat((images, captions)), total_steps=2,
               sample_eval=True).step == 2
    resumed, _ = tiny_models(seed=11)
    state = run(tmp_path / "split", resumed, vq1, itertools.repeat((images, captions)), sample_eval=True)
    assert state.step == 4 and state.optimizer.count == 4
    want = params_of(model)
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert losses(tmp_path / "split")[2:] == losses(tmp_path / "full")[2:]


def test_encode_prefetch_changes_nothing(tmp_path):
    """encode_prefetch only changes WHEN the host work runs (a producer
    thread), never the math: the same parameters and loss trajectory with
    it on and off (tests/test_driver.py::test_encode_prefetch_parity)."""
    out = {}
    for pf in (0, 1):
        model, vq = tiny_models()
        data = itertools.islice(((one_batch(seed=i)) for i in itertools.count()), 100)
        run(tmp_path / f"run{pf}", model, vq, data, total_steps=3, eval_every=100, encode_prefetch=pf)
        out[pf] = params_of(model), losses(tmp_path / f"run{pf}")
    assert len(out[0][1]) == 3 and out[0][1] == out[1][1]
    for k, v in out[0][0].items():
        assert torch.equal(v, out[1][0][k]), k


def test_checkpoint_round_trips_moments_count_and_generator(tmp_path):
    """bf16 Adam moments stay bf16 through a save and a restore (torch's
    Optimizer.load_state_dict would cast them to the parameters' f32), with
    the update count, the skips, the step and the draw generator: the
    restored state's next step equals the original's next step bit for bit
    (tests/test_driver.py::test_checkpoint_roundtrip_bf16_moments)."""
    cfg = TrainConfig(warmup_updates=1, lr=1e-3, adam_moment_dtype="bfloat16")
    enc, null = encoder()
    batch = enc(*one_batch())
    model, vq = tiny_models()
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg)
    for _ in range(2):
        step(state, batch, null)
    state.optimizer.param_groups[0]["nonfinite_skips"] = 3  # carried like the count
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval=1)
    assert mgr.save(2, checkpoint_state(model, state), force=True)
    mgr.wait()

    other, _ = tiny_models(seed=5)
    restored = create_train_state(other, cfg, torch.Generator().manual_seed(99))
    assert restore_checkpoint(mgr, other, restored)
    assert restored.step == 2 and restored.optimizer.count == 2 and restored.optimizer.nonfinite_skips == 3
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(p, q)
        for k in ("mu", "nu"):
            a, b = state.optimizer.state[p][k], restored.optimizer.state[q][k]
            assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    m1, m2 = step(state, batch, null), make_train_step(other, vq, cfg)(restored, batch, null)
    assert float(m1["loss"]) == float(m2["loss"])
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(p, q)


def test_sigterm_saves_and_the_run_resumes(tmp_path):
    """SIGTERM mid-run: the loop finishes the step in flight, saves a
    checkpoint at that step and returns; the handlers are put back; a new
    run resumes from the stop step
    (tests/test_driver.py::test_graceful_preemption_saves_and_resumes)."""
    images, captions = one_batch()

    def preempting_data():
        for i in itertools.count():
            if i == 2:  # after two clean steps
                os.kill(os.getpid(), signal.SIGTERM)
            yield images, captions

    model, vq = tiny_models()
    state = run(tmp_path / "run", model, vq, preempting_data(), total_steps=10, log_every=100, eval_every=100)
    stopped_at = state.step
    assert 0 < stopped_at < 10
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    assert CheckpointManager(str(tmp_path / "run" / "checkpoints")).all_steps() == [stopped_at]
    resumed, _ = tiny_models(seed=7)
    state = run(tmp_path / "run", resumed, vq, itertools.repeat((images, captions)), total_steps=stopped_at + 1,
                log_every=100, eval_every=100)
    assert state.step == stopped_at + 1 and state.optimizer.count == stopped_at + 1


def test_eval_grid_writes_five_rows(tmp_path):
    """The five rows (orig / noised / soft-argmax reconstruction / sampled
    with the image conditioning / without it, src_distributed/train.py:140-183)
    as one jpg and as uint8 rows with the sampled tokens in an .npz; the
    prompts-only grid has the sampled row alone
    (tests/test_driver.py::test_eval_grid_collage)."""
    pytest.importorskip("PIL")
    from PIL import Image

    model, vq = tiny_models()
    enc, _ = encoder()
    d_cfg = driver_cfg(tmp_path)
    images, _ = one_batch(b=2)
    names = _eval_grid(model, vq, enc, d_cfg, step=7, workdir=str(tmp_path), images=images, captions=["a cat", "a dog"])
    assert names == ["orig", "noised", "reconstructed", "sampled", "sampled_noimg"]
    w, h = Image.open(tmp_path / "eval_0000007.jpg").size
    assert h > 5 * 64 and w > 2 * 64  # five rows, two columns
    with np.load(tmp_path / "eval_0000007.npz") as grid:
        assert all(grid[n].shape == (2, 64, 64, 3) and grid[n].dtype == np.uint8 for n in names)
        np.testing.assert_array_equal(grid["orig"], (images * 255).astype(np.uint8))
        assert grid["tokens"].shape == grid["tokens_noimg"].shape == (2, 16, 16)
    assert _eval_grid(model, vq, enc, d_cfg, step=8, workdir=str(tmp_path)) == ["sampled"]
    assert (tmp_path / "eval_0000008.jpg").exists()
    seeds = eval_seeds(8, 3)
    assert seeds.shape == (3, 2) and len({tuple(s) for s in seeds.tolist()}) == 3


@pytest.mark.parametrize("max_to_keep,interval", [(2, 1), (3, 2)])
def test_rotation_and_save_decisions_match_orbax(tmp_path, max_to_keep, interval):
    """The same save calls (the first, on and off the interval, forced,
    behind the latest) on the port's manager and on the JAX package's orbax
    wrapper: the same answers, and the same steps kept after each; a forced
    save of a saved step raises in both."""
    from paella_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager

    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=max_to_keep, save_interval=interval)
    ref = JaxCheckpointManager(str(tmp_path / "orbax"), max_to_keep=max_to_keep, save_interval=interval)
    calls = [(1, False), (2, False), (3, False), (3, True), (4, False), (5, True), (5, False), (6, False),
             (2, False), (7, False), (8, False)]
    for step, force in calls:
        if step in port.all_steps() and force:
            with pytest.raises(Exception, match="already exists"):
                ref.save(step, {"w": jnp.zeros((2,))}, force=True)
            with pytest.raises(FileExistsError):
                port.save(step, {"w": torch.zeros(2)}, force=True)
            continue
        want = ref.save(step, {"w": jnp.full((2,), step, jnp.float32)}, force=force)
        ref.wait()
        got = port.save(step, {"w": torch.full((2,), float(step))}, force=force)
        assert got == bool(want), (step, force)
        assert port.all_steps() == ref.all_steps(), (step, force)
    assert port.latest_step() == ref.latest_step() and len(port.all_steps()) == max_to_keep
    saved, _ = port.restore(None)
    assert float(saved["w"][0]) == port.latest_step()
    ref.close()


def test_params_npz_round_trips_with_the_jax_files(tmp_path):
    """save_params_npz writes the JAX package's flat '/' layout: each
    package reads the other's file."""
    from paella_tpu.train.checkpoints import load_params_npz as jax_load
    from paella_tpu.train.checkpoints import save_params_npz as jax_save

    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.ones(3, np.float32)},
            "b": np.zeros((2,), np.int32)}
    save_params_npz(str(tmp_path / "port.npz"), {"a": {k: torch.from_numpy(v) for k, v in tree["a"].items()},
                                                  "b": tree["b"]})
    jax_save(str(tmp_path / "jax.npz"), tree)
    for got in (jax_load(str(tmp_path / "port.npz")), load_params_npz(str(tmp_path / "jax.npz"))):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, tree)


def test_synthetic_encode_fn_matches_jax():
    """The hash embeddings of make_synthetic_encode_fn equal the JAX
    package's in the same process, and its NullCond too."""
    from paella_tpu.train.driver import make_synthetic_encode_fn as jax_make

    enc, null = encoder()
    jenc, jnull = jax_make(CFG.byt5_embd, CFG.clip_embd, seq_len=8)
    images, captions = one_batch(b=3)
    got, want = enc(images, captions), jenc(images, captions)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)), err_msg=f.name)
    for f in dataclasses.fields(null):
        np.testing.assert_array_equal(getattr(null, f.name).numpy(), np.asarray(getattr(jnull, f.name)), err_msg=f.name)


def test_logging_matches_jax(tmp_path):
    """MetricLogger writes the JAX package's JSONL records (but the wall
    time), save_image_grid the same jpg bytes, StepTimer the same rate."""
    pytest.importorskip("PIL")
    from paella_tpu.utils.logging import MetricLogger as JaxMetricLogger
    from paella_tpu.utils.logging import save_image_grid as jax_grid

    for name, cls in (("port", MetricLogger), ("jax", JaxMetricLogger)):
        log = cls(str(tmp_path / name), print_every=0)
        log.log(3, {"loss": torch.tensor(1.5), "acc": np.float32(0.25), "note": "x"})
        log.close()
    rows = [[{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in open(tmp_path / name / "metrics.jsonl")] for name in ("port", "jax")]
    assert rows[0] == rows[1] == [{"step": 3, "loss": 1.5, "acc": 0.25, "note": "x"}]
    grid = [np.random.default_rng(i).uniform(size=(2, 8, 8, 3)).astype(np.float32) for i in range(3)]
    assert save_image_grid(str(tmp_path / "a.jpg"), grid) and jax_grid(str(tmp_path / "b.jpg"), grid)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    timer = StepTimer(window=3)
    timer._times = [0.0, 0.5, 1.0, 1.5]
    assert timer.steps_per_sec == 2.0

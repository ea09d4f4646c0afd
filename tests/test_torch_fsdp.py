"""FSDP in the port's training (parallel/mesh.py::shard_model, AdamW over
sharded gradients, run_training at DriverConfig.fsdp > 1) over real OS
processes on gloo, the counterpart of the JAX driver's (dp, fsdp) mesh:
two ranks at fsdp 2 and four at dp 2 x fsdp 2 (HSDP) step as the single
process does on the whole batch, the parameters are really sharded, a
non-finite gradient on one rank makes every rank skip, and a checkpoint
moves between world sizes in both directions. The chain to JAX: these
steps equal the port's single-process step, which tests/test_torch_train.py
holds to JAX's."""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paella_tpu_torch.parallel import fsdp_param_spec
from paella_tpu_torch.train import CheckpointManager, DriverConfig, create_train_state, make_train_step, run_training
from paella_tpu_torch.train import driver as driver_module
from paella_tpu_torch.train.driver import restore_checkpoint
from tests._torch_ddp_worker import STEPS, build_case
from tests._torch_fsdp_worker import DRIVER, driver_case, driver_train_config

WORKER = os.path.join(os.path.dirname(__file__), "_torch_fsdp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(n: int, fsdp: int, out, ckpt_dir=None) -> list:
    """Run n workers (each with a 240 s limit) and load what each wrote.
    They meet through a file in `out` (no TCP port to pick and hold)."""
    coordinator = (out / "rendezvous").as_uri()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    extra = [str(ckpt_dir)] if ckpt_dir is not None else []
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, str(n), str(i), str(fsdp), str(out)] + extra,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in log, f"worker {i}:\n{log}"
    phases = ("steps", "skip", "driver", "resumed") if ckpt_dir is not None else ("steps", "skip")
    return [{ph: torch.load(out / f"rank{i}_{ph}.pt", weights_only=True) for ph in phases} for i in range(n)]


@pytest.fixture(scope="module")
def world1_run(tmp_path_factory):
    """run_training at world size 1 with the driver phase's case and config:
    its workdir (a checkpoint at step 2)."""
    d = tmp_path_factory.mktemp("world1")
    model, vq, enc, null, data = driver_case(seed=0)
    run_training(model, vq, data, enc, null, driver_train_config(), DriverConfig(workdir=str(d), **DRIVER))
    return d


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, world1_run):
    """Two workers at fsdp 2; the resume phase from a copy of world1_run."""
    out = tmp_path_factory.mktemp("fsdp2")
    ckpt_dir = out / "from_world1"
    shutil.copytree(world1_run, ckpt_dir)
    return _launch(2, 2, out, ckpt_dir), out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Four workers on a (2, 2) mesh: dp 2 x fsdp 2."""
    out = tmp_path_factory.mktemp("hsdp")
    return _launch(4, 2, out)


@pytest.fixture(scope="module")
def single_process():
    """The single-process steps on the whole batch: per step the metrics
    and gradients; then the parameters and the initial ones."""
    model, vq, cfg, batch, null, draws = build_case(seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = dataclasses.replace(cfg, grad_accum_steps=1)
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg)
    metrics, grads = [], []
    for d in draws:
        metrics.append({k: float(v) for k, v in step(state, batch, null, [d]).items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert state.step == STEPS
    return metrics, grads, {k: v.detach().clone() for k, v in model.state_dict().items()}, init, cfg.lr


def _assert_steps_match(results, single_process):
    """Every rank's gathered parameters and metrics alike, bit for bit (rank
    1 and up started from other weights: shard_model broadcasts rank 0's);
    against the single-process steps, the tolerances of
    tests/test_torch_distributed.py::test_ddp_train_steps_equal_the_single_process_steps:
    loss, acc, grad_norm to 1e-5 relative, every gradient within 1e-5 of
    its tensor's largest, after step 2 99.9% of the parameters within 0.02
    lr and all within 2.1 lr."""
    metrics, grads, params, init, lr = single_process
    steps = [r["steps"] for r in results]
    for k, v in steps[0]["params"].items():
        assert all(torch.equal(v, s["params"][k]) for s in steps[1:]), k
    assert all(s["metrics"] == steps[0]["metrics"] for s in steps[1:])
    assert all(s["count"] == STEPS for s in steps)
    for i in range(STEPS):
        got = steps[0]["metrics"][i]
        for key in ("loss", "acc", "grad_norm"):
            assert got[key] == pytest.approx(metrics[i][key], rel=1e-5, abs=1e-7), (i, key)
        for name, g in grads[i].items():
            peak = g.abs().max().item()
            assert (steps[0]["grads"][i][name] - g).abs().max().item() <= 1e-5 * max(peak, 1e-12), (i, name)
    errs = torch.cat([((steps[0]["params"][k] - v).abs() / lr).reshape(-1) for k, v in params.items()])
    moved = torch.cat([(v - init[k]).abs().reshape(-1) for k, v in params.items()])
    assert (moved > 0.5 * lr).float().mean() > 0.5, "the update is vacuous"
    assert torch.quantile(errs, 0.999).item() <= 0.02 and errs.max().item() <= 2.1


def test_fsdp2_steps_equal_the_single_process_steps(two_ranks, single_process):
    """(a) Two ranks at fsdp 2, two microbatches each, two steps."""
    results, _ = two_ranks
    assert results[0]["steps"]["mesh"] == [1, 2]
    _assert_steps_match(results, single_process)


def test_hsdp_four_ranks_equal_the_single_process_steps(four_ranks, single_process):
    """(e) Four ranks on the (2, 2) mesh: replicated over dp, sharded over
    fsdp, the dp all-reduce on the last microbatch only. Each dp group
    steps on its own copy of the batch, so the mean is the whole batch's."""
    assert four_ranks[0]["steps"]["mesh"] == [2, 2]
    _assert_steps_match(four_ranks, single_process)


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_fsdp_shards_are_real(ranks, request):
    """(b) Each parameter's local shard is its rank's part: a parameter the
    JAX rule shards holds half its elements along that rule's axis; every
    other one is split along axis 0 (FSDP2 has no replicated parameter)."""
    results = request.getfixturevalue(ranks)
    results = results[0] if ranks == "two_ranks" else results
    big = 0
    for rank, r in enumerate(results):
        for name, (local, shape, placements) in r["steps"]["shards"].items():
            axis = fsdp_param_spec(shape, 2)
            assert placements == ["R", f"S({0 if axis is None else axis})"], (name, placements)
            if axis is not None:
                big += 1
                want = list(shape)
                want[axis] //= 2
                assert list(local) == want, (rank, name, local, shape)
            else:  # torch.chunk's split along axis 0 at this rank's fsdp coordinate (rank % 2)
                chunks = torch.arange(shape[0]).chunk(2)
                rows = len(chunks[rank % 2]) if rank % 2 < len(chunks) else 0
                assert list(local) == [rows] + list(shape[1:]), (rank, name, local, shape)
    assert big >= 4, "no parameter of the tiny model is large enough for the JAX rule"


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_nonfinite_gradient_on_one_rank_skips_on_every_rank(ranks, request):
    """(c) An inf written into the last rank's gradient shard only, before
    AdamW runs: every rank skips (nonfinite_skips 1, the update count
    unchanged) and the parameters stay as they were, alike on every rank."""
    results = request.getfixturevalue(ranks)
    results = results[0] if ranks == "two_ranks" else results
    skips = [r["skip"] for r in results]
    assert all(s["metrics"]["nonfinite_skips"] == 1 for s in skips), [s["metrics"] for s in skips]
    assert all(s["count"] == STEPS for s in skips)
    for k, v in skips[0]["before"].items():
        assert all(torch.equal(v, s["after"][k]) and torch.equal(v, s["before"][k]) for s in skips), k


def _layout(tree):
    """A state dict's structure: tensors as (shape, dtype), numbers kept."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return type(tree)


def test_fsdp_checkpoint_is_the_world_size_1_layout_and_loads_there(two_ranks, world1_run):
    """(d) run_training at fsdp 2 (2 steps, eval_every 2) writes one
    checkpoint whose model and optimizer entries have the keys, shapes and
    dtypes (bf16 moments) of the world-size-1 run's; loaded into a plain
    model and AdamW at world size 1 it equals the ranks' gathered
    parameters; rank 0 wrote the eval grid, whose sampled tokens a plain
    model loaded from that checkpoint draws again."""
    results, out = two_ranks
    run = out / "fsdp_run"
    steps = CheckpointManager(str(run / "checkpoints")).all_steps()
    assert steps == [2]
    got = CheckpointManager(str(run / "checkpoints")).restore(None, 2)[0]
    want = CheckpointManager(str(world1_run / "checkpoints")).restore(None, 2)[0]
    assert _layout(got["model"]) == _layout(want["model"])
    assert _layout(got["optimizer"]) == _layout(want["optimizer"])
    assert {s["mu"].dtype for s in got["optimizer"]["state"].values()} == {torch.bfloat16}
    assert got["step"] == 2 and got["optimizer"]["param_groups"][0]["count"] == 2
    assert len(got["generators"]) == 2

    model, vq, enc, null, data = driver_case(seed=5)
    state = create_train_state(model, driver_train_config())
    assert restore_checkpoint(CheckpointManager(str(run / "checkpoints")), model, state)
    for r in results:
        assert r["driver"]["step"] == 2 and r["driver"]["count"] == 2
        for k, p in model.named_parameters():
            assert torch.equal(p.detach(), r["driver"]["params"][k]), k
    assert state.optimizer.count == 2 and state.step == 2
    for i, p in enumerate(model.parameters()):
        assert state.optimizer.state[p]["mu"].dtype == torch.bfloat16
        assert torch.equal(state.optimizer.state[p]["nu"], got["optimizer"]["state"][i]["nu"])
    assert (run / "eval_0000002.npz").exists()
    grid = np.load(run / "eval_0000002.npz")
    assert grid["tokens"].shape == (4, 16, 16) and grid["sampled"].shape == (4, 64, 64, 3)
    assert results[0]["driver"]["grid_tokens_equal"] == [True, True]


def test_world_size_1_checkpoint_resumes_at_fsdp2(two_ranks, world1_run):
    """(d) The world-size-1 run's step-2 checkpoint, resumed by
    run_training at fsdp 2 (from other weights on each rank): both ranks'
    gathered parameters equal the checkpoint's, bit for bit, and the
    gathered optimizer state equals its moments, count and step."""
    results, _ = two_ranks
    want = CheckpointManager(str(world1_run / "checkpoints")).restore(None, 2)[0]
    for r in results:
        for k, v in r["resumed"]["params"].items():
            assert torch.equal(v, want["model"][k]), k
    snap = results[0]["resumed"]["snapshot"]
    assert snap["step"] == 2
    for k, v in want["model"].items():
        assert torch.equal(snap["model"][k], v), k
    assert snap["optimizer"]["param_groups"][0]["count"] == want["optimizer"]["param_groups"][0]["count"] == 2
    for i, s in want["optimizer"]["state"].items():
        for key in ("mu", "nu"):
            assert snap["optimizer"]["state"][i][key].dtype == torch.bfloat16
            assert torch.equal(snap["optimizer"]["state"][i][key], s[key].cpu()), (i, key)


def test_fsdp_that_does_not_divide_the_world_raises(tmp_path):
    """(f) make_mesh refuses fsdp that does not divide the world, as JAX's
    make_mesh does, before any collective; so does run_training at world
    size 1 and fsdp 2."""
    from paella_tpu_torch.parallel import make_mesh

    for fsdp, world in ((3, 2), (2, 3), (4, 2), (0, 2)):
        with pytest.raises(ValueError, match="devices"):
            make_mesh(fsdp, world, "cpu")
    model, vq, enc, null, data = driver_case(seed=0)
    with pytest.raises(ValueError, match="1 devices"):
        run_training(model, vq, data, enc, null, driver_train_config(),
                     DriverConfig(workdir=str(tmp_path), fsdp=2, **DRIVER))


def test_fsdp_1_builds_the_ddp_route(tmp_path, monkeypatch):
    """(f) At fsdp 1 with a process group run_training wraps the model with
    data_parallel, as before, and never shards it."""
    calls = []

    def no_shard(*args, **kwargs):
        raise AssertionError("shard_model called at fsdp 1")

    def fake_ddp(model, group):
        calls.append(group)
        return None  # make_train_step then steps without DDP: one process, no group

    monkeypatch.setattr(driver_module, "shard_model", no_shard)
    monkeypatch.setattr(driver_module, "data_parallel", fake_ddp)
    model, vq, enc, null, data = driver_case(seed=0)
    group = object()
    state = run_training(model, vq, data, enc, null, driver_train_config(),
                         DriverConfig(workdir=str(tmp_path), total_steps=1, eval_every=5, log_every=1, encode_prefetch=0),
                         sample_eval=False, process_group=group)
    assert calls == [group] and state.step == 1
    with pytest.raises(ValueError, match="process_group"):
        run_training(model, vq, data, enc, null, driver_train_config(),
                     DriverConfig(workdir=str(tmp_path / "b"), fsdp=2, **DRIVER), process_group=group)

"""The port's data parallelism (parallel/) over two real OS processes on
gloo, the counterpart of tests/test_distributed.py's data-stream (:63) and
train-step (:199) tests: each rank reads a disjoint share of the shards by
default, and two DDP train steps (each rank two microbatches of its half of
the batch, the first under no_sync) equal the single-process steps on the
whole batch. Also the FSDP sharding rule against the JAX package's."""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_ddp_worker import STEPS, build_case

WORKER = os.path.join(os.path.dirname(__file__), "_torch_ddp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the two workers (240 s limit) on four shards of three samples."""
    pytest.importorskip("PIL")
    from paella_tpu_torch.data import write_tar_shard
    from tests.test_data import png_bytes

    d = tmp_path_factory.mktemp("ddp")
    all_caps = set()
    for s in range(4):
        samples = [(f"shard{s}_sample{j}", {"png": png_bytes(40, 40, s * 10 + j), "txt": f"shard{s}_sample{j}".encode()})
                   for j in range(3)]
        all_caps.update(k for k, _ in samples)
        write_tar_shard(str(d / f"shard-{s:03d}.tar"), samples)
    coordinator, n = f"127.0.0.1:{_free_port()}", 2
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, str(n), str(i), str(d), str(d / f"rank{i}.pt")],
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
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, f"worker {i}:\n{out}"
    streams = [set(c for c in next(ln for ln in out.splitlines() if ln.startswith("CAPS="))[5:].split(";") if c)
               for out in outs]
    results = [torch.load(d / f"rank{i}.pt", weights_only=True) for i in range(n)]
    return all_caps, streams, results


def test_two_process_disjoint_data_streams(two_ranks):
    """WebDatasetLoader's default shard_offset / shard_stride are the rank
    and the world size: disjoint, jointly complete streams."""
    all_caps, streams, _ = two_ranks
    assert streams[0] and streams[1]
    assert not (streams[0] & streams[1]), "ranks read overlapping samples"
    assert streams[0] | streams[1] == all_caps


def test_ddp_train_steps_equal_the_single_process_steps(two_ranks):
    """Both ranks end bit for bit alike (rank 1 started from other weights:
    DDP broadcasts rank 0's). Against the single-process steps on the whole
    batch with the same draws: loss, acc (averaged over the ranks) and
    grad_norm to 1e-5 relative, every averaged gradient within 1e-5 of its
    tensor's largest, and after step 2 (the first with lr > 0) 99.9% of the
    parameters within 0.02 lr and all within 2.1 lr (Adam normalizes each
    gradient by its own size; the summation orders differ)."""
    _, _, results = two_ranks
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k]), k
    assert results[0]["metrics"] == results[1]["metrics"]

    from paella_tpu_torch.train import create_train_state, make_train_step

    model, vq, cfg, batch, null, draws = build_case(seed=0)
    cfg = dataclasses.replace(cfg, grad_accum_steps=1)
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg)
    for i, d in enumerate(draws):
        want = {k: float(v) for k, v in step(state, batch, null, [d]).items()}
        got = results[0]["metrics"][i]
        for key in ("loss", "acc", "grad_norm"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), (i, key)
        for name, p in model.named_parameters():
            g = results[0]["grads"][i][name]
            peak = p.grad.abs().max().item()
            assert (g - p.grad).abs().max().item() <= 1e-5 * max(peak, 1e-12), (i, name)
    assert state.step == STEPS
    errs = torch.cat([((results[0]["params"][k] - v).abs() / cfg.lr).reshape(-1) for k, v in model.state_dict().items()
                      if v.is_floating_point()])
    moved = torch.cat([(v - build_case(seed=0)[0].state_dict()[k]).abs().reshape(-1) for k, v in model.state_dict().items()
                       if v.is_floating_point()])
    assert (moved > 0.5 * cfg.lr).float().mean() > 0.5, "the update is vacuous"
    assert torch.quantile(errs, 0.999).item() <= 0.02 and errs.max().item() <= 2.1


@pytest.mark.parametrize("shape,fsdp", [((128, 64), 4), ((64, 256), 2), ((3, 3, 64, 64), 8), ((8192,), 2),
                                        ((100, 7), 2), ((7, 7), 2), ((16384,), 3), ((256, 256), 1)])
def test_fsdp_rule_matches_jax(shape, fsdp):
    """fsdp_param_spec picks the axis the JAX rule shards (or none), and
    fsdp_placement gives FSDP2 that axis, or axis 0 where JAX replicates."""
    from torch.distributed.tensor import Shard

    from paella_tpu.parallel import fsdp_param_spec as jax_spec
    from paella_tpu_torch.parallel import fsdp_param_spec, fsdp_placement

    want = jax_spec((), np.zeros(shape, np.float32), fsdp)
    got = fsdp_param_spec(shape, fsdp)
    assert got == next((i for i, a in enumerate(want) if a == "fsdp"), None), (shape, want, got)
    assert fsdp_placement(shape, fsdp) == Shard(0 if got is None else got)

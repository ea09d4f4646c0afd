"""Multi-process initialization over torch.distributed, the counterpart of
`paella_tpu/parallel/distributed.py` (jax.distributed there).

The reference needs a SLURM script, torch mp.spawn per GPU
(src_distributed/train.py:186-189) and rank arithmetic with a rendezvous
(src_distributed/utils.py:85-94). Here every process runs the same program
and calls `initialize_distributed` once: NCCL on CUDA, gloo on the CPU, the
rendezvous from explicit arguments or from the usual MASTER_ADDR /
MASTER_PORT / RANK / WORLD_SIZE variables. With neither, it is a visible
no-op: one process, rank 0 of 1.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> dict:
    """Join the process group. coordinator_address is "host:port" (or a
    full init URL such as "tcp://host:port"); num_processes and process_id
    the world size and this process's rank. Missing arguments come from
    MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK. backend defaults to NCCL
    where CUDA is available, gloo otherwise; with NCCL, the process takes
    the card LOCAL_RANK names (default: its rank modulo the cards).

    Returns {process_index, process_count, local_devices, backend}. Safe to
    call twice, and on a single process (no-op, said on stdout).
    """
    if dist.is_initialized():
        return _summary()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        # make the single-process fallback VISIBLE: a multi-process job that
        # lands here (variables unset or stripped by the launcher) would run
        # as N independent processes until the first collective hangs
        print(
            "[distributed] multi-process init skipped: no coordinator address, world size and rank "
            "(arguments or MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK): single-process mode"
        )
        return _summary()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    return _summary()


def _summary() -> dict:
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "backend": dist.get_backend() if up else None,
    }


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The world size, 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 check for host-side side effects: checkpoint writes, logging
    and eval images (the reference gates the same things on `main_node`,
    src_distributed/train.py:35,125)."""
    return process_index() == 0

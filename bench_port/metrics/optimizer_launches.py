"""Kernels launched inside the program's `train.optimizer` ranges (AdamW's
`_foreach` chain and the derived weights' drop), per `train.step` range of
the profiled slice with the host (core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.launches(run, "train.optimizer", per="train.step")

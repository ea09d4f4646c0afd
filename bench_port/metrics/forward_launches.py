"""Kernels launched inside the program's `train.forward` ranges, per
`train.step` range of the profiled slice with the host (core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.launches(run, "train.forward", per="train.step")

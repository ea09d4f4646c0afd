"""Kernels launched inside the program's `train_graph.replay` ranges (a
captured training step's replay, with its input copies and dropout-mask
draws), per `train.step` range of the profiled slice with the host
(core/program.py). A program without the training graph has no such range
and reads None."""

from bench_port.core import program


def read(run, metric):
    return program.launches(run, "train_graph.replay", per="train.step")

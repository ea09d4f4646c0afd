"""The host's wait for the device a training step: the program's
`train.sync` spans (each host read of a device value) summed and divided by
its `train.step` spans, in ms, over steps run with the program's recorder
on and no profiler (core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.span_ms(run, "train.sync", per="train.step")

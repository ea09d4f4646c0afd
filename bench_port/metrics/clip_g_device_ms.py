"""The CLIP-bigG text tower's device time a prior call: the union of the
device intervals launched inside the program's `cond.clip_text` ranges,
over the `prior.sample` ranges of the profiled slice with the host, in ms
(core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.device_ms(run, "cond.clip_text", per="prior.sample")

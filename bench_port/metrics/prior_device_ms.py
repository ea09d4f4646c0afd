"""The prior sampler's device time a call: the union of the device intervals
whose launch call lies inside the program's `prior.sample` ranges (the
sampler graph's replay among them, matched by the trace's correlation ids),
over the `prior.sample` ranges of the profiled slice with the host, in ms
(core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.device_ms(run, "prior.sample", per="prior.sample")

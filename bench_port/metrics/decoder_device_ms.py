"""The decoder sampler's device time a call: the union of the device
intervals whose launch call lies inside the program's `decoder.sample`
ranges (the Stage B graph's replay among them, matched by the trace's
correlation ids), over the `decoder.sample` ranges of the profiled slice
with the host, in ms (core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.device_ms(run, "decoder.sample", per="decoder.sample")

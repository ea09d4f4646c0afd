"""The ByT5 encoder's device time a request: the union of the device
intervals whose launch call lies inside the program's `cond.byt5` ranges
(matched by the trace's correlation ids), over the `serve.request` ranges of
the profiled slice with the host, in ms (core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.device_ms(run, "cond.byt5", per="serve.request")

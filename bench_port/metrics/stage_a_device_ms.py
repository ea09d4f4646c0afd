"""Stage A's decode's device time a decoder call: the union of the device
intervals launched inside the program's `decoder.stage_a` ranges, over the
`decoder.sample` ranges of the profiled slice with the host, in ms
(core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.device_ms(run, "decoder.stage_a", per="decoder.sample")

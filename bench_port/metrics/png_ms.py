"""The PNG encode's time a request: the program's `serve.png` spans summed
and divided by its `serve.request` spans, in ms, over calls run with the
program's recorder on and no profiler (core/program.py)."""

from bench_port.core import program


def read(run, metric):
    return program.span_ms(run, "serve.png", per="serve.request")

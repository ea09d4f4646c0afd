"""Kernel launches of the profiled slice over the steps or calls it held."""


def read(run, metric):
    t = run.trace
    if not t or not run.slice_calls:
        return None
    return t["launches"] / run.slice_calls

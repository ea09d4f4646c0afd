"""The device's idle share of the profiled slice, in %: 100 x (1 - the union
of its kernel, copy and set intervals over the slice's length)."""


def read(run, metric):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0

"""The sampler's time a call: the span around the `sample` that
paella_tpu_torch.pipeline calls (a graph replay with its input copies), the
mean over the traced run's calls, in ms."""


def read(run, metric):
    v = run.spans.durations("sample")
    return sum(v) / len(v) * 1e3 if v else None

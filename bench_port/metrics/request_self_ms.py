"""Host time of the server and pipeline around the layers: each request
span's duration less its child spans (text encoders, sampler, decode), the
mean over the traced run's requests, in ms."""


def read(run, metric):
    v = run.spans.self_times("request")
    return sum(v) / len(v) * 1e3 if v else None

"""The codec's time a call: the span around the codec instance's
`decode_indices`, the mean over the traced run's calls, in ms."""


def read(run, metric):
    v = run.spans.durations("decode")
    return sum(v) / len(v) * 1e3 if v else None

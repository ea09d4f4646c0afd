"""The ByT5 encoder's time a request: the span around the `byt5_encode_fn`
the benchmark hands the pipeline, summed over the traced run and divided by
its requests, in ms (a request whose prompt the text cache holds adds 0)."""


def read(run, metric):
    v = run.spans.durations("byt5_encode")
    n = len(run.spans.durations("request"))
    return sum(v) / n * 1e3 if v and n else None

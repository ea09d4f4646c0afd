"""The CLIP text tower's time a request: the span around the `clip_text_fn`
the benchmark hands the pipeline, summed and divided by the requests, in ms."""


def read(run, metric):
    v = run.spans.durations("clip_text")
    n = len(run.spans.durations("request"))
    return sum(v) / n * 1e3 if v and n else None

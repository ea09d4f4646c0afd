"""The device memory peak over the window (`torch.cuda.max_memory_allocated`
after a reset at its start), in GiB."""


def read(run, metric):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None

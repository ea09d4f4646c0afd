"""The whole work's share of the card's bf16 peak, in %: the model FLOPs of
the calls or steps of the device-only profiled slice (reference/flops.py,
counted on the benchmark's own reference: products and convolutions, no
padding, no recomputation) over (the slice's length on the device trace x
989 TFLOP/s). The f32 decode and frozen encode count at the same peak."""

from bench_port.core.roofline import BF16_PEAK


def read(run, metric):
    t = run.trace
    if run.device.type != "cuda" or not run.slice_flops or not t or t["window_s"] <= 0:
        return None
    return run.slice_flops / (t["window_s"] * BF16_PEAK) * 100.0

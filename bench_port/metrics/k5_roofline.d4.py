"""K5's share of its roofline in Stage B's profiled slice, in %: the least
time of the attention executions of a decoder call (core/stage_b_roofline.py::
attention_bound_s: 1024 queries over 1028 keys at level 2 and 256 over 260
at level 3, 20 heads of 64, a repeated level once a run), times the steps,
times the slice's calls, over the device time of the kernels whose names a
direct `kernels.attention.fused_attention` call at each shape, in the
model's layout, launched in the same run: so it reads the same work
whichever design the policy picks."""

from bench_port.core.kernels import share
from bench_port.core.stage_b_roofline import K5


def read(run, metric):
    return share(run, K5)

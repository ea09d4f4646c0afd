"""K1's share of its roofline in Stage B's profiled slice, in %: the least
time of the ResBlock executions of a decoder call (a repeated level's
blocks once a run; core/stage_c_roofline.py::resblock_bound_s at each
shape, the channelwise skip joined into fc1), times the steps, times the
slice's calls, over the device time of the kernels whose names direct calls
of `kernels.resblock.fused_resblock` at those shapes launched in the same
run (core/stage_b_roofline.py)."""

from bench_port.core.kernels import share
from bench_port.core.stage_b_roofline import K1


def read(run, metric):
    return share(run, K1)

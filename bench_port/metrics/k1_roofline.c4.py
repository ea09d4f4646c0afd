"""K1's share of its roofline in Stage C's profiled slice, in %: the least
time of the slice's 64 ResBlock calls a forward, the channelwise-skip call
among them (core/stage_c_roofline.py::resblock_bound_s at each shape, times
the steps a call makes, times the slice's calls) over the device time of
the kernels whose names direct calls of `kernels.resblock.fused_resblock`
at those shapes launched in the same run."""

from bench_port.core.kernels import share
from bench_port.core.stage_c_roofline import KEY


def read(run, metric):
    return share(run, KEY)

"""K1's share of its roofline in the profiled slice, in %: the least time of
the slice's ResBlock calls (core/roofline.py::resblock_bound_s at each shape,
times the calls a sampler call makes, times the slice's calls) over the
device time of the kernels whose names a direct call of
`kernels.resblock.fused_resblock` at those shapes launched in the same run."""

from bench_port.core.kernels import share


def read(run, metric):
    return share(run, "K1")

"""K3's share of its roofline in the profiled slice, in %: the least time of
the slice's Gumbel draws (core/roofline.py::gumbel_bound_s over each step's
logits) over the device time of the kernels whose names a direct call of
`kernels.sampling.gumbel_categorical` at the cell's logits launched."""

from bench_port.core.kernels import share


def read(run, metric):
    return share(run, "K3")

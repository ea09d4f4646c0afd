"""Vector quantization for the f4 codec, the counterpart of
`paella_tpu/codec/quantize.py::VectorQuantize`: nearest-code lookup with a
straight-through value, and `idx2vq` for decoding token grids.

The lookup always goes through `kernels/quantize.py::fused_codebook_lookup`
(the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor), so
VQConfig.lookup_impl is not read.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.quantize import fused_codebook_lookup
from ..nn import init


class VectorQuantize(nn.Module):
    """Codebook of K entries of width c, channels-last. The parameter is the
    reference's `codebook.weight` (an nn.Embedding), so a reference or
    converted state dict loads as it is."""

    def __init__(self, c: int, k: int):
        super().__init__()
        self.codebook = nn.Embedding(k, c)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """U(+-1/K), the JAX package's codebook init."""
        init.uniform_(self.codebook.weight, 1.0 / self.codebook.num_embeddings, gen)

    def quantize(self, z: torch.Tensor):
        """(z_q straight-through, (vq_loss, commit_loss), indices), as the JAX
        package returns them; z_q_st = z + (z_q - z).detach() is the value
        (and the gradient) of the straight-through estimator."""
        idx = fused_codebook_lookup(z.detach().float().contiguous(), self.codebook.weight.detach().float().contiguous())
        z_q = self.idx2vq(idx).to(z.dtype)
        vq_loss = torch.mean(torch.square(z.detach() - z_q))
        commit_loss = torch.mean(torch.square(z - z_q.detach()))
        return z + (z_q - z).detach(), (vq_loss, commit_loss), idx

    def idx2vq(self, idx: torch.Tensor) -> torch.Tensor:
        return self.codebook.weight[idx.long()]

"""paella_tpu_torch: the PyTorch + CUDA port of paella_tpu for NVIDIA Hopper.

Layout conventions are the JAX package's:
- latents: (B, h, w) integer token grids
- activations and logits: NHWC, (B, h, w, C)
- images:  (B, H, W, 3)

The port imports torch and numpy only; its CUDA kernels (csrc/) are built
from source on first use on a CUDA tensor.
"""

from .config import PaellaConfig, SampleConfig, VQConfig
from .pipeline import PaellaPipeline

__version__ = "0.1.0"

__all__ = ["PaellaConfig", "PaellaPipeline", "SampleConfig", "VQConfig", "__version__"]

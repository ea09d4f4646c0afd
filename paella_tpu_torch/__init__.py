"""paella_tpu_torch: the PyTorch + CUDA port of paella_tpu for NVIDIA Hopper.

Layout conventions are the JAX package's:
- latents: (B, h, w) integer token grids
- activations and logits: NHWC, (B, h, w, C)
- images:  (B, H, W, 3)

The port imports torch and numpy only; its CUDA kernels (csrc/) are built
from source on first use on a CUDA tensor.
"""

from .config import (DecoderSampleConfig, PaellaConfig, PriorSampleConfig, SampleConfig, StageBConfig, StageCConfig,
                     TrainConfig, VQConfig)
from .pipeline import CascadeDecoderPipeline, CascadePipeline, CascadePriorPipeline, PaellaPipeline

__version__ = "0.1.0"

__all__ = ["CascadeDecoderPipeline", "CascadePipeline", "CascadePriorPipeline", "DecoderSampleConfig", "PaellaConfig",
           "PaellaPipeline", "PriorSampleConfig", "SampleConfig", "StageBConfig", "StageCConfig", "TrainConfig",
           "VQConfig", "__version__"]

from .quantize import VectorQuantize
from .vqgan import VQModel, VQResBlock

__all__ = ["VQModel", "VQResBlock", "VectorQuantize"]

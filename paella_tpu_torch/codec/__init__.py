from .vqgan import VQModel, VQResBlock

__all__ = ["VQModel", "VQResBlock"]

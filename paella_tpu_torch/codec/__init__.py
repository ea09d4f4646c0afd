from .quantize import VectorQuantize
from .trainer import CodecAdamW, CodecTrainConfig, CodecTrainState, create_codec_train_state, make_codec_train_step
from .vqgan import Discriminator, SpectralNormConv, VQModel, VQResBlock

__all__ = [
    "CodecAdamW",
    "CodecTrainConfig",
    "CodecTrainState",
    "Discriminator",
    "SpectralNormConv",
    "VQModel",
    "VQResBlock",
    "VectorQuantize",
    "create_codec_train_state",
    "make_codec_train_step",
]

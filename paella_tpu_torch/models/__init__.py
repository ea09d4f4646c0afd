from .denoiser import Paella

__all__ = ["Paella"]

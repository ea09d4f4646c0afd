from .denoiser import Paella
from .noise import add_noise, get_loss_weight

__all__ = ["Paella", "add_noise", "get_loss_weight"]

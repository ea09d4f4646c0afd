from .denoiser import Paella
from .noise import add_noise, get_loss_weight
from .stage_b import StageB
from .stage_c import StageC

__all__ = ["Paella", "StageB", "StageC", "add_noise", "get_loss_weight"]

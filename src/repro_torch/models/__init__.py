from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.model import ModelFns, get_model

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ModelFns", "get_model"]

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.model import (ModelFns, abstract_batch,
                                      abstract_cache, abstract_params,
                                      get_model)
from repro_torch.models.sharding import MeshCtx, cpu_mesh_ctx

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ModelFns", "get_model",
           "abstract_batch", "abstract_cache", "abstract_params", "MeshCtx",
           "cpu_mesh_ctx"]

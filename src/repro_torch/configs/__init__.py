from repro_torch.configs.base import (ASSIGNED_ARCHS, SHAPES, ArchConfig, ShapeConfig, get_arch,
                                     get_shape, list_archs, shape_supported)

__all__ = ["ASSIGNED_ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch", "get_shape",
           "list_archs", "shape_supported"]

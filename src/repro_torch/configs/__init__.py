from repro_torch.configs.registry import (ARCHS, PORTED, SHAPES, SUBQUADRATIC, ShapeCell,
                                          get_config, get_smoke_config, list_archs,
                                          shapes_for)

__all__ = ["ARCHS", "PORTED", "SHAPES", "SUBQUADRATIC", "ShapeCell", "get_config",
           "get_smoke_config", "list_archs", "shapes_for"]

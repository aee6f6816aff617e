from repro_torch.models.build import build_model
from repro_torch.models.common import ModelConfig, ParamDef, init_params, shape_tree, spec_tree

__all__ = ["ModelConfig", "ParamDef", "init_params", "shape_tree", "spec_tree", "build_model"]

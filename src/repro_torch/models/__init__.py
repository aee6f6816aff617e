from repro_torch.models.build import build_model
from repro_torch.models.common import ModelConfig, ParamDef, init_params

__all__ = ["ModelConfig", "ParamDef", "init_params", "build_model"]

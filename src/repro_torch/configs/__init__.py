from repro_torch.configs.registry import ARCHS, PORTED, get_config, get_smoke_config

__all__ = ["ARCHS", "PORTED", "get_config", "get_smoke_config"]

from repro_torch.configs.registry import (ARCHS, PORTED, get_config, get_smoke_config,
                                          list_archs)

__all__ = ["ARCHS", "PORTED", "get_config", "get_smoke_config", "list_archs"]

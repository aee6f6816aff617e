from repro_torch.serving.engine import GenerationResult, ServingEngine, resolve_device
from repro_torch.serving.sampler import GenerationParams, SamplerConfig
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.serving.scheduler import ContinuousBatcher, Request, WindowPolicy
from repro_torch.serving.broker import SessionBroker, SessionHandle, SessionResult
from repro_torch.serving.pagepool import (TRASH_PAGE, PagePool, PoolStats, SlotSplicer,
                                          chunk_plan)
from repro_torch.serving.prefix_cache import CacheStats, PrefixCache, PrefixLease
from repro_torch.serving.speculative import (DraftModel, ModelDrafter, NgramDrafter,
                                             SpecStats)
from repro_torch.serving.fleet import EngineFleet, FleetHandle

__all__ = ["ServingEngine", "GenerationResult", "resolve_device", "ByteTokenizer",
           "GenerationParams", "SamplerConfig", "ContinuousBatcher", "Request",
           "WindowPolicy", "SessionBroker", "SessionHandle", "SessionResult",
           "TRASH_PAGE", "PagePool", "PoolStats", "SlotSplicer", "chunk_plan",
           "CacheStats", "PrefixCache", "PrefixLease",
           "DraftModel", "ModelDrafter", "NgramDrafter", "SpecStats",
           "EngineFleet", "FleetHandle"]

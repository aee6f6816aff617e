from repro_torch.serving.engine import GenerationResult, ServingEngine, resolve_device
from repro_torch.serving.sampler import GenerationParams, SamplerConfig
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.serving.broker import SessionBroker, SessionHandle, SessionResult
from repro_torch.serving.pagepool import TRASH_PAGE, PagePool, PoolStats, chunk_plan
from repro_torch.serving.prefix_cache import CacheStats, PrefixCache, PrefixLease

__all__ = ["ServingEngine", "GenerationResult", "resolve_device", "ByteTokenizer",
           "GenerationParams", "SamplerConfig", "ContinuousBatcher", "Request",
           "SessionBroker", "SessionHandle", "SessionResult",
           "TRASH_PAGE", "PagePool", "PoolStats", "chunk_plan",
           "CacheStats", "PrefixCache", "PrefixLease"]

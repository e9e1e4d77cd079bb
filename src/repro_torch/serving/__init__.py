"""Serving: the batched engine with Jet admission control, and the paged
KV cache."""
from .engine import EngineConfig, Request, ServingEngine
from .kv_cache import PagedKV, PagedKVConfig

__all__ = ["EngineConfig", "PagedKV", "PagedKVConfig", "Request",
           "ServingEngine"]

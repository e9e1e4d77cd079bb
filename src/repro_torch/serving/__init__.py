"""Serving: the batched engine with Jet admission control."""
from .engine import EngineConfig, Request, ServingEngine

__all__ = ["EngineConfig", "Request", "ServingEngine"]

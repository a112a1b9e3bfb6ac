"""Continuous-batching serving over paged KV (see ``serving.paged``)."""

from .engine import (EngineBackpressure, EngineClosed, LLMEngine, Request,
                     bucket_length)
from .kvcache import BlockPool, BlockPoolExhausted, PrefixCache
from .paged import PagedLLMEngine

__all__ = ["LLMEngine", "PagedLLMEngine", "Request", "EngineBackpressure",
           "EngineClosed", "bucket_length", "BlockPool", "BlockPoolExhausted",
           "PrefixCache"]

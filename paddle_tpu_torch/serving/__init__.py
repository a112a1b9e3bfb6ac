"""Continuous-batching serving: the slot layout (``LLMEngine``), paged KV
(``serving.paged``) and speculative decoding (``serving.speculative``)."""

from .engine import (EngineBackpressure, EngineClosed, LLMEngine, Request,
                     bucket_length)
from .kvcache import BlockPool, BlockPoolExhausted, PrefixCache
from .paged import PagedLLMEngine
from .speculative import SpeculativeLLMEngine

__all__ = ["LLMEngine", "PagedLLMEngine", "SpeculativeLLMEngine", "Request",
           "EngineBackpressure", "EngineClosed", "bucket_length", "BlockPool",
           "BlockPoolExhausted", "PrefixCache"]

"""Continuous-batching serving: the slot layout (``LLMEngine``), paged KV
(``serving.paged``) with LoRA adapters (``serving.adapters``), the
host-RAM KV tier and KV migration, and speculative decoding
(``serving.speculative``)."""

from .adapters import AdapterArena, AdapterArenaExhausted, random_lora_factors
from .engine import (EngineBackpressure, EngineClosed, LLMEngine, Request,
                     bucket_length)
from .kvcache import (BlockPool, BlockPoolExhausted, HostKVTier,
                      HostTierLost, PrefixCache)
from .paged import PagedLLMEngine
from .speculative import SpeculativeLLMEngine

__all__ = ["LLMEngine", "PagedLLMEngine", "SpeculativeLLMEngine", "Request",
           "EngineBackpressure", "EngineClosed", "bucket_length", "BlockPool",
           "BlockPoolExhausted", "PrefixCache", "AdapterArena",
           "AdapterArenaExhausted", "HostKVTier", "HostTierLost",
           "random_lora_factors"]

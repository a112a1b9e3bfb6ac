"""Continuous-batching serving: the slot layout (``LLMEngine``), paged KV
(``serving.paged``) with LoRA adapters (``serving.adapters``), the
host-RAM KV tier and KV migration, speculative decoding
(``serving.speculative``), and the multi-replica fleet
(``serving.fleet``: ``ServingFleet`` behind a ``Router``, with
disaggregated prefill/decode and a ``FleetAutoscaler``)."""

from .adapters import AdapterArena, AdapterArenaExhausted, random_lora_factors
from .autoscale import FleetAutoscaler
from .engine import (EngineBackpressure, EngineClosed, LLMEngine, Request,
                     bucket_length)
from .fleet import FleetRequest, Replica, ServingFleet
from .kvcache import (BlockPool, BlockPoolExhausted, HostKVTier,
                      HostTierLost, PrefixCache)
from .paged import PagedLLMEngine
from .router import RetryAfter, Router
from .speculative import SpeculativeLLMEngine

__all__ = ["LLMEngine", "PagedLLMEngine", "SpeculativeLLMEngine", "Request",
           "EngineBackpressure", "EngineClosed", "bucket_length", "BlockPool",
           "BlockPoolExhausted", "PrefixCache", "AdapterArena",
           "AdapterArenaExhausted", "HostKVTier", "HostTierLost",
           "random_lora_factors", "ServingFleet", "FleetRequest", "Replica",
           "Router", "RetryAfter", "FleetAutoscaler"]

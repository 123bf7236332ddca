"""LLM serving of the port (counterparts of the JAX package's ``llm``):
continuous batching over a paged KV cache with a radix prefix index, on
the card, behind an asyncio request plane."""

from .engine import GenerationResult, RequestHandle, SlotEngine
from .paged import OverloadedError, PagePool, RadixIndex
from .serve import LLMServer, build_llm_app

__all__ = [
    "SlotEngine",
    "RequestHandle",
    "GenerationResult",
    "LLMServer",
    "build_llm_app",
    "OverloadedError",
    "PagePool",
    "RadixIndex",
]

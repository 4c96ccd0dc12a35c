"""Serving: batched prefill + decode over the KV cache, and the
online-learning service (inference under live traffic with background
MGD re-trim)."""
from .decode import greedy_generate, serve_batch
from .online import (OnlineService, OnlineTrimmer, ParamSnapshot, ParamStore,
                     ReplayBuffer, ServeResult, ServiceConfig, TrimConfig,
                     serve)

__all__ = [
    "serve_batch", "greedy_generate", "OnlineService", "OnlineTrimmer",
    "ParamSnapshot", "ParamStore", "ReplayBuffer", "ServeResult",
    "ServiceConfig", "TrimConfig", "serve",
]

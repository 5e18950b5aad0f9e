"""Serving subsystem: tick = schedule -> prefill -> fused decode horizon.

``engine`` orchestrates the tick; ``prefill`` holds the slot / batched /
chunked strategies; ``policies`` the pluggable admission policies;
``sampling`` the greedy sampler.
"""
from repro_torch.serving.engine import DecodeEngine, EngineConfig, EngineTiming
from repro_torch.serving.policies import available_policies, make_policy
from repro_torch.serving.prefill import (BatchedPrefiller, ChunkedPrefiller,
                                         SlotPrefiller, make_prefiller)
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import (Sampler, greedy_sample,
                                          make_sampler, make_scan_sampler)

__all__ = [
    "DecodeEngine", "EngineConfig", "EngineTiming", "Request",
    "make_policy", "available_policies",
    "SlotPrefiller", "BatchedPrefiller", "ChunkedPrefiller", "make_prefiller",
    "Sampler", "greedy_sample", "make_sampler", "make_scan_sampler",
]

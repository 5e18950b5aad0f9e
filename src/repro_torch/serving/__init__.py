"""Serving subsystem: tick = schedule -> prefill -> fused decode horizon.

``engine`` orchestrates the tick; ``prefill`` holds the slot / batched /
chunked strategies; ``policies`` the pluggable admission policies;
``sampling`` the greedy, temperature and top-k samplers and the
speculative verifier; ``cluster`` the disaggregated prefill/decode router
over a pool of engines.
"""
from repro_torch.serving.cluster import (ClusterConfig, EngineCluster,
                                         EngineHandle)
from repro_torch.serving.engine import DecodeEngine, EngineConfig, EngineTiming
from repro_torch.serving.policies import available_policies, make_policy
from repro_torch.serving.prefill import (BatchedPrefiller, ChunkedPrefiller,
                                         SlotPrefiller, make_prefiller)
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import (Sampler, greedy_sample,
                                          make_sampler, make_scan_sampler)

__all__ = [
    "DecodeEngine", "EngineConfig", "EngineTiming", "Request",
    "EngineCluster", "ClusterConfig", "EngineHandle",
    "make_policy", "available_policies",
    "SlotPrefiller", "BatchedPrefiller", "ChunkedPrefiller", "make_prefiller",
    "Sampler", "greedy_sample", "make_sampler", "make_scan_sampler",
]

"""Serving: the Generator, the continuous batcher over per-slot pools, the
multi-host frontend over batcher replicas and its scaling simulator."""

from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.cluster import ClusterFrontend, HostReplica, ReplicaStats
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator, sample_token
from smoothquant_tpu_torch.serve.sim import (
    Arrival,
    CostModel,
    SimBatcher,
    bursty_trace,
    scaling_efficiency,
    simulate_cluster,
    skewed_trace,
    uniform_trace,
)

__all__ = [
    "ContinuousBatcher", "Request", "ClusterFrontend", "HostReplica", "ReplicaStats",
    "GenerationConfig", "Generator", "sample_token", "Arrival", "CostModel", "SimBatcher",
    "bursty_trace", "scaling_efficiency", "simulate_cluster", "skewed_trace",
    "uniform_trace",
]

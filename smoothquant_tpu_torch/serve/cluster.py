"""Multi-host serving tier: request distribution over batcher replicas
(port of smoothquant_tpu/serve/cluster.py).

A `HostReplica` wraps any ContinuousBatcher-compatible engine and the
`ClusterFrontend` routes requests with least-outstanding-work scheduling
(ties to the lowest host id), steals queued work between replicas and
aggregates throughput and scaling metrics.  On a real deployment each
replica's step() runs on its own host and the frontend exchanges only
token ids; in one process the replicas step round-robin and each one's
busy time is kept apart, which is what that host's wall clock would be.
The module is transport-agnostic and touches no device itself: the
replicas' batchers hold the model and run on whatever device they were
built for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request


@dataclasses.dataclass
class ReplicaStats:
    steps: int = 0
    busy_s: float = 0.0
    tokens: int = 0
    requests_done: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.busy_s if self.busy_s > 0 else 0.0


class HostReplica:
    """One host's serving engine and its share of the bookkeeping."""

    def __init__(self, batcher: ContinuousBatcher, host_id: int):
        self.batcher = batcher
        self.host_id = host_id
        self.stats = ReplicaStats()
        self.requests: list[Request] = []
        self.outstanding = 0  # submitted-but-unfinished token budget

    def submit(self, req: Request) -> None:
        self.outstanding += len(req.prompt) + req.max_new_tokens
        self.requests.append(req)
        self.batcher.submit(req)

    def has_work(self) -> bool:
        return bool(self.batcher.queue) or any(r is not None for r in self.batcher.slot_req)

    def step(self) -> list[Request]:
        """One batcher step; its seconds count as this host's busy time.  A
        batcher on the card syncs inside step() (it reads the tokens on the
        host), so the host clock covers the device work."""
        t0 = time.perf_counter()
        finished = self.batcher.step()
        self.stats.busy_s += time.perf_counter() - t0
        self.stats.steps += 1
        self.stats.tokens = sum(len(r.generated) for r in self.requests)
        for req in finished:
            self.stats.requests_done += 1
            self.outstanding -= len(req.prompt) + req.max_new_tokens
        return finished


def steal_queued(replicas: list[HostReplica], on_move=None) -> int:
    """Queue-level work stealing: move QUEUED (never admitted) requests from
    replicas whose queue exceeds their free slots to replicas with a free
    slot and nothing queued.  Queued requests own no KV state, so only
    prompt ids move.  A giver donates only its excess, so a taker (one
    queued request against at least one free slot) never qualifies as a
    giver: no ping-pong.  on_move(request, taker) runs before each move's
    submit (the simulator's clock).  Returns the moves."""
    moved = 0
    while True:
        takers = [r for r in replicas
                  if not r.batcher.queue and any(s is None for s in r.batcher.slot_req)]
        givers = sorted((r for r in replicas
                         if len(r.batcher.queue) > sum(s is None for s in r.batcher.slot_req)),
                        key=lambda r: -len(r.batcher.queue))
        if not takers or not givers:
            return moved
        g, t = givers[0], takers[0]
        req = g.batcher.queue.pop()       # the tail: least FIFO disturbance
        g.outstanding -= len(req.prompt) + req.max_new_tokens
        g.requests.remove(req)
        if on_move is not None:
            on_move(req, t)
        t.submit(req)
        moved += 1


class ClusterFrontend:
    """Route requests across host replicas; aggregate scaling metrics.

    make_batcher(host_id) -> ContinuousBatcher builds each host's engine
    (each replica may hold its own params copy or device).  Routing is least
    outstanding work, ties to the lowest host id: deterministic, so results
    repeat across runs and host counts."""

    def __init__(self, make_batcher: Callable[[int], ContinuousBatcher], n_hosts: int):
        self.replicas = [HostReplica(make_batcher(i), i) for i in range(n_hosts)]

    def submit(self, req: Request) -> None:
        tgt = min(self.replicas, key=lambda r: (r.outstanding, r.host_id))
        tgt.submit(req)

    def rebalance(self) -> int:
        """Work stealing at the queue level (steal_queued): attacks the
        routing imbalance that submit-time routing cannot foresee (decode
        lengths).  Returns the requests moved."""
        return steal_queued(self.replicas)

    def step_all(self) -> list[Request]:
        self.rebalance()
        done: list[Request] = []
        for rep in self.replicas:
            if rep.has_work():
                done.extend(rep.step())
        return done

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_steps):
            done.extend(self.step_all())
            if not any(rep.has_work() for rep in self.replicas):
                break
        return done

    def stats(self, baseline_tokens_per_s: Optional[float] = None) -> dict:
        """Aggregate metrics: cluster_tokens_per_s models hosts stepping
        concurrently (total tokens over the busiest host's busy time, each
        host owning its own chips); scaling_efficiency = cluster tokens/s /
        (n_hosts × a 1-host baseline) when the baseline is given."""
        per_host = {r.host_id: dataclasses.asdict(r.stats) | {
            "tokens_per_s": r.stats.tokens_per_s} for r in self.replicas}
        total_tokens = sum(r.stats.tokens for r in self.replicas)
        bottleneck = max((r.stats.busy_s for r in self.replicas), default=0.0)
        cluster_tps = total_tokens / bottleneck if bottleneck > 0 else 0.0
        out = {
            "n_hosts": len(self.replicas),
            "total_tokens": total_tokens,
            "requests_done": sum(r.stats.requests_done for r in self.replicas),
            "cluster_tokens_per_s": cluster_tps,
            "per_host": per_host,
        }
        if baseline_tokens_per_s:
            out["scaling_efficiency"] = cluster_tps / (len(self.replicas)
                                                       * baseline_tokens_per_s)
        return out

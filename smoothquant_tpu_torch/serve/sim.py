"""Discrete-event scaling simulation of the cluster serving tier (port of
smoothquant_tpu/serve/sim.py).

The real `ClusterFrontend` routing (least outstanding work, queue-level
work stealing) and the real `ContinuousBatcher` admission (bucket-grouped,
pow2-row prefill batches) run unchanged, but each replica's engine is a
`SimBatcher` whose prefill and decode charge a COST MODEL to a virtual
per-host clock instead of touching a device.  Feed it per-step costs
measured on the card (chip_smoke.py's cluster phase does) and an arrival
trace; it returns tokens, makespan and scaling efficiency against one host.

Its numbers are simulated, not measured: they say how well the scheduling
(imbalance, admission batching, routing) uses the measured per-host costs,
and nothing of a network between hosts.  The traces draw from numpy's
default_rng exactly as the JAX package's do, so one seed gives one trace in
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.cluster import ClusterFrontend, steal_queued


@dataclasses.dataclass
class CostModel:
    """Virtual per-host step costs, in seconds (measured on the card)."""

    decode_step_s: float                 # one batched decode step
    prefill_s_per_token: float           # per (padded) prompt token row
    prefill_base_s: float = 0.0          # per prefill launch


@dataclasses.dataclass
class Arrival:
    t: float
    request: Request


class SimBatcher(ContinuousBatcher):
    """ContinuousBatcher with the device replaced by a virtual clock.

    Inherits submit, _admit and _emit untouched (the scheduling under test
    is the real code) and overrides only the device methods, _prefill and
    _scatter, and step(), which charges cost.decode_step_s in place of a
    decode."""

    def __init__(self, cost: CostModel, max_batch: int = 4, max_len: int = 512):
        # deliberately no super().__init__: no model, no caches, only the
        # state _admit / _emit / step touch
        self.cost = cost
        self.max_batch, self.max_len = max_batch, max_len
        self.clock = 0.0
        self.key_valid = np.zeros((max_batch, max_len), bool)
        self.seq_pos = np.zeros(max_batch, np.int32)
        self.pool_pos = np.zeros(max_batch, np.int64)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self._steps = 0
        self.prefill_params = None
        self.params = None
        # slot occupancy during decode steps: the admission's batching quality
        self._active_slot_steps = 0
        self._slot_steps = 0

    def _prefill(self, ids: np.ndarray, lens: np.ndarray):
        rows, bucket = ids.shape
        self.clock += self.cost.prefill_base_s + self.cost.prefill_s_per_token * rows * bucket
        # greedy token 0 for every row: the traces carry no EOS, max_new_tokens ends them
        return np.zeros((rows,), np.int32), None

    def _scatter(self, batch, row: int, slot: int, new_pos: int) -> None:
        pass

    def step(self) -> list[Request]:
        self._admit()
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        if not active:
            return []
        self.clock += self.cost.decode_step_s
        self._steps += 1
        self._active_slot_steps += len(active)
        self._slot_steps += self.max_batch
        finished = []
        for s in active:
            self.seq_pos[s] += 1
            req = self.slot_req[s]
            self._emit(s, 0)
            if req.done:
                finished.append(req)
        return finished


def skewed_trace(n_requests: int, seed: int = 0, *, max_len: int = 512,
                 mean_arrival_s: float = 0.005) -> list[Arrival]:
    """Bursty arrivals (exponential gaps) with long-tailed prompt and output
    lengths: the load skew the routing must absorb."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(mean_arrival_s))
        p_len = int(np.clip(rng.lognormal(3.5, 1.0), 4, max_len // 2))
        m_new = int(np.clip(rng.lognormal(3.0, 0.8), 4, max_len // 2))
        m_new = min(m_new, max_len - p_len)
        prompt = rng.integers(1, 100, size=(p_len,)).astype(np.int32)
        out.append(Arrival(t, Request(uid=i, prompt=prompt, max_new_tokens=m_new)))
    return out


def uniform_trace(n_requests: int, seed: int = 0, *, max_len: int = 512,
                  gap_s: float = 0.005) -> list[Arrival]:
    """Constant arrival gaps, a narrow length spread: the easy case, where a
    scheduler below ~1.0 loses to its own admission policy, not to skew."""
    rng = np.random.default_rng(seed)
    out = []
    lo_p, hi_p = max(4, max_len // 8), max(6, max_len // 4)
    lo_m, hi_m = max(2, max_len // 16), max(4, max_len // 8)
    for i in range(n_requests):
        p_len = int(rng.integers(lo_p, hi_p))
        m_new = min(int(rng.integers(lo_m, hi_m)), max_len - p_len)
        prompt = rng.integers(1, 100, size=(p_len,)).astype(np.int32)
        out.append(Arrival(gap_s * (i + 1), Request(uid=i, prompt=prompt,
                                                    max_new_tokens=m_new)))
    return out


def bursty_trace(n_requests: int, seed: int = 0, *, max_len: int = 512,
                 burst: int = 8, gap_s: float = 0.08) -> list[Arrival]:
    """On / off bursts: `burst` simultaneous arrivals between idle gaps,
    which a burst's routing must spread over the hosts and the admission
    group by bucket."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        t = gap_s * (i // burst + 1)
        p_len = int(np.clip(rng.lognormal(3.8, 0.7), 8, max_len // 2))
        m_new = int(np.clip(rng.lognormal(3.2, 0.6), 8, max_len // 2))
        m_new = min(m_new, max_len - p_len)
        prompt = rng.integers(1, 100, size=(p_len,)).astype(np.int32)
        out.append(Arrival(t, Request(uid=i, prompt=prompt, max_new_tokens=m_new)))
    return out


def simulate_cluster(n_hosts: int, trace: list[Arrival], cost: CostModel, *,
                     max_batch: int = 4, max_len: int = 512) -> dict:
    """Event-driven run: always advance the earliest event (the lagging
    working replica steps once, or the next arrival is delivered).  Mutates
    the trace's requests (clone it to run it again)."""
    front = ClusterFrontend(lambda i: SimBatcher(cost, max_batch=max_batch, max_len=max_len),
                            n_hosts)
    pending = sorted(trace, key=lambda a: a.t)
    requests = [a.request for a in pending]

    def start_after_arrival(req, taker):
        # stolen work cannot start on the taker's clock before it arrived
        taker.batcher.clock = max(taker.batcher.clock,
                                  getattr(req, "_arrival_t", taker.batcher.clock))

    while pending or any(rep.has_work() for rep in front.replicas):
        steal_queued(front.replicas, start_after_arrival)
        workers = [r for r in front.replicas if r.has_work()]
        t_step = min((r.batcher.clock for r in workers), default=float("inf"))
        if pending and pending[0].t <= t_step:
            arr = pending.pop(0)
            # an idle replica cannot have done anything before this arrival
            for rep in front.replicas:
                if not rep.has_work():
                    rep.batcher.clock = max(rep.batcher.clock, arr.t)
            arr.request._arrival_t = arr.t
            front.submit(arr.request)
            continue
        rep = min(workers, key=lambda r: r.batcher.clock)
        rep.step()

    makespan = max(rep.batcher.clock for rep in front.replicas)
    tokens = sum(len(r.generated) for r in requests)
    if not all(r.done for r in requests):
        raise AssertionError("simulation ended with unfinished requests")
    busy = [rep.batcher.clock for rep in front.replicas]
    occ = [rep.batcher._active_slot_steps / max(rep.batcher._slot_steps, 1)
           for rep in front.replicas]
    return {
        "n_hosts": n_hosts,
        "tokens": tokens,
        "makespan_s": makespan,
        "tokens_per_s": tokens / makespan if makespan else 0.0,
        "per_host_busy_s": busy,
        # loss attribution: routing imbalance = the share of the makespan the
        # AVERAGE host sits idle behind the slowest; admission occupancy = the
        # filled-slot share during decode steps (batching quality)
        "routing_imbalance": 1.0 - (sum(busy) / len(busy)) / max(busy) if max(busy) else 0.0,
        "admission_occupancy": sum(occ) / len(occ),
    }


def scaling_efficiency(trace: list[Arrival], cost: CostModel, n_hosts: int, **kw) -> dict:
    """tokens/s at n_hosts over n_hosts × the 1-host run's, on the SAME trace."""
    one = simulate_cluster(1, _clone_trace(trace), cost, **kw)
    many = simulate_cluster(n_hosts, _clone_trace(trace), cost, **kw)
    eff = many["tokens_per_s"] / (n_hosts * one["tokens_per_s"])
    return {"one_host": one, "n_host": many, "n_hosts": n_hosts,
            "scaling_efficiency": eff,
            "routing_imbalance": many["routing_imbalance"],
            "admission_occupancy": many["admission_occupancy"]}


def _clone_trace(trace: list[Arrival]) -> list[Arrival]:
    return [Arrival(a.t, Request(uid=a.request.uid, prompt=np.array(a.request.prompt),
                                 max_new_tokens=a.request.max_new_tokens))
            for a in trace]

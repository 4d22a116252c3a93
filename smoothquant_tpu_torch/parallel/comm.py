"""The collectives of the parallel modes over torch.distributed process
groups: the counterparts of what shard_map issues in the JAX package
(jax.lax.psum, jax.lax.all_gather(tiled=True), jax.lax.ppermute by +1).

Each takes the group it runs over.  Under NCCL a CUDA tensor goes to the
collective where it lies.  Under gloo a CUDA tensor goes through the host
on purpose (HOST_TRANSPORT): one copy out, the collective between the
ranks' host buffers, one copy back.  That is the transport of two ranks
that share one card (NCCL refuses two ranks on one GPU); the computation
never leaves the card.  At world size 1 every collective is still issued
(a sum over one rank is the identity, but nothing short-cuts the call).

COUNTS counts the collectives issued, by name ("all_reduce" for the
synchronous and the asynchronous one, "all_gather", "ring_hop"), as
kernels._build.LAUNCHES counts kernel launches: a test or chip_smoke reads
how many a forward issued per layer.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()

# the backends whose CUDA tensors travel through host buffers
HOST_TRANSPORT = ("gloo",)


def reset_counts() -> None:
    COUNTS.clear()


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) in HOST_TRANSPORT


def _out(t: torch.Tensor, group) -> torch.Tensor:
    """t's buffer for the collective: a host copy under the host transport,
    else t itself made contiguous."""
    return t.detach().contiguous().cpu() if _via_host(t, group) else t.contiguous()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (jax.lax.psum), in t's dtype and
    on t's device.  t itself may be overwritten with the sum."""
    COUNTS["all_reduce"] += 1
    buf = _out(t, group)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


class PendingReduce:
    """An all-reduce in flight; wait() returns the sum on the tensor's
    device."""

    def __init__(self, buf: torch.Tensor, work, device):
        self._buf, self._work, self._device = buf, work, device

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._buf.to(self._device)


def all_reduce_async(t: torch.Tensor, group) -> PendingReduce:
    """all_reduce issued with async_op=True: the caller goes on (the next
    chunk's product) while it runs, and waits on the result."""
    COUNTS["all_reduce"] += 1
    buf = _out(t, group)
    return PendingReduce(buf, dist.all_reduce(buf, group=group, async_op=True), t.device)


def all_gather(t: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """The ranks' t concatenated along `axis` in rank order
    (jax.lax.all_gather(..., tiled=True))."""
    COUNTS["all_gather"] += 1
    buf = _out(t, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=axis).to(t.device)


class PendingHop:
    """A ring hop in flight; wait() returns the tensor received from the
    previous rank, on the sender's device."""

    def __init__(self, recv: torch.Tensor, works, device):
        self._recv, self._works, self._device = recv, works, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._recv.to(self._device)


def ring_hop_start(t: torch.Tensor, group) -> PendingHop:
    """Send t to the next rank of the group and receive the previous
    rank's (jax.lax.ppermute with perm [(i, i + 1 mod n)]), one
    dist.batch_isend_irecv; the caller computes while it is in flight."""
    COUNTS["ring_hop"] += 1
    n, r = dist.get_world_size(group), dist.get_rank(group)
    buf = _out(t, group)
    recv = torch.empty_like(buf)
    if n == 1:
        # a rank of one sends to itself: a one-rank all-to-all (gloo has no
        # connection from a rank to itself for a point-to-point send)
        return PendingHop(recv, [dist.all_to_all_single(recv, buf, group=group,
                                                        async_op=True)], t.device)
    peer = lambda i: dist.get_global_rank(group, i) if group is not None else i
    ops = [dist.P2POp(dist.isend, buf, peer((r + 1) % n), group),
           dist.P2POp(dist.irecv, recv, peer((r - 1) % n), group)]
    return PendingHop(recv, dist.batch_isend_irecv(ops), t.device)


def ring_hop(t: torch.Tensor, group) -> torch.Tensor:
    """ring_hop_start(t, group).wait()."""
    return ring_hop_start(t, group).wait()

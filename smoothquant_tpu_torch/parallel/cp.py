"""Context (sequence) parallelism: ring-attention prefill (port of
smoothquant_tpu/parallel/cp.py).

Long-context prefill splits the SEQUENCE over the "cp" ranks: each holds
S / cp tokens, runs the whole (replicated-weight) layer stack on them, and
attention streams the K / V chunks around the ring (parallel.comm's ring
hop, the next hop issued before the current chunk's attention so that it
is in flight while the chunk computes).  Weights, packed or fp, are whole
on every rank, so each rank's work is the single-device forward on its
tokens: only models.common.attention becomes collective (under
ForwardContext.cp_group).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from smoothquant_tpu_torch.parallel import comm
from smoothquant_tpu_torch.parallel.mesh import axis_group

CP_AXIS = "cp"

NEG_INF = -1e30


def make_cp_mesh(cp: Optional[int] = None):
    """A 1-D ("cp",) DeviceMesh over the default group's ranks
    (cp.py:38-51); cp, if given, must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if cp is not None and cp != n:
        raise ValueError(f"cp={cp}: a cp mesh spans the {n} ranks")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu", torch.arange(n),
                      mesh_dim_names=(CP_AXIS,))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, *,
                   scale: Optional[float] = None,
                   attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal ring attention over the group (cp.py:52-148).  q (B, Sl, H,
    D) this rank's queries, k / v (B, H_kv, Sl, D) its keys and values,
    attn_mask (B, Sl) the validity of its keys; returns (B, Sl, H, D) in
    q's dtype.

    Rank r holds global rows [r·Sl, (r+1)·Sl).  Step t attends to the chunk
    that started at rank (r − t) mod n (chunks move +1 a step) with a
    streaming softmax (m, l, acc) in f32, as the flash decode kernels do,
    so the result is the single-device attention's to f32 rounding.  A
    chunk wholly in the causal future of the rank's rows skips its work
    (its hop still runs: every rank takes part); GQA heads repeat per
    chunk, so only H_kv heads travel."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, sl, nh, d = q.shape
    rep = nh // k.shape[1]
    if scale is None:
        scale = 1.0 / d ** 0.5
    qh = q.transpose(1, 2).float()                         # (B, H, Sl, D)
    q_off = r * sl
    qi = torch.arange(sl, device=q.device)[:, None]
    kj = torch.arange(sl, device=q.device)[None, :]
    m = torch.full((b, nh, sl, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nh, sl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nh, sl, d), dtype=torch.float32, device=q.device)
    mask = None if attn_mask is None else attn_mask.to(torch.int32)
    chunk = [k, v] + ([] if mask is None else [mask])
    for t in range(n):
        k_off = ((r - t) % n) * sl
        # the next hop goes out before this chunk's work (n hops, as the
        # JAX loop's: the last brings each chunk home)
        hops = [comm.ring_hop_start(c, group) for c in chunk]
        if k_off <= q_off + sl - 1:
            k_c, v_c = chunk[0], chunk[1]
            if rep != 1:
                k_c, v_c = k_c.repeat_interleave(rep, 1), v_c.repeat_interleave(rep, 1)
            s = torch.einsum("bhqd,bhkd->bhqk", qh, k_c.float()) * scale
            s = torch.where((k_off + kj) <= (q_off + qi), s, NEG_INF)
            if mask is not None:
                s = torch.where(chunk[2][:, None, None, :].bool(), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            # a fully masked chunk would give exp(NEG_INF − NEG_INF) = 1
            p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m_new))
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_c.float())
            m = m_new
        chunk = [h.wait() for h in hops]
    out = acc / torch.clamp(l, min=1e-30)               # every row sees itself: l > 0
    return out.transpose(1, 2).to(q.dtype)


def make_cp_prefill(mod, cfg, mesh, *, compute: str = "auto", quant=None):
    """build(params) → fwd(params, ids) → f32 logits (B, S, V)
    (cp.py:151-177): ids (B, S) whole on every rank, S % cp == 0; the rank
    takes its S / cp tokens at their global positions, runs the forward
    with ring attention, and the ranks' logits are all-gathered along S."""
    from smoothquant_tpu_torch.models.common import ForwardContext

    group = axis_group(mesh, CP_AXIS)
    cp, r = dist.get_world_size(group), dist.get_rank(group)

    def build(params):
        ctx = ForwardContext(quant=quant, compute=compute, cp_group=group)

        @torch.no_grad()
        def fwd(local_params, ids):
            b, s = ids.shape
            if s % cp:
                raise ValueError(f"sequence {s} not divisible by cp={cp}")
            sl = s // cp
            positions = r * sl + torch.arange(sl, device=ids.device).expand(b, sl)
            logits, _ = mod.forward(local_params, ids[:, r * sl:(r + 1) * sl], cfg, ctx=ctx,
                                    positions=positions)
            return comm.all_gather(logits, group, axis=1)

        return fwd

    return build

"""Expert parallelism for MoE models (port of
smoothquant_tpu/parallel/ep.py).

The experts of every layer are stacked on a leading E axis
(mixtral.stack_experts) and split over the "ep" ranks, E / ep each
(ep_specs, parallel.mesh.shard_tree):

  * the router runs whole on every rank (its output is E logits);
  * each rank gathers the capacity-bounded token buffers of its own
    experts (models.mixtral._moe_block_sparse under
    ForwardContext.ep_group);
  * the ranks' partial MoE outputs are all-reduced: one all-reduce a MoE
    block, no all-to-all.

Capacity, routing and drops follow the GLOBAL assignment order on every
rank, so with top-2 each token's output is the single-device sparse
dispatch's sum of its two weighted expert outputs (a + b in f32 either
way).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from smoothquant_tpu_torch.kernels.pack import PackedLinear
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.parallel.mesh import axis_group, shard_tree

EP_AXIS = "ep"


def make_ep_mesh(ep: Optional[int] = None):
    """A 1-D ("ep",) DeviceMesh over the default group's ranks
    (ep.py:33-38); ep, if given, must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if ep is not None and ep != n:
        raise ValueError(f"ep={ep}: an ep mesh spans the {n} ranks")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu", torch.arange(n),
                      mesh_dim_names=(EP_AXIS,))


def ep_specs(params: dict) -> dict:
    """The spec tree (ep.py:46-67): every leaf under an experts "stacked"
    subtree split on its leading (expert) axis, everything else whole."""

    def walk(node, stacked=False):
        if isinstance(node, PackedLinear):
            return dict.fromkeys(("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask"),
                                 0 if stacked else None)
        if isinstance(node, dict):
            return {k: walk(v, stacked or k == "stacked") for k, v in node.items()}
        return 0 if stacked and node is not None else None

    return walk(params)


def ep_local(params: dict, mesh) -> dict:
    """This rank's params of a stack_experts tree: its block of experts."""
    group = axis_group(mesh, EP_AXIS)
    return shard_tree(params, ep_specs(params), dist.get_rank(group),
                      dist.get_world_size(group))


def make_ep_forward(mod, cfg, mesh, *, compute: str = "auto", capacity_factor: float = 2.0):
    """build(params) → fwd(params, ids) → f32 logits (ep.py:70-104), params
    the rank's ep_local tree: sparse dispatch with the given capacity
    factor, each rank running its experts."""
    group = axis_group(mesh, EP_AXIS)
    ep = dist.get_world_size(group)
    if cfg.num_local_experts % ep:
        raise ValueError(f"num_local_experts {cfg.num_local_experts} not divisible by ep={ep}")

    def build(params):
        ctx = ForwardContext(compute=compute, moe_dispatch="sparse",
                             moe_capacity_factor=capacity_factor, ep_group=group)

        @torch.no_grad()
        def fwd(local_params, ids):
            return mod.forward(local_params, ids, cfg, ctx=ctx)[0]

        return fwd

    return build

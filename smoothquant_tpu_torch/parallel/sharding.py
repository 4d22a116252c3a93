"""Tensor-parallel sharding of plain and simulated-quantized trees (port
of smoothquant_tpu/parallel/sharding.py).

Megatron-style styles per projection name (the JAX package's tables):
column-parallel ("col_parallel": weight (out, in) split on out, bias with
it) for q / k / v / gate / up / fc1 / query_key_value / dense_h_to_4h /
the experts' w1 / w3; row-parallel ("row_parallel": split on in, bias
whole) for o_proj / down_proj / out_proj / fc2 / dense / dense_4h_to_h /
w2; the Mixtral router replicated.  Embeddings and an untied lm_head are
split on the vocabulary, norms whole, salient metadata whole (it indexes
the whole layer's input channels).

In the JAX package GSPMD keeps the global math of jit(mod.forward) over
the sharded arrays.  Here each rank holds its slices (shard_params: its
linears as models.common.ShardedLinear) and sharded_forward runs the
rank's part with explicit collectives to the single-device result, up to
the order of the row-parallel sums: a column-parallel linear's outputs
are all-gathered; a row-parallel linear's activation quantizer runs on
the whole input row, which every rank holds, before the rank takes its
K-slice (a per-token scale of the slice would be another quantizer); the
embedding table is all-gathered for the lookup; an untied lm_head's
logits are computed on the rank's vocabulary rows and all-gathered.

Groups straddle K-shards of a row-parallel layer unless group_size |
in_features / tp: assert_group_shardable checks it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from smoothquant_tpu_torch.models.common import ForwardContext, ShardedLinear
from smoothquant_tpu_torch.parallel import comm
from smoothquant_tpu_torch.parallel.mesh import TP_AXIS, axis_group, shard_tree

COL = "col_parallel"  # weight (out, in) sharded on out
ROW = "row_parallel"  # weight (out, in) sharded on in
REP = "replicated"

LLAMA_LINEAR_STYLES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "o_proj": ROW,
    "gate_proj": COL, "up_proj": COL, "down_proj": ROW,
}
OPT_LINEAR_STYLES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "out_proj": ROW,
    "fc1": COL, "fc2": ROW,
}
FALCON_LINEAR_STYLES = {
    "query_key_value": COL, "dense": ROW,
    "dense_h_to_4h": COL, "dense_4h_to_h": ROW,
}
MIXTRAL_LINEAR_STYLES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "o_proj": ROW,
    "gate": REP, "w1": COL, "w3": COL, "w2": ROW,
}
ARCH_LINEAR_STYLES = {
    "llama": LLAMA_LINEAR_STYLES, "mistral": LLAMA_LINEAR_STYLES,
    "opt": OPT_LINEAR_STYLES,
    "falcon": FALCON_LINEAR_STYLES, "bloom": FALCON_LINEAR_STYLES,
    "mixtral": MIXTRAL_LINEAR_STYLES,
}
_EMBEDDINGS = ("embed_tokens", "word_embeddings")
_STYLE_OF_AXIS = {0: "col", 1: "row"}


def _linear_spec(style: str, node: dict) -> dict:
    w, b = {COL: (0, 0), ROW: (1, None)}.get(style, (None, None))
    return {k: w if k == "weight" else b if k == "bias" else None for k in node}


def _match(subtree: dict, styles: dict) -> dict:
    out = {}
    for name, child in subtree.items():
        if not isinstance(child, dict):
            out[name] = None
        elif "weight" in child and name in styles:
            out[name] = _linear_spec(styles[name], child)
        elif "weight" in child:        # norms and other unlisted leaves: whole
            out[name] = dict.fromkeys(child)
        else:
            out[name] = _match(child, styles)
    return out


def param_specs(arch: str, params: dict) -> dict:
    """The spec tree of `params` for a registered architecture
    (sharding.py:85-100): each leaf's split axis or None."""
    try:
        styles = ARCH_LINEAR_STYLES[arch]
    except KeyError:
        raise ValueError(f"no TP styles for arch {arch!r} "
                         f"(have {sorted(ARCH_LINEAR_STYLES)})") from None
    specs = _match(params, styles)
    for emb in _EMBEDDINGS:
        if emb in specs:
            specs[emb] = {"weight": 0}
    if "lm_head" in specs:
        specs["lm_head"] = {"weight": 0, "bias": 0}
    return specs


def _wrap(local, specs, top=True):
    """Linears of a sharded tree as ShardedLinear, by their weight's axis
    (the embeddings and the lm_head stay plain: sharded_forward handles
    them)."""
    if not isinstance(local, dict):
        return local
    ax = specs.get("weight") if isinstance(specs, dict) and "weight" in local else None
    if isinstance(ax, int):
        return ShardedLinear(params=local, style=_STYLE_OF_AXIS[ax])
    return {k: (v if top and k in (*_EMBEDDINGS, "lm_head")
                else _wrap(v, None if specs is None else specs.get(k), False))
            for k, v in local.items()}


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """This rank's slices of `params` along its mesh's "tp" axis (the
    counterpart of device_put onto the mesh, sharding.py:103-110): the
    split linears as ShardedLinear, the rest as slices or whole."""
    group = axis_group(mesh, TP_AXIS)
    r, n = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    return _wrap(shard_tree(params, specs, r, n), specs)


def assert_group_shardable(in_features: int, tp: int, group_size: int) -> None:
    """Groups must not straddle TP shards for row-parallel layers."""
    shard = in_features // tp
    if in_features % tp or shard % group_size:
        raise ValueError(
            f"group_size={group_size} straddles TP shards "
            f"(in_features={in_features}, tp={tp}, shard={shard}); pick group_size | shard")


@torch.no_grad()
def sharded_forward(mod, params: dict, ids: torch.Tensor, cfg, mesh,
                    ctx: Optional[ForwardContext] = None) -> torch.Tensor:
    """f32 logits (B, S, V) of a shard_params tree on this rank, the
    single-device forward's up to the order of the row-parallel sums:
    the embedding table all-gathered for the lookup, the layers through
    ShardedLinear call sites under ctx (its quant recipe, if any) with the
    mesh's tp group, and an untied lm_head on the rank's vocabulary rows,
    its logits all-gathered."""
    group = axis_group(mesh, TP_AXIS)
    ctx = dataclasses.replace(ctx or ForwardContext(), tp_group=group)
    tree = dict(params)
    for emb in _EMBEDDINGS:
        if emb in tree:
            tree[emb] = {**tree[emb], "weight": comm.all_gather(tree[emb]["weight"], group, 0)}
    h, _ = mod.forward_hidden(tree, ids, cfg, ctx=ctx)
    lm = tree.get("lm_head")
    logits = mod.lm_head_logits(tree, h, cfg, ctx)
    if isinstance(lm, dict) and not getattr(cfg, "tie_word_embeddings", False):
        logits = comm.all_gather(logits, group, -1)
    return logits

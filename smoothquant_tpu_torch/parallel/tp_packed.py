"""Tensor parallelism of the packed (real-kernel) path (port of
smoothquant_tpu/parallel/tp_packed.py).

Each PackedLinear's meta.tp_reduce says how the ranks of the tp group
combine its outputs (ForwardContext.tp_group, models.common.call_linear):

v1 (pack_model's packs, tp_reduce "gather"): every quantizable linear is
column-parallel.  A rank holds the O-shard of its weights, group scales,
salient block and bias (the channel permutation and everything indexed by
input channel whole), runs its kernel on the shard and all-gathers the
outputs.  The activation is quantized whole on every rank, so each output
column is the single-card one: one all-gather a linear.

v2 (pack_model_tp, Megatron): q / k / v / gate / up are column-parallel
with tp_reduce "none", their outputs left head / neuron-sharded, so the
attention runs on the rank's heads over a KV cache of those heads alone;
o_proj / down_proj are row-parallel ("psum", pack_linear_row_sharded:
each K-shard packed on its own), their partial products all-reduced: two
all-reduces a layer, and the cache split tp ways.

A rank takes its slice with local_shard (what shard_map's in_specs does
in the JAX package); meta keeps the global dimensions of a column pack
and one shard's of a row pack, as under shard_map.  The make_* functions
take a DeviceMesh with a "tp" axis or a ProcessGroup, and return
build(params), whose result runs the rank's part of the forward on its
local params.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from smoothquant_tpu_torch.kernels.pack import PackedLinear
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache, QuantKVCache
from smoothquant_tpu_torch.parallel.mesh import TP_AXIS, axis_group, shard_tree


def _packed_specs(p: PackedLinear) -> dict:
    """The split axis of each field (tp_packed.py:47-75): a "psum" pack's
    leading (K-concatenated) axis of w_qt, w_scales_t, w_sal_t, perm and
    ns_mask, its bias whole; a "gather" / "none" pack's last (O) axis of
    w_qt, w_scales_t, w_sal_t and the bias, perm and ns_mask whole; a "rep"
    pack whole."""
    if p.meta.tp_reduce == "psum":
        return {"w_qt": 0, "w_scales_t": 0, "w_sal_t": 0, "bias": None, "perm": 0,
                "ns_mask": 0}
    if p.meta.tp_reduce == "rep":
        return dict.fromkeys(("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask"))
    o_axis = lambda t: None if t is None else t.ndim - 1
    return {"w_qt": o_axis(p.w_qt), "w_scales_t": o_axis(p.w_scales_t),
            "w_sal_t": o_axis(p.w_sal_t), "bias": o_axis(p.bias), "perm": None,
            "ns_mask": None}


def packed_model_specs(params):
    """The spec tree of a packed tree: each PackedLinear's field axes
    (_packed_specs), every other leaf whole (None)."""
    if isinstance(params, PackedLinear):
        return _packed_specs(params)
    if isinstance(params, dict):
        return {k: packed_model_specs(v) for k, v in params.items()}
    return None


def local_shard(params, rank: int, world: int):
    """Rank `rank` of `world`'s local params of a global packed tree (the
    counterpart of shard_map's in_specs over packed_model_specs)."""
    return shard_tree(params, packed_model_specs(params), rank, world)


def assert_tp_divisible(params, tp: int) -> None:
    """Every column-parallel pack's out_features divisible by tp
    (tp_packed.py:90-104); "psum" packs are K-concatenated shards by
    construction, "rep" packs whole."""
    if isinstance(params, PackedLinear):
        if params.meta.tp_reduce in ("gather", "none") and params.meta.out_features % tp:
            raise ValueError(f"out_features {params.meta.out_features} not divisible by "
                             f"tp={tp}")
    elif isinstance(params, dict):
        for v in params.values():
            assert_tp_divisible(v, tp)


def pack_model_tp(arch: str, params: dict, cfg, qcfg, tp: int,
                  input_feat: Optional[dict] = None, act_scales: Optional[dict] = None,
                  compute_dtype=None, nibble: bool = False, lm_head_qcfg=None) -> dict:
    """Megatron-aware packing (tp_packed.py:107-152): column layers packed
    whole (tp_reduce "none", split on O by local_shard), row layers packed
    per K-shard (pack_linear_row_sharded, "psum"), replicated layers (the
    Mixtral router) whole ("rep"); with lm_head_qcfg the lm_head is packed
    as a v1 column layer ("gather": its vocabulary O-sharded)."""
    from smoothquant_tpu_torch.kernels.pack import pack_linear, pack_linear_row_sharded
    from smoothquant_tpu_torch.models.registry import get_arch
    from smoothquant_tpu_torch.parallel.sharding import ARCH_LINEAR_STYLES, COL, REP, ROW
    from smoothquant_tpu_torch.quant.smooth import _get_path, _set_path

    mod = get_arch(arch)
    styles = ARCH_LINEAR_STYLES[arch]
    compute_dtype = compute_dtype or cfg.torch_dtype
    for path, key, _qo in mod.quantizable_linears(cfg):
        style = styles.get(path[-1], COL)
        lin = _get_path(params, path)
        imp = None if input_feat is None else np.asarray(input_feat[key])
        absmax = None if act_scales is None else np.asarray(act_scales[key])
        if style == ROW:
            packed = pack_linear_row_sharded(lin, qcfg, tp, importance=imp, act_absmax=absmax,
                                             compute_dtype=compute_dtype, nibble=nibble)
        else:
            packed = pack_linear(lin, qcfg, importance=imp, act_absmax=absmax,
                                 compute_dtype=compute_dtype, nibble=nibble)
            if style == COL and packed.meta.out_features % tp:
                raise ValueError(f"{'.'.join(path)}: out_features "
                                 f"{packed.meta.out_features} not divisible by tp={tp}")
            packed = dataclasses.replace(packed, meta=dataclasses.replace(
                packed.meta, tp_reduce="rep" if style == REP else "none"))
        params = _set_path(params, path, packed)
    if lm_head_qcfg is not None and isinstance(params.get("lm_head"), dict):
        params = dict(params)
        params["lm_head"] = pack_linear(params["lm_head"], lm_head_qcfg,
                                        compute_dtype=compute_dtype)
    return params


def _group_of(mesh):
    group = axis_group(mesh, TP_AXIS)
    return group, dist.get_world_size(group)


def _local_config(cfg, tp: int, who: str):
    """cfg over a rank's heads: local head counts, the global head width
    (tp_packed.py:173-183)."""
    nh = cfg.num_attention_heads
    nkv = getattr(cfg, "num_key_value_heads", nh)
    if not any(f.name == "head_dim_value" for f in dataclasses.fields(cfg)):
        raise NotImplementedError(f"{who} needs a config with head_dim_value (llama-family); "
                                  "use make_tp_forward for other archs")
    if nh % tp or nkv % tp:
        raise ValueError(f"tp={tp} must divide heads ({nh}) and kv heads ({nkv})")
    return dataclasses.replace(cfg, num_attention_heads=nh // tp,
                               num_key_value_heads=nkv // tp, head_dim_value=cfg.head_dim)


def make_tp_forward(mod, cfg, qcfg, mesh, *, compute: str = "auto"):
    """v1 (tp_packed.py:261-292): build(params) → fwd(params, ids) → f32
    logits (B, S, V), params the rank's local_shard of a pack_model tree;
    every linear computes its O-shard and all-gathers."""
    group, tp = _group_of(mesh)

    def build(params):
        assert_tp_divisible(params, tp)
        ctx = ForwardContext(quant=qcfg, compute=compute, tp_group=group)

        @torch.no_grad()
        def fwd(local_params, ids):
            return mod.forward(local_params, ids, cfg, ctx=ctx)[0]

        return fwd

    return build


def make_tp_forward_v2(mod, cfg, mesh, *, compute: str = "auto", overlap_chunks: int = 0):
    """v2, Megatron (tp_packed.py:155-203): build(params) → fwd(params,
    ids) → f32 logits, params the rank's local_shard of a pack_model_tp
    tree; attention on the rank's heads, o_proj / down_proj all-reduced:
    two all-reduces a layer.  overlap_chunks > 1 splits each row-parallel
    reduce over the token axis (ForwardContext.tp_overlap_chunks)."""
    group, tp = _group_of(mesh)
    cfg_local = _local_config(cfg, tp, "make_tp_forward_v2")

    def build(params):
        ctx = ForwardContext(compute=compute, tp_group=group, tp_overlap_chunks=overlap_chunks)

        @torch.no_grad()
        def fwd(local_params, ids):
            return mod.forward(local_params, ids, cfg_local, ctx=ctx)[0]

        return fwd

    return build


def local_caches(caches: list, rank: int, world: int) -> list:
    """The rank's heads of per-layer KVCache / QuantKVCache lists over all
    the heads (the head axis split as make_tp_decode_v2's shard_map splits
    it, tp_packed.py:221-228), contiguous copies."""
    out = []
    for c in caches:
        spec = {f.name: (None if f.name == "pos" else 1) for f in dataclasses.fields(c)}
        out.append(type(c)(**shard_tree({f: getattr(c, f) for f in spec}, spec, rank,
                                        world)))
    return out


def make_tp_decode_v2(mod, cfg, mesh, *, compute: str = "auto"):
    """The Megatron decode step over a head-sharded KV cache
    (tp_packed.py:206-258): build(params) →
    step(params, ids, caches) → (f32 logits, caches), params the rank's
    local_shard of a pack_model_tp tree and caches per-layer KVCache /
    QuantKVCache over the rank's step.kv_heads heads (local_caches of
    caches over all heads, or a Generator's: it builds caches of a
    forward_fn's kv_heads).  The packed linears run as in
    make_tp_forward_v2; each rank attends over its heads only, so the
    cache's memory splits tp ways."""
    group, tp = _group_of(mesh)
    cfg_local = _local_config(cfg, tp, "make_tp_decode_v2")
    kv_heads = cfg_local.num_key_value_heads

    def build(params):
        ctx = ForwardContext(compute=compute, tp_group=group)

        @torch.no_grad()
        def step(local_params, ids, caches):
            for c in caches:
                if not isinstance(c, (KVCache, QuantKVCache)):
                    raise NotImplementedError(f"cache type {type(c).__name__}")
                h = (c.k_q if isinstance(c, QuantKVCache) else c.k).shape[1]
                if h != kv_heads:
                    raise ValueError(f"the step takes per-layer caches of the rank's "
                                     f"{kv_heads} kv heads (local_caches), not {h}")
            return mod.forward(local_params, ids, cfg_local, ctx=ctx, caches=caches)

        step.kv_heads = kv_heads
        return step

    return build

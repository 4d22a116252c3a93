"""Parameters of the JAX package → the port's (torch tensors and
PackedLinear leaves).

The input is a nested dict of numpy arrays (the JAX tree flattened by the
caller, so the port never sees a JAX type).  A packed linear is a dict
holding its fields (w_qt, w_scales_t, w_sal_t, bias, perm, ns_mask) and
its PackedMeta as a plain dict under "meta" (a tensor-parallel pack of any
tp_reduce too: a row-parallel "psum" pack arrives K-concatenated, as
pack_linear_row_sharded builds it, a column-parallel one whole, and a
rank takes its slice with parallel.tp_packed.local_shard); an
identity-int8 pack
(promote_int8's, or the per-channel lm_head) gets its weight stored
K-major (kernels/pack.k_major), as the port's own packs hold it.  Plain
and transposed-fp ("weight_t", llama.pack_fp_decode) linears are dicts of
arrays and convert leaf by leaf — the fp OPT tree among them, and the
simulated trees of quantize_model, whose int32 "sal_perm", "sal_inv_perm"
and "salient_indices" leaves become int64, the index dtype the port's
quantize_linear_params stores them in.  The real-INT8
OPT tree (opt_int8.from_float's) converts by int8_opt_from_numpy.  bfloat16
arrays may arrive as any numpy dtype named "bfloat16".  A tree carries
whatever leaves it has: a tied tree without an lm_head converts to a tied
tree.  config_from builds the port's config of a family from the JAX
package's (or any object or dict with the same field names), every field
the port's class declares carried across unchanged (Mistral's
sliding_window and tie_word_embeddings among them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels.pack import PackedLinear, PackedMeta, k_major
from smoothquant_tpu_torch.models.opt_int8 import Int8Linear, Int8OPTLayerParams

_FIELDS = ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")
_INDEX_LEAVES = ("sal_perm", "sal_inv_perm", "salient_indices")
_META_FIELDS = {f.name for f in dataclasses.fields(PackedMeta)}
TP_REDUCES = ("gather", "none", "psum", "rep")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on `device`.  bfloat16 arrives as any
    dtype named "bfloat16", or as the raw 2-byte void ("|V2") that np.savez
    writes for one: fp16 is saved as "<f2", so a "|V2" leaf is bf16."""
    a = np.ascontiguousarray(a)
    bf16 = a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2")
    if bf16:
        a = a.view(np.int16)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if bf16 else t).to(device, copy=True)


def packed_from_numpy(d: dict, device) -> PackedLinear:
    meta = dict(d["meta"])
    if meta.get("tp_reduce", "gather") not in TP_REDUCES:
        raise ValueError(f"tp_reduce {meta['tp_reduce']!r}: one of {TP_REDUCES}")
    if d.get("sal_select") is not None:
        raise NotImplementedError("block_decode_tree packs are TPU-only")
    unknown = set(meta) - _META_FIELDS
    if unknown:
        raise ValueError(f"unknown PackedMeta fields {sorted(unknown)}")
    t = {f: None if d.get(f) is None else tensor_from_numpy(d[f], device)
         for f in _FIELDS}
    t["perm"] = t["perm"].to(torch.int64)
    meta = PackedMeta(**meta)
    if meta.layout == "identity" and not meta.nibble:
        t["w_qt"] = k_major(t["w_qt"])
    return PackedLinear(meta=meta, **t)


def config_from(cls, src):
    """An instance of the port's config dataclass `cls` with each of its
    fields read from `src` (an object with those attributes, or a dict); a
    field `src` lacks keeps cls's default."""
    get = src.get if isinstance(src, dict) else (lambda k, d: getattr(src, k, d))
    missing = object()
    vals = {f.name: get(f.name, missing) for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vals.items() if v is not missing})


def params_from_numpy(tree, device="cuda"):
    """Convert a flattened JAX params tree; see the module docstring."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if node is None:
            return None
        if isinstance(node, dict):
            if "meta" in node and "w_qt" in node:
                return packed_from_numpy(node, dev)
            return {k: walk(v, k) for k, v in node.items()}
        t = tensor_from_numpy(node, dev)
        return t.to(torch.int64) if key in _INDEX_LEAVES else t

    return walk(tree)


def int8_opt_from_numpy(tree: dict, device="cuda") -> dict:
    """Convert the JAX package's Int8 OPT tree (opt_int8.from_float): its fp
    entries leaf by leaf, each of "int8_layers" — an Int8OPTLayerParams, or
    a dict of its fields, with numpy leaves — into the port's, the scales
    and each Int8Linear's alpha as Python floats."""
    dev = resolve_device(device)

    def field(node, name):
        return node[name] if isinstance(node, dict) else getattr(node, name)

    def t(a):
        return tensor_from_numpy(a, dev)

    def lin(node):
        return Int8Linear(w_q=t(field(node, "w_q")), bias=t(field(node, "bias")).float(),
                          alpha=float(np.asarray(field(node, "alpha"))))

    layers = []
    for lp in tree["int8_layers"]:
        kw = {f: t(field(lp, f)) for f in ("ln_attn_gamma", "ln_attn_beta",
                                           "ln_fc_gamma", "ln_fc_beta")}
        kw.update({p: lin(field(lp, p)) for p in ("q_proj", "k_proj", "v_proj",
                                                  "out_proj", "fc1", "fc2")})
        scales = {k: float(np.asarray(v)) for k, v in field(lp, "scales").items()}
        layers.append(Int8OPTLayerParams(scales=scales, **kw))
    out = params_from_numpy({k: v for k, v in tree.items() if k != "int8_layers"}, dev)
    out["int8_layers"] = layers
    return out

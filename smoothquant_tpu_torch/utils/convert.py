"""Parameters of the JAX package → the port's (torch tensors and
PackedLinear leaves).

The input is a nested dict of numpy arrays (the JAX tree flattened by the
caller, so the port never sees a JAX type).  A packed linear is a dict
holding its fields (w_qt, w_scales_t, w_sal_t, bias, perm, ns_mask) and
its PackedMeta as a plain dict under "meta"; an identity-int8 pack
(promote_int8's, or the per-channel lm_head) gets its weight stored
K-major (kernels/pack.k_major), as the port's own packs hold it.  Plain
and transposed-fp ("weight_t", llama.pack_fp_decode) linears are dicts of
arrays and convert leaf by leaf.  bfloat16 arrays may arrive as any numpy
dtype named "bfloat16".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels.pack import PackedLinear, PackedMeta, k_major

_FIELDS = ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")
_META_FIELDS = {f.name for f in dataclasses.fields(PackedMeta)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def packed_from_numpy(d: dict, device) -> PackedLinear:
    meta = dict(d["meta"])
    if meta.pop("tp_reduce", "gather") != "gather":
        raise NotImplementedError("tensor-parallel packs are not ported")
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


def params_from_numpy(tree, device="cuda"):
    """Convert a flattened JAX params tree; see the module docstring."""
    dev = resolve_device(device)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            if "meta" in node and "w_qt" in node:
                return packed_from_numpy(node, dev)
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return walk(tree)

"""SmoothQuant smoothing: a params→params weight transform (port of
smoothquant_tpu/quant/smooth.py:24-106).

For a norm feeding a set of linears: s = clamp(act_max^α / w_max^(1-α),
1e-5) per input channel, in float32; the norm's weight (and bias) are
divided by s and the linears' input columns multiplied by it.  Runs on the
device the weights lie on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_EPS = 1e-5


def compute_smoothing_scales(act_scales, weights: Sequence[torch.Tensor],
                             alpha: float) -> torch.Tensor:
    """s = clamp(act^α / w_max^(1-α), 1e-5) in float32; w_max is the
    column-wise absmax over every consuming linear's (out_i, C) weight."""
    dev = weights[0].device
    a = torch.as_tensor(np.asarray(act_scales, np.float32), device=dev)
    w_max = torch.stack([w.float().abs().amax(dim=0) for w in weights]).amax(dim=0)
    w_max = torch.clamp_min(w_max, _EPS)
    s = torch.pow(a, alpha) / torch.pow(w_max, 1.0 - alpha)
    return torch.clamp_min(s, _EPS)


def smooth_norm_linears(norm_params: dict, linear_params: Sequence[dict],
                        act_scales, alpha: float = 0.5):
    """Fold the smoothing scales into one norm (LayerNorm with bias, or
    RMSNorm) and its consuming linears; returns (norm, [linears])."""
    s = compute_smoothing_scales(act_scales, [p["weight"] for p in linear_params],
                                 alpha)
    new_norm = dict(norm_params)
    nw = norm_params["weight"]
    new_norm["weight"] = (nw.float() / s).to(nw.dtype)
    if norm_params.get("bias") is not None:
        nb = norm_params["bias"]
        new_norm["bias"] = (nb.float() / s).to(nb.dtype)
    new_linears = []
    for p in linear_params:
        q = dict(p)
        q["weight"] = (p["weight"].float() * s[None, :]).to(p["weight"].dtype)
        new_linears.append(q)
    return new_norm, new_linears


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_path(tree, path, value):
    if not path:
        return value
    new = dict(tree)
    new[path[0]] = _set_path(tree[path[0]], path[1:], value)
    return new


def smooth_model(params: dict, smoothing_map, act_scales: dict,
                 alpha: float = 0.5) -> dict:
    """Smooth a whole params tree: smoothing_map holds (norm_path,
    [linear_paths], scales_key) entries; act_scales is keyed by HF-style
    module names."""
    for norm_path, linear_paths, scales_key in smoothing_map:
        if scales_key not in act_scales:
            raise KeyError(f"activation scales missing key: {scales_key}")
        new_norm, new_linears = smooth_norm_linears(
            _get_path(params, norm_path), [_get_path(params, p) for p in linear_paths],
            act_scales[scales_key], alpha)
        params = _set_path(params, norm_path, new_norm)
        for p, lp in zip(linear_paths, new_linears):
            params = _set_path(params, p, lp)
    return params

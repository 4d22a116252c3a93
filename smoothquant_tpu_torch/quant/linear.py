"""The simulated quantized linear (port of smoothquant_tpu/quant/linear.py),
the reference's W4A4Linear as two functions over a params dict:

  quantize_linear_params(params, cfg, importance): the offline weight Q-DQ
    at cfg.weight_quant granularity, then the salient input columns
    restored to their original values (W4A4Linear.from_float);
  quant_linear(params, x, cfg, quantize_output): the forward — the
    activation Q-DQ of the non-salient channels, the matmul, and with
    quantize_output the same quantizer on the output.

params["weight"] is (out_features, in_features); y = x @ W.T + b.

The output Q-DQ is salient-agnostic (the whole output), as in the JAX
package (linear.py:17-21): the reference applies the INPUT channels'
salient mask to the output columns, which holds only for square layers;
neither package copies that.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch.quant import core
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.saliency import (
    salient_partition_perm,
    select_salient_indices,
)
from smoothquant_tpu_torch.quant.smooth import _get_path, _set_path

LinearParams = dict


def linear(params: LinearParams, x: torch.Tensor) -> torch.Tensor:
    """Plain linear: x @ W.T + b in x's dtype."""
    y = torch.matmul(x, params["weight"].t().to(x.dtype))
    if params.get("bias") is not None:
        y = y + params["bias"].to(x.dtype)
    return y


def quantize_linear_params(params: LinearParams, cfg: QuantConfig,
                           importance: Optional[np.ndarray] = None) -> LinearParams:
    """Weight Q-DQ with the salient columns restored (linear.py:47-80).

    With an importance vector and cfg.salient_prop > 0, the
    cfg.num_salient(in_features) most important input columns keep their
    original values, and the result carries "sal_perm" / "sal_inv_perm"
    (salient_partition_perm) and "salient_indices" (descending importance)
    as int64 tensors on the weight's device — the index dtype of torch's
    gathers, taken once here (the JAX package stores int32;
    utils.convert widens those at load).  The weight Q-DQ divides exactly:
    the reference flow quantizes the weights eagerly (cli/ppl_eval.py)."""
    w = params["weight"]
    in_features = w.shape[1]
    k = cfg.num_salient(in_features) if importance is not None else 0
    wq_fn = core.get_weight_quantizer(cfg.weight_quant, cfg.quant_bits, cfg.group_size,
                                      cfg.sort_strategy)
    new = {"weight": wq_fn(w).contiguous(), "bias": params.get("bias")}
    if k > 0:
        sal_idx = select_salient_indices(np.asarray(importance), k)
        perm, inv_perm = salient_partition_perm(in_features, sal_idx)
        idx = lambda a: torch.as_tensor(a.astype(np.int64), device=w.device)
        sal = idx(sal_idx)
        new["weight"][:, sal] = w[:, sal]
        new["sal_perm"], new["sal_inv_perm"] = idx(perm), idx(inv_perm)
        new["salient_indices"] = sal
    return new


def quantize_linears(params: dict, listing, cfg: QuantConfig,
                     input_feat: Optional[dict] = None) -> dict:
    """quantize_linear_params at every (params path, stats key, _) of
    `listing` (a model's quantizable_linears), each linear's importance
    input_feat[stats key] when given; a new tree, `params` untouched."""
    for path, key, _ in listing:
        imp = None if input_feat is None else np.asarray(input_feat[key])
        params = _set_path(params, path,
                           quantize_linear_params(_get_path(params, path), cfg, imp))
    return params


def _act_quantizer(cfg: QuantConfig):
    return core.get_act_quantizer(cfg.act_quant, cfg.effective_act_bits, cfg.group_size,
                                  cfg.sort_strategy)


def _act_qdq(x2d: torch.Tensor, params: LinearParams, cfg: QuantConfig) -> torch.Tensor:
    """The activation Q-DQ with the salient channels passed through
    (linear.py:83-101): the non-salient columns, compacted by the static
    permutation, are quantized as one matrix (so per-token scales and
    group boundaries see only them, as the reference's x[:, non_salient]
    does) and scattered back."""
    aq = _act_quantizer(cfg)
    if "sal_perm" not in params:
        return aq(x2d)
    c = x2d.shape[-1]
    k = params["salient_indices"].shape[0]
    x_p = x2d.index_select(-1, params["sal_perm"])
    q_ns = aq(x_p[:, :c - k])
    return torch.cat([q_ns, x_p[:, c - k:]], dim=-1).index_select(-1, params["sal_inv_perm"])


def quant_linear(params: LinearParams, x: torch.Tensor, cfg: QuantConfig,
                 quantize_output: bool = False) -> torch.Tensor:
    """The simulated quantized linear's forward (linear.py:104-125).
    x: (..., in_features).  quantize_output applies the activation
    quantizer to the output too (the q / k / v projections under
    cfg.quantize_bmm_input).  Activation Q-DQ takes the jitted rule (the
    f32 reciprocal of q_max), as the JAX forward runs under jit."""
    shape = x.shape
    q_x = _act_qdq(x.reshape(-1, shape[-1]), params, cfg)
    y = torch.matmul(q_x, params["weight"].t().to(q_x.dtype))
    if params.get("bias") is not None:
        y = y + params["bias"].to(y.dtype)
    if quantize_output:
        y = _act_quantizer(cfg)(y)
    return y.reshape(*shape[:-1], y.shape[-1])

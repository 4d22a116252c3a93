"""Real-INT8 OPT decoder (port of smoothquant_tpu/models/opt_int8.py:36-277),
the reference's only real-kernel path (smoothquant/opt.py:23-481).

Every decoder-layer projection is a static-scale int8 GEMM (K15a), both
LayerNorms emit int8 directly (K16), and attention runs QKᵀ and PV as int8
batched products (K15b) with the softmax in f32 between them and the
probabilities requantized at 1/127.  Residual adds stay in f32; the
embeddings and the final LayerNorm come from the fp tree.

Scale plumbing (get_static_decoder_layer_scales_opt → layer_from_float):
  attn_input_scale   LN(q/k/v input) int8 scale
  q_output_scale     q_proj output int8 scale (× 1/√d when folded)
  k/v_output_scale   k/v_proj output int8 scales
  out_input_scale    out_proj input (= PV output) int8 scale
  fc1_input_scale    LN(fc input) int8 scale
  fc2_input_scale    fc2 input (= ReLU(fc1) output) int8 scale

Numerics: the three kernels copy the jitted JAX kernels (their fused
multiply-adds included); the glue copies the JAX forward's eager ops: the
mask value −1e9, jax.nn.softmax's exp(x − max) / Σ, round(p·127) clipped to
±127, the f32 layer_norm and unembed.  The caches are per-layer KVCaches
of int8 holding the raw static-scale k / v projections, so a cached decode
step equals the teacher-forced forward at that position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch.kernels.int8 import int8_bmm, int8_linear
from smoothquant_tpu_torch.kernels.norm_quant import layer_norm_q
from smoothquant_tpu_torch.models.common import layer_norm, unembed
from smoothquant_tpu_torch.models.opt import POS_OFFSET, OPTConfig, positions_from

MASK_VALUE = -1e9    # opt_int8.py:196


@dataclasses.dataclass
class Int8Linear:
    """Static-scale int8 linear: weights quantized at export time.
    w_q (O, K) int8; bias (O,) f32 in the OUTPUT domain; alpha the f32
    scalar s_in·s_w [/ s_out for int8 outputs], held as a Python float."""

    w_q: torch.Tensor
    bias: torch.Tensor
    alpha: float

    @classmethod
    def from_float(cls, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   input_scale: float, output_scale: Optional[float] = None):
        """Quantize an fp linear (opt_int8.py:45-65) in the float32 steps the
        JAX code takes under NumPy 2, each dtype spelled out:
        s_w = max(|w|.max(), 1e-8)/127; w_q = clip(round(w/s_w)); α =
        f32(input_scale)·s_w [then / f32(output_scale)]; bias /
        f32(output_scale).  Runs on the weight's device."""
        w = weight.float()
        amax = np.float32(w.abs().amax().item())
        s_w = np.float32(np.maximum(amax, np.float32(1e-8)) / np.float32(127.0))
        w_q = torch.round(w / torch.tensor(s_w, dtype=torch.float32, device=w.device))
        w_q = w_q.clamp(-127, 127)
        alpha = np.float32(np.float32(input_scale) * s_w)
        b = (torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
             if bias is None else bias.float())
        if output_scale is not None:
            so = np.float32(output_scale)
            alpha = np.float32(alpha / so)
            b = b / torch.tensor(so, dtype=torch.float32, device=w.device)
        return cls(w_q=w_q.to(torch.int8), bias=b, alpha=float(alpha))

    def __call__(self, x_q: torch.Tensor, *, relu: bool = False,
                 out_dtype=torch.float32) -> torch.Tensor:
        shape = x_q.shape
        y = int8_linear(x_q.reshape(-1, shape[-1]), self.w_q, self.alpha, self.bias,
                        relu=relu, out_dtype=out_dtype)
        return y.reshape(*shape[:-1], y.shape[-1])


@dataclasses.dataclass
class Int8OPTLayerParams:
    ln_attn_gamma: torch.Tensor
    ln_attn_beta: torch.Tensor
    ln_fc_gamma: torch.Tensor
    ln_fc_beta: torch.Tensor
    q_proj: Int8Linear
    k_proj: Int8Linear
    v_proj: Int8Linear
    out_proj: Int8Linear
    fc1: Int8Linear
    fc2: Int8Linear
    scales: dict  # the seven static scales (Python floats)


def layer_from_float(lp: dict, layer_scales: dict) -> Int8OPTLayerParams:
    """Int8OPTDecoderLayer.from_float (opt_int8.py:92-118): lp an fp layer of
    models/opt.py, layer_scales one entry of
    get_static_decoder_layer_scales_opt."""
    s = {k: float(v) for k, v in layer_scales.items()}
    sa = lp["self_attn"]

    def lin(p, s_in, s_out=None):
        return Int8Linear.from_float(p["weight"], p.get("bias"), s_in, s_out)

    return Int8OPTLayerParams(
        ln_attn_gamma=lp["self_attn_layer_norm"]["weight"],
        ln_attn_beta=lp["self_attn_layer_norm"]["bias"],
        ln_fc_gamma=lp["final_layer_norm"]["weight"],
        ln_fc_beta=lp["final_layer_norm"]["bias"],
        q_proj=lin(sa["q_proj"], s["attn_input_scale"], s["q_output_scale"]),
        k_proj=lin(sa["k_proj"], s["attn_input_scale"], s["k_output_scale"]),
        v_proj=lin(sa["v_proj"], s["attn_input_scale"], s["v_output_scale"]),
        out_proj=lin(sa["out_proj"], s["out_input_scale"]),
        fc1=lin(lp["fc1"], s["fc1_input_scale"], s["fc2_input_scale"]),
        fc2=lin(lp["fc2"], s["fc2_input_scale"]),
        scales=dict(s),
    )


def from_float(params: dict, cfg: OPTConfig, decoder_layer_scales: list,
               fold_q_scaling: bool = True) -> dict:
    """Int8OPTForCausalLM.from_float (opt_int8.py:121-157): fp embeddings and
    final LayerNorm, every decoder layer converted to static-scale int8.
    fold_q_scaling folds 1/√head_dim into the q projection (in f32) and its
    output scale before quantization."""
    d = cfg.head_dim
    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = params["layers"][str(i)]
        ls = decoder_layer_scales[i]
        if fold_q_scaling:
            f = np.float32(d ** -0.5)
            qp = dict(lp["self_attn"]["q_proj"])
            qp["weight"] = qp["weight"].float() * f
            if qp.get("bias") is not None:
                qp["bias"] = qp["bias"].float() * f
            lp = dict(lp, self_attn=dict(lp["self_attn"], q_proj=qp))
            ls = dict(ls, q_output_scale=ls["q_output_scale"] * (d ** -0.5))
        layers.append(layer_from_float(lp, ls))
    out = {k: params[k] for k in ("embed_tokens", "embed_positions",
                                  "final_layer_norm", "project_in", "project_out")
           if k in params}
    out["int8_layers"] = layers
    return out


def attention_mask(b: int, sq: int, sk: int, device, causal_offset=0,
                   valid_len=None, attn_mask: Optional[torch.Tensor] = None):
    """(B or 1, 1, Sq, Sk) bool: key j is seen by query i when j ≤ i +
    causal_offset, j < valid_len and attn_mask[b, j] (opt_int8.py:189-195).
    One mask serves every layer of a forward."""
    qi = torch.arange(sq, device=device).reshape(1, 1, sq, 1)
    kj = torch.arange(sk, device=device).reshape(1, 1, 1, sk)

    def per_batch(v):
        v = torch.as_tensor(v, device=device)
        return v.reshape(-1, 1, 1, 1) if v.ndim == 1 else v

    mask = kj <= qi + per_batch(causal_offset)
    if valid_len is not None:
        mask = mask & (kj < per_batch(valid_len))
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].bool()
    return mask


def _int8_attention(q8, k8, v8, scales: dict, cfg: OPTConfig, mask):
    """int8 QKᵀ → f32 softmax → int8 probs (·127) → int8 PV
    (opt_int8.py:165-205).  q8 (B, Sq, H) int8; k8 / v8 (B, nh, Sk, d) int8
    head-major — this call's projections or a whole cache; PV reads v in
    its (Sk, d) layout (int8_bmm's b_kn)."""
    b, sq, h = q8.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    sk = k8.shape[2]
    q3 = q8.reshape(b, sq, nh, d).transpose(1, 2).reshape(b * nh, sq, d)
    k3 = k8.reshape(b * nh, sk, d)
    v3 = v8.reshape(b * nh, sk, d)

    alpha_qk = scales["q_output_scale"] * scales["k_output_scale"]
    logits = int8_bmm(q3, k3, alpha_qk).reshape(b, nh, sq, sk)
    logits = torch.where(mask, logits, torch.full((), MASK_VALUE, device=logits.device))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).reshape(b * nh, sq, sk)
    probs8 = torch.round(probs * 127.0).clamp(-127, 127).to(torch.int8)

    alpha_pv = (1.0 / 127.0) * scales["v_output_scale"] / scales["out_input_scale"]
    ctx8 = int8_bmm(probs8, v3, alpha_pv, out_dtype=torch.int8, b_kn=True)
    return ctx8.reshape(b, nh, sq, d).transpose(1, 2).reshape(b, sq, h)


def forward(params: dict, input_ids: torch.Tensor, cfg: OPTConfig, ctx=None,
            caches: Optional[list] = None, positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None):
    """(logits f32 (B, S, V), updated caches) (opt_int8.py:208-277).
    caches: per-layer common.KVCache of int8 at the layers' static k / v
    output scales, or None.  ctx is accepted for the model-module contract
    and unused (the int8 path has no calibration taps)."""
    del ctx
    b, s = input_ids.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    x = params["embed_tokens"]["weight"][input_ids].float()
    if "project_in" in params:
        x = x @ params["project_in"]["weight"].t().float()
    if positions is None:
        positions = positions_from(caches, b, s, x.device)
    x = x + params["embed_positions"]["weight"][positions + POS_OFFSET].float()

    if caches is None:
        mask = attention_mask(b, s, s, x.device, attn_mask=attn_mask)
    else:
        pos = caches[0].pos
        mask = attention_mask(b, s, caches[0].k.shape[2], x.device, causal_offset=pos,
                              valid_len=pos + s, attn_mask=attn_mask)
    new_caches = None if caches is None else []
    for li, lp in enumerate(params["int8_layers"]):
        sc = lp.scales
        residual = x
        h8 = layer_norm_q(x.reshape(-1, x.shape[-1]), lp.ln_attn_gamma, lp.ln_attn_beta,
                          sc["attn_input_scale"], eps=cfg.layer_norm_eps).reshape(x.shape)
        q8 = lp.q_proj(h8, out_dtype=torch.int8)
        k4 = lp.k_proj(h8, out_dtype=torch.int8).reshape(b, s, nh, d)
        v4 = lp.v_proj(h8, out_dtype=torch.int8).reshape(b, s, nh, d)
        if caches is not None:
            cache = caches[li].update(k4, v4)
            ctx8 = _int8_attention(q8, *cache.read(), sc, cfg, mask)
            new_caches.append(cache)
        else:
            ctx8 = _int8_attention(q8, k4.transpose(1, 2), v4.transpose(1, 2), sc, cfg,
                                   mask)
        x = residual + lp.out_proj(ctx8, out_dtype=torch.float32)

        residual = x
        h8 = layer_norm_q(x.reshape(-1, x.shape[-1]), lp.ln_fc_gamma, lp.ln_fc_beta,
                          sc["fc1_input_scale"], eps=cfg.layer_norm_eps).reshape(x.shape)
        h8 = lp.fc1(h8, relu=True, out_dtype=torch.int8)
        x = residual + lp.fc2(h8, out_dtype=torch.float32)

    if "final_layer_norm" in params:
        x = layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    if "project_out" in params:
        x = x @ params["project_out"]["weight"].t().float()
    return unembed(x, params["embed_tokens"]["weight"]), new_caches

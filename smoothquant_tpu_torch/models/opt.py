"""OPT decoder (port of smoothquant_tpu/models/opt.py, the parts the real-
INT8 export path, the simulated path and serving use: the per-layer
forward of fp, simulated (quantize_params) and packed trees with and
without caches (an int or (B,) per-slot positions), its calibration taps,
the smoothing pairs and perm_fold_pairs).

HF OPT's facts, as the JAX module mirrors them: learned positions with an
offset of 2, pre-LayerNorm blocks (do_layer_norm_before), q scaled by
1/√head_dim at projection time (attention then runs with scale 1.0), ReLU
MLP, the decoder-level final LayerNorm, the tied unembedding, and
project_in / project_out where word_embed_proj_dim differs from hidden.

forward is forward_hidden (embedding → layers → final LayerNorm →
project_out) then lm_head_logits (the tied unembedding), so the batcher
unembeds only each row's last true position.

Not ported: stack_layers and the prefetch-scan decode, fuse_projections
(both raise NotImplementedError) and the HF checkpoint import.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    attention,
    cached_attention,
    call_linear,
    layer_norm,
    to_head_major,
    unembed,
)
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.linear import quantize_linears

POS_OFFSET = 2  # OPTLearnedPositionalEmbedding offset
ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "out_proj")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None  # != hidden_size only for 350m
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def opt_125m(cls) -> "OPTConfig":
        return cls()

    @classmethod
    def opt_1_3b(cls) -> "OPTConfig":
        return cls(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24,
                   num_attention_heads=32)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "OPTConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, ffn_dim=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=128, dtype="float32")


def init_params(gen: torch.Generator, cfg: OPTConfig, device="cuda") -> dict:
    """Random OPT params from `gen`, at the shapes of opt.py:80-111 (the
    numbers are torch's, not jax.random's)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h, ffn = cfg.hidden_size, cfg.ffn_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=dev)

    def lin(out_f, in_f, bias=True):
        return {"weight": randn(out_f, in_f) * (in_f ** -0.5),
                "bias": torch.zeros(out_f, dtype=dt, device=dev) if bias else None}

    def ln(c):
        return {"weight": torch.ones(c, dtype=dt, device=dev),
                "bias": torch.zeros(c, dtype=dt, device=dev)}

    layers = {str(i): {
        "self_attn_layer_norm": ln(h),
        "self_attn": {p: lin(h, h) for p in ATTN_PROJS},
        "final_layer_norm": ln(h),
        "fc1": lin(ffn, h),
        "fc2": lin(h, ffn),
    } for i in range(cfg.num_hidden_layers)}
    params = {
        "embed_tokens": {"weight": randn(cfg.vocab_size, cfg.embed_dim) * 0.02},
        "embed_positions": {"weight": randn(cfg.max_position_embeddings + POS_OFFSET,
                                            h) * 0.02},
        "final_layer_norm": ln(h),
        "layers": layers,
    }
    if cfg.embed_dim != h:
        params["project_in"] = lin(h, cfg.embed_dim, bias=False)
        params["project_out"] = lin(cfg.embed_dim, h, bias=False)
    return params


def _decoder_layer(lp: dict, x: torch.Tensor, cfg: OPTConfig, layer_name: str,
                   ctx: Optional[ForwardContext], cache, attn_mask):
    """One layer (opt.py:114-160), separate q/k/v projections."""
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    pre = cfg.do_layer_norm_before

    residual = x
    hidden = layer_norm(lp["self_attn_layer_norm"], x, eps) if pre else x
    sa = lp["self_attn"]
    q, k, v = (call_linear(sa[p], hidden, f"{layer_name}.self_attn.{p}", ctx, True)
               for p in ("q_proj", "k_proj", "v_proj"))
    q = (q * (d ** -0.5)).reshape(b, s, nh, d)
    k = k.reshape(b, s, nh, d)
    v = v.reshape(b, s, nh, d)
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        attn = cached_attention(q, cache, causal_offset=offset, ctx=ctx,
                                attn_mask=attn_mask, scale=1.0)
    else:
        attn = attention(q, to_head_major(k), to_head_major(v), attn_mask=attn_mask,
                         scale=1.0)
    x = residual + call_linear(sa["out_proj"], attn.reshape(b, s, h),
                               f"{layer_name}.self_attn.out_proj", ctx)
    if not pre:
        x = layer_norm(lp["self_attn_layer_norm"], x, eps)

    residual = x
    hidden = layer_norm(lp["final_layer_norm"], x, eps) if pre else x
    hidden = torch.relu(call_linear(lp["fc1"], hidden, f"{layer_name}.fc1", ctx))
    x = residual + call_linear(lp["fc2"], hidden, f"{layer_name}.fc2", ctx)
    if not pre:
        x = layer_norm(lp["final_layer_norm"], x, eps)
    return x, cache


def positions_from(caches, b: int, s: int, device) -> torch.Tensor:
    """(B, S) positions: each cache's fill position + arange(S), or arange."""
    start = torch.zeros((), dtype=torch.int64, device=device)
    if caches is not None:
        start = torch.as_tensor(caches[0].pos).to(device=device, dtype=torch.int64)
        if start.ndim == 1:   # per-slot positions
            start = start[:, None]
    return (start + torch.arange(s, device=device)[None, :]).expand(b, s)


def forward_hidden(params: dict, input_ids: torch.Tensor, cfg: OPTConfig,
                   ctx: Optional[ForwardContext] = None, caches: Optional[list] = None,
                   positions: Optional[torch.Tensor] = None,
                   attn_mask: Optional[torch.Tensor] = None):
    """Hidden states before the unembedding (B, S, embed_dim) and the
    updated per-layer caches or None (opt.py:322-383, the per-layer
    branch, up to its unembed)."""
    if "stacked" in params["layers"]:
        raise NotImplementedError("stacked OPT trees (the prefetch-scan decode) "
                                  "are not ported")
    b, s = input_ids.shape
    x = params["embed_tokens"]["weight"][input_ids]
    if "project_in" in params:
        x = x @ params["project_in"]["weight"].t().to(x.dtype)
    if positions is None:
        positions = positions_from(caches, b, s, x.device)
    x = x + params["embed_positions"]["weight"][positions + POS_OFFSET].to(x.dtype)

    new_caches = None if caches is None else []
    for i in range(cfg.num_hidden_layers):
        x, c = _decoder_layer(params["layers"][str(i)], x, cfg,
                              f"model.decoder.layers.{i}", ctx,
                              None if caches is None else caches[i], attn_mask)
        if new_caches is not None:
            new_caches.append(c)
    if "final_layer_norm" in params:
        x = layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    if "project_out" in params:
        x = x @ params["project_out"]["weight"].t().to(x.dtype)
    return x, new_caches


def lm_head_logits(params: dict, h: torch.Tensor, cfg: OPTConfig,
                   ctx: Optional[ForwardContext] = None) -> torch.Tensor:
    """f32 logits through the tied unembedding (opt.py:382)."""
    del ctx
    return unembed(h, params["embed_tokens"]["weight"])


def forward(params: dict, input_ids: torch.Tensor, cfg: OPTConfig,
            ctx: Optional[ForwardContext] = None, caches: Optional[list] = None,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None):
    """(logits f32 (B, S, V), updated per-layer caches or None)
    (opt.py:322-383, the per-layer branch)."""
    h, caches = forward_hidden(params, input_ids, cfg, ctx, caches, positions, attn_mask)
    return lm_head_logits(params, h, cfg, ctx), caches


def stack_layers(params: dict, cfg: OPTConfig) -> dict:
    raise NotImplementedError("stacked OPT trees are not ported")


def fuse_projections(params: dict, cfg: OPTConfig) -> dict:
    raise NotImplementedError("fused OPT projections are not ported")


def perm_fold_pairs(cfg: OPTConfig, fused: bool):
    """(consumer_path, [(producer_path, n_splits)]) (opt.py:226-231): fc2's
    input is relu(fc1's output), elementwise, so fc2's packed channel perm
    folds into fc1's output rows; fc1 / fc2 never fuse, so `fused` changes
    nothing."""
    del fused
    return [(("layers", str(i), "fc2"), [(("layers", str(i), "fc1"), 1)])
            for i in range(cfg.num_hidden_layers)]


def smoothing_map(cfg: OPTConfig):
    """smooth_lm's OPT pairs (opt.py:416-432): self_attn_layer_norm →
    q/k/v; each layer's final_layer_norm → fc1."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pairs.append((li + ("self_attn_layer_norm",),
                      [li + ("self_attn", p) for p in ("q_proj", "k_proj", "v_proj")],
                      f"model.decoder.layers.{i}.self_attn.q_proj"))
        pairs.append((li + ("final_layer_norm",), [li + ("fc1",)],
                      f"model.decoder.layers.{i}.fc1"))
    return pairs


def quantizable_linears(cfg: OPTConfig):
    """(params_path, stats key, quantize_output) of every projection
    (opt.py:489-500)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.decoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}", True))
        out.append((li + ("self_attn", "out_proj"), f"{pre}.self_attn.out_proj", False))
        out.append((li + ("fc1",), f"{pre}.fc1", False))
        out.append((li + ("fc2",), f"{pre}.fc2", False))
    return out


def quantize_params(params: dict, cfg: OPTConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """The simulated path's offline weight quantization (opt.py:386-412):
    q / k / v / out_proj, fc1 and fc2 of every layer through
    quant.linear.quantize_linear_params; input_feat (summed mean-|x|
    calibration vectors) is keyed by the HF-style names of
    quantizable_linears."""
    return quantize_linears(params, quantizable_linears(cfg), qcfg, input_feat)

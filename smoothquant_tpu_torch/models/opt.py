"""OPT decoder (port of smoothquant_tpu/models/opt.py: the per-layer
forward of fp, simulated (quantize_params) and packed trees, fused or not,
with and without caches (an int or (B,) per-slot positions), its
calibration taps, the smoothing pairs and perm_fold_pairs, fuse_projections,
stack_layers and the stacked decode, the HF checkpoint import).

HF OPT's facts, as the JAX module mirrors them: learned positions with an
offset of 2, pre-LayerNorm blocks (do_layer_norm_before), q scaled by
1/√head_dim at projection time (attention then runs with scale 1.0), ReLU
MLP, the decoder-level final LayerNorm, the tied unembedding, and
project_in / project_out where word_embed_proj_dim differs from hidden.

forward is forward_hidden (embedding → layers → final LayerNorm →
project_out) then lm_head_logits (the tied unembedding), so the batcher
unembeds only each row's last true position.  A single query over an int8
per-layer cache runs K11 with sm_scale 1.0 (cached_attention, as ctx.attn
picks it).

A stacked tree (stack_layers) of nibble packs decodes one token through a
Python loop over the layers that hands the layer index to the kernels, the
counterpart of the JAX lax.scan (_prefetch_scan_decode, opt.py:234-298):
LayerNorm → qkv (fused or q / k / v; the input gathered into the pack's
channel order, K1 up to 4 rows, K7 + K5 above; biases added) → q scaled by
1/√D → K10 (rotary off) → K11 with sm_scale 1.0 → out_proj → LayerNorm →
fc1 → ReLU → fc2.  A post-LN tree (do_layer_norm_before False), an fp
tree, a multi-token call, taps or attn "einsum" run _decoder_layer over
layer views of the stack and its cache (stacked_layers), as the JAX scan
over _decoder_layer does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    KVCache,
    QuantKVCache,
    as_torch_dtype,
    attention,
    cached_attention,
    call_linear,
    decode_bias,
    layer_norm,
    maybe_quantize_output,
    prefetch_tree_capable,
    stack_layer_trees,
    stacked_cache_append_fused,
    stacked_flash_attention,
    stacked_layers,
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
    """One layer (opt.py:112-160), fused (fuse_projections) or separate
    q / k / v projections."""
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    pre = cfg.do_layer_norm_before

    residual = x
    hidden = layer_norm(lp["self_attn_layer_norm"], x, eps) if pre else x
    sa = lp["self_attn"]
    q, k, v = _qkv(sa, hidden, f"{layer_name}.self_attn", ctx)
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
                         scale=1.0, ctx=ctx)
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


def _qkv(sa: dict, hidden: torch.Tensor, name: str, ctx, layer_idx: Optional[int] = None):
    """q, k, v (B, S, H) of a layer: the fused qkv_proj split in three, each
    through maybe_quantize_output (opt.py:123-127), or the three
    projections, each marked quantize_output."""
    if "qkv_proj" in sa:
        h = hidden.shape[-1]
        qkv = call_linear(sa["qkv_proj"], hidden, f"{name}.qkv_proj", ctx, layer_idx=layer_idx)
        return tuple(maybe_quantize_output(t, ctx) for t in torch.split(qkv, h, dim=-1))
    return tuple(call_linear(sa[p], hidden, f"{name}.{p}", ctx, True, layer_idx=layer_idx)
                 for p in ("q_proj", "k_proj", "v_proj"))


def positions_from(caches, b: int, s: int, device, stacked: bool = False) -> torch.Tensor:
    """(B, S) positions: each cache's fill position + arange(S), or arange
    (a stacked cache: layer 0's, (L,) or (L, B))."""
    start = torch.zeros((), dtype=torch.int64, device=device)
    if caches is not None:
        pos = caches.pos[0] if stacked else caches[0].pos
        start = torch.as_tensor(pos).to(device=device, dtype=torch.int64)
        if start.ndim == 1:   # per-slot positions
            start = start[:, None]
    return (start + torch.arange(s, device=device)[None, :]).expand(b, s)


def forward_hidden(params: dict, input_ids: torch.Tensor, cfg: OPTConfig,
                   ctx: Optional[ForwardContext] = None, caches: Optional[list] = None,
                   positions: Optional[torch.Tensor] = None,
                   attn_mask: Optional[torch.Tensor] = None):
    """Hidden states before the unembedding (B, S, embed_dim) and the
    updated caches (opt.py:322-383 up to its unembed): per-layer caches
    over a per-layer tree; over a stacked tree one stacked cache or None
    (the stacked decode where _prefetch_capable takes it, else the
    per-layer body over the stack)."""
    b, s = input_ids.shape
    stacked = "stacked" in params["layers"]
    x = params["embed_tokens"]["weight"][input_ids]
    if "project_in" in params:
        x = x @ params["project_in"]["weight"].t().to(x.dtype)
    if positions is None:
        positions = positions_from(caches, b, s, x.device, stacked)
    x = x + params["embed_positions"]["weight"][positions + POS_OFFSET].to(x.dtype)

    def layer(lp, x, i, cache):
        name = "model.decoder.layers.scan" if stacked else f"model.decoder.layers.{i}"
        return _decoder_layer(lp, x, cfg, name, ctx, cache, attn_mask)

    if stacked and _prefetch_capable(params, cfg, ctx, caches, s):
        x, new_caches = _prefetch_scan_decode(params, x, cfg, ctx, caches, attn_mask)
    elif stacked:
        x, new_caches = stacked_layers(layer, params["layers"]["stacked"], x,
                                       cfg.num_hidden_layers, caches, ctx)
    else:
        new_caches = None if caches is None else []
        for i in range(cfg.num_hidden_layers):
            x, c = layer(params["layers"][str(i)], x, i, None if caches is None else caches[i])
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
    """Stack the per-layer trees along a leading L axis (one copy)."""
    return stack_layer_trees(params, cfg.num_hidden_layers)


def stacked_caches(cfg: OPTConfig, batch: int, max_len: int, dtype=None, *,
                   pos: int = 0, quant_kv: bool = False, device="cuda"):
    """A stacked head-major decode cache, leading L axis on every field
    (opt.py:175-194): the int8 QuantKVCache, or an fp KVCache in `dtype`
    (default cfg's), with (L,) aligned positions."""
    cls = QuantKVCache if quant_kv else KVCache
    return cls.create(batch, max_len, cfg.num_attention_heads, cfg.head_dim,
                      dtype or cfg.torch_dtype, resolve_device(device),
                      n_layers=cfg.num_hidden_layers, pos=pos)


def fuse_projections(params: dict, cfg: OPTConfig) -> dict:
    """q / k / v concatenated into self_attn.qkv_proj of every layer (an fp
    tree; opt.py:197-223): weights row-concatenated, biases too (a missing
    one as zeros), so the fused pack shares q_proj's calibration key."""
    layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        sa = dict(lp["self_attn"])
        if "q_proj" in sa:
            parts = [sa.pop(p) for p in ("q_proj", "k_proj", "v_proj")]
            w = torch.cat([p["weight"] for p in parts], dim=0)
            bias = None
            if any(p.get("bias") is not None for p in parts):
                bias = torch.cat([p["bias"] if p.get("bias") is not None
                                  else torch.zeros(p["weight"].shape[0], dtype=w.dtype,
                                                   device=w.device) for p in parts])
            sa["qkv_proj"] = {"weight": w, "bias": bias}
        lp["self_attn"] = sa
        layers[str(i)] = lp
    return {**params, "layers": layers}


def _norm_at(node: dict, i: int) -> dict:
    return {"weight": node["weight"][i], "bias": node["bias"][i]}


def _prefetch_scan_decode(params: dict, x: torch.Tensor, cfg: OPTConfig,
                          ctx: Optional[ForwardContext], caches, attn_mask):
    """Single-token decode over a stacked tree (opt.py:234-298), per layer:
    LayerNorm → qkv → q·1/√D → K10 (rotary off) → K11 (sm_scale 1.0) →
    out_proj → LayerNorm → fc1 → ReLU → fc2, each linear with its bias.
    Every layer's bias comes from its own position in one pass; the
    positions advance after the layer loop."""
    st = params["layers"]["stacked"]
    sa = st["self_attn"]
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    s_max = (caches.k_q if isinstance(caches, QuantKVCache) else caches.k).shape[3]
    pos = caches.pos if caches.pos.ndim == 2 else caches.pos[:, None].expand(-1, b)
    bias = decode_bias(pos, b, s_max, attn_mask)               # (L, B, S_max)
    for i in range(cfg.num_hidden_layers):
        residual = x
        hidden = layer_norm(_norm_at(st["self_attn_layer_norm"], i), x, eps)
        q, k, v = _qkv(sa, hidden, "model.decoder.layers.scan.self_attn", ctx, i)
        q = (q * (d ** -0.5)).reshape(b, nh, d)
        stacked_cache_append_fused(caches, i, k.reshape(b, s, nh, d), v.reshape(b, s, nh, d),
                                   None, None, rotate_k=False)
        a = stacked_flash_attention(caches, i, q, bias[i], sm_scale=1.0)
        x = residual + call_linear(sa["out_proj"], a.reshape(b, s, h), layer_idx=i)
        residual = x
        hidden = layer_norm(_norm_at(st["final_layer_norm"], i), x, eps)
        hidden = torch.relu(call_linear(st["fc1"], hidden, layer_idx=i))
        x = residual + call_linear(st["fc2"], hidden, layer_idx=i)
    caches.pos += s
    return x, caches


def _prefetch_capable(params: dict, cfg: OPTConfig, ctx: Optional[ForwardContext],
                      caches, s: int) -> bool:
    """The stacked decode's gate (opt.py:301-316): a pre-LN tree,
    prefetch_tree_capable (one token, a head-major stacked cache with (L,) or
    (L, B) positions, no taps, attn not "einsum", every projection a
    tile-aligned nibble pack), and shapes K11 tiles."""
    if not cfg.do_layer_norm_before or not isinstance(caches, (KVCache, QuantKVCache)):
        return False
    if not prefetch_tree_capable(params["layers"].get("stacked"), caches, s, ctx):
        return False
    kbuf = caches.k_q if isinstance(caches, QuantKVCache) else caches.k
    return k11.supported(kbuf.shape[3], cfg.num_attention_heads, cfg.num_attention_heads,
                         cfg.head_dim)


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


def quantizable_linears_fused(cfg: OPTConfig):
    """quantizable_linears of a fuse_projections tree (opt.py:503-516): the
    fused qkv shares q_proj's calibration key (the same input)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.decoder.layers.{i}"
        out.append((li + ("self_attn", "qkv_proj"), f"{pre}.self_attn.q_proj", True))
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


# ---------------------------------------------------------------------------
# HF checkpoint import (opt.py:435-486)
# ---------------------------------------------------------------------------

def config_from_hf(hf_cfg) -> OPTConfig:
    """OPTConfig from an HF OPT config (a transformers config or
    utils.hf_import.read_hf_config's namespace)."""
    return OPTConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        ffn_dim=hf_cfg.ffn_dim,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        word_embed_proj_dim=(hf_cfg.word_embed_proj_dim
                             if hf_cfg.word_embed_proj_dim != hf_cfg.hidden_size else None),
        do_layer_norm_before=hf_cfg.do_layer_norm_before,
    )


def params_from_hf_state_dict(state: dict, cfg: OPTConfig, dtype=None,
                              device="cuda") -> dict:
    """An HF OPT state dict as the port's tree on `device`, each tensor cast
    to `dtype` (default cfg.dtype) as it moves: project_in / project_out
    where the checkpoint has them (word_embed_proj_dim ≠ hidden), the
    decoder's final LayerNorm where it has one."""
    dt = as_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)

    def arr(name):
        return state[name].to(device=dev, dtype=dt, copy=True)

    def lin(name, bias=True):
        return {"weight": arr(name + ".weight"),
                "bias": arr(name + ".bias") if bias and name + ".bias" in state else None}

    def ln(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    d = "model.decoder"
    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"{d}.layers.{i}"
        layers[str(i)] = {
            "self_attn_layer_norm": ln(f"{p}.self_attn_layer_norm"),
            "self_attn": {k: lin(f"{p}.self_attn.{k}") for k in ATTN_PROJS},
            "final_layer_norm": ln(f"{p}.final_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
        }
    params = {
        "embed_tokens": {"weight": arr(f"{d}.embed_tokens.weight")},
        "embed_positions": {"weight": arr(f"{d}.embed_positions.weight")},
        "layers": layers,
    }
    if f"{d}.final_layer_norm.weight" in state:
        params["final_layer_norm"] = ln(f"{d}.final_layer_norm")
    if f"{d}.project_in.weight" in state:
        params["project_in"] = lin(f"{d}.project_in", bias=False)
        params["project_out"] = lin(f"{d}.project_out", bias=False)
    return params

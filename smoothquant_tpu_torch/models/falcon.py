"""Falcon decoder (port of smoothquant_tpu/models/falcon.py: the three HF
Falcon block layouts, calibration, smoothing, packing, the Generator, the
batcher and the stacked decode, the HF checkpoint import).

HF Falcon's facts, as the JAX module mirrors them (falcon.py:1-14): rotary
positions; one fused query_key_value projection whose output holds the
heads in HF's layout — multi-query [all q heads, k, v] (Falcon-7B: 71
query heads over one kv head), the new decoder's per kv group [q ...,
k, v] (Falcon-40B), the classic per-head [q, k, v] interleave; the 7B's
parallel attention and MLP off ONE input_layernorm, the new decoder's
ln_attn / ln_mlp, the classic block's post_attention_layernorm;
LayerNorms with biases; the tied unembedding.  The cache holds
effective_kv_heads heads (1 for multi-query).

One departure from the JAX module, which is a fault there: its MLP takes
jax.nn.gelu's default, the tanh approximation, where HF Falcon's
activation "gelu" is the exact GELU; this port takes the exact one (the
tests hold it to the JAX module with its GELU made exact).

The per-layer forward runs with no cache (the prefill, the calibration
taps) or over per-layer KVCache / QuantKVCache lists (an int or (B,)
per-slot positions; a single query over the int8 cache runs K11 as
ForwardContext.attn picks it, at any rep).  A stacked tree (stack_layers)
decodes one token through a Python loop over the layers that hands the
layer index to the kernels — the counterpart of the JAX lax.scan
(_prefetch_scan_decode, falcon.py:237-310): LayerNorm → query_key_value
(input gathered into the pack's channel order; K1 up to 4 rows, K7 + K5
above) → K10 (k rotated and written; over the int8 cache q rotated in the
same launch) → K11 at rep H / H_kv → dense → the MLP (dense_h_to_4h →
exact GELU → dense_4h_to_h) beside or after the attention as the layout
says.  A stacked tree that _prefetch_capable declines (an fp tree, a
multi-token call, no cache, taps, attn "einsum") runs _decoder_layer over
layer views of the stack and its cache (stacked_layers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.models.bloom import gelu
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    KVCache,
    QuantKVCache,
    apply_rotary,
    as_torch_dtype,
    attention,
    cached_attention,
    call_linear,
    decode_bias,
    layer_norm,
    prefetch_tree_capable,
    rotary_cos_sin,
    stack_layer_trees,
    stacked_cache_append_fused,
    stacked_flash_attention,
    stacked_layers,
    unembed,
)
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.linear import quantize_linears

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    """tiiuae/falcon-7b's shapes by default (falcon.py:42-73)."""

    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: int = 1
    multi_query: bool = True
    parallel_attn: bool = True
    new_decoder_architecture: bool = False
    bias: bool = False
    layer_norm_epsilon: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def effective_kv_heads(self) -> int:
        """The kv heads the cache holds: num_kv_heads for the new decoder,
        1 for multi-query, else one a query head."""
        if self.new_decoder_architecture:
            return self.num_kv_heads
        return 1 if self.multi_query else self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def falcon_7b(cls) -> "FalconConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256, **kw) -> "FalconConfig":
        base = dict(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, num_kv_heads=2, dtype="float32")
        base.update(kw)
        return cls(**base)


def _qkv_dim(cfg: FalconConfig) -> int:
    return cfg.hidden_size + 2 * cfg.effective_kv_heads * cfg.head_dim


def init_params(gen: torch.Generator, cfg: FalconConfig, device="cuda") -> dict:
    """Random Falcon params from `gen`, at the shapes of falcon.py:80-117
    (linear weights N(0, 1/in), zero biases where cfg.bias, unit
    LayerNorms, embeddings N(0, 0.02²); the numbers are torch's)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h = cfg.hidden_size

    def lin(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=gen, dtype=dt, device=dev)
        return {"weight": w * (in_f ** -0.5),
                "bias": torch.zeros(out_f, dtype=dt, device=dev) if cfg.bias else None}

    def ln(c):
        return {"weight": torch.ones(c, dtype=dt, device=dev),
                "bias": torch.zeros(c, dtype=dt, device=dev)}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = {"self_attention": {"query_key_value": lin(_qkv_dim(cfg), h),
                                 "dense": lin(h, h)},
              "mlp": {"dense_h_to_4h": lin(4 * h, h), "dense_4h_to_h": lin(h, 4 * h)}}
        for name in _norm_names(cfg):
            lp[name] = ln(h)
        layers[str(i)] = lp
    emb = torch.randn((cfg.vocab_size, h), generator=gen, dtype=dt, device=dev) * 0.02
    return {"word_embeddings": {"weight": emb}, "layers": layers, "ln_f": ln(h)}


def _norm_names(cfg: FalconConfig) -> tuple:
    if cfg.new_decoder_architecture:
        return ("ln_attn", "ln_mlp")
    return ("input_layernorm",) if cfg.parallel_attn else ("input_layernorm",
                                                            "post_attention_layernorm")


def _split_qkv(fused: torch.Tensor, cfg: FalconConfig):
    """q (B, S, H, D), k / v (B, S, H_kv, D) of the fused projection in HF's
    head layout (falcon.py:120-139); views where the layout allows."""
    b, s, _ = fused.shape
    nh, d, n_kv = cfg.num_attention_heads, cfg.head_dim, cfg.effective_kv_heads
    if cfg.new_decoder_architecture:
        per = nh // n_kv
        qkv = fused.reshape(b, s, n_kv, per + 2, d)
        return qkv[:, :, :, :per].reshape(b, s, nh, d), qkv[:, :, :, per], qkv[:, :, :, per + 1]
    if cfg.multi_query:
        return (fused[..., : nh * d].reshape(b, s, nh, d),
                fused[..., nh * d: (nh + 1) * d].reshape(b, s, 1, d),
                fused[..., (nh + 1) * d:].reshape(b, s, 1, d))
    qkv = fused.reshape(b, s, nh, 3, d)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _norm_inputs(lp: dict, x: torch.Tensor, cfg: FalconConfig):
    """(attention input, MLP input) of a block: ln_attn / ln_mlp for the new
    decoder, else input_layernorm's output for both (the classic block
    replaces the MLP's after the attention)."""
    eps = cfg.layer_norm_epsilon
    if cfg.new_decoder_architecture:
        return layer_norm(lp["ln_attn"], x, eps), layer_norm(lp["ln_mlp"], x, eps)
    a = layer_norm(lp["input_layernorm"], x, eps)
    return a, a


def _mlp(mlp: dict, x: torch.Tensor, name: str, ctx, layer_idx=None):
    h1 = call_linear(mlp["dense_h_to_4h"], x, f"{name}.mlp.dense_h_to_4h", ctx,
                     layer_idx=layer_idx)
    return call_linear(mlp["dense_4h_to_h"], gelu(h1), f"{name}.mlp.dense_4h_to_h", ctx,
                       layer_idx=layer_idx)


def _block_tail(lp: dict, x, residual, attn_out, mlp_in, cfg: FalconConfig, name: str,
                ctx, layer_idx=None):
    """The MLP and residuals after the attention (falcon.py:168-184):
    parallel (the 7B and the new decoder) or sequential (classic)."""
    if cfg.parallel_attn or cfg.new_decoder_architecture:
        return residual + attn_out + _mlp(lp["mlp"], mlp_in, name, ctx, layer_idx)
    x = residual + attn_out
    post = lp["post_attention_layernorm"]
    if layer_idx is not None:
        post = {"weight": post["weight"][layer_idx], "bias": post["bias"][layer_idx]}
    return x + _mlp(lp["mlp"], layer_norm(post, x, cfg.layer_norm_epsilon), name, ctx,
                    layer_idx)


def _decoder_layer(lp: dict, x: torch.Tensor, cfg: FalconConfig, name: str, cos, sin,
                   ctx: Optional[ForwardContext], cache, attn_mask):
    """One layer (falcon.py:142-185), each call site named by its HF module
    path for the calibration taps."""
    b, s, _ = x.shape
    residual = x
    attn_in, mlp_in = _norm_inputs(lp, x, cfg)
    sa = lp["self_attention"]
    fused = call_linear(sa["query_key_value"], attn_in,
                        f"{name}.self_attention.query_key_value", ctx, True)
    q, k, v = _split_qkv(fused, cfg)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        a = cached_attention(q, cache, causal_offset=offset, ctx=ctx, attn_mask=attn_mask)
    else:
        a = attention(q, k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_mask)
    attn_out = call_linear(sa["dense"], a.reshape(b, s, cfg.num_attention_heads * cfg.head_dim),
                           f"{name}.self_attention.dense", ctx)
    return _block_tail(lp, x, residual, attn_out, mlp_in, cfg, name, ctx), cache


def stack_layers(params: dict, cfg: FalconConfig) -> dict:
    """Stack the per-layer trees along a leading L axis (one copy)."""
    return stack_layer_trees(params, cfg.num_hidden_layers)


def stacked_caches(cfg: FalconConfig, batch: int, max_len: int, dtype=None, *,
                   pos: int = 0, quant_kv: bool = False, device="cuda"):
    """A stacked head-major decode cache of effective_kv_heads heads, leading
    L axis on every field (falcon.py:208-230): the int8 QuantKVCache, or an
    fp KVCache in `dtype` (default cfg's), with (L,) aligned positions."""
    cls = QuantKVCache if quant_kv else KVCache
    return cls.create(batch, max_len, cfg.effective_kv_heads, cfg.head_dim,
                      dtype or cfg.torch_dtype, resolve_device(device),
                      n_layers=cfg.num_hidden_layers, pos=pos)


def _prefetch_scan_decode(params: dict, x: torch.Tensor, cfg: FalconConfig,
                          ctx: Optional[ForwardContext], caches, cos, sin, attn_mask):
    """Single-token decode over a stacked tree (falcon.py:233-297), per
    layer: the block's LayerNorm(s) → query_key_value → K10 (k rotated and
    written in place; over the int8 cache q rotated in the same launch, an
    fp cache takes apply_rotary) → K11 over the (B, S) bias at rep H / H_kv
    → dense → the MLP.  Every layer's bias comes from its own position in
    one pass; the positions advance after the layer loop."""
    st = params["layers"]["stacked"]
    sa = st["self_attention"]
    b, s, _ = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    quant = isinstance(caches, QuantKVCache)
    s_max = (caches.k_q if quant else caches.k).shape[3]
    pos = caches.pos if caches.pos.ndim == 2 else caches.pos[:, None].expand(-1, b)
    bias = decode_bias(pos, b, s_max, attn_mask)              # (L, B, S_max)
    names = _norm_names(cfg)
    if not quant:
        cos_q, sin_q = cos.to(x.dtype), sin.to(x.dtype)
    for i in range(cfg.num_hidden_layers):
        lp = {n: {"weight": st[n]["weight"][i], "bias": st[n]["bias"][i]} for n in names
              if n != "post_attention_layernorm"}
        residual = x
        attn_in, mlp_in = _norm_inputs(lp, x, cfg)
        fused = call_linear(sa["query_key_value"], attn_in, layer_idx=i)
        q, k, v = _split_qkv(fused, cfg)
        if quant:
            q = stacked_cache_append_fused(caches, i, k, v, cos, sin, q=q)
        else:
            q = apply_rotary(q, cos_q, sin_q)[:, 0]
            stacked_cache_append_fused(caches, i, k, v, cos, sin)
        a = stacked_flash_attention(caches, i, q, bias[i])
        attn_out = call_linear(sa["dense"], a.reshape(b, s, nh * d), layer_idx=i)
        x = _block_tail(st, x, residual, attn_out, mlp_in, cfg, "transformer.h.scan", ctx, i)
    caches.pos += s
    return x, caches


def _prefetch_capable(params: dict, cfg: FalconConfig, ctx: Optional[ForwardContext],
                      caches, s: int) -> bool:
    """The stacked decode's gate (falcon.py:300-313): prefetch_tree_capable
    (one token, a head-major stacked cache with (L,) or (L, B) positions, no
    taps, attn not "einsum", every projection a tile-aligned nibble pack)
    and shapes K11 tiles."""
    if not isinstance(caches, (KVCache, QuantKVCache)):
        return False
    if not prefetch_tree_capable(params["layers"].get("stacked"), caches, s, ctx):
        return False
    kbuf = caches.k_q if isinstance(caches, QuantKVCache) else caches.k
    return k11.supported(kbuf.shape[3], cfg.num_attention_heads, cfg.effective_kv_heads,
                         cfg.head_dim)


def forward_hidden(params: dict, input_ids: torch.Tensor, cfg: FalconConfig,
                   ctx: Optional[ForwardContext] = None, caches=None,
                   positions: Optional[torch.Tensor] = None,
                   attn_mask: Optional[torch.Tensor] = None):
    """Hidden states after ln_f (B, S, H) and the updated caches
    (falcon.py:316-367 without the unembedding).  caches: None, a list of
    per-layer caches, or, over a stacked tree, one stacked cache or None;
    positions default to each cache's fill position + arange(S)."""
    b, s = input_ids.shape
    stacked = "stacked" in params["layers"]
    x = params["word_embeddings"]["weight"][input_ids]
    if positions is None:
        if caches is None:
            start = torch.zeros((), dtype=torch.int64, device=x.device)
        else:
            start = caches.pos[0] if stacked else torch.as_tensor(caches[0].pos)
            start = start.to(device=x.device, dtype=torch.int64)
        if start.ndim == 1:
            start = start[:, None]
        positions = start + torch.arange(s, device=x.device)[None, :]
    cos, sin = rotary_cos_sin(positions.reshape(-1, s), cfg.head_dim, cfg.rope_theta)

    def layer(lp, x, i, cache):
        name = "transformer.h.scan" if stacked else f"transformer.h.{i}"
        return _decoder_layer(lp, x, cfg, name, cos, sin, ctx, cache, attn_mask)

    if stacked and _prefetch_capable(params, cfg, ctx, caches, s):
        x, caches = _prefetch_scan_decode(params, x, cfg, ctx, caches, cos, sin, attn_mask)
    elif stacked:
        x, caches = stacked_layers(layer, params["layers"]["stacked"], x,
                                   cfg.num_hidden_layers, caches, ctx)
    else:
        new_caches = None if caches is None else []
        for i in range(cfg.num_hidden_layers):
            x, c = layer(params["layers"][str(i)], x, i, None if caches is None else caches[i])
            if new_caches is not None:
                new_caches.append(c)
        caches = new_caches
    return layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon), caches


def lm_head_logits(params: dict, h: torch.Tensor, cfg: FalconConfig,
                   ctx: Optional[ForwardContext] = None) -> torch.Tensor:
    """f32 logits through the tied unembedding (falcon.py:366)."""
    del ctx
    return unembed(h, params["word_embeddings"]["weight"])


def forward(params: dict, input_ids: torch.Tensor, cfg: FalconConfig,
            ctx: Optional[ForwardContext] = None, caches=None,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None):
    """(f32 logits (B, S, V), updated caches) (falcon.py:316-367)."""
    h, caches = forward_hidden(params, input_ids, cfg, ctx, caches, positions, attn_mask)
    return lm_head_logits(params, h, cfg, ctx), caches


def smoothing_map(cfg: FalconConfig):
    """smooth_lm's Falcon pairs (falcon.py:396-416, reference smooth.py:
    101-125): the 7B's one input_layernorm → [query_key_value,
    dense_h_to_4h]; the new decoder's ln_attn → qkv and ln_mlp → h_to_4h;
    the classic block's input_layernorm → qkv, post_attention_layernorm →
    h_to_4h."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        qkv = li + ("self_attention", "query_key_value")
        fc1 = li + ("mlp", "dense_h_to_4h")
        qkv_key = f"transformer.h.{i}.self_attention.query_key_value"
        fc1_key = f"transformer.h.{i}.mlp.dense_h_to_4h"
        if not cfg.new_decoder_architecture and cfg.parallel_attn:
            pairs.append((li + ("input_layernorm",), [qkv, fc1], qkv_key))
        elif cfg.new_decoder_architecture:
            pairs.append((li + ("ln_attn",), [qkv], qkv_key))
            pairs.append((li + ("ln_mlp",), [fc1], fc1_key))
        else:
            pairs.append((li + ("input_layernorm",), [qkv], qkv_key))
            pairs.append((li + ("post_attention_layernorm",), [fc1], fc1_key))
    return pairs


def quantizable_linears(cfg: FalconConfig):
    """(params_path, stats key, quantize_output) of every projection
    (falcon.py:472-484)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"transformer.h.{i}"
        out.append((li + ("self_attention", "query_key_value"),
                    f"{pre}.self_attention.query_key_value", True))
        out.append((li + ("self_attention", "dense"), f"{pre}.self_attention.dense", False))
        out.append((li + ("mlp", "dense_h_to_4h"), f"{pre}.mlp.dense_h_to_4h", False))
        out.append((li + ("mlp", "dense_4h_to_h"), f"{pre}.mlp.dense_4h_to_h", False))
    return out


def quantize_params(params: dict, cfg: FalconConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """The simulated path's offline weight quantization (falcon.py:370-393,
    reference fake_quant.py:671-731): query_key_value, dense,
    dense_h_to_4h and dense_4h_to_h of every layer."""
    return quantize_linears(params, quantizable_linears(cfg), qcfg, input_feat)


# ---------------------------------------------------------------------------
# HF checkpoint import (falcon.py:419-469)
# ---------------------------------------------------------------------------

def config_from_hf(hf_cfg) -> FalconConfig:
    """FalconConfig from an HF Falcon config (a transformers config or
    utils.hf_import.read_hf_config's namespace).  An ALiBi checkpoint
    (alibi: true) is refused: the JAX module ignores the key and would run
    it with rotary positions."""
    if getattr(hf_cfg, "alibi", False):
        raise NotImplementedError("Falcon with ALiBi positions (alibi: true) is not supported")
    return FalconConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_kv_heads", 1) or 1,
        multi_query=getattr(hf_cfg, "multi_query", True),
        parallel_attn=getattr(hf_cfg, "parallel_attn", True),
        new_decoder_architecture=getattr(hf_cfg, "new_decoder_architecture", False),
        bias=getattr(hf_cfg, "bias", False),
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
    )


def params_from_hf_state_dict(state: dict, cfg: FalconConfig, dtype=None,
                              device="cuda") -> dict:
    """An HF Falcon state dict as the port's tree on `device`, each tensor
    cast to `dtype` (default cfg.dtype) as it moves."""
    dt = as_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)

    def arr(name):
        return state[name].to(device=dev, dtype=dt, copy=True)

    def lin(name):
        return {"weight": arr(name + ".weight"),
                "bias": arr(name + ".bias") if cfg.bias and name + ".bias" in state else None}

    def ln(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        lp = {"self_attention": {"query_key_value": lin(f"{p}.self_attention.query_key_value"),
                                 "dense": lin(f"{p}.self_attention.dense")},
              "mlp": {"dense_h_to_4h": lin(f"{p}.mlp.dense_h_to_4h"),
                      "dense_4h_to_h": lin(f"{p}.mlp.dense_4h_to_h")}}
        for name in _norm_names(cfg):
            lp[name] = ln(f"{p}.{name}")
        layers[str(i)] = lp
    return {"word_embeddings": {"weight": arr("transformer.word_embeddings.weight")},
            "layers": layers, "ln_f": ln("transformer.ln_f")}

"""Bloom decoder (port of smoothquant_tpu/models/bloom.py, the parts the
serving path uses: calibration, smoothing, the nibble pack, the Generator,
the batcher and the stacked decode).

HF Bloom's facts, as the JAX module mirrors them: ALiBi attention (no
positions; score += slope_h · key position), the fused per-head qkv
projection (its output viewed as (B, S, H, 3, D)), the LayerNorm after the
word embeddings, LayerNorms with biases, exact GELU, the tied unembedding.
SmoothQuant names Bloom for smoothing (input_layernorm → query_key_value,
post_attention_layernorm → dense_h_to_4h); the JAX package also packs its
four projections, and so does this port.

The per-layer forward runs with no cache (the full-model prefill and the
calibration taps) or over per-layer KVCache / QuantKVCache lists (an int
or (B,) per-slot positions): a single query runs K11 with the slopes as
ForwardContext.attn picks it (the role the TPU kernel has in
_cached_alibi_attention: "auto" over the int8 cache, "kernel" over the fp
one too), everything else the einsum.  A stacked tree (stack_layers)
decodes one token through a Python loop over the layers that hands the
layer index to the kernels — the counterpart of the JAX lax.scan
(_prefetch_scan_decode, :237-295): the packs' input is gathered into their
channel order (real_linear; Bloom's LayerNorm fuses into no kernel), K1 up
to 32 rows or K7a + K5 above, K10 with rotary off, K11 with the slopes,
over (L,) aligned positions or the batcher's (L, B) per-slot ones.  A
stacked tree that _prefetch_capable declines (an fp tree, a multi-token
call, no cache, taps, attn "einsum") runs
_decoder_layer over layer views of the stack and of its cache, as the JAX
package's scan over _decoder_layer does (:332-342).  forward is
forward_hidden (embedding → layers → ln_f) then lm_head_logits (the tied
unembedding), so the batcher unembeds only the rows it needs.

Not ported: config_from_hf and params_from_hf_state_dict (no checkpoint in
the repository).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    as_torch_dtype,
    KVCache,
    QuantKVCache,
    attention,
    call_linear,
    decode_bias,
    layer_norm,
    prefetch_tree_capable,
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
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "BloomConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, dtype="float32")


def alibi_slopes(n_heads: int) -> np.ndarray:
    """HF Bloom's ALiBi slopes, float32 (bloom.py:53-62): a geometric run
    from the largest power of two of heads, the rest interleaved from the
    next one."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes.extend(extra_base ** (2 * i + 1) for i in range(n_heads - closest))
    return np.asarray(slopes, np.float32)


def init_params(gen: torch.Generator, cfg: BloomConfig, device="cuda") -> dict:
    """Random Bloom params from `gen`, at the shapes of bloom.py:65-96
    (linear weights N(0, 1/in), zero biases, unit LayerNorms, embeddings
    N(0, 0.02²); the numbers are torch's, not jax.random's)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h = cfg.hidden_size

    def lin(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=gen, dtype=dt, device=dev)
        return {"weight": w * (in_f ** -0.5),
                "bias": torch.zeros(out_f, dtype=dt, device=dev)}

    def ln(c):
        return {"weight": torch.ones(c, dtype=dt, device=dev),
                "bias": torch.zeros(c, dtype=dt, device=dev)}

    layers = {str(i): {
        "input_layernorm": ln(h),
        "post_attention_layernorm": ln(h),
        "self_attention": {"query_key_value": lin(3 * h, h), "dense": lin(h, h)},
        "mlp": {"dense_h_to_4h": lin(4 * h, h), "dense_4h_to_h": lin(h, 4 * h)},
    } for i in range(cfg.num_hidden_layers)}
    emb = torch.randn((cfg.vocab_size, h), generator=gen, dtype=dt, device=dev) * 0.02
    return {"word_embeddings": {"weight": emb}, "word_embeddings_layernorm": ln(h),
            "layers": layers, "ln_f": ln(h)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in jax.nn.gelu's form: 0.5·x·erfc(−x·√½), √½ rounded to
    x's dtype."""
    sqrt_half = float(torch.tensor(np.sqrt(0.5), dtype=x.dtype))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def _cached_alibi_attention(q: torch.Tensor, cache, slopes: torch.Tensor, offset,
                            ctx: Optional[ForwardContext], attn_mask: Optional[torch.Tensor]):
    """Attention over an already-updated per-layer cache (bloom.py:130-168):
    a single query runs K11 with the slopes and validity folded into a
    (B, S) bias where ctx.attn picks it ("auto": the int8 cache; "kernel":
    the fp cache too; "einsum": never); the rest and the prefill take the
    einsum over the cache's (dequantized) view."""
    if not isinstance(cache, (KVCache, QuantKVCache)):
        raise NotImplementedError(f"cache type {type(cache).__name__}")
    b, sq, nh, d = q.shape
    mode = "auto" if ctx is None else ctx.attn
    quant = isinstance(cache, QuantKVCache)
    kbuf = cache.k_q if quant else cache.k
    s = kbuf.shape[2]
    if (sq == 1 and mode != "einsum" and (mode == "kernel" or quant)
            and k11.supported(s, nh, nh, d)):
        last = torch.as_tensor(cache.pos, device=q.device) - 1
        bias = decode_bias(last, b, s, attn_mask)          # keys < pos
        scales = (cache.k_scale, cache.v_scale) if quant else (None, None)
        out = k11.decode_attention(q[:, 0], kbuf, cache.v_q if quant else cache.v, bias,
                                   *scales, slopes)
        return out[:, None]
    return attention(q, *cache.read(), causal_offset=offset, valid_len=cache.pos,
                     attn_mask=attn_mask, alibi_slopes=slopes)


def _decoder_layer(lp: dict, x: torch.Tensor, cfg: BloomConfig, name: str, slopes,
                   ctx: Optional[ForwardContext], cache, attn_mask):
    """One layer (bloom.py:171-201), each call site named by its HF module
    path for the calibration taps."""
    b, s, _ = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    residual = x
    hidden = layer_norm(lp["input_layernorm"], x, eps)
    sa = lp["self_attention"]
    qkv = call_linear(sa["query_key_value"], hidden,
                      f"{name}.self_attention.query_key_value", ctx, True)
    qkv = qkv.reshape(b, s, nh, 3, d)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        a = _cached_alibi_attention(q, cache, slopes, offset, ctx, attn_mask)
    else:
        a = attention(q, k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_mask,
                      alibi_slopes=slopes)
    x = residual + call_linear(sa["dense"], a.reshape(b, s, nh * d),
                               f"{name}.self_attention.dense", ctx)
    residual = x
    hidden = layer_norm(lp["post_attention_layernorm"], x, eps)
    h1 = call_linear(lp["mlp"]["dense_h_to_4h"], hidden, f"{name}.mlp.dense_h_to_4h", ctx)
    return residual + call_linear(lp["mlp"]["dense_4h_to_h"], gelu(h1),
                                  f"{name}.mlp.dense_4h_to_h", ctx), cache


def stack_layers(params: dict, cfg: BloomConfig) -> dict:
    """Stack the per-layer trees along a leading L axis (one copy)."""
    return stack_layer_trees(params, cfg.num_hidden_layers)


def stacked_caches(cfg: BloomConfig, batch: int, max_len: int, dtype=None, *,
                   pos: int = 0, quant_kv: bool = False, device="cuda"):
    """A stacked head-major decode cache, leading L axis on every field
    (bloom.py:216-234): the int8 QuantKVCache, or an fp KVCache in `dtype`
    (default cfg's), with (L,) aligned positions."""
    cls = QuantKVCache if quant_kv else KVCache
    return cls.create(batch, max_len, cfg.num_attention_heads, cfg.head_dim,
                      dtype or cfg.torch_dtype, resolve_device(device),
                      n_layers=cfg.num_hidden_layers, pos=pos)


def _norm_at(node: dict, i: int) -> dict:
    return {"weight": node["weight"][i], "bias": node["bias"][i]}


def _prefetch_scan_decode(params: dict, x: torch.Tensor, cfg: BloomConfig, caches,
                          slopes: torch.Tensor, attn_mask):
    """Single-token decode over a stacked tree (bloom.py:237-295), per
    layer: LayerNorm → qkv (input gathered, K1 or K7a + K5) → K10 (rotary
    off) → K11 with the slopes → dense → LayerNorm → dense_h_to_4h → exact
    GELU → dense_4h_to_h.  Every layer's bias comes from its own positions
    in one pass ((L,) aligned positions serve every row; the batcher's
    per-slot pool gives each layer (B,) positions, as JAX's scan reads
    pos[i], bloom.py:272-274), and K10 writes each slot at its own; the
    positions advance after the layer loop."""
    st = params["layers"]["stacked"]
    sa, mlp = st["self_attention"], st["mlp"]
    b, s, _ = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    s_max = (caches.k_q if isinstance(caches, QuantKVCache) else caches.k).shape[3]
    pos = caches.pos if caches.pos.ndim == 2 else caches.pos[:, None].expand(-1, b)
    bias = decode_bias(pos, b, s_max, attn_mask)              # (L, B, S_max)
    for i in range(cfg.num_hidden_layers):
        residual = x
        hidden = layer_norm(_norm_at(st["input_layernorm"], i), x, eps)
        qkv = call_linear(sa["query_key_value"], hidden, layer_idx=i).reshape(b, s, nh, 3, d)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        stacked_cache_append_fused(caches, i, k, v, None, None, rotate_k=False)
        a = stacked_flash_attention(caches, i, q[:, 0], bias[i], alibi_slopes=slopes)
        x = residual + call_linear(sa["dense"], a.reshape(b, s, nh * d), layer_idx=i)
        residual = x
        hidden = layer_norm(_norm_at(st["post_attention_layernorm"], i), x, eps)
        h1 = call_linear(mlp["dense_h_to_4h"], hidden, layer_idx=i)
        x = residual + call_linear(mlp["dense_4h_to_h"], gelu(h1), layer_idx=i)
    caches.pos += s
    return x, caches


def _prefetch_capable(params: dict, cfg: BloomConfig, ctx: Optional[ForwardContext],
                      caches, s: int) -> bool:
    """The stacked decode's gate (bloom.py:298-310): prefetch_tree_capable
    (one token, a stacked cache with (L,) aligned or (L, B) per-slot
    positions, no taps, attn not "einsum", every projection tile-aligned),
    a head-major cache (the S-major one takes no slopes), and shapes K11
    tiles."""
    if not isinstance(caches, (KVCache, QuantKVCache)):
        return False
    if not prefetch_tree_capable(params["layers"].get("stacked"), caches, s, ctx):
        return False
    kbuf = caches.k_q if isinstance(caches, QuantKVCache) else caches.k
    return k11.supported(kbuf.shape[3], cfg.num_attention_heads,
                         cfg.num_attention_heads, cfg.head_dim)


def forward_hidden(params: dict, input_ids: torch.Tensor, cfg: BloomConfig,
                   ctx: Optional[ForwardContext] = None, caches=None,
                   positions: Optional[torch.Tensor] = None,
                   attn_mask: Optional[torch.Tensor] = None):
    """Hidden states after ln_f (B, S, H) and the updated caches
    (bloom.py:313-354 without the unembedding).  caches: None, a list of
    per-layer caches, or, over a stacked tree, one stacked cache or None.
    positions is accepted for the model-module contract and unused: ALiBi
    reads the key positions."""
    del positions
    b, s = input_ids.shape
    x = params["word_embeddings"]["weight"][input_ids]
    x = layer_norm(params["word_embeddings_layernorm"], x, cfg.layer_norm_epsilon)
    slopes = torch.as_tensor(alibi_slopes(cfg.num_attention_heads), device=x.device)
    stacked = "stacked" in params["layers"]

    def layer(lp, x, i, cache):
        name = "transformer.h.scan" if stacked else f"transformer.h.{i}"
        return _decoder_layer(lp, x, cfg, name, slopes, ctx, cache, attn_mask)

    if stacked and _prefetch_capable(params, cfg, ctx, caches, s):
        x, caches = _prefetch_scan_decode(params, x, cfg, caches, slopes, attn_mask)
    elif stacked:
        x, caches = stacked_layers(layer, params["layers"]["stacked"], x,
                                   cfg.num_hidden_layers, caches, ctx)
    else:
        new_caches = None if caches is None else []
        for i in range(cfg.num_hidden_layers):
            x, c = layer(params["layers"][str(i)], x, i,
                         None if caches is None else caches[i])
            if new_caches is not None:
                new_caches.append(c)
        caches = new_caches
    return layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon), caches


def lm_head_logits(params: dict, h: torch.Tensor, cfg: BloomConfig,
                   ctx: Optional[ForwardContext] = None) -> torch.Tensor:
    """f32 logits through the tied unembedding (bloom.py:353)."""
    del ctx
    return unembed(h, params["word_embeddings"]["weight"])


def forward(params: dict, input_ids: torch.Tensor, cfg: BloomConfig,
            ctx: Optional[ForwardContext] = None, caches=None,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None):
    """(f32 logits (B, S, V), updated caches) (bloom.py:313-354)."""
    h, caches = forward_hidden(params, input_ids, cfg, ctx, caches, positions, attn_mask)
    return lm_head_logits(params, h, cfg, ctx), caches


def smoothing_map(cfg: BloomConfig):
    """smooth_lm's Bloom pairs (bloom.py:384-399, reference smooth.py:91-100):
    input_layernorm → query_key_value, post_attention_layernorm →
    dense_h_to_4h."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"transformer.h.{i}"
        pairs.append((li + ("input_layernorm",),
                      [li + ("self_attention", "query_key_value")],
                      f"{pre}.self_attention.query_key_value"))
        pairs.append((li + ("post_attention_layernorm",), [li + ("mlp", "dense_h_to_4h")],
                      f"{pre}.mlp.dense_h_to_4h"))
    return pairs


def quantizable_linears(cfg: BloomConfig):
    """(params_path, stats key, quantize_output) of every projection
    (bloom.py:447-459)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"transformer.h.{i}"
        out.append((li + ("self_attention", "query_key_value"),
                    f"{pre}.self_attention.query_key_value", True))
        out.append((li + ("self_attention", "dense"), f"{pre}.self_attention.dense", False))
        out.append((li + ("mlp", "dense_h_to_4h"), f"{pre}.mlp.dense_h_to_4h", False))
        out.append((li + ("mlp", "dense_4h_to_h"), f"{pre}.mlp.dense_4h_to_h", False))
    return out


def quantize_params(params: dict, cfg: BloomConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """The simulated path's offline weight quantization (bloom.py:357-380;
    the reference quantizes no Bloom): query_key_value, dense,
    dense_h_to_4h and dense_4h_to_h of every layer through
    quant.linear.quantize_linear_params; input_feat (summed mean-|x|
    calibration vectors) is keyed by the HF-style names of
    quantizable_linears."""
    return quantize_linears(params, quantizable_linears(cfg), qcfg, input_feat)


# ---------------------------------------------------------------------------
# HF checkpoint import (bloom.py:402-441)
# ---------------------------------------------------------------------------

def config_from_hf(hf_cfg) -> BloomConfig:
    """BloomConfig from an HF Bloom config (a transformers config or
    utils.hf_import.read_hf_config's namespace)."""
    return BloomConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.n_layer,
        num_attention_heads=hf_cfg.n_head,
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
    )


def params_from_hf_state_dict(state: dict, cfg: BloomConfig, dtype=None,
                              device="cuda") -> dict:
    """An HF Bloom state dict as the port's tree on `device`, each tensor
    cast to `dtype` (default cfg.dtype) as it moves."""
    dt = as_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)

    def arr(name):
        return state[name].to(device=dev, dtype=dt, copy=True)

    def lin(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        layers[str(i)] = {
            "input_layernorm": lin(f"{p}.input_layernorm"),
            "post_attention_layernorm": lin(f"{p}.post_attention_layernorm"),
            "self_attention": {
                "query_key_value": lin(f"{p}.self_attention.query_key_value"),
                "dense": lin(f"{p}.self_attention.dense"),
            },
            "mlp": {
                "dense_h_to_4h": lin(f"{p}.mlp.dense_h_to_4h"),
                "dense_4h_to_h": lin(f"{p}.mlp.dense_4h_to_h"),
            },
        }
    return {
        "word_embeddings": {"weight": arr("transformer.word_embeddings.weight")},
        "word_embeddings_layernorm": lin("transformer.word_embeddings_layernorm"),
        "layers": layers,
        "ln_f": lin("transformer.ln_f"),
    }

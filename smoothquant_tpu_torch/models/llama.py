"""Llama-family decoder, Mistral included (port of
smoothquant_tpu/models/llama.py, the parts the W4A4 serving path, the bf16
decode baseline, the Generator and the batcher use).

Params are nested dicts of tensors with PackedLinear leaves after packing,
as in the JAX package.  The per-layer forward hands a ForwardContext to
every call site, named by its HF module path (model.layers.{i}.mlp.
gate_proj, ...): the calibration taps read the fp tree through it, and its
`compute` reaches the packed one; smoothing_map pairs each norm with the
linears it feeds.  forward is split into forward_hidden (embedding →
decoder layers → final norm) and lm_head_logits, so a caller that needs
only some positions' logits (the batcher's prefill) runs the lm_head on
those rows alone.  The per-layer forward runs with no cache (the full-model
prefill) or over per-layer KVCache / QuantKVCache / SMajorQuantKVCache
lists.  A stacked tree (stack_layers) decodes one token through a
per-layer Python loop that hands the layer index to the kernels — the
counterpart of the JAX lax.scan over scalar-prefetch kernels
(_prefetch_scan_decode, llama.py:288-490): a packed tree over the stacked
S-major int8 cache (:427-432), a packed tree over the stacked head-major
int8 cache with per-slot positions or a key mask (the "off" branch,
:351-356,443-448), the same tree over that cache with aligned (L,)
positions and no mask (the virtual-tile attention K12 in the composition
ForwardContext.fuse_attn names, :346-366,407-442, and the fused MLP K14
with fuse_mlp), or a pack_fp_decode tree over a stacked head-major fp
cache (the "off" branch).  A stacked tree that the stacked decode declines
(taps, attn "einsum", compute "dequant", a multi-token call, no cache, a
tree prefetch_tree_capable does not take) runs _decoder_layer layer by
layer over layer views of the stack and of a stacked cache, which comes
back stacked (the JAX lax.scan over _decoder_layer, llama.py:551-572).

Mistral is this architecture with LlamaConfig.sliding_window set
(mistral_7b, llama.py:78-84): every attention path masks the keys older
than the window (the prefill and cached einsum, K11's bias, the stacked
decode's bias, which takes the "off" composition over a head-major int8
cache as JAX does, llama.py:362-366).  A tied tree (tie_word_embeddings,
or no lm_head) unembeds through embed_tokens (llama.py:589-590).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.kernels.pack import PackedLinear, permute_output_columns
from smoothquant_tpu_torch.kernels.attn_fused import (
    fused_rope_write_attn_stacked,
    fused_virtual_attn_flat,
    fused_virtual_attn_stacked,
)
from smoothquant_tpu_torch.kernels.real_linear import can_fuse_mlp, can_fuse_norm, real_mlp_fused
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    as_torch_dtype,
    KVCache,
    QuantKVCache,
    SMajorQuantKVCache,
    apply_rotary,
    attention,
    cached_attention,
    call_linear,
    decode_bias,
    maybe_quantize_output,
    prefetch_tree_capable,
    rms_norm,
    rotary_cos_sin,
    stack_layer_trees,
    stacked_cache_append_fused,
    stacked_layers,
    stacked_flash_attention,
    stacked_smajor_attention,
    unembed,
)
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.linear import quantize_linears

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None  # Mistral: 4096
    dtype: str = "bfloat16"
    # the head width where it is not hidden_size / heads: a tensor-parallel
    # rank's config of its local heads (parallel.tp_packed, llama.py:61-67)
    head_dim_value: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_value is not None:
            return self.head_dim_value
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """The JAX package's preset (llama.py:78-84), copied as it stands:
        Mistral-7B v0.1's 4096 window beside v0.2's rope_theta of 1e6."""
        return cls(hidden_size=4096, intermediate_size=14336,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=8, rope_theta=1e6,
                   sliding_window=4096, vocab_size=32000)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        """Small config for tests."""
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   dtype="float32")


# ---------------------------------------------------------------- params


def _init_lin(gen, out_f, in_f, bias, dtype, device):
    w = torch.randn((out_f, in_f), generator=gen, dtype=dtype, device=device)
    return {"weight": w * (in_f ** -0.5),
            "bias": torch.zeros(out_f, dtype=dtype, device=device) if bias else None}


def init_layer_params(gen: torch.Generator, cfg: LlamaConfig,
                      device="cuda") -> dict:
    """One decoder layer's params from `gen` (build deep models layer by
    layer)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim
    lin = lambda o, i, b: _init_lin(gen, o, i, b, dt, dev)
    return {
        "input_layernorm": {"weight": torch.ones(h, dtype=dt, device=dev)},
        "post_attention_layernorm": {"weight": torch.ones(h, dtype=dt, device=dev)},
        "self_attn": {
            "q_proj": lin(h, h, cfg.attention_bias),
            "k_proj": lin(kv_dim, h, cfg.attention_bias),
            "v_proj": lin(kv_dim, h, cfg.attention_bias),
            "o_proj": lin(h, h, False),
        },
        "mlp": {
            "gate_proj": lin(inter, h, cfg.mlp_bias),
            "up_proj": lin(inter, h, cfg.mlp_bias),
            "down_proj": lin(h, inter, cfg.mlp_bias),
        },
    }


def init_params(gen: torch.Generator, cfg: LlamaConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h = cfg.hidden_size
    params = {
        "layers": {str(i): init_layer_params(gen, cfg, dev)
                   for i in range(cfg.num_hidden_layers)},
        "embed_tokens": {"weight": torch.randn(
            (cfg.vocab_size, h), generator=gen, dtype=dt, device=dev) * 0.02},
        "norm": {"weight": torch.ones(h, dtype=dt, device=dev)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _init_lin(gen, cfg.vocab_size, h, False, dt, dev)
    return params


# ---------------------------------------------------------------- forward


def _decoder_layer(lp: dict, x: torch.Tensor, cfg: LlamaConfig, layer_name: str, cos, sin,
                   ctx: Optional[ForwardContext], cache, attn_mask):
    """One layer (llama.py:164-228); fused or separate projections, each
    call site named by its HF module path for the calibration taps; with no
    cache the attention is the causal einsum over this call's k / v, with a
    cache cached_attention as ctx.attn picks it; both under the window."""
    b, s, _ = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    residual = x
    hidden = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    sa = lp["self_attn"]
    if "qkv_proj" in sa:
        qkv = call_linear(sa["qkv_proj"], hidden, f"{layer_name}.self_attn.qkv_proj", ctx)
        q, k, v = (maybe_quantize_output(t, ctx) for t in
                   torch.split(qkv, [nh * d, n_kv * d, n_kv * d], dim=-1))
    else:
        q, k, v = (call_linear(sa[p], hidden, f"{layer_name}.self_attn.{p}", ctx, True)
                   for p in ("q_proj", "k_proj", "v_proj"))
    q = apply_rotary(q.reshape(b, s, nh, d), cos, sin)
    k = apply_rotary(k.reshape(b, s, n_kv, d), cos, sin)
    v = v.reshape(b, s, n_kv, d)
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        attn = cached_attention(q, cache, causal_offset=offset, ctx=ctx,
                                attn_mask=attn_mask, sliding_window=cfg.sliding_window)
    else:
        attn = attention(q, k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_mask,
                         sliding_window=cfg.sliding_window, ctx=ctx)
    x = residual + call_linear(sa["o_proj"], attn.reshape(b, s, nh * d),
                               f"{layer_name}.self_attn.o_proj", ctx)
    residual = x
    hidden = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    mlp = lp["mlp"]
    if "gate_up_proj" in mlp:
        gate, up = call_linear(mlp["gate_up_proj"], hidden, f"{layer_name}.mlp.gate_up_proj",
                               ctx).chunk(2, dim=-1)
    else:
        gate, up = (call_linear(mlp[p], hidden, f"{layer_name}.mlp.{p}", ctx)
                    for p in ("gate_proj", "up_proj"))
    down = call_linear(mlp["down_proj"], torch.nn.functional.silu(gate) * up,
                       f"{layer_name}.mlp.down_proj", ctx)
    return residual + down, cache


def _stacked_decode(params, x, cfg: LlamaConfig, caches, cos, sin, attn_mask,
                    ctx: Optional[ForwardContext]):
    """Single-token decode over a stacked tree (llama.py:288-490), per layer:
      packed tree, S-major int8 cache: K1 (qkv, RMSNorm fused) → K2 (q- and
        k-rotary, quantize, row write, q / k / v read in place from the qkv
        rows) → K3 → K1 (o_proj) → K1 (gate_up, RMSNorm fused) → SiLU·up →
        K1 (down_proj);
      packed tree, head-major int8 cache with aligned (L,) positions and no
        mask, the attention ctx.fuse_attn names (llama.py:346-366,407-448):
        "auto" K12's flat body on pre-rotary q for MHA, or q-rotary and K12's
        stacked body for GQA, then K10; "fused" q-rotary and K12's write
        body; "off" as the next case;
      packed tree, head-major int8 cache with per-slot positions, a mask or
        a sliding window ("off"): K10 (q rotated in its launch too) and K11
        in place of K2 and K3;
      pack_fp_decode tree, head-major fp cache: RMSNorm → K13 (qkv) →
        rotary → fp row write → K11 → K13 (o) → RMSNorm → K13 (gate_up) →
        SiLU·up → K13 (down).
    Up to 32 rows the packed linears run K1; above, the RMSNorm runs first
    and K7a + K5 take them (real_linear).  ctx.fuse_mlp runs gate_up,
    SiLU·up and down_proj as one K14 launch where can_fuse_mlp holds (N <=
    8; llama.py:327-334,455-462)."""
    st = params["layers"]["stacked"]
    sa, mlp = st["self_attn"], st["mlp"]
    b, s, _ = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    if isinstance(caches, SMajorQuantKVCache):
        s_max, mode = caches.k_q.shape[2], "smajor"
    elif isinstance(caches, KVCache):
        s_max, mode = caches.k.shape[3], "off"
    elif isinstance(caches, QuantKVCache):
        s_max = caches.k_q.shape[3]
        # the virtual-tile kernels take one aligned position, no mask and no
        # window (llama.py:351-366)
        aligned = (caches.pos.ndim == 1 and attn_mask is None
                   and cfg.sliding_window is None)
        mode = (ctx.fuse_attn if ctx is not None else "auto") if aligned else "off"
    else:
        raise NotImplementedError(f"cache type {type(caches).__name__}")
    fp_tree = not isinstance(sa["qkv_proj"], PackedLinear)
    fuse_norm = (not fp_tree and can_fuse_norm(sa["qkv_proj"])
                 and can_fuse_norm(mlp["gate_up_proj"]))
    if not (fp_tree or fuse_norm):
        raise NotImplementedError("stacked decode fuses the RMSNorm into qkv and "
                                  "gate_up (pre-permuted per-group nibble packs)")
    fuse_mlp = (fuse_norm and ctx is not None and ctx.fuse_mlp
                and can_fuse_mlp(mlp["gate_up_proj"], mlp["down_proj"], b * s))
    norms = ("input_layernorm", "post_attention_layernorm")
    # fused: the JAX kernel casts the norm rows to the activation dtype, then f32
    rows = {n: st[n]["weight"].to(x.dtype).float() for n in norms} if fuse_norm else {}
    bias = None
    if mode in ("smajor", "off"):
        # every layer's bias from its own position, in one pass: the positions
        # advance only after the layer loop; aligned (L,) positions serve every row
        pos = caches.pos if caches.pos.ndim == 2 else caches.pos[:, None].expand(-1, b)
        bias = decode_bias(pos, b, s_max, attn_mask, cfg.sliding_window)   # (L, B, S_max)
    attend = stacked_smajor_attention if mode == "smajor" else stacked_flash_attention
    flat = mode == "auto" and nh == n_kv
    # "smajor" and "off" over an int8 cache: the writer rotates q in its launch
    fused_write = mode in ("smajor", "off") and not isinstance(caches, KVCache)
    if not fused_write:
        # q-rotary tables in the activation dtype (apply_rotary's cast, once)
        cos_q, sin_q = cos.to(x.dtype), sin.to(x.dtype)

    def normed_linear(lin, inp, i, norm):
        if fuse_norm:
            return call_linear(lin, inp, layer_idx=i, norm=(rows[norm], eps, "rms"))
        hidden = rms_norm({"weight": st[norm]["weight"][i]}, inp, eps)
        return call_linear(lin, hidden, layer_idx=i)

    for i in range(cfg.num_hidden_layers):
        residual = x
        qkv = normed_linear(sa["qkv_proj"], x, i, norms[0])
        q, k, v = torch.split(qkv, [nh * d, n_kv * d, n_kv * d], dim=-1)
        k, v = k.reshape(b, s, n_kv, d), v.reshape(b, s, n_kv, d)
        if fused_write:
            # one launch: q rotated, k / v written, all read in place from qkv
            q = stacked_cache_append_fused(caches, i, k, v, cos, sin, q=q.reshape(b, s, nh, d))
        elif not flat:
            q = apply_rotary(q.reshape(b, s, nh, d), cos_q, sin_q)[:, 0]   # (B, H, D)
        if mode in ("auto", "fused"):
            # K12 reads the OLD cache at this layer's aligned position
            # (llama.py:407-442); "auto" writes the row with K10 after it
            k12 = (fused_virtual_attn_flat if flat else fused_virtual_attn_stacked
                   if mode == "auto" else fused_rope_write_attn_stacked)
            a = k12(i, caches.pos[i], q, k[:, 0], v[:, 0], cos, sin, caches.k_q,
                    caches.v_q, caches.k_scale, caches.v_scale)
            if mode == "auto":
                stacked_cache_append_fused(caches, i, k, v, cos, sin)
        else:
            if not fused_write:
                caches = stacked_cache_append_fused(caches, i, k, v, cos, sin)
            a = attend(caches, i, q, bias[i])
        x = residual + call_linear(sa["o_proj"], a.reshape(b, s, nh * d), layer_idx=i)
        residual = x
        if fuse_mlp:
            down = real_mlp_fused(mlp["gate_up_proj"], mlp["down_proj"], x, layer_idx=i,
                                  norm=(st[norms[1]]["weight"][i], eps, "rms"))
        else:
            gate, up = normed_linear(mlp["gate_up_proj"], x, i, norms[1]).chunk(2, dim=-1)
            down = call_linear(mlp["down_proj"], torch.nn.functional.silu(gate) * up,
                               layer_idx=i)
        x = residual + down
    # every layer read its own position above; advance them all at once
    caches.pos += s
    return x, caches


def _prefetch_capable(params: dict, cfg: LlamaConfig, ctx: Optional[ForwardContext],
                      caches, s: int) -> bool:
    """The stacked decode's gate (llama.py:493-512): prefetch_tree_capable,
    shapes the JAX kernels tile (k11.supported), and a plan of the
    layout's attention kernel (decode_attention.plan at the queries' dtype
    and the cache's B·H_kv heads): K3 over the S-major cache, K12 over an
    aligned head-major int8 cache in fuse_attn "auto" / "fused", else K11.
    All three take any GQA rep, above 8 query rows a kv head in groups of
    8 (the TPU kernels' rule of 8 query rows a dot does not apply, so the
    S-major rule is wider than JAX's attn_smajor.supported); a shape the
    kernel's plan refuses (a head_dim outside 64 / 128 / 256, a flash body
    past its shared memory) runs the per-layer body, as JAX's gate
    declines."""
    if not prefetch_tree_capable(params["layers"].get("stacked"), caches, s, ctx):
        return False
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    smajor = isinstance(caches, SMajorQuantKVCache)
    kbuf = caches.k_q if isinstance(caches, QuantKVCache) or smajor else caches.k
    s_max = kbuf.shape[2] if smajor else kbuf.shape[3]
    if not k11.supported(s_max, nh, n_kv, d):
        return False
    aligned_int8 = (isinstance(caches, QuantKVCache) and caches.pos.ndim == 1
                    and (ctx.fuse_attn if ctx is not None else "auto") in ("auto", "fused"))
    kernel = "K3" if smajor else "K12" if aligned_int8 else "K11"
    try:
        k11.plan(kernel, params["embed_tokens"]["weight"].dtype, kbuf.shape[1] * n_kv,
                 s_max, d, nh // n_kv)
    except ValueError:
        return False
    return True


def forward_hidden(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig,
                   caches=None, positions: Optional[torch.Tensor] = None,
                   attn_mask: Optional[torch.Tensor] = None, *,
                   ctx: Optional[ForwardContext] = None):
    """Final-normed hidden states (B, S, H) and the updated caches.

    caches: None (no cache: the full-model prefill), a list of per-layer
    caches (int or (B,) per-slot positions), or, over a stacked tree, one
    stacked cache or None.  positions default to each cache's fill
    position + arange(S).  ctx's fuse_attn / fuse_mlp choose the stacked
    decode's composition; its taps, compute, quant and attn reach every
    call site of the per-layer body."""
    b, s = input_ids.shape
    stacked = "stacked" in params["layers"]
    x = params["embed_tokens"]["weight"][input_ids]
    if positions is None:
        if caches is None:
            start = torch.zeros((), dtype=torch.int64, device=x.device)
        else:
            start = caches.pos[0] if stacked else torch.as_tensor(caches[0].pos)
            start = start.to(device=x.device, dtype=torch.int64)
        if start.ndim == 1:
            start = start[:, None]
        positions = start + torch.arange(s, device=x.device)[None, :]
    cos, sin = rotary_cos_sin(positions.reshape(-1, s), cfg.head_dim,
                              cfg.rope_theta)

    def layer(lp, x, i, cache):
        name = "model.layers.scan" if stacked else f"model.layers.{i}"
        return _decoder_layer(lp, x, cfg, name, cos, sin, ctx, cache, attn_mask)

    if stacked and _prefetch_capable(params, cfg, ctx, caches, s):
        x, caches = _stacked_decode(params, x, cfg, caches, cos, sin, attn_mask, ctx)
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
    return rms_norm(params["norm"], x, cfg.rms_norm_eps), caches


def lm_head_logits(params: dict, h: torch.Tensor, cfg: LlamaConfig,
                   ctx: Optional[ForwardContext] = None) -> torch.Tensor:
    """f32 logits of final-normed hidden states (llama.py:589-599): a tied
    tree (tie_word_embeddings, or no lm_head) unembeds through
    embed_tokens; else the packed lm_head (call site "lm_head"), or an fp
    {"weight"} one through unembed, whose products accumulate in f32 as
    the JAX einsum's do."""
    lm = params.get("lm_head")
    if cfg.tie_word_embeddings or lm is None:
        return unembed(h, params["embed_tokens"]["weight"])
    if isinstance(lm, PackedLinear):
        return call_linear(lm, h, "lm_head", ctx).float()
    return unembed(h, lm["weight"])


def forward(params, input_ids, cfg, caches=None, positions=None, attn_mask=None, *,
            ctx: Optional[ForwardContext] = None):
    """(logits f32 (B, S, V), updated caches)."""
    h, caches = forward_hidden(params, input_ids, cfg, caches, positions, attn_mask,
                               ctx=ctx)
    return lm_head_logits(params, h, cfg, ctx), caches


# ---------------------------------------------------------------- trees


def stack_layers(params: dict, cfg: LlamaConfig) -> dict:
    """Stack the per-layer trees along a leading L axis (one copy)."""
    return stack_layer_trees(params, cfg.num_hidden_layers)


def stacked_caches(cfg: LlamaConfig, batch: int, max_len: int, dtype=None, *,
                   pos: int = 0, quant_kv: bool = False, smajor: bool = False,
                   per_slot: bool = False, device="cuda"):
    """A stacked decode cache, leading L axis on every field
    (llama.py:249-285, with its defaults: a head-major fp cache): the
    S-major int8 cache (always (L, B) per-slot positions), or a head-major
    int8 QuantKVCache or fp KVCache in `dtype` (default cfg's) with (L,)
    aligned or, per_slot, (L, B) positions."""
    dev = resolve_device(device)
    n_l, n_kv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    if quant_kv and smajor:
        return SMajorQuantKVCache.create(batch, max_len, n_kv, d, dev,
                                         n_layers=n_l, pos=pos)
    if smajor:
        raise ValueError("the S-major layout is int8-only (quant_kv=True)")
    cls = QuantKVCache if quant_kv else KVCache
    return cls.create(batch, max_len, n_kv, d, dtype or cfg.torch_dtype, dev,
                      per_slot=per_slot, n_layers=n_l, pos=pos)


def fuse_projections(params: dict, cfg: LlamaConfig) -> dict:
    """q/k/v → qkv_proj and gate/up → gate_up_proj by row concatenation."""

    def cat(parts):
        w = torch.cat([p["weight"] for p in parts], dim=0)
        if any(p.get("bias") is not None for p in parts):
            bias = torch.cat([p["bias"] if p.get("bias") is not None
                              else torch.zeros(p["weight"].shape[0], dtype=w.dtype,
                                               device=w.device) for p in parts])
        else:
            bias = None
        return {"weight": w, "bias": bias}

    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        sa, mlp = dict(lp["self_attn"]), dict(lp["mlp"])
        if "q_proj" in sa:
            sa["qkv_proj"] = cat([sa.pop(p) for p in ("q_proj", "k_proj", "v_proj")])
        if "gate_proj" in mlp:
            mlp["gate_up_proj"] = cat([mlp.pop(p) for p in ("gate_proj", "up_proj")])
        lp["self_attn"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def pack_fp_decode(params: dict, cfg: LlamaConfig) -> dict:
    """An UNQUANTIZED tree for the stacked decode (llama.py:704-729): fused
    q/k/v and gate/up, every projection transposed to (K, O) under
    "weight_t", so call_linear routes it to K13 once stack_layers has
    stacked it — the bf16 baseline the W4A4 decode is measured against.
    The transposes are views; stack_layers makes the (L, K, O) copy."""
    params = fuse_projections(params, cfg)

    def tr(lin):
        return {"weight_t": lin["weight"].t(), "bias": lin.get("bias")}

    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        sa, mlp = dict(lp["self_attn"]), dict(lp["mlp"])
        for node, name in ((sa, "qkv_proj"), (sa, "o_proj"), (mlp, "gate_up_proj"),
                           (mlp, "down_proj")):
            node[name] = tr(node[name])
        lp["self_attn"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def residual_consumers(cfg: LlamaConfig, fused: bool):
    """(param_path, stats key) of every linear reading the normed residual
    stream (llama.py:642-660): the fused qkv / gate_up, or each of q / k / v
    and gate / up."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.layers.{i}"
        if fused:
            out.append((li + ("self_attn", "qkv_proj"), f"{pre}.self_attn.q_proj"))
            out.append((li + ("mlp", "gate_up_proj"), f"{pre}.mlp.gate_proj"))
        else:
            out += [(li + ("self_attn", p), f"{pre}.self_attn.{p}")
                    for p in ("q_proj", "k_proj", "v_proj")]
            out += [(li + ("mlp", p), f"{pre}.mlp.{p}") for p in ("gate_proj", "up_proj")]
    return out


def apply_shared_residual_basis(params: dict, cfg: LlamaConfig, perm) -> dict:
    """Move the residual stream into the shared permuted basis: embedding
    columns, norm weights and the o/down output columns are relaid."""
    take = torch.as_tensor(np.asarray(perm, np.int64),
                           device=params["embed_tokens"]["weight"].device)
    out = dict(params)
    out["embed_tokens"] = {
        "weight": params["embed_tokens"]["weight"].index_select(1, take)}
    out["norm"] = {"weight": params["norm"]["weight"].index_select(0, take)}
    if isinstance(params.get("lm_head"), dict):
        lm = params["lm_head"]
        out["lm_head"] = {"weight": lm["weight"].index_select(1, take),
                          "bias": lm.get("bias")}
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        for nrm in ("input_layernorm", "post_attention_layernorm"):
            lp[nrm] = {"weight": lp[nrm]["weight"].index_select(0, take)}
        sa, mlp = dict(lp["self_attn"]), dict(lp["mlp"])
        sa["o_proj"] = permute_output_columns(sa["o_proj"], perm)
        mlp["down_proj"] = permute_output_columns(mlp["down_proj"], perm)
        lp["self_attn"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out["layers"] = new_layers
    return out


def perm_fold_pairs(cfg: LlamaConfig, fused: bool):
    """(consumer_path, [(producer_path, n_splits)]) (llama.py:852-866):
    down_proj's input perm folds into the fused gate_up output rows, or into
    gate_proj's and up_proj's each."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i), "mlp")
        prods = ([(li + ("gate_up_proj",), 2)] if fused
                 else [(li + ("gate_proj",), 1), (li + ("up_proj",), 1)])
        out.append((li + ("down_proj",), prods))
    return out


def smoothing_map(cfg: LlamaConfig):
    """smooth_lm's Llama pairs (llama.py:773-797): input_layernorm → q/k/v
    (scales key: q_proj's input), post_attention_layernorm → gate/up (scales
    key: gate_proj's input).  o_proj and down_proj read the outputs of
    attention and SiLU·up, not of a norm: they stay unsmoothed."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.layers.{i}"
        pairs.append((li + ("input_layernorm",),
                      [li + ("self_attn", p) for p in ("q_proj", "k_proj", "v_proj")],
                      f"{pre}.self_attn.q_proj"))
        pairs.append((li + ("post_attention_layernorm",),
                      [li + ("mlp", p) for p in ("gate_proj", "up_proj")],
                      f"{pre}.mlp.gate_proj"))
    return pairs


def quantizable_linears(cfg: LlamaConfig):
    """(params_path, stats key, quantize_output) of every projection."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}", True))
        out.append((li + ("self_attn", "o_proj"), f"{pre}.self_attn.o_proj", False))
        for p in ("gate_proj", "up_proj", "down_proj"):
            out.append((li + ("mlp", p), f"{pre}.mlp.{p}", False))
    return out


def quantizable_linears_fused(cfg: LlamaConfig):
    """quantizable_linears of a fuse_projections tree (the first part's key
    supplies the fusion's stats)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.layers.{i}"
        out.append((li + ("self_attn", "qkv_proj"), f"{pre}.self_attn.q_proj", True))
        out.append((li + ("self_attn", "o_proj"), f"{pre}.self_attn.o_proj", False))
        out.append((li + ("mlp", "gate_up_proj"), f"{pre}.mlp.gate_proj", False))
        out.append((li + ("mlp", "down_proj"), f"{pre}.mlp.down_proj", False))
    return out


def quantize_params(params: dict, cfg: LlamaConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """The simulated path's offline weight quantization (llama.py:737-771):
    all seven projections of every layer through
    quant.linear.quantize_linear_params; input_feat (summed mean-|x|
    calibration vectors) is keyed by the HF-style names of
    quantizable_linears."""
    return quantize_linears(params, quantizable_linears(cfg), qcfg, input_feat)


# ---------------------------------------------------------------------------
# HF checkpoint import (llama.py:800-849)
# ---------------------------------------------------------------------------

def config_from_hf(hf_cfg) -> LlamaConfig:
    """LlamaConfig from an HF Llama / Mistral config (a transformers config
    or utils.hf_import.read_hf_config's namespace)."""
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        attention_bias=getattr(hf_cfg, "attention_bias", False),
        mlp_bias=getattr(hf_cfg, "mlp_bias", False),
        sliding_window=getattr(hf_cfg, "sliding_window", None),
    )


def params_from_hf_state_dict(state: dict, cfg: LlamaConfig, dtype=None,
                              device="cuda") -> dict:
    """An HF Llama / Mistral state dict (tensors, host or device) as the
    port's tree on `device`, each tensor cast to `dtype` (default
    cfg.dtype) as it moves, one at a time."""
    dt = as_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)

    def arr(name):
        return state[name].to(device=dev, dtype=dt, copy=True)

    def lin(name, bias):
        return {"weight": arr(name + ".weight"),
                "bias": arr(name + ".bias") if bias and name + ".bias" in state else None}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layers[str(i)] = {
            "input_layernorm": {"weight": arr(f"{p}.input_layernorm.weight")},
            "post_attention_layernorm": {"weight": arr(f"{p}.post_attention_layernorm.weight")},
            "self_attn": {k: lin(f"{p}.self_attn.{k}", cfg.attention_bias)
                          for k in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {k: lin(f"{p}.mlp.{k}", cfg.mlp_bias)
                    for k in ("gate_proj", "up_proj", "down_proj")},
        }
    params = {
        "embed_tokens": {"weight": arr("model.embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": arr("model.norm.weight")},
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = {"weight": arr("lm_head.weight"), "bias": None}
    return params

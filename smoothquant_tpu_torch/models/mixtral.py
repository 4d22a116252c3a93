"""Mixtral (sparse MoE) decoder (port of smoothquant_tpu/models/mixtral.py:
the per-layer forward with dense and sparse expert dispatch, calibration,
smoothing, packing, the Generator, the batcher and the stacked decode, the
HF checkpoint import).

Llama-style attention (GQA, rotary, RMSNorm, separate q / k / v
projections) and a top-2 MoE block (mixtral.py:1-14): the router `gate`
(a quantizable linear with 8 outputs), softmax in f32, top-k with ties to
the lower expert index (jax.lax.top_k's order), renormalized; each
expert's SwiGLU MLP (w1 gate, w3 up, w2 down).  ForwardContext.moe_dispatch
picks the execution: "dense" runs every expert on every token and sums the
outputs in f32 in expert order, each weighted by its routing probability
(zero for the experts not chosen); "sparse" gathers each expert's routed
tokens into a buffer of moe_capacity rows (a stable sort by expert; the
assignments past the capacity go to a trash row and are dropped) and sums
each token's top-k outputs in f32 by index-add.  With top-2 both sum the
same two products, so they agree wherever no token overflows.

A stacked tree (stack_layers: each layer's experts stacked first, then the
layers) decodes one token through a Python loop over the layers that hands
the layer index to the kernels — the counterpart of the JAX lax.scan
(_prefetch_scan_decode, mixtral.py:358-424): RMSNorm → q / k / v (input
gathered into each pack's channel order; K1 up to 4 rows, K7 + K5 above) →
K10 (k rotated and written; over the int8 cache q rotated in the same
launch) → K11 at rep H / H_kv → o_proj → RMSNorm → the MoE block, whose
expert leaves are viewed as (L·E, ...) stacks: expert e of layer i is
stacked index i·E + e.  A stacked tree the gate declines runs
_decoder_layer over layer views of the stack and its cache.  Expert
parallelism (ForwardContext.ep_axis) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.kernels.pack import PackedLinear
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
    layer_tree,
    prefetch_tree_capable,
    rms_norm,
    rotary_cos_sin,
    stack_layer_trees,
    stack_trees,
    stacked_cache_append_fused,
    stacked_flash_attention,
    stacked_layers,
    unembed,
)
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.linear import quantize_linears

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
EXPERT_PROJS = ("w1", "w2", "w3")


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    """mistralai/Mixtral-8x7B-v0.1's shapes by default (mixtral.py:41-68)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "MixtralConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   num_local_experts=4, max_position_embeddings=128, dtype="float32")


def init_params(gen: torch.Generator, cfg: MixtralConfig, device="cuda") -> dict:
    """Random Mixtral params from `gen`, at the shapes of mixtral.py:75-116
    (linear weights N(0, 1/in), unit RMSNorms, embeddings N(0, 0.02²); the
    numbers are torch's)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim

    def lin(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=gen, dtype=dt, device=dev)
        return {"weight": w * (in_f ** -0.5), "bias": None}

    def norm():
        return {"weight": torch.ones(h, dtype=dt, device=dev)}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        experts = {str(e): {"w1": lin(inter, h), "w2": lin(h, inter), "w3": lin(inter, h)}
                   for e in range(cfg.num_local_experts)}
        layers[str(i)] = {
            "input_layernorm": norm(),
            "post_attention_layernorm": norm(),
            "self_attn": {"q_proj": lin(h, h), "k_proj": lin(kv_dim, h),
                          "v_proj": lin(kv_dim, h), "o_proj": lin(h, h)},
            "block_sparse_moe": {"gate": lin(cfg.num_local_experts, h), "experts": experts},
        }
    emb = torch.randn((cfg.vocab_size, h), generator=gen, dtype=dt, device=dev) * 0.02
    return {"embed_tokens": {"weight": emb}, "layers": layers, "norm": norm(),
            "lm_head": lin(cfg.vocab_size, h)}


def stack_experts(params: dict, cfg: MixtralConfig) -> dict:
    """Each layer's per-expert trees stacked along a leading E axis under
    experts["stacked"] (one copy; mixtral.py:119-133)."""
    layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        moe = dict(lp["block_sparse_moe"])
        moe["experts"] = {"stacked": stack_trees([moe["experts"][str(e)]
                                                  for e in range(cfg.num_local_experts)])}
        lp["block_sparse_moe"] = moe
        layers[str(i)] = lp
    return {**params, "layers": layers}


def _experts_view(bp: dict):
    """(per-expert trees, E) of a block: the dict of experts, or views of the
    stacked form (mixtral.py:136-145)."""
    ex = bp["experts"]
    if "stacked" in ex:
        e_local = ex["stacked"]["w1"]
        e_local = (e_local.w_qt if isinstance(e_local, PackedLinear)
                   else e_local["weight"]).shape[0]
        return [layer_tree(ex["stacked"], e) for e in range(e_local)], e_local
    return [ex[str(e)] for e in range(len(ex))], len(ex)


def moe_capacity(n_tokens: int, cfg: MixtralConfig, capacity_factor: float) -> int:
    """Rows of each expert's buffer under sparse dispatch (mixtral.py:148-163):
    ceil(int(topk · n · factor) / E), clamped to [1, n]."""
    e, k = cfg.num_local_experts, cfg.num_experts_per_tok
    cap = -(-int(k * n_tokens * capacity_factor) // e)
    return max(1, min(n_tokens, cap))


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index as jax.lax.top_k orders them (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(bp: dict, x: torch.Tensor, cfg: MixtralConfig, layer_name: str,
           ctx: Optional[ForwardContext], layer_idx=None):
    """Routing weights and experts (mixtral.py:166-173): softmax over the
    gate's logits in f32 (jax.nn.softmax's form), top-k, renormalized."""
    logits = call_linear(bp["gate"], x, f"{layer_name}.gate", ctx,
                         layer_idx=layer_idx).float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    top_p, top_idx = top_k(probs, cfg.num_experts_per_tok)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_idx


def _expert_mlp(ep: dict, x: torch.Tensor, pre: str, ctx, layer_idx=None) -> torch.Tensor:
    g = call_linear(ep["w1"], x, f"{pre}.w1", ctx, layer_idx=layer_idx)
    u = call_linear(ep["w3"], x, f"{pre}.w3", ctx, layer_idx=layer_idx)
    return call_linear(ep["w2"], torch.nn.functional.silu(g) * u, f"{pre}.w2", ctx,
                       layer_idx=layer_idx)


def _expert_runner(bp: dict, cfg: MixtralConfig, layer_name: str, ctx, layer_idx,
                   experts_flat):
    """(expert e, rows) → expert e's MLP of the rows: per-expert trees, or
    the stacked decode's flat (L·E, ...) stacks at index layer_idx·E + e."""
    if experts_flat is not None:
        e_total = cfg.num_local_experts
        return lambda e, rows: _expert_mlp(experts_flat, rows, f"{layer_name}.experts.{e}",
                                           ctx, layer_idx=layer_idx * e_total + e)
    experts, e_local = _experts_view(bp)
    if e_local != cfg.num_local_experts:
        raise NotImplementedError("expert parallelism (a block of local experts) is not ported")
    return lambda e, rows: _expert_mlp(experts[e], rows, f"{layer_name}.experts.{e}", ctx)


def _moe_block_dense(bp: dict, x: torch.Tensor, cfg: MixtralConfig, layer_name: str,
                     ctx: Optional[ForwardContext], layer_idx=None,
                     experts_flat=None) -> torch.Tensor:
    """Every expert on every token, the outputs summed in f32 in expert
    order, each weighted by its routing probability (mixtral.py:184-201)."""
    top_p, top_idx = _route(bp, x, cfg, layer_name, ctx, layer_idx)
    one_hot = torch.nn.functional.one_hot(top_idx, cfg.num_local_experts).to(top_p.dtype)
    weights = (one_hot * top_p[..., None]).sum(dim=-2)            # (B, S, E)
    run = _expert_runner(bp, cfg, layer_name, ctx, layer_idx, experts_flat)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_local_experts):
        out = out + run(e, x).float() * weights[..., e:e + 1]
    return out.to(x.dtype)


def _moe_block_sparse(bp: dict, x: torch.Tensor, cfg: MixtralConfig, layer_name: str,
                      ctx: Optional[ForwardContext], layer_idx=None,
                      experts_flat=None) -> torch.Tensor:
    """Capacity-bounded dispatch (mixtral.py:204-283): the (token, k)
    assignments sorted stably by expert, each expert's first `capacity`
    tokens gathered into its (capacity, H) buffer (the rest into a trash
    row), each buffer through its expert, and each token's kept outputs,
    weighted in f32, added by index."""
    b, s, h = x.shape
    n, topk, e_total = b * s, cfg.num_experts_per_tok, cfg.num_local_experts
    xf = x.reshape(n, h)
    top_p, top_idx = _route(bp, x, cfg, layer_name, ctx, layer_idx)
    capacity = moe_capacity(n, cfg, ctx.moe_capacity_factor if ctx is not None else 2.0)
    dev = x.device
    flat_e = top_idx.reshape(n * topk)
    flat_t = torch.arange(n, device=dev).repeat_interleave(topk)
    flat_w = top_p.reshape(n * topk).float()
    order = torch.sort(flat_e, stable=True).indices
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.bincount(flat_e, minlength=e_total)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * topk, device=dev) - starts[se]
    keep = pos < capacity
    dest = torch.where(keep, se * capacity + pos, e_total * capacity)
    disp = torch.zeros((e_total * capacity + 1, h), dtype=x.dtype, device=dev)
    disp[dest] = xf[st]
    disp = disp[:-1].reshape(e_total, capacity, h)
    run = _expert_runner(bp, cfg, layer_name, ctx, layer_idx, experts_flat)
    ys = torch.cat([run(e, disp[e]) for e in range(e_total)] +
                   [torch.zeros((1, h), dtype=x.dtype, device=dev)])
    y_a = ys[dest].float() * sw[:, None]
    y_a = torch.where(keep[:, None], y_a, 0.0)
    out = torch.zeros((n, h), dtype=torch.float32, device=dev).index_add_(0, st, y_a)
    return out.reshape(b, s, h).to(x.dtype)


def _moe_block(bp: dict, x: torch.Tensor, cfg: MixtralConfig, layer_name: str,
               ctx: Optional[ForwardContext], layer_idx=None, experts_flat=None):
    block = (_moe_block_sparse if ctx is not None and ctx.moe_dispatch == "sparse"
             else _moe_block_dense)
    return block(bp, x, cfg, layer_name, ctx, layer_idx, experts_flat)


def _decoder_layer(lp: dict, x: torch.Tensor, cfg: MixtralConfig, name: str, cos, sin,
                   ctx: Optional[ForwardContext], cache, attn_mask):
    """One layer (mixtral.py:300-321), each call site named by its HF module
    path for the calibration taps."""
    b, s, _ = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    residual = x
    hidden = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    sa = lp["self_attn"]
    q, k, v = (call_linear(sa[p], hidden, f"{name}.self_attn.{p}", ctx, True)
               for p in ("q_proj", "k_proj", "v_proj"))
    q = apply_rotary(q.reshape(b, s, nh, d), cos, sin)
    k = apply_rotary(k.reshape(b, s, n_kv, d), cos, sin)
    v = v.reshape(b, s, n_kv, d)
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        a = cached_attention(q, cache, causal_offset=offset, ctx=ctx, attn_mask=attn_mask)
    else:
        a = attention(q, k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_mask)
    x = residual + call_linear(sa["o_proj"], a.reshape(b, s, nh * d),
                               f"{name}.self_attn.o_proj", ctx)
    residual = x
    hidden = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    return residual + _moe_block(lp["block_sparse_moe"], hidden, cfg,
                                 f"{name}.block_sparse_moe", ctx), cache


def stack_layers(params: dict, cfg: MixtralConfig) -> dict:
    """Experts stacked first (stack_experts), then the layers along a
    leading L axis (mixtral.py:324-334): expert leaves (L, E, ...)."""
    if "stacked" not in params["layers"]["0"]["block_sparse_moe"]["experts"]:
        params = stack_experts(params, cfg)
    return stack_layer_trees(params, cfg.num_hidden_layers)


def stacked_caches(cfg: MixtralConfig, batch: int, max_len: int, dtype=None, *,
                   pos: int = 0, quant_kv: bool = False, device="cuda"):
    """A stacked head-major decode cache, leading L axis on every field
    (mixtral.py:337-355): the int8 QuantKVCache, or an fp KVCache in `dtype`
    (default cfg's), with (L,) aligned positions."""
    cls = QuantKVCache if quant_kv else KVCache
    return cls.create(batch, max_len, cfg.num_key_value_heads, cfg.head_dim,
                      dtype or cfg.torch_dtype, resolve_device(device),
                      n_layers=cfg.num_hidden_layers, pos=pos)


def _flatten_le(node):
    """A stacked tree's (L, E, ...) leaves viewed as (L·E, ...) (no copy)."""
    if isinstance(node, PackedLinear):
        return dataclasses.replace(node, **{
            f: None if getattr(node, f) is None else _flatten_le(getattr(node, f))
            for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")})
    if isinstance(node, dict):
        return {k: _flatten_le(v) for k, v in node.items()}
    return None if node is None else node.reshape((-1,) + tuple(node.shape[2:]))


def _prefetch_scan_decode(params: dict, x: torch.Tensor, cfg: MixtralConfig,
                          ctx: Optional[ForwardContext], caches, cos, sin, attn_mask):
    """Single-token decode over a stacked tree (mixtral.py:358-424), per
    layer: RMSNorm → q / k / v → K10 (k rotated and written in place; over
    the int8 cache q rotated in the same launch, an fp cache takes
    apply_rotary) → K11 over the (B, S) bias → o_proj → RMSNorm → the MoE
    block in ctx.moe_dispatch over the (L·E, ...) expert stacks.  Every
    layer's bias comes from its own position in one pass; the positions
    advance after the layer loop."""
    st = params["layers"]["stacked"]
    sa, moe = st["self_attn"], st["block_sparse_moe"]
    experts_flat = _flatten_le(moe["experts"]["stacked"])
    b, s, _ = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    quant = isinstance(caches, QuantKVCache)
    s_max = (caches.k_q if quant else caches.k).shape[3]
    pos = caches.pos if caches.pos.ndim == 2 else caches.pos[:, None].expand(-1, b)
    bias = decode_bias(pos, b, s_max, attn_mask)              # (L, B, S_max)
    if not quant:
        cos_q, sin_q = cos.to(x.dtype), sin.to(x.dtype)
    nm = "model.layers.scan"
    for i in range(cfg.num_hidden_layers):
        residual = x
        hidden = rms_norm({"weight": st["input_layernorm"]["weight"][i]}, x, eps)
        q, k, v = (call_linear(sa[p], hidden, f"{nm}.self_attn.{p}", ctx, True, layer_idx=i)
                   for p in ("q_proj", "k_proj", "v_proj"))
        q = q.reshape(b, s, nh, d)
        k, v = k.reshape(b, s, n_kv, d), v.reshape(b, s, n_kv, d)
        if quant:
            q = stacked_cache_append_fused(caches, i, k, v, cos, sin, q=q)
        else:
            q = apply_rotary(q, cos_q, sin_q)[:, 0]
            stacked_cache_append_fused(caches, i, k, v, cos, sin)
        a = stacked_flash_attention(caches, i, q, bias[i])
        x = residual + call_linear(sa["o_proj"], a.reshape(b, s, nh * d), layer_idx=i)
        residual = x
        hidden = rms_norm({"weight": st["post_attention_layernorm"]["weight"][i]}, x, eps)
        x = residual + _moe_block(moe, hidden, cfg, f"{nm}.block_sparse_moe", ctx,
                                  layer_idx=i, experts_flat=experts_flat)
    caches.pos += s
    return x, caches


def _prefetch_capable(params: dict, cfg: MixtralConfig, ctx: Optional[ForwardContext],
                      caches, s: int) -> bool:
    """The stacked decode's gate (mixtral.py:427-442): prefetch_tree_capable
    (its q_proj the attention's first projection), the experts stacked, a
    head-major cache and shapes K11 tiles."""
    stacked = params["layers"].get("stacked")
    if not isinstance(caches, (KVCache, QuantKVCache)):
        return False
    if not prefetch_tree_capable(stacked, caches, s, ctx):
        return False
    if "stacked" not in stacked.get("block_sparse_moe", {}).get("experts", {}):
        return False
    kbuf = caches.k_q if isinstance(caches, QuantKVCache) else caches.k
    return k11.supported(kbuf.shape[3], cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim)


def forward_hidden(params: dict, input_ids: torch.Tensor, cfg: MixtralConfig,
                   ctx: Optional[ForwardContext] = None, caches=None,
                   positions: Optional[torch.Tensor] = None,
                   attn_mask: Optional[torch.Tensor] = None):
    """Final-normed hidden states (B, S, H) and the updated caches
    (mixtral.py:445-498 without the unembedding).  caches: None, a list of
    per-layer caches, or, over a stacked tree, one stacked cache or None."""
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
    cos, sin = rotary_cos_sin(positions.reshape(-1, s), cfg.head_dim, cfg.rope_theta)

    def layer(lp, x, i, cache):
        name = "model.layers.scan" if stacked else f"model.layers.{i}"
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
    return rms_norm(params["norm"], x, cfg.rms_norm_eps), caches


def lm_head_logits(params: dict, h: torch.Tensor, cfg: MixtralConfig,
                   ctx: Optional[ForwardContext] = None) -> torch.Tensor:
    """f32 logits (mixtral.py:491-497): a tied tree (tie_word_embeddings, or
    no lm_head) unembeds through embed_tokens; else the packed lm_head, or
    an fp one through unembed (products accumulated in f32)."""
    lm = params.get("lm_head")
    if cfg.tie_word_embeddings or lm is None:
        return unembed(h, params["embed_tokens"]["weight"])
    if isinstance(lm, PackedLinear):
        return call_linear(lm, h, "lm_head", ctx).float()
    return unembed(h, lm["weight"])


def forward(params: dict, input_ids: torch.Tensor, cfg: MixtralConfig,
            ctx: Optional[ForwardContext] = None, caches=None,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None):
    """(f32 logits (B, S, V), updated caches) (mixtral.py:445-498)."""
    h, caches = forward_hidden(params, input_ids, cfg, ctx, caches, positions, attn_mask)
    return lm_head_logits(params, h, cfg, ctx), caches


def smoothing_map(cfg: MixtralConfig):
    """smooth_lm's Mixtral pairs (mixtral.py:528-548, reference smooth.py:
    142-160): input_layernorm → q / k / v; post_attention_layernorm → the
    router gate and every expert's w1 and w3."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pairs.append((li + ("input_layernorm",),
                      [li + ("self_attn", p) for p in ("q_proj", "k_proj", "v_proj")],
                      f"model.layers.{i}.self_attn.q_proj"))
        fcs = [li + ("block_sparse_moe", "gate")]
        for e in range(cfg.num_local_experts):
            fcs += [li + ("block_sparse_moe", "experts", str(e), w) for w in ("w1", "w3")]
        pairs.append((li + ("post_attention_layernorm",), fcs,
                      f"model.layers.{i}.block_sparse_moe.gate"))
    return pairs


def quantizable_linears(cfg: MixtralConfig):
    """(params_path, stats key, quantize_output) of every projection
    (mixtral.py:610-625): q / k / v (their outputs quantized), o_proj, the
    router gate, each expert's w1 / w2 / w3."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li, pre = ("layers", str(i)), f"model.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}", True))
        out.append((li + ("self_attn", "o_proj"), f"{pre}.self_attn.o_proj", False))
        out.append((li + ("block_sparse_moe", "gate"), f"{pre}.block_sparse_moe.gate", False))
        for e in range(cfg.num_local_experts):
            for p in EXPERT_PROJS:
                out.append((li + ("block_sparse_moe", "experts", str(e), p),
                            f"{pre}.block_sparse_moe.experts.{e}.{p}", False))
    return out


def quantize_params(params: dict, cfg: MixtralConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """The simulated path's offline weight quantization (mixtral.py:501-525,
    reference fake_quant.py:564-668): the attention projections, the router
    gate and every expert's w1 / w2 / w3."""
    return quantize_linears(params, quantizable_linears(cfg), qcfg, input_feat)


# ---------------------------------------------------------------------------
# HF checkpoint import (mixtral.py:551-607)
# ---------------------------------------------------------------------------

def config_from_hf(hf_cfg) -> MixtralConfig:
    """MixtralConfig from an HF Mixtral config (a transformers config or
    utils.hf_import.read_hf_config's namespace)."""
    return MixtralConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=hf_cfg.num_key_value_heads,
        num_local_experts=hf_cfg.num_local_experts,
        num_experts_per_tok=hf_cfg.num_experts_per_tok,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=getattr(hf_cfg, "rope_theta", 1e6),
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
    )


def params_from_hf_state_dict(state: dict, cfg: MixtralConfig, dtype=None,
                              device="cuda") -> dict:
    """An HF Mixtral state dict as the port's tree on `device`, each tensor
    cast to `dtype` (default cfg.dtype) as it moves; lm_head where the
    checkpoint has one."""
    dt = as_torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)

    def arr(name):
        return state[name].to(device=dev, dtype=dt, copy=True)

    def lin(name):
        return {"weight": arr(name + ".weight"), "bias": None}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layers[str(i)] = {
            "input_layernorm": {"weight": arr(f"{p}.input_layernorm.weight")},
            "post_attention_layernorm": {"weight": arr(f"{p}.post_attention_layernorm.weight")},
            "self_attn": {k: lin(f"{p}.self_attn.{k}") for k in ATTN_PROJS},
            "block_sparse_moe": {
                "gate": lin(f"{p}.block_sparse_moe.gate"),
                "experts": {str(e): {k: lin(f"{p}.block_sparse_moe.experts.{e}.{k}")
                                     for k in EXPERT_PROJS}
                            for e in range(cfg.num_local_experts)},
            },
        }
    params = {"embed_tokens": {"weight": arr("model.embed_tokens.weight")},
              "layers": layers, "norm": {"weight": arr("model.norm.weight")}}
    if "lm_head.weight" in state:
        params["lm_head"] = {"weight": arr("lm_head.weight"), "bias": None}
    return params

"""Shared model building blocks (port of smoothquant_tpu/models/common.py,
the parts the W4A4 serving path, the simulated (fake-quant) path, the bf16
decode baseline, the Generator and the ContinuousBatcher use).

  ForwardContext (its calibration taps, quant, compute and attn, :32-83),
  call_linear (packed, transposed-fp "weight_t", simulated quantized and
  plain fp linears, with the taps, :109-223), maybe_quantize_output
  (:226-239), rms_norm,
  layer_norm (:242-251), to_head_major (:578-580), unembed (:658-662),
  rotary_cos_sin, apply_rotary, the head-major KVCache / QuantKVCache
  (:281-387) and SMajorQuantKVCache (:390-467), each per-layer with an int
  or (B,) per-slot positions or stacked, the einsum attention (:550-575;
  with the sliding window and ALiBi slopes, also Bloom's _alibi_attention,
  models/bloom.py:99-127), cached_attention (:583-655; the decode kernel
  K11 over a head-major cache as ForwardContext.attn picks it),
  prefetch_tree_capable (:672-732), layer_tree (a stacked tree's layer i),
  stacked_cache_append (:735-775), stacked_cache_append_fused (:778-817:
  K2 for the S-major cache, K10 for the head-major int8 one, k rotated or,
  for a non-rotary architecture, not; given q, q's rotary in the same
  launch), decode_bias (:820-838, with the sliding window),
  stacked_smajor_attention (:841-854) and stacked_flash_attention
  (:857-875, with Bloom's ALiBi slopes).

Caches are updated IN PLACE (the JAX functions return new buffers); the
objects are returned all the same so call sites read like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from smoothquant_tpu_torch.kernels.attn_smajor import (
    NEG_INF as ATTN_NEG_INF,
    decode_attention_smajor_stacked,
    quantize_rows_int8,
    rope_q_write_cache_smajor,
    write_quant_cache_smajor,
)
from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.kernels.cache_write import (
    rope_q_write_cache_stacked,
    write_quant_cache_stacked,
)
from smoothquant_tpu_torch.kernels.kv_write import apply_rotary
from smoothquant_tpu_torch.kernels.fp_matmul import fp_matmul_stacked
from smoothquant_tpu_torch.kernels.pack import PackedLinear, stack_packed
from smoothquant_tpu_torch.kernels.real_linear import COMPUTE_CHOICES, real_quant_linear
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.core import get_act_quantizer, rms_factor
from smoothquant_tpu_torch.quant.linear import quant_linear

NEG_INF = -1e9   # einsum attention mask value (common.py:29)

_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from its name ("float32", "bfloat16", "float16", the
    names the JAX package passes to jnp.dtype) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPE_NAMES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r} (known: {sorted(_DTYPE_NAMES)})") from None


@dataclasses.dataclass
class ForwardContext:
    """Per-call context of a forward pass (common.py:32-106), the parts the
    port runs: with `taps` set, every linear call site reports its input
    and output to the collector (quant.calibrate.TapCollector).

    compute picks the kernel of a per-layer int8-container pack
    (real_linear.real_quant_linear): "int" (K8), "dequant" (K9) or "auto"
    (by recipe and token count).  quant is the recipe of the simulated
    path: with it set, a plain {"weight", "bias"} linear (quantize_model's
    output) runs quant.linear.quant_linear; packed linears carry their
    recipe in their meta and take from quant only quantize_bmm_input,
    which quantizes the q / k / v projections' outputs with its activation
    quantizer on either path.

    fuse_attn chooses the attention of the stacked decode over an aligned
    head-major int8 cache ((L,) positions, no mask; common.py:85-98):
      "auto"   the virtual-tile attention (K12) over the OLD cache, flat
               pre-rotary q for MHA or rotated q for GQA, then the cache
               writer (K10);
      "fused"  K12's body that also writes the row; no K10;
      "off"    K10, then K11 over the (B, S) bias (the new position inside
               its S-tile, where K12 folds it in last: an f32 reordering).
    fuse_mlp (opt-in, common.py:99-106) runs gate_up, SiLU·up and down_proj
    of that decode as one K14 launch where can_fuse_mlp holds (N <= 8).

    attn picks the single-query attention over a per-layer head-major
    cache (common.py:80-84,616-628): "auto" runs K11 over an int8 cache and
    the einsum over an fp one, "kernel" K11 over either (its split body for
    bf16 queries, its flash body for f32), "einsum" never K11; a stacked
    tree under "einsum" declines the stacked decode (prefetch_tree_capable)
    and runs the per-layer body over its layers.

    moe_dispatch (Mixtral, common.py:52-59): "dense" runs every expert on
    every token, weighted by its routing probability; "sparse" gathers
    each expert's routed tokens into buffers of moe_capacity(n,
    moe_capacity_factor) rows (overflow dropped).

    The parallel modes (common.py:48-79) name torch.distributed process
    groups where JAX names shard_map mesh axes (parallel/):
      tp_group  packed linears combine the ranks' outputs by their
                meta.tp_reduce ("gather": the O-shards all-gathered;
                "psum": the K-shards' partial products all-reduced; "none"
                and "rep": left as they are), and the plain / simulated
                linears of parallel.sharding's trees (ShardedLinear) by
                their style;
      tp_overlap_chunks > 1  a "psum" linear over 3-d input with at least
                8 tokens a chunk splits the tokens into that many
                (product, all-reduce) pairs, chunk c's reduce in flight
                while chunk c+1 computes (bitwise the one reduce);
      ep_group  Mixtral's sparse MoE block runs the rank's block of
                experts and all-reduces the combined output;
      cp_group  the no-cache attention is parallel.cp.ring_attention over
                the rank's sequence chunk."""

    quant: Optional[QuantConfig] = None
    taps: Optional[object] = None
    compute: str = "auto"
    attn: str = "auto"
    fuse_attn: str = "auto"
    fuse_mlp: bool = False
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 2.0
    tp_group: Optional[object] = None
    tp_overlap_chunks: int = 0
    ep_group: Optional[object] = None
    cp_group: Optional[object] = None

    def __post_init__(self):
        if self.moe_dispatch not in ("dense", "sparse"):
            raise ValueError(f"moe_dispatch {self.moe_dispatch!r}: 'dense' or 'sparse'")
        if self.compute not in COMPUTE_CHOICES:
            raise ValueError(f"compute {self.compute!r}: one of {COMPUTE_CHOICES}")
        if self.attn not in ("auto", "kernel", "einsum"):
            raise ValueError(f"attn {self.attn!r}: 'auto', 'kernel' or 'einsum'")
        if self.fuse_attn not in ("auto", "fused", "off"):
            raise ValueError(f"fuse_attn {self.fuse_attn!r}: 'auto', 'fused' or 'off'")


def call_linear(params, x: torch.Tensor, name: Optional[str] = None,
                ctx: Optional[ForwardContext] = None, quantize_output: bool = False, *,
                layer_idx: Optional[int] = None,
                norm: Optional[tuple] = None) -> torch.Tensor:
    """A linear call site (common.py:109-223; the recipe of a packed linear
    travels in its meta).  `name` is the HF-style module path the
    calibration statistics are keyed by; with ctx.taps set the site
    reports its input and output to the collector.

    A transposed-fp {"weight_t", "bias"} dict (llama.pack_fp_decode) runs
    K13 on layer layer_idx of its (L, K, O) stack, or one matmul when it is
    not stacked; a PackedLinear runs real_quant_linear with ctx.compute; a
    plain {"weight", "bias"} dict runs quant_linear under ctx.quant, else
    x @ W.T + b in x's dtype.  quantize_output marks the q/k/v projections,
    whose outputs ctx.quant's quantize_bmm_input quantizes on the packed
    and the simulated path (a transposed-fp linear ignores the recipe, as
    in the JAX package)."""
    taps = None if ctx is None else ctx.taps
    quant = None if ctx is None else ctx.quant
    tp = None if ctx is None else ctx.tp_group
    if taps is not None:
        taps.tap_input(name, x)
    weight_t = isinstance(params, dict) and "weight_t" in params
    compute = "auto" if ctx is None else ctx.compute
    if isinstance(params, ShardedLinear):
        y = _sharded_linear(params, x, ctx)
        if quantize_output:
            y = maybe_quantize_output(y, ctx)     # the whole output row
    elif quant is not None and not weight_t and not isinstance(params, PackedLinear):
        if layer_idx is not None or norm is not None:
            raise NotImplementedError("simulated linears take no layer index or norm")
        y = quant_linear(params, x, quant, quantize_output and quant.quantize_bmm_input)
    else:
        reduce = params.meta.tp_reduce if tp is not None and isinstance(
            params, PackedLinear) else None
        if reduce == "psum":
            y = _row_parallel(params, x, layer_idx, norm, compute, tp, ctx.tp_overlap_chunks)
        else:
            y = _linear(params, x, layer_idx, norm, compute)
            if reduce == "gather":
                from smoothquant_tpu_torch.parallel import comm

                y = comm.all_gather(y, tp, axis=-1)     # v1: the ranks' O-shards
        if quantize_output and not weight_t:
            y = maybe_quantize_output(y, ctx)
    if taps is not None:
        taps.tap_output(name, y)
    return y


@dataclasses.dataclass
class ShardedLinear:
    """A plain or simulated-quantized linear's slice on one rank of a
    tensor-parallel group (parallel.sharding.shard_params): style "col"
    holds rows [r·O/tp, (r+1)·O/tp) of the weight and of the bias, "row"
    columns [r·C/tp, (r+1)·C/tp) of the weight and the whole bias.  The
    salient metadata of a simulated linear indexes the whole layer's input
    channels and stays whole."""

    params: dict
    style: str


def _sharded_linear(lin: ShardedLinear, x: torch.Tensor, ctx: ForwardContext):
    """A ShardedLinear under ctx.tp_group, to the single-device result up
    to the order of the row-parallel sum.  Column-parallel: the local
    output columns, all-gathered (the activation quantizer saw the whole
    input row, which every rank holds).  Row-parallel: the activation
    quantizer runs on the WHOLE input row (per-token scales, groups and
    salient channels of the whole layer), then the rank's K-slice of the
    quantized row meets its weight columns, the partial products are
    all-reduced and the bias added once."""
    from smoothquant_tpu_torch.parallel import comm
    from smoothquant_tpu_torch.quant.linear import linear, quantize_input

    if ctx is None or ctx.tp_group is None:
        raise ValueError("a ShardedLinear runs under ForwardContext.tp_group")
    p, quant, group = lin.params, ctx.quant, ctx.tp_group
    if lin.style == "col":
        y = linear(p, x) if quant is None else quant_linear(p, x, quant)
        return comm.all_gather(y, group, axis=-1)
    xq = x if quant is None else quantize_input(p, x, quant)
    k = p["weight"].shape[1]
    r = torch.distributed.get_rank(group)
    y = torch.matmul(xq[..., r * k:(r + 1) * k], p["weight"].t().to(xq.dtype))
    y = comm.all_reduce(y, group)
    if p.get("bias") is not None:
        y = y + p["bias"].to(y.dtype)
    return y


def _row_parallel(params: PackedLinear, x, layer_idx, norm, compute, group, chunks: int):
    """A row-parallel ("psum") pack (common.py:160-204): the local K-shard's
    product, all-reduced (the bias, stored divided by tp, comes back once).
    chunks > 1 over 3-d input of at least 8 tokens a chunk splits the
    token axis: each chunk's all-reduce is issued asynchronously as soon as
    its product is done, so it is in flight while the next chunk computes;
    each row's product and sum are the synchronous ones, bit for bit."""
    from smoothquant_tpu_torch.parallel import comm

    if chunks > 1 and x.ndim == 3 and x.shape[1] >= chunks * 8 and x.shape[1] % chunks == 0:
        step = x.shape[1] // chunks
        pending = [comm.all_reduce_async(
            _linear(params, x[:, c * step:(c + 1) * step], layer_idx, norm, compute), group)
            for c in range(chunks)]
        return torch.cat([p.wait() for p in pending], dim=1)
    return comm.all_reduce(_linear(params, x, layer_idx, norm, compute), group)


def maybe_quantize_output(y: torch.Tensor, ctx: Optional[ForwardContext]) -> torch.Tensor:
    """A projection output through the recipe's activation quantizer when
    ctx.quant.quantize_bmm_input is on (common.py:226-239): the fused q / k
    / v projections call it on each split, as the reference quantizes
    each projection's output; any other context leaves y as it is."""
    if ctx is None or ctx.quant is None or not ctx.quant.quantize_bmm_input:
        return y
    q = ctx.quant
    return get_act_quantizer(q.act_quant, q.effective_act_bits, q.group_size,
                             q.sort_strategy)(y)


def _linear(params, x, layer_idx, norm, compute):
    if isinstance(params, dict) and "weight_t" in params:
        if norm is not None:
            raise NotImplementedError("norm fusion is a packed-linear path")
        x2d = x.reshape(-1, x.shape[-1])
        bias = params.get("bias")
        if layer_idx is not None:
            y = fp_matmul_stacked(layer_idx, x2d, params["weight_t"])
            bias = None if bias is None else bias[layer_idx]
        else:
            y = torch.matmul(x2d, params["weight_t"].to(x.dtype))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)
    if isinstance(params, PackedLinear):
        return real_quant_linear(params, x, compute=compute, layer_idx=layer_idx, norm=norm)
    if layer_idx is not None or norm is not None:
        raise NotImplementedError("plain fp linears take no layer index or norm")
    y = torch.matmul(x, params["weight"].t().to(x.dtype))
    if params.get("bias") is not None:
        y = y + params["bias"].to(x.dtype)
    return y


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast to x's dtype, its factor by quant.core.rms_factor:
    the rule K1's pre-pass and K14 take, the same bits on the CPU and the
    card."""
    xf = x.float()
    y = xf * rms_factor(xf, eps)
    return (y * params["weight"].float()).to(x.dtype)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (common.py:242-251): two-pass mean and variance,
    then ·weight and +bias as two roundings, as the JAX code runs eagerly."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["weight"].float()
    if params.get("bias") is not None:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def to_head_major(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) → (B, H, S, D) view for the no-cache attention path."""
    return x.transpose(1, 2)


def unembed(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """(..., H) @ (V, H)ᵀ → f32 logits (common.py:658-662): the embedding
    cast to x's dtype, the products accumulated in f32 from the operands'
    values as the einsum with preferred_element_type=f32 takes them (the
    upcast of bf16 operands is exact)."""
    return torch.matmul(x.float(), embedding.to(x.dtype).float().t())


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   theta: float = 10000.0):
    """HF-Llama rotary tables (..., S, head_dim) with duplicated halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _write_rows(buf: torch.Tensor, new: torch.Tensor, pos, s_axis: int = 2) -> None:
    """Write `new` into a per-layer buffer at position `pos` along its S axis
    (axis 2 of the head-major (B, H, S[, D]) buffers, axis 1 of the S-major
    (B, S, H·D) values), in place.  pos is an int, a 0-d tensor (one
    position for every row) or (B,) per-slot positions, each row written at
    its own; as jax.lax.dynamic_update_slice (vmap'd over the rows for
    per-slot positions) a start past the end is clamped so the rows fit."""
    sq, s = new.shape[s_axis], buf.shape[s_axis]
    if isinstance(pos, int):
        buf.narrow(s_axis, min(max(pos, 0), s - sq), sq).copy_(new)
        return
    start = torch.clamp(torch.as_tensor(pos, device=buf.device).to(torch.int64), 0, s - sq)
    rows = start.expand(buf.shape[0])[:, None] + torch.arange(sq, device=buf.device)
    slot = torch.arange(buf.shape[0], device=buf.device)[:, None]
    if s_axis == 1:
        buf[slot, rows] = new
    else:   # the indexed view is (B, Sq, H[, D])
        buf[slot, :, rows] = new.movedim(2, 1)


@dataclasses.dataclass
class KVCache:
    """fp decode cache k/v (B, H_kv, S, D), head-major (common.py:281-322),
    with an int fill position or, per_slot, (B,) int32 positions (each slot
    its own, the batcher's per-layer pool); the stacked form (n_layers
    given) carries a leading L axis and (L,) aligned or, per_slot, (L, B)
    positions.  Updated IN PLACE."""

    k: torch.Tensor
    v: torch.Tensor
    pos: Union[int, torch.Tensor]

    @classmethod
    def create(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype, device, per_slot: bool = False,
               n_layers: Optional[int] = None, pos: int = 0):
        lead = () if n_layers is None else (n_layers,)
        shape = lead + (batch, n_kv_heads, max_len, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=_initial_pos(batch, n_layers, per_slot, pos, device))

    def layer(self, i: int, pos=None) -> "KVCache":
        """Layer i of a stacked cache as a per-layer view (shared storage),
        at `pos` (default: the layer's own, a 0-d or (B,) view)."""
        return KVCache(self.k[i], self.v[i], self.pos[i] if pos is None else pos)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Append k/v (B, Sq, H_kv, D) at pos (each slot at its own)."""
        _write_rows(self.k, k_new.transpose(1, 2).to(self.k.dtype), self.pos)
        _write_rows(self.v, v_new.transpose(1, 2).to(self.v.dtype), self.pos)
        return dataclasses.replace(self, pos=self.pos + k_new.shape[1])

    def read(self):
        """(B, H_kv, S, D) key / value views."""
        return self.k, self.v


@dataclasses.dataclass
class QuantKVCache:
    """int8 decode cache (common.py:325-387): k_q/v_q (B, H_kv, S, D) int8
    with per-(slot, head, position) f32 scales (B, H_kv, S), max(absmax,
    1e-8)/127 as jitted JAX computes it.  pos, per_slot and the stacked
    form as KVCache.  Updated IN PLACE."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    pos: Union[int, torch.Tensor]

    @classmethod
    def create(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype=None, device="cuda", per_slot: bool = False,
               n_layers: Optional[int] = None, pos: int = 0):
        del dtype  # storage is int8; read() dequantizes to bf16
        device = resolve_device(device)
        lead = () if n_layers is None else (n_layers,)
        shape = lead + (batch, n_kv_heads, max_len, head_dim)
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return cls(k_q=z(shape, torch.int8), v_q=z(shape, torch.int8),
                   k_scale=z(shape[:-1], torch.float32),
                   v_scale=z(shape[:-1], torch.float32),
                   pos=_initial_pos(batch, n_layers, per_slot, pos, device))

    def layer(self, i: int, pos=None) -> "QuantKVCache":
        """Layer i of a stacked cache as a per-layer view, as KVCache.layer."""
        return QuantKVCache(self.k_q[i], self.v_q[i], self.k_scale[i], self.v_scale[i],
                            self.pos[i] if pos is None else pos)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "QuantKVCache":
        """Quantize and append k/v (B, Sq, H_kv, D) at pos (each slot at its
        own)."""
        for new, q_buf, s_buf in ((k_new, self.k_q, self.k_scale),
                                  (v_new, self.v_q, self.v_scale)):
            q, sc = quantize_rows_int8(new.transpose(1, 2))   # (B,H,Sq,D), (B,H,Sq)
            _write_rows(q_buf, q, self.pos)
            _write_rows(s_buf, sc, self.pos)
        return dataclasses.replace(self, pos=self.pos + k_new.shape[1])

    def read(self):
        """(B, H_kv, S, D) dequantized bf16 views (the einsum path)."""
        def deq(q, sc):
            return (q.float() * sc[..., None]).to(torch.bfloat16)

        return deq(self.k_q, self.k_scale), deq(self.v_q, self.v_scale)


def _initial_pos(batch, n_layers, per_slot, pos, device):
    """An int (per-layer, aligned), or int32 positions: (B,) per-layer per
    slot, (L,) stacked aligned, (L, B) stacked per slot."""
    if n_layers is None and not per_slot:
        return pos
    shape = ((n_layers,) if n_layers is not None else ()) + ((batch,) if per_slot else ())
    return torch.full(shape, pos, dtype=torch.int32, device=device)


@dataclasses.dataclass
class SMajorQuantKVCache:
    """INT8 KV cache in S-major value layout: k_q/v_q (B, S, H_kv·D),
    head-major scales (B, H_kv, S) (common.py:390-467).  The stacked form
    carries a leading L axis on every tensor and (L, B) per-slot positions;
    a per-layer cache holds an int position or, per_slot, (B,) ones."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    pos: Union[int, torch.Tensor]

    @classmethod
    def create(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               device, n_layers: Optional[int] = None, pos=0, per_slot: bool = False):
        """Zeroed cache; with n_layers, stacked (L, ...) with (L, B) pos."""
        lead = () if n_layers is None else (n_layers,)
        hd = n_kv_heads * head_dim
        z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
        pos = _initial_pos(batch, n_layers, per_slot or n_layers is not None, pos, device)
        return cls(k_q=z((batch, max_len, hd), torch.int8),
                   v_q=z((batch, max_len, hd), torch.int8),
                   k_scale=z((batch, n_kv_heads, max_len), torch.float32),
                   v_scale=z((batch, n_kv_heads, max_len), torch.float32),
                   pos=pos)

    def layer(self, i: int, pos=None) -> "SMajorQuantKVCache":
        """Layer i of a stacked cache as a per-layer view (shared storage),
        at `pos` (default: the layer's own (B,) positions)."""
        return SMajorQuantKVCache(self.k_q[i], self.v_q[i], self.k_scale[i],
                                  self.v_scale[i], self.pos[i] if pos is None else pos)

    @property
    def n_kv_heads(self) -> int:
        return self.k_scale.shape[-2]

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write k/v (B, Sq, H, D) at pos (each slot at its own), in place."""
        b, sq, h, d = k_new.shape
        for new, q_buf, s_buf in ((k_new, self.k_q, self.k_scale),
                                  (v_new, self.v_q, self.v_scale)):
            q, sc = quantize_rows_int8(new)          # (B,Sq,H,D), (B,Sq,H)
            _write_rows(q_buf, q.reshape(b, sq, h * d), self.pos, s_axis=1)
            _write_rows(s_buf, sc.transpose(1, 2), self.pos)
        return dataclasses.replace(self, pos=self.pos + sq)

    def read(self):
        """(B, H, S, D) dequantized bf16 views (the einsum path)."""
        b, s, hd = self.k_q.shape
        h = self.n_kv_heads
        d = hd // h

        def deq(q, sc):
            x = q.reshape(b, s, h, d).transpose(1, 2).float() * sc[..., None]
            return x.to(torch.bfloat16)

        return deq(self.k_q, self.k_scale), deq(self.v_q, self.v_scale)


def _per_batch(x):
    x = torch.as_tensor(x)
    return x.reshape(-1, 1, 1, 1) if x.ndim == 1 else x


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal_offset=0, valid_len=None,
              attn_mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              alibi_slopes: Optional[torch.Tensor] = None,
              sliding_window: Optional[int] = None,
              ctx: Optional[ForwardContext] = None):
    """Einsum attention with causal masking and GQA (common.py:550-575).

    q: (B, Sq, H, D); k/v: (B, H_kv, Sk, D).  Scores and softmax in f32,
    probabilities cast to v's dtype before PV.  scale defaults to 1/√D
    (OPT scales q itself and passes 1.0).  alibi_slopes (H,): Bloom's
    score += slope_h · j at key position j, before the mask
    (bloom.py:99-127: slope·j equals HF's slope·(j − i) up to a per-row
    constant that the softmax cancels).  sliding_window W (Mistral): the
    query at absolute position p sees the keys in (p − W, p].

    Under ctx.cp_group (context-parallel prefill, common.py:494-507) q / k
    / v are the rank's chunk of the sequence and the attention is
    parallel.cp.ring_attention, causal from the ring's global offsets:
    no valid_len, window, ALiBi or causal offset (a key mask rides
    attn_mask)."""
    if ctx is not None and ctx.cp_group is not None:
        from smoothquant_tpu_torch.parallel.cp import ring_attention

        assert valid_len is None, "cp prefill uses attn_mask, not valid_len"
        assert sliding_window is None and alibi_slopes is None, (
            "ring attention implements no sliding window or ALiBi")
        assert isinstance(causal_offset, int) and causal_offset == 0, (
            "cp prefill masks causally from the ring's global offsets")
        return ring_attention(q, k, v, ctx.cp_group, scale=scale, attn_mask=attn_mask)
    b, sq, nh, d = q.shape
    n_kv, sk = k.shape[1], k.shape[2]
    if n_kv != nh:
        k = k.repeat_interleave(nh // n_kv, dim=1)
        v = v.repeat_interleave(nh // n_kv, dim=1)
    if scale is None:
        scale = 1.0 / d ** 0.5
    scores = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(sq, device=q.device).reshape(1, 1, sq, 1)
    kj = torch.arange(sk, device=q.device).reshape(1, 1, 1, sk)
    if alibi_slopes is not None:
        scores = scores + alibi_slopes.float().reshape(1, nh, 1, 1) * kj.float()
    qpos = qi + _per_batch(causal_offset).to(q.device)
    mask = kj <= qpos
    if sliding_window is not None:
        mask = mask & (kj > qpos - sliding_window)
    if valid_len is not None:
        mask = mask & (kj < _per_batch(valid_len).to(q.device))
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].bool()
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    # jax.nn.softmax's form: exp(s - max) divided by its sum
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.float(), v.float())
    return out.to(v.dtype).to(q.dtype)


def cached_attention(q: torch.Tensor, cache, *, causal_offset,
                     ctx: Optional[ForwardContext] = None,
                     attn_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     sliding_window: Optional[int] = None):
    """Attention over an already-updated per-layer cache (common.py:583-655).
    A single query over a head-major cache runs K11 where ctx.attn picks it
    ("auto": the int8 cache; "kernel": the fp cache too; "einsum": never)
    and K11 tiles the shape, with validity, the window and the key mask
    folded into a (B, S) bias; everything else (prefill, the S-major cache)
    is the einsum over the cache's (dequantized) view.  `scale` (default
    1/√D; OPT's 1.0) reaches K11 as its sm_scale, as in JAX (:640-650)."""
    if not isinstance(cache, (SMajorQuantKVCache, KVCache, QuantKVCache)):
        raise NotImplementedError(f"cache type {type(cache).__name__}")
    mode = "auto" if ctx is None else ctx.attn
    if not isinstance(cache, SMajorQuantKVCache) and q.shape[1] == 1:
        quant = isinstance(cache, QuantKVCache)
        b, _, nh, d = q.shape
        kbuf = cache.k_q if quant else cache.k
        n_kv, s = kbuf.shape[1], kbuf.shape[2]
        if (mode != "einsum" and (mode == "kernel" or quant)
                and k11.supported(s, nh, n_kv, d)):
            col = torch.arange(s, device=q.device)[None, :]
            ok = col < torch.as_tensor(cache.pos, device=q.device).expand(b)[:, None]
            if sliding_window is not None:
                qpos = torch.as_tensor(causal_offset, device=q.device).expand(b)
                ok = ok & (col > qpos[:, None] - sliding_window)
            if attn_mask is not None:
                ok = ok & attn_mask.bool()
            bias = torch.where(ok, 0.0, k11.NEG_INF).to(torch.float32)
            scales = (cache.k_scale, cache.v_scale) if quant else ()
            out = k11.decode_attention(q[:, 0], kbuf, cache.v_q if quant else cache.v,
                                       bias, *scales, sm_scale=scale)
            return out[:, None]
    return attention(q, *cache.read(), causal_offset=causal_offset,
                     valid_len=cache.pos, attn_mask=attn_mask, scale=scale,
                     sliding_window=sliding_window)


def decode_bias(pos_i: torch.Tensor, b: int, s_max: int,
                attn_mask: Optional[torch.Tensor],
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """(..., B, S_max) additive f32 bias for single-token decode: 0 where
    the key position is < pos_i + 1 (and attn_mask allows it, and, with a
    sliding window W, > pos_i − W), -1e30 elsewhere (common.py:820-838).
    pos_i is a scalar, (B,) per slot, or (L, B) per layer."""
    pos_i = torch.as_tensor(pos_i)[..., None]
    col = torch.arange(s_max, device=pos_i.device)[None, :].expand(b, s_max)
    ok = col < pos_i + 1
    if sliding_window is not None:
        ok = ok & (col > pos_i - sliding_window)
    if attn_mask is not None:
        ok = ok & attn_mask.bool()
    return torch.where(ok, 0.0, ATTN_NEG_INF).to(torch.float32)


def prefetch_tree_capable(stacked, caches, s: int,
                          ctx: Optional[ForwardContext] = None) -> bool:
    """The gate of the stacked single-token decode (common.py:672-732):
    one token, a stacked cache with (L,) or (L, B) positions, no taps, no
    tp or ep group (common.py:689-690), attn not "einsum", and every
    projection a transposed-fp "weight_t" dict whose K is a multiple of 8
    and O of 128, or a tile-aligned nibble PackedLinear
    under compute "auto" or "int".  The attention's first projection is
    Llama's / OPT's fused self_attn.qkv_proj, Bloom's / Falcon's
    self_attention.query_key_value or an unfused q_proj (Mixtral, an unfused
    OPT tree).  A tree it declines runs the per-layer body over its layers
    (layer_tree)."""
    if s != 1 or caches is None or not isinstance(getattr(caches, "pos", None),
                                                   torch.Tensor):
        return False
    if ctx is not None and (ctx.taps is not None or ctx.attn == "einsum"
                            or ctx.tp_group is not None or ctx.ep_group is not None):
        return False
    if caches.pos.ndim not in (1, 2) or not isinstance(stacked, dict):
        return False
    sa = stacked.get("self_attn", stacked.get("self_attention", {}))
    qp = sa.get("qkv_proj", sa.get("query_key_value", sa.get("q_proj")))

    def leaves(node):
        if isinstance(node, PackedLinear) or (isinstance(node, dict)
                                              and "weight_t" in node):
            yield node
        elif isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)

    if isinstance(qp, dict) and "weight_t" in qp:
        return all(isinstance(lin, dict) and lin["weight_t"].shape[1] % 8 == 0
                   and lin["weight_t"].shape[2] % 128 == 0 for lin in leaves(stacked))
    if isinstance(qp, PackedLinear) and qp.meta.nibble:
        if ctx is not None and ctx.compute not in ("auto", "int"):
            return False
        return all(isinstance(lin, PackedLinear) and lin.meta.nibble
                   and (lin.meta.k_ns // (2 * lin.meta.group_size)) % 8 == 0
                   and lin.w_qt.shape[-1] % 256 == 0 for lin in leaves(stacked))
    return False


_PACKED_TENSORS = ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")


def layer_tree(node, i: int):
    """Layer i of a stacked tree (views, nothing copied): every tensor and
    every PackedLinear field indexed on its leading L axis — what the JAX
    lax.scan over _decoder_layer hands each layer (llama.py:551-572)."""
    if isinstance(node, PackedLinear):
        return dataclasses.replace(node, **{
            f: None if getattr(node, f) is None else getattr(node, f)[i]
            for f in _PACKED_TENSORS})
    if isinstance(node, dict):
        return {k: layer_tree(v, i) for k, v in node.items()}
    return None if node is None else node[i]


def stacked_layers(layer_fn, stacked: dict, x: torch.Tensor, n_layers: int, caches,
                   ctx: Optional[ForwardContext]):
    """The per-layer body over a stacked tree that the stacked decode
    declines (JAX's lax.scan over _decoder_layer, llama.py:551-572,
    bloom.py:332-342): layer i runs `layer_fn(layer_tree(stacked, i), x, i,
    cache)` over layer i's view of a stacked cache (its (L,) or (L, B)
    positions) or with no cache, and the stacked cache comes back stacked,
    its positions advanced by the tokens of the call."""
    if ctx is not None and ctx.taps is not None:
        raise NotImplementedError("calibration taps name per-layer trees (JAX: "
                                  "taps unsupported with scan)")
    for i in range(n_layers):
        x, _ = layer_fn(layer_tree(stacked, i), x, i,
                        None if caches is None else caches.layer(i))
    if caches is not None:
        caches.pos += x.shape[1]
    return x, caches


def stack_trees(nodes: list):
    """Trees of one structure stacked along a new leading axis (one copy;
    PackedLinear leaves by stack_packed, None stays None)."""
    if isinstance(nodes[0], PackedLinear):
        return stack_packed(list(nodes))
    if isinstance(nodes[0], dict):
        return {k: stack_trees([n[k] for n in nodes]) for k in nodes[0]}
    if nodes[0] is None:
        return None
    return torch.stack(nodes)


def stack_layer_trees(params: dict, n_layers: int) -> dict:
    """params with its per-layer trees "0" .. n_layers − 1 stacked along a
    leading L axis under layers["stacked"] (stack_trees) — the stack_layers
    of every family."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {"stacked": stack_trees([params["layers"][str(i)]
                                             for i in range(n_layers)])}
    return out


def stacked_cache_append(cache: KVCache, i: int, k_new: torch.Tensor,
                         v_new: torch.Tensor) -> KVCache:
    """Write one decode position's k/v (B, 1, H_kv, D) into layer i of a
    stacked fp cache at each row's position (common.py:735-775), in place;
    positions past the cache clamp to its last row as dynamic_update_slice
    does.  The positions advance after the layer loop."""
    pos_i = cache.pos[i]
    s_max = cache.k.shape[3]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new[:, 0].to(buf.dtype)                      # (B, H_kv, D)
        rows = torch.clamp(pos_i.to(torch.int64), 0, s_max - 1)
        if rows.ndim == 0:
            buf[i, :, :, rows] = new
        else:
            buf[i, torch.arange(new.shape[0], device=new.device), :, rows] = new
    return cache


def stacked_cache_append_fused(cache, i: int, k_new: torch.Tensor,
                               v_new: torch.Tensor, cos, sin, rotate_k: bool = True,
                               q: Optional[torch.Tensor] = None):
    """Layer i's cache write in the stacked decode (common.py:778-817).
    k_new/v_new (B, 1, H_kv, D), k PRE-rotary when rotate_k.  The S-major
    int8 cache runs K2 and the head-major int8 cache K10 (rotary-k, int8
    quantize, in-place row write at each slot's position, or the aligned
    one); an fp cache takes apply_rotary and stacked_cache_append.  A
    non-rotary architecture (Bloom) passes rotate_k=False and no tables
    (JAX passes dummy ones): the writers run with rotary off and read none.
    Returns the cache; or, given q (B, 1, H, D) PRE-rotary (the "smajor"
    and "off" steps over an int8 cache), the writer's row body
    (rope_q_write_cache_smajor / rope_q_write_cache_stacked) rotates q in
    the same launch and this returns q rotated as apply_rotary rotates it,
    (B, H, D).  q, k_new and v_new may be strided views into the qkv rows:
    the row body reads them where they lie."""
    b, _, h, d = k_new.shape
    if isinstance(cache, (SMajorQuantKVCache, QuantKVCache)):
        smajor = isinstance(cache, SMajorQuantKVCache)
        args = (k_new.reshape(b, h, d), v_new.reshape(b, h, d), cos, sin, cache.k_q,
                cache.v_q, cache.k_scale, cache.v_scale)
        if q is not None:
            write = rope_q_write_cache_smajor if smajor else rope_q_write_cache_stacked
            return write(i, cache.pos[i], q.reshape(b, -1, d), *args, rotary=rotate_k)
        write = write_quant_cache_smajor if smajor else write_quant_cache_stacked
        write(i, cache.pos[i], *args, rotary=rotate_k)
        return cache
    if q is not None:
        raise NotImplementedError("q is rotated in the write only over an int8 cache")
    if isinstance(cache, KVCache):
        if rotate_k:
            k_new = apply_rotary(k_new, cos, sin)
        return stacked_cache_append(cache, i, k_new, v_new)
    raise NotImplementedError(f"cache type {type(cache).__name__}")


def stacked_smajor_attention(cache: SMajorQuantKVCache, i: int,
                             q_bhd: torch.Tensor, bias: torch.Tensor):
    """K3: layer-i decode attention over the stacked S-major cache.
    q_bhd (B, H, D) post-rotary → (B, H, D)."""
    return decode_attention_smajor_stacked(
        i, q_bhd, cache.k_q, cache.v_q, bias, cache.k_scale, cache.v_scale)


def stacked_flash_attention(cache, i: int, q_bhd: torch.Tensor,
                            bias: torch.Tensor, alibi_slopes: Optional[torch.Tensor] = None,
                            sm_scale: Optional[float] = None):
    """K11: layer-i decode attention over a stacked head-major cache, fp or
    int8 (common.py:857-875).  q_bhd (B, H, D) post-rotary → (B, H, D);
    alibi_slopes (H,): Bloom's per-head ALiBi term, added in the kernel;
    sm_scale: 1.0 for OPT, whose q is scaled at projection (default 1/√D)."""
    if isinstance(cache, QuantKVCache):
        return k11.decode_attention_stacked(i, q_bhd, cache.k_q, cache.v_q, bias,
                                            cache.k_scale, cache.v_scale, alibi_slopes,
                                            sm_scale=sm_scale)
    return k11.decode_attention_stacked(i, q_bhd, cache.k, cache.v, bias,
                                        alibi_slopes=alibi_slopes, sm_scale=sm_scale)

"""Shared model building blocks (port of smoothquant_tpu/models/common.py,
the parts the W4A4 serving path uses).

  call_linear, rms_norm, rotary_cos_sin,
  apply_rotary, SMajorQuantKVCache (create / update / read), the einsum
  attention and cached_attention's S-major branch (:470-609), decode_bias
  (:820-838), the S-major branch of stacked_cache_append_fused (:785-799)
  and stacked_smajor_attention (:841-854).

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
    write_quant_cache_smajor,
)
from smoothquant_tpu_torch.kernels.pack import PackedLinear
from smoothquant_tpu_torch.kernels.real_linear import real_quant_linear
from smoothquant_tpu_torch.quant.core import f32_reciprocal

NEG_INF = -1e9   # einsum attention mask value (common.py:29)


def call_linear(params, x: torch.Tensor, layer_idx: Optional[int] = None,
                norm: Optional[tuple] = None) -> torch.Tensor:
    """A quantizable linear call site (packed linears only; the recipe
    travels in the pack's meta, so no forward context is needed)."""
    if not isinstance(params, PackedLinear):
        raise NotImplementedError("only packed (real-kernel) linears are ported")
    return real_quant_linear(params, x, layer_idx=layer_idx, norm=norm)


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) * f32_reciprocal(x.shape[-1])
    y = xf * torch.rsqrt(ms + eps)
    return (y * params["weight"].float()).to(x.dtype)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   theta: float = 10000.0):
    """HF-Llama rotary tables (..., S, head_dim) with duplicated halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B or 1, S, D)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotated * sin


@dataclasses.dataclass
class SMajorQuantKVCache:
    """INT8 KV cache in S-major value layout: k_q/v_q (B, S, H_kv·D),
    head-major scales (B, H_kv, S).  The stacked form carries a leading L
    axis on every tensor and (L, B) per-slot positions; a per-layer cache
    (prefill) holds an int position."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    pos: Union[int, torch.Tensor]

    @classmethod
    def create(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               device, n_layers: Optional[int] = None, pos=0):
        """Zeroed cache; with n_layers, stacked (L, ...) with (L, B) pos."""
        lead = () if n_layers is None else (n_layers,)
        hd = n_kv_heads * head_dim
        z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
        if n_layers is not None:
            pos = torch.full((n_layers, batch), pos, dtype=torch.int32,
                             device=device)
        return cls(k_q=z((batch, max_len, hd), torch.int8),
                   v_q=z((batch, max_len, hd), torch.int8),
                   k_scale=z((batch, n_kv_heads, max_len), torch.float32),
                   v_scale=z((batch, n_kv_heads, max_len), torch.float32),
                   pos=pos)

    def layer(self, i: int) -> "SMajorQuantKVCache":
        """Layer i of a stacked cache as a per-layer view (shared storage)."""
        return SMajorQuantKVCache(self.k_q[i], self.v_q[i], self.k_scale[i],
                                  self.v_scale[i], pos=0)

    @property
    def n_kv_heads(self) -> int:
        return self.k_scale.shape[-2]

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write k/v (B, Sq, H, D) at the int position, in place."""
        if not isinstance(self.pos, int):
            raise NotImplementedError("per-slot per-layer caches")
        b, sq, h, d = k_new.shape
        p = self.pos
        for new, q_buf, s_buf in ((k_new, self.k_q, self.k_scale),
                                  (v_new, self.v_q, self.v_scale)):
            q, sc = quantize_rows_int8(new)          # (B,Sq,H,D), (B,Sq,H)
            q_buf[:, p:p + sq] = q.reshape(b, sq, h * d)
            s_buf[:, :, p:p + sq] = sc.transpose(1, 2)
        return dataclasses.replace(self, pos=p + sq)

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
              attn_mask: Optional[torch.Tensor] = None):
    """Einsum attention with causal masking and GQA (common.py:550-575).

    q: (B, Sq, H, D); k/v: (B, H_kv, Sk, D).  Scores and softmax in f32,
    probabilities cast to v's dtype before PV."""
    b, sq, nh, d = q.shape
    n_kv, sk = k.shape[1], k.shape[2]
    if n_kv != nh:
        k = k.repeat_interleave(nh // n_kv, dim=1)
        v = v.repeat_interleave(nh // n_kv, dim=1)
    scores = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    qi = torch.arange(sq, device=q.device).reshape(1, 1, sq, 1)
    kj = torch.arange(sk, device=q.device).reshape(1, 1, 1, sk)
    mask = kj <= qi + _per_batch(causal_offset).to(q.device)
    if valid_len is not None:
        mask = mask & (kj < _per_batch(valid_len).to(q.device))
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, :].bool()
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.float(), v.float())
    return out.to(v.dtype).to(q.dtype)


def cached_attention(q: torch.Tensor, cache, *, causal_offset,
                     attn_mask: Optional[torch.Tensor] = None):
    """Attention over an updated S-major cache: the einsum over its
    dequantized view (common.py:603-609)."""
    if not isinstance(cache, SMajorQuantKVCache):
        raise NotImplementedError("only the S-major int8 cache is ported")
    return attention(q, *cache.read(), causal_offset=causal_offset,
                     valid_len=cache.pos, attn_mask=attn_mask)


def decode_bias(pos_i: torch.Tensor, b: int, s_max: int,
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., B, S_max) additive f32 bias for single-token decode: 0 where
    the key position is < pos_i + 1 (and attn_mask allows it), -1e30
    elsewhere.  pos_i is a scalar, (B,) per slot, or (L, B) per layer."""
    pos_i = torch.as_tensor(pos_i)[..., None]
    col = torch.arange(s_max, device=pos_i.device)[None, :].expand(b, s_max)
    ok = col < pos_i + 1
    if attn_mask is not None:
        ok = ok & attn_mask.bool()
    return torch.where(ok, 0.0, ATTN_NEG_INF).to(torch.float32)


def stacked_cache_append_fused(cache: SMajorQuantKVCache, i: int,
                               k_new: torch.Tensor, v_new: torch.Tensor,
                               cos, sin):
    """K2 on layer i of a stacked S-major cache: rotary-k, int8 quantize
    and the in-place row write at each slot's position.  k_new/v_new
    (B, 1, H_kv, D), k PRE-rotary."""
    if not isinstance(cache, SMajorQuantKVCache):
        raise NotImplementedError("only the S-major int8 cache is ported")
    b, _, h, d = k_new.shape
    write_quant_cache_smajor(i, cache.pos[i], k_new.reshape(b, h, d),
                             v_new.reshape(b, h, d), cos, sin, cache.k_q,
                             cache.v_q, cache.k_scale, cache.v_scale)
    return cache


def stacked_smajor_attention(cache: SMajorQuantKVCache, i: int,
                             q_bhd: torch.Tensor, bias: torch.Tensor):
    """K3: layer-i decode attention over the stacked S-major cache.
    q_bhd (B, H, D) post-rotary → (B, H, D)."""
    return decode_attention_smajor_stacked(
        i, q_bhd, cache.k_q, cache.v_q, bias, cache.k_scale, cache.v_scale)

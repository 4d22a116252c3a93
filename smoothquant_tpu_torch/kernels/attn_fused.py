"""Virtual-tile decode attention over the stacked head-major int8 cache
(K12), with its plain PyTorch version.

K12 — port of smoothquant_tpu/kernels/attn_fused.py _fused_attn_call
    (:293; pallas_call :345 for the inline bodies, :491 for the phased body
    that writes the row), behind its three entry points:
      fused_virtual_attn_flat (:607-634)       q (B, 1, H·D) PRE-rotary, MHA
                                               only, flat output; the
                                               q-rotary runs in the kernel;
      fused_virtual_attn_stacked (:572-601)    q (B, H, D) already rotated,
                                               GQA, no cache write;
      fused_rope_write_attn_stacked (:537-566) the stacked body that also
                                               writes the row and its scale.
    One aligned decode position per layer (a scalar, or a one-element
    device tensor: the cache's (L,) positions), no mask.  Attention reads
    the OLD cache, columns < pos, and folds the new position in LAST, as
    one more online-softmax step (attn_fused.py:114-152); the new k is
    rotated (fma(x, cos, rot(x)·sin) in f32) and k / v quantized as K10
    does it (scale max(absmax, 1e-8)/127 as the reciprocal multiply, codes
    rounded half to even), so the virtual row is bit-identical to the row
    K10 writes.  The flat body rotates q in f32 the same way and rounds it
    to q's dtype before the dot; the stacked bodies take q as given.  The
    write body writes the row at pos (clamped to S − 1, as K10) IN PLACE;
    the JAX function returns new buffers.

int8_dots (the opt-in int8 BMMs) is on no path of the port and raises.
The softmax scale is the caller's (default 1/√D, as the JAX kernel's), and
GQA takes any rep (the JAX kernel pads rep to a multiple of 8): above 8
query rows a kv head both designs run groups of 8 (grid z, as K11's), each
folding the new position in itself; only group 0 writes the row.  CUDA
source:
csrc/attn_fused.cu, two designs picked as K11's are (decode_attention.plan):
bf16 queries at D = 64 / 128 take the split-S cluster body
(csrc/split_decode.cuh: each rank's row range known from the scalar
position, the virtual row folded into every rank's slice of the outputs),
f32 queries and D = 256 the flash body (csrc/flash_decode.cuh's phases).
A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The split design counts its launches of all
three bodies under "fused_attn", the flash design under "fused_attn_flash"
(LAUNCH_KEYS).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.kernels.attn_smajor import _rot_half, quantize_rows_int8
from smoothquant_tpu_torch.kernels.decode_attention import (
    NEG_INF,
    _pick_tile_s,
    online_softmax_tiles,
    plan,
)
from smoothquant_tpu_torch.quant.core import fma_f32

# K12's launch counter of each design
LAUNCH_KEYS = {"split": "fused_attn", "flash": "fused_attn_flash"}


def fused_attn_supported(s: int, n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Shapes the JAX kernel tiles (attn_fused.py:287-290)."""
    return (_pick_tile_s(s) is not None and n_heads % n_kv == 0
            and head_dim % 64 == 0)


def _tables(cos, sin, b: int, d: int):
    """(B or 1, 1, D) rotary tables as (B, D) f32, one row per slot."""
    return (cos.float().reshape(-1, d).expand(b, d),
            sin.float().reshape(-1, d).expand(b, d))


def new_row_codes(k_new, v_new, cos, sin, *, rotary: bool = True):
    """The new position's int8 codes and scales ((B, H_kv, D), (B, H_kv))
    for k and for v: K10's rotary and quantize."""
    b, _, d = k_new.shape
    k = k_new.float()
    if rotary:
        c, s = _tables(cos, sin, b, d)
        k = fma_f32(k, c[:, None], _rot_half(k) * s[:, None])
    return quantize_rows_int8(k), quantize_rows_int8(v_new)


def fused_attn_plain(layer_idx: int, pos, q, k_new, v_new, cos, sin, k_q, v_q, k_scale,
                     v_scale, *, rotary: bool = True, flat: bool = False,
                     write_cache: bool = False,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch K12 (the wrapper's arguments): the old cache's tiles,
    then the new position folded in last; the write body writes the row in
    place.  Returns attention in q's dtype and shape."""
    _, b, n_kv, s, d = k_q.shape
    h = q.shape[-1] // d if flat else q.shape[1]
    (k8, ksc), (v8, vsc) = new_row_codes(k_new, v_new, cos, sin, rotary=rotary)
    qf = q.reshape(b, h, d).float()
    if flat and rotary:
        c, sn = _tables(cos, sin, b, d)
        qf = fma_f32(qf, c[:, None], _rot_half(qf) * sn[:, None]).to(q.dtype).float()
    qf = qf.reshape(b, n_kv, h // n_kv, d)
    p = int(torch.as_tensor(pos).reshape(()))
    bias = torch.where(torch.arange(s, device=q.device) < p, 0.0, NEG_INF)
    bias = bias.to(torch.float32)[None].expand(b, s)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    m, l_sum, acc = online_softmax_tiles(qf, k_q[layer_idx], v_q[layer_idx], bias,
                                         k_scale[layer_idx], v_scale[layer_idx],
                                         sm_scale=scale)
    s_v = torch.einsum("bgrd,bgd->bgr", qf, k8.float())[..., None]
    s_v = s_v * scale * ksc[..., None, None]
    m_safe = torch.clamp_min(torch.maximum(m, s_v), NEG_INF / 2)
    alpha = torch.exp(m - m_safe)
    p_v = torch.exp(s_v - m_safe)
    l_sum = l_sum * alpha + p_v
    pv = (p_v * vsc[..., None, None]).to(torch.bfloat16).float() * v8.float()[:, :, None]
    acc = acc * alpha + pv
    denom = torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    out = (acc / denom).reshape(q.shape).to(q.dtype)
    if write_cache:
        row = min(max(p, 0), s - 1)
        k_q[layer_idx][:, :, row] = k8
        v_q[layer_idx][:, :, row] = v8
        k_scale[layer_idx][:, :, row] = ksc
        v_scale[layer_idx][:, :, row] = vsc
    return out


def _fused_attn(layer_idx, pos, q, k_new, v_new, cos, sin, k_q, v_q, k_scale, v_scale, *,
                rotary, flat, write_cache, sm_scale, int8_dots, body, split):
    if int8_dots:
        raise NotImplementedError("K12's int8_dots mode is not ported")
    if q.device.type == "cpu":
        return fused_attn_plain(layer_idx, pos, q, k_new, v_new, cos, sin, k_q, v_q,
                                k_scale, v_scale, rotary=rotary, flat=flat,
                                write_cache=write_cache, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    if k_q.ndim != 5:
        raise ValueError(f"K12 takes a stacked (L, B, H_kv, S, D) cache, not {tuple(k_q.shape)}")
    _, b, n_kv, s, d = k_q.shape
    h = q.shape[-1] // d if flat else q.shape[1]
    want_q = (b, 1, h * d) if flat else (b, h, d)
    if (tuple(q.shape) != want_q or tuple(k_new.shape) != (b, n_kv, d) or h % n_kv
            or (flat and h != n_kv)):
        raise ValueError(f"K12 does not take q {tuple(q.shape)}, k {tuple(k_new.shape)} over "
                         f"cache {tuple(k_q.shape)} (the flat body MHA only)")
    chosen, c = plan("K12", q.dtype, b * n_kv, s, d, h // n_kv, body, split)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    ts = _pick_tile_s(s)
    for t, dt in ((k_q, torch.int8), (v_q, torch.int8),
                  (k_scale, torch.float32), (v_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError("K12 reads an int8 cache with f32 scales")
    if (v_q.shape != k_q.shape or k_scale.shape != k_q.shape[:4]
            or v_scale.shape != k_q.shape[:4]):
        raise ValueError("cache values (L, B, H, S, D) and scales (L, B, H, S)")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype or v_new.shape != k_new.shape:
        raise TypeError("q, k_new and v_new share one dtype and k / v one shape")
    pos32 = torch.as_tensor(pos, device=q.device)
    if pos32.numel() != 1:
        raise ValueError("K12 takes one aligned position")
    pos32 = pos32.to(torch.int32).reshape(1).contiguous()
    if cos is None:
        cos = sin = torch.zeros((1, 1, d), device=q.device)
    # (B or 1, D) rows, one row read by every slot (stride 0): no expanded copy
    cos, sin = (t.float().reshape(-1, d).contiguous() for t in (cos, sin))
    if cos.shape[0] not in (1, b) or sin.shape != cos.shape:
        raise ValueError(f"rotary tables of {cos.shape[0]} rows for {b} slots")
    tab_stride = 0 if cos.shape[0] == 1 else d
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    _build.check_operands(q.device, k_new=k_new, v_new=v_new, cos=cos, sin=sin, pos=pos32,
                          k_q=k_q, v_q=v_q, k_scale=k_scale, v_scale=v_scale)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            pos32.data_ptr(), k_q[layer_idx].data_ptr(), v_q[layer_idx].data_ptr(),
            k_scale[layer_idx].data_ptr(), v_scale[layer_idx].data_ptr(), out.data_ptr())
    if chosen == "split":
        _build.check(_build.lib().sq_fused_attn_split(
            *ptrs, b, h, n_kv, s, d, ts, c.bit_length() - 1, int(rotary), tab_stride, int(flat),
            int(write_cache), scale, _build.stream_ptr(q)), "sq_fused_attn_split")
    else:
        _build.check(_build.lib().sq_fused_attn(
            *ptrs, b, h, n_kv, s, d, ts, int(rotary), tab_stride, int(flat), int(write_cache),
            scale, _build.dt_code(q), _build.stream_ptr(q)), "sq_fused_attn")
    _build.LAUNCHES[LAUNCH_KEYS[chosen]] += 1
    return out


def fused_virtual_attn_flat(layer_idx: int, pos, q2d, k_new, v_new, cos, sin, k_q, v_q,
                            k_scale, v_scale, *, sm_scale: Optional[float] = None,
                            rotary: bool = True, int8_dots: bool = False,
                            body: Optional[str] = None,
                            split: Optional[int] = None) -> torch.Tensor:
    """(B, 1, H·D) attention of layer `layer_idx` from PRE-rotary flat q
    (MHA only) over the old cache and the new position; no cache write."""
    return _fused_attn(layer_idx, pos, q2d, k_new, v_new, cos, sin, k_q, v_q, k_scale,
                       v_scale, rotary=rotary, flat=True, write_cache=False,
                       sm_scale=sm_scale, int8_dots=int8_dots, body=body,
                       split=split)


def fused_virtual_attn_stacked(layer_idx: int, pos, q, k_new, v_new, cos, sin, k_q, v_q,
                               k_scale, v_scale, *, sm_scale: Optional[float] = None,
                               rotary: bool = True, int8_dots: bool = False,
                               body: Optional[str] = None,
                               split: Optional[int] = None) -> torch.Tensor:
    """(B, H, D) attention of layer `layer_idx` from rotated q over the old
    cache and the new position; no cache write (the caller runs K10 after)."""
    return _fused_attn(layer_idx, pos, q, k_new, v_new, cos, sin, k_q, v_q, k_scale,
                       v_scale, rotary=rotary, flat=False, write_cache=False,
                       sm_scale=sm_scale, int8_dots=int8_dots, body=body,
                       split=split)


def fused_rope_write_attn_stacked(layer_idx: int, pos, q, k_new, v_new, cos, sin, k_q, v_q,
                                  k_scale, v_scale, *, sm_scale: Optional[float] = None,
                                  rotary: bool = True, int8_dots: bool = False,
                                  body: Optional[str] = None,
                                  split: Optional[int] = None) -> torch.Tensor:
    """fused_virtual_attn_stacked that also writes the new row and its
    scale at pos, in place; returns the (B, H, D) attention."""
    return _fused_attn(layer_idx, pos, q, k_new, v_new, cos, sin, k_q, v_q, k_scale,
                       v_scale, rotary=rotary, flat=False, write_cache=True,
                       sm_scale=sm_scale, int8_dots=int8_dots, body=body,
                       split=split)

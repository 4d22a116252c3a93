"""The stacked head-major int8 KV cache writer: K10, with its plain PyTorch
version.

K10 write_quant_cache_stacked — port of smoothquant_tpu/kernels/
    cache_write.py:73 (pallas_call :114).  One decode position's k / v
    (B, H_kv, D) go into layer `layer_idx` of the (L, B, H_kv, S, D) int8
    cache and its (L, B, H_kv, S) f32 scales, at each slot's position (a
    scalar, or (B,) per slot) clamped to S − 1: rotary on k in f32 as jitted
    XLA fuses it, fma(x, cos, rot(x)·sin), then scale = max(absmax, 1e-8)/127
    (the reciprocal multiply) and codes round(x / scale) half to even.
    rotary=False (Bloom) skips the rotary and takes no tables (None).
    Unlike the JAX function (which returns new buffers through
    input_output_aliases) this one UPDATES THE CACHE TENSORS IN PLACE.
    rope_q_write_cache_stacked is the same write that also takes the
    pre-rotary queries and returns them rotated as apply_rotary rotates
    them, in the same launch.

CUDA source: csrc/cache_write.cu — the row body K2 shares (kv_write.py,
csrc/kv_quant.cuh: q, k and v read where the qkv linear left them, any
slot and head strides), and the first design as body="warps".  The
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.kernels.kv_write import (
    _check_tables,
    _ptr,
    _rot_half,
    _tables,
    launch_key,
    launch_rows,
    quantize_rows_int8,
    rotate_q_plain,
    write_body,
)
from smoothquant_tpu_torch.quant.core import fma_f32


def _rows(pos, b: int, s: int, device) -> torch.Tensor:
    """Each slot's write row: pos broadcast to (B,), clamped to [0, S-1]."""
    pos = torch.as_tensor(pos, device=device).reshape(-1).expand(b)
    return torch.clamp(pos.to(torch.int64), 0, s - 1)


def write_quant_cache_stacked_plain(layer_idx: int, pos, k_new, v_new, cos, sin,
                                    k_q, v_q, k_scale, v_scale, *,
                                    rotary: bool = True) -> None:
    """Plain PyTorch K10 (same arguments as the wrapper), in place."""
    _check_tables(cos, sin, rotary)
    b = k_new.shape[0]
    rows = _rows(pos, b, k_q.shape[3], k_new.device)
    bi = torch.arange(b, device=k_new.device)
    k = k_new.float()
    if rotary:
        k = fma_f32(k, cos.float(), _rot_half(k) * sin.float())
    for x, q_buf, s_buf in ((k, k_q, k_scale), (v_new, v_q, v_scale)):
        q, sc = quantize_rows_int8(x)                   # (B, H, D), (B, H)
        q_buf[layer_idx][bi, :, rows] = q
        s_buf[layer_idx][bi, :, rows] = sc


def rope_q_write_cache_stacked_plain(layer_idx: int, pos, q, k_new, v_new, cos, sin,
                                     k_q, v_q, k_scale, v_scale, *,
                                     rotary: bool = True) -> Optional[torch.Tensor]:
    """Plain PyTorch version of the fused entry: apply_rotary on q (when
    given), then K10's plain version on k / v as given."""
    q_rot = None if q is None else rotate_q_plain(q, cos, sin)
    write_quant_cache_stacked_plain(layer_idx, pos, k_new, v_new, cos, sin, k_q, v_q,
                                    k_scale, v_scale, rotary=rotary)
    return q_rot


def rope_q_write_cache_stacked(
    layer_idx: int,
    pos,                      # () or (B,) int tensor: each slot's write position
    q,                        # (B, H, D) PRE-rotary queries, or None
    k_new: torch.Tensor,      # (B, H_kv, D) PRE-rotary keys
    v_new: torch.Tensor,      # (B, H_kv, D)
    cos,                      # (B or 1, 1, D) f32 rotary tables at each slot's position;
    sin,                      #   None with rotary=False (the kernel reads no table)
    k_q: torch.Tensor,        # (L, B, H_kv, S, D) int8, updated in place
    v_q: torch.Tensor,
    k_scale: torch.Tensor,    # (L, B, H_kv, S) f32, updated in place
    v_scale: torch.Tensor,
    *,
    rotary: bool = True,
    body: Optional[str] = None,
) -> Optional[torch.Tensor]:
    """Write one decode row per slot of layer `layer_idx`, in place, and
    return q rotated as apply_rotary rotates it ((B, H, D), q's dtype; None
    without q).  q, k_new and v_new may be strided views into the qkv rows
    (unit stride along D).  `body` overrides the shape rule for
    measurements (kv_write.write_body)."""
    if k_new.device.type == "cpu":
        return rope_q_write_cache_stacked_plain(layer_idx, pos, q, k_new, v_new, cos, sin,
                                                k_q, v_q, k_scale, v_scale, rotary=rotary)
    if k_new.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {k_new.device}")
    b, h, d = k_new.shape
    if k_q.ndim != 5 or k_q.shape[1:3] != (b, h) or k_q.shape[4] != d or d > 256 or d % 2:
        raise ValueError(f"cache {tuple(k_q.shape)} does not fit k {tuple(k_new.shape)}")
    for t, dt in ((k_q, torch.int8), (v_q, torch.int8),
                  (k_scale, torch.float32), (v_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError("head-major int8 cache: int8 values and f32 scales")
    if v_q.shape != k_q.shape or k_scale.shape != k_q.shape[:4] or v_scale.shape != k_q.shape[:4]:
        raise ValueError("cache values (L, B, H, S, D) and scales (L, B, H, S)")
    if v_new.dtype != k_new.dtype or v_new.shape != k_new.shape:
        raise TypeError("k_new and v_new must share a dtype and shape")
    if write_body(d, True, body, q) != "warps":
        q_out, chosen = launch_rows(False, layer_idx, pos, q, k_new, v_new, cos, sin, k_q,
                                    v_q, k_scale, v_scale, rotary=rotary, body=body)
        _build.LAUNCHES[launch_key("write_quant_cache_stacked", chosen)] += 1
        return q_out
    s = k_q.shape[3]
    pos32 = torch.as_tensor(pos, device=k_new.device).to(torch.int32).reshape(-1)
    pos32 = pos32.expand(b).contiguous()
    cos, sin = _tables(cos, sin, b, d, rotary)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    _build.check_operands(k_new.device, pos=pos32, cos=cos, sin=sin, v_new=v_new,
                          k_q=k_q, v_q=v_q, k_scale=k_scale, v_scale=v_scale)
    _build.check(_build.lib().sq_write_cache_hm(
        k_new.data_ptr(), v_new.data_ptr(), _ptr(cos), _ptr(sin),
        pos32.data_ptr(), k_q[layer_idx].data_ptr(), v_q[layer_idx].data_ptr(),
        k_scale[layer_idx].data_ptr(), v_scale[layer_idx].data_ptr(), b, s, h, d,
        int(rotary), _build.dt_code(k_new), _build.stream_ptr(k_new)),
        "sq_write_cache_hm")
    _build.LAUNCHES[launch_key("write_quant_cache_stacked", "warps")] += 1
    return None


def write_quant_cache_stacked(layer_idx: int, pos, k_new, v_new, cos, sin, k_q, v_q,
                              k_scale, v_scale, *, rotary: bool = True,
                              body: Optional[str] = None) -> None:
    """K10 with the JAX signature: write one decode row per slot of layer
    `layer_idx`, in place (rope_q_write_cache_stacked without q)."""
    rope_q_write_cache_stacked(layer_idx, pos, None, k_new, v_new, cos, sin, k_q, v_q,
                               k_scale, v_scale, rotary=rotary, body=body)

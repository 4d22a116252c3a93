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

CUDA source: csrc/cache_write.cu (its math shared with K2 through
csrc/kv_quant.cuh).  The wrapper runs the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.kernels.attn_smajor import (
    _check_tables,
    _ptr,
    _rot_half,
    _tables,
    quantize_rows_int8,
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


def write_quant_cache_stacked(
    layer_idx: int,
    pos,                      # () or (B,) int tensor: each slot's write position
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
) -> None:
    """Write one decode row per slot of layer `layer_idx`, in place."""
    if k_new.device.type == "cpu":
        write_quant_cache_stacked_plain(layer_idx, pos, k_new, v_new, cos, sin, k_q,
                                        v_q, k_scale, v_scale, rotary=rotary)
        return
    if k_new.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {k_new.device}")
    b, h, d = k_new.shape
    if k_q.ndim != 5 or k_q.shape[1:3] != (b, h) or k_q.shape[4] != d or d > 256 or d % 2:
        raise ValueError(f"cache {tuple(k_q.shape)} does not fit k {tuple(k_new.shape)}")
    s = k_q.shape[3]
    for t, dt in ((k_q, torch.int8), (v_q, torch.int8),
                  (k_scale, torch.float32), (v_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError("head-major int8 cache: int8 values and f32 scales")
    if v_q.shape != k_q.shape or k_scale.shape != k_q.shape[:4] or v_scale.shape != k_q.shape[:4]:
        raise ValueError("cache values (L, B, H, S, D) and scales (L, B, H, S)")
    if v_new.dtype != k_new.dtype or v_new.shape != k_new.shape:
        raise TypeError("k_new and v_new must share a dtype and shape")
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
    _build.LAUNCHES["write_quant_cache_stacked"] += 1

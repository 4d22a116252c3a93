"""The host side K2 (attn_smajor.write_quant_cache_smajor) and K10
(cache_write.write_quant_cache_stacked) share: the row body's shape rule and
launch, and the plain PyTorch pieces of both plain versions (the rotary, the
per-row int8 quantize).

The row body (csrc/kv_quant.cuh kv_rows_kernel) writes one decode
position's k / v rows of B slots into one layer of an int8 cache, S-major
or head-major, and, when the caller hands it the queries, rotates them in
the same launch.  It reads q, k and v where the qkv linear left them: each
part is a (B, heads, D) view with unit stride along D and any slot and head
strides (Llama's fused qkv row, Bloom's interleaved (nh, 3, D) rows), so no
copy comes first; the position from layer i's row of the (L, B) or (L,)
int32 positions and the tables from (B or 1, 1, D) f32 rows, a shared row
with stride 0.

Bodies, picked by `write_body`:
  "rows"    the row body with 16-byte loads and stores: D in ROW_DIMS and
            every part's start, slot stride and head stride, and the
            tables', 16-byte aligned (the cache layer 8-byte aligned);
  "scalar"  the same body with scalar loads and stores, for D in ROW_DIMS
            when some part is not aligned so;
  "warps"   the first design (one warp a head; k / v copied contiguous and
            the tables expanded to (B, D) first): any other even D <= 256,
            and forced for measurements.  It rotates no q.
Each body counts its launches under its own key (`launch_key`): the
writer's name for "rows", with "_scalar" or "_warps" appended for the
others.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import f32_reciprocal, fma_f32

ROW_DIMS = (16, 32, 64, 128, 256)   # D = 8 values a lane × a power of two lanes <= 32
BODIES = ("rows", "scalar", "warps")
# threads a block of the row body: a slot's (Hq + 2·H_kv)·D/8 lanes over
# ceil(lanes / ROW_THREADS) blocks — 12 a slot for Llama-2-7B's q, k and v.
# chip_smoke's writer rows time 64-1024 through launch_rows (threads_ms); 128
# was the fastest or within 0.2 µs of it at B = 4, 32 and 64 and Bloom's
# B = 4 and 64 (NVIDIA H100 80GB HBM3, 700 W); one block a slot cannot hold
# 7B's 1536 lanes
ROW_THREADS = 128


def quantize_rows_int8(x: torch.Tensor):
    """Symmetric int8 over the last axis: (q int8, scale f32 (...,)) with
    scale = max(absmax, 1e-8)/127 (models/common.py QuantKVCache._quantize;
    the constant division as XLA compiles it, see quant/core.py)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) * f32_reciprocal(127.0)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B or 1, S, D) (common.py:271-278)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    if x.dtype == torch.float32:
        # jitted XLA fuses the f32 form into fma(x, cos, rotated·sin)
        return fma_f32(x, cos, rotated * sin)
    return x * cos + rotated * sin


def rotate_q_plain(q: torch.Tensor, cos, sin) -> torch.Tensor:
    """The writers' plain q rotary: apply_rotary on (B, H, D) queries with
    (B or 1, 1, D) tables, in q's dtype."""
    d = q.shape[-1]
    return apply_rotary(q[:, None], cos.reshape(-1, 1, d), sin.reshape(-1, 1, d))[:, 0]


def _check_tables(cos, sin, rotary: bool) -> None:
    if rotary and (cos is None or sin is None):
        raise ValueError("rotary=True needs the cos and sin tables")


def _tables(cos, sin, b: int, d: int, rotary: bool):
    """The "warps" body's (B, D) f32 rotary tables — one row per slot, an
    aligned decode's one row broadcast — or (None, None) with rotary off."""
    _check_tables(cos, sin, rotary)
    if not rotary:
        return None, None
    return tuple(t.float().reshape(-1, d).expand(b, d).contiguous() for t in (cos, sin))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def launch_key(writer: str, body: str) -> str:
    return writer if body == "rows" else f"{writer}_{body}"


def write_body(d: int, aligned: bool, body: Optional[str] = None, q=None) -> str:
    """The body a call takes (module docstring); a forced body raises on a
    call it does not take."""
    if body is None:
        body = ("rows" if aligned else "scalar") if d in ROW_DIMS else "warps"
    elif body not in BODIES:
        raise ValueError(f"body {body!r}: one of {BODIES}")
    if body != "warps" and d not in ROW_DIMS:
        raise ValueError(f"the row body takes head_dim in {ROW_DIMS}, not {d}")
    if body == "rows" and not aligned:
        raise ValueError("the row body's 16-byte form takes 16-byte aligned rows")
    if body == "warps" and q is not None:
        raise ValueError(f"the warps body rotates no q (head_dim {d}: the row body takes "
                         f"{ROW_DIMS})")
    return body


def _part(t: torch.Tensor, name: str, b: int, d: int) -> torch.Tensor:
    """A (B, heads, D) part as the row body reads it: unit stride along D
    (a view with another D stride is copied first)."""
    if t.ndim != 3 or t.shape[0] != b or t.shape[2] != d:
        raise ValueError(f"{name} {tuple(t.shape)} is not (B={b}, heads, D={d})")
    return t if t.stride(2) == 1 else t.contiguous()


def _table(t: torch.Tensor, b: int, d: int) -> torch.Tensor:
    t = t.reshape(-1, d)
    if t.shape[0] not in (1, b):
        raise ValueError(f"rotary table rows {t.shape[0]}: 1 or B = {b}")
    if t.dtype != torch.float32:
        t = t.float()
    return t if t.stride(1) == 1 else t.contiguous()


def _aligned16(t: torch.Tensor, *strides: int) -> bool:
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * e % 16 == 0 for s in strides)


def _positions(pos, b: int, device) -> tuple[torch.Tensor, int]:
    """pos as the body reads it: an int32 tensor of 1 or B values and the
    stride between slots (0 for one shared position)."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    pos = pos.reshape(-1)
    if pos.numel() == 1:
        return pos, 0
    if pos.numel() != b:
        raise ValueError(f"{pos.numel()} positions for {b} slots")
    return pos, pos.stride(0)


def launch_rows(smajor: bool, layer_idx: int, pos, q, k_new, v_new, cos, sin,
                k_buf, v_buf, k_scale, v_scale, *, rotary: bool, body: Optional[str],
                threads: int = ROW_THREADS):
    """One launch of the row body on CUDA tensors (the wrappers have checked
    the cache): returns (the rotated q (B, H, D) in q's dtype or None, the
    body taken).  `threads`, the block size, is ROW_THREADS on every path;
    chip_smoke's writer rows time other sizes through it."""
    b, n_kv, d = k_new.shape
    if q is not None and not rotary:
        raise ValueError("q is rotated only with rotary=True")
    if v_new.dtype != k_new.dtype or (q is not None and q.dtype != k_new.dtype):
        raise TypeError("q, k_new and v_new must share a dtype")
    if tuple(v_new.shape) != (b, n_kv, d):
        raise ValueError(f"v_new {tuple(v_new.shape)} != k_new {tuple(k_new.shape)}")
    parts = [_part(t, n, b, d) for t, n in ((k_new, "k_new"), (v_new, "v_new"))]
    if q is not None:
        parts.append(_part(q, "q", b, d))
    k_new, v_new = parts[:2]
    q = parts[2] if q is not None else None
    _check_tables(cos, sin, rotary)
    tabs = (_table(cos, b, d), _table(sin, b, d)) if rotary else (None, None)
    if rotary and (tabs[0].shape != tabs[1].shape or tabs[0].stride() != tabs[1].stride()):
        raise ValueError("cos and sin must share a shape and a layout")
    t_sb = 0 if not rotary or tabs[0].shape[0] == 1 else tabs[0].stride(0)
    pos, pos_sb = _positions(pos, b, k_new.device)
    dev = k_new.device
    for name, t in (("q", q), ("cos", tabs[0]), ("sin", tabs[1]), ("pos", pos),
                    ("v_new", v_new), ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the kernel runs on {dev}")
    _build.check_operands(dev, k_buf=k_buf, v_buf=v_buf, k_scale=k_scale, v_scale=v_scale)
    hq = 0 if q is None else q.shape[1]
    q_out = None if q is None else torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    kl, vl = k_buf[layer_idx], v_buf[layer_idx]
    aligned = (all(_aligned16(t, t.stride(0), t.stride(1))
                   for t in (p for p in (q, k_new, v_new) if p is not None))
               and (not rotary or all(_aligned16(t, t_sb) for t in tabs))
               and kl.data_ptr() % 8 == 0 and vl.data_ptr() % 8 == 0)
    chosen = write_body(d, aligned, body, q)
    s = k_buf.shape[2] if smajor else k_buf.shape[3]
    zero = (0, 0)
    q_st = zero if q is None else (q.stride(0), q.stride(1))
    entry = _build.lib().sq_kv_rows_smajor if smajor else _build.lib().sq_kv_rows_hm
    _build.check(entry(
        _ptr(q), k_new.data_ptr(), v_new.data_ptr(), _ptr(tabs[0]), _ptr(tabs[1]),
        pos.data_ptr(), _ptr(q_out), kl.data_ptr(), vl.data_ptr(),
        k_scale[layer_idx].data_ptr(), v_scale[layer_idx].data_ptr(),
        *q_st, k_new.stride(0), k_new.stride(1), v_new.stride(0), v_new.stride(1),
        t_sb, pos_sb, b, s, hq, n_kv, d, int(rotary), int(chosen == "rows"),
        threads, _build.dt_code(k_new), _build.stream_ptr(k_new)),
        "sq_kv_rows_smajor" if smajor else "sq_kv_rows_hm")
    return q_out, chosen

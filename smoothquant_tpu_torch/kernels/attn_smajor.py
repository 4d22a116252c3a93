"""S-major int8 KV cache: the decode cache writer (K2) and single-query
decode attention (K3), each with its plain PyTorch version.

K2  write_quant_cache_smajor — port of smoothquant_tpu/kernels/
    attn_smajor.py:305 (pallas_call :340).  Rotary on k (lane-half rotate,
    f32), per-(b, head) int8 quantize max(absmax, 1e-8)/127 with round
    half to even, and a row write at each slot's position clamped to S−1.
    Unlike the JAX function (which returns new buffers through
    input_output_aliases) this one UPDATES THE CACHE TENSORS IN PLACE.
    rope_q_write_cache_smajor is the same write that also takes the
    pre-rotary queries and returns them rotated as apply_rotary rotates
    them, in the same launch: the stacked decode hands it q, k and v as
    views into the qkv rows.  Both run on the row body K10 shares
    (kv_write.py, csrc/kv_quant.cuh); the first design stays as
    body="warps".
K3 decode_attention_smajor_stacked — port of :169 (pallas_call :213).
    scores = q·k·sm_scale·k_scale + bias (sm_scale default 1/√D, as the
    JAX kernel's), the TPU kernel's online softmax over tiles of
    _pick_tile_s(S) positions (p against the running max of its tile),
    p·v_scale rounded to bf16 there, PV, GQA at any rep (above 8 query rows
    a kv head the bodies run groups of 8, as K11's); a fully masked row
    outputs 0.  Two bodies, picked as K11's are (decode_attention.plan):
    bf16 queries at D = 64 / 128 take the split-S cluster body
    (csrc/split_decode.cuh, its rows by 2-D TMA boxes), f32 queries and
    D = 256 the flash body (csrc/flash_decode.cuh); each counts its
    launches under its own key (LAUNCH_KEYS).

Layout (as the JAX package): values (L, B, S, H_kv·D) int8, scales
(L, B, H_kv, S) f32.  CUDA source: csrc/attn_smajor.cu.  A wrapper runs
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.kernels.decode_attention import (
    _pick_tile_s,
    online_softmax_tiles,
    plan,
)
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

NEG_INF = -1e30
# K3's launch counter of each body
LAUNCH_KEYS = {"split": "decode_attention_smajor_stacked",
               "flash": "decode_attention_smajor_stacked_flash"}


def _check_cache(device, k_sm, v_sm, k_scale, v_scale):
    for t, dt in ((k_sm, torch.int8), (v_sm, torch.int8),
                  (k_scale, torch.float32), (v_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError("S-major cache: int8 values and f32 scales")
    _build.check_operands(device, k_sm=k_sm, v_sm=v_sm, k_scale=k_scale,
                          v_scale=v_scale)


# ---------------------------------------------------------------- K2


def write_quant_cache_smajor_plain(layer_idx: int, pos, k_new, v_new, cos, sin,
                                   k_sm, v_sm, k_scale, v_scale, *,
                                   rotary: bool = True) -> None:
    """Plain PyTorch K2 (same arguments as the wrapper), in place."""
    _check_tables(cos, sin, rotary)
    b, h, d = k_new.shape
    s = k_sm.shape[2]
    rows = torch.clamp(torch.as_tensor(pos, device=k_new.device).to(torch.int64), 0, s - 1)
    bi = torch.arange(b, device=k_new.device)
    k = k_new.float()
    if rotary:
        k = k * cos.float() + _rot_half(k) * sin.float()
    for x, q_buf, s_buf in ((k, k_sm, k_scale), (v_new, v_sm, v_scale)):
        q, sc = quantize_rows_int8(x)
        q_buf[layer_idx][bi, rows] = q.reshape(b, h * d)
        s_buf[layer_idx][bi, :, rows] = sc


def rope_q_write_cache_smajor_plain(layer_idx: int, pos, q, k_new, v_new, cos, sin,
                                    k_sm, v_sm, k_scale, v_scale, *,
                                    rotary: bool = True) -> Optional[torch.Tensor]:
    """Plain PyTorch version of the fused entry: apply_rotary on q (when
    given), then K2's plain version on k / v as given."""
    q_rot = None if q is None else rotate_q_plain(q, cos, sin)
    write_quant_cache_smajor_plain(layer_idx, pos, k_new, v_new, cos, sin, k_sm, v_sm,
                                   k_scale, v_scale, rotary=rotary)
    return q_rot


def rope_q_write_cache_smajor(
    layer_idx: int,
    pos,                      # () or (B,) int: each slot's write position
    q,                        # (B, H, D) PRE-rotary queries, or None
    k_new: torch.Tensor,      # (B, H_kv, D) PRE-rotary keys
    v_new: torch.Tensor,      # (B, H_kv, D)
    cos,                      # (B or 1, 1, D) f32; None with rotary=False
    sin,
    k_sm: torch.Tensor,       # (L, B, S, H_kv·D) int8, updated in place
    v_sm: torch.Tensor,
    k_scale: torch.Tensor,    # (L, B, H_kv, S) f32, updated in place
    v_scale: torch.Tensor,
    *,
    rotary: bool = True,
    body: Optional[str] = None,
) -> Optional[torch.Tensor]:
    """Write one decode row per slot of layer `layer_idx`, in place, and
    return q rotated as apply_rotary rotates it ((B, H, D), q's dtype; None
    without q).  q, k_new and v_new may be strided views into the qkv rows
    (unit stride along D): the row body reads them where they lie.  `body`
    ("rows" / "scalar" / "warps") overrides the shape rule for
    measurements (kv_write.write_body)."""
    if k_new.device.type == "cpu":
        return rope_q_write_cache_smajor_plain(layer_idx, pos, q, k_new, v_new, cos, sin,
                                               k_sm, v_sm, k_scale, v_scale, rotary=rotary)
    if k_new.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {k_new.device}")
    b, h, d = k_new.shape
    l_num, b2, s, hd = k_sm.shape
    if b2 != b or hd != h * d or d > 256 or d % 2:
        raise ValueError(f"cache {tuple(k_sm.shape)} does not fit k {tuple(k_new.shape)}")
    if (k_scale.shape != (l_num, b, h, s) or v_sm.shape != k_sm.shape
            or v_scale.shape != k_scale.shape):
        raise ValueError("S-major cache values (L, B, S, H·D) and scales (L, B, H, S)")
    _check_cache(k_new.device, k_sm, v_sm, k_scale, v_scale)
    if write_body(d, True, body, q) != "warps":
        q_out, chosen = launch_rows(True, layer_idx, pos, q, k_new, v_new, cos, sin, k_sm,
                                    v_sm, k_scale, v_scale, rotary=rotary, body=body)
        _build.LAUNCHES[launch_key("write_quant_cache_smajor", chosen)] += 1
        return q_out
    if v_new.dtype != k_new.dtype:
        raise TypeError("k_new and v_new must share a dtype")
    pos32 = torch.as_tensor(pos, device=k_new.device).to(torch.int32).reshape(-1)
    pos32 = pos32.expand(b).contiguous()
    cos, sin = _tables(cos, sin, b, d, rotary)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    _build.check_operands(k_new.device, pos=pos32, cos=cos, sin=sin, v_new=v_new)
    _build.check(_build.lib().sq_write_cache_smajor(
        k_new.data_ptr(), v_new.data_ptr(), _ptr(cos), _ptr(sin),
        pos32.data_ptr(), k_sm[layer_idx].data_ptr(),
        v_sm[layer_idx].data_ptr(), k_scale[layer_idx].data_ptr(),
        v_scale[layer_idx].data_ptr(), b, s, h, d, int(rotary),
        _build.dt_code(k_new), _build.stream_ptr(k_new)),
        "sq_write_cache_smajor")
    _build.LAUNCHES[launch_key("write_quant_cache_smajor", "warps")] += 1
    return None


def write_quant_cache_smajor(layer_idx: int, pos, k_new, v_new, cos, sin, k_sm, v_sm,
                             k_scale, v_scale, *, rotary: bool = True,
                             body: Optional[str] = None) -> None:
    """K2 with the JAX signature: write one decode row per slot of layer
    `layer_idx`, in place (rope_q_write_cache_smajor without q)."""
    rope_q_write_cache_smajor(layer_idx, pos, None, k_new, v_new, cos, sin, k_sm, v_sm,
                              k_scale, v_scale, rotary=rotary, body=body)


# ---------------------------------------------------------------- K3


def decode_attention_smajor_plain(layer_idx: int, q, k_sm, v_sm, bias,
                                  k_scale, v_scale, sm_scale=None):
    """Plain PyTorch K3 (same arguments as the wrapper): the TPU kernel's
    online softmax over tiles of _pick_tile_s(S) positions, on the S-major
    layer viewed head-major ((B, S, H_kv, D) → (B, H_kv, S, D))."""
    b, h, d = q.shape
    s, hd = k_sm.shape[2], k_sm.shape[3]
    n_kv = hd // d
    head_major = lambda t: t[layer_idx].reshape(b, s, n_kv, d).transpose(1, 2)
    qf = q.float().reshape(b, n_kv, h // n_kv, d)
    _, l_sum, acc = online_softmax_tiles(qf, head_major(k_sm), head_major(v_sm), bias,
                                         k_scale[layer_idx], v_scale[layer_idx],
                                         sm_scale=sm_scale)
    denom = torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    return (acc / denom).reshape(b, h, d).to(q.dtype)


def decode_attention_smajor_stacked(
    layer_idx: int,
    q: torch.Tensor,          # (B, H, D) post-rotary queries
    k_sm: torch.Tensor,       # (L, B, S, H_kv·D) int8
    v_sm: torch.Tensor,
    bias: torch.Tensor,       # (B, S) f32 additive mask
    k_scale: torch.Tensor,    # (L, B, H_kv, S) f32
    v_scale: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    body: Optional[str] = None,
    split: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, D) attention of layer `layer_idx` over the S-major cache;
    sm_scale the score scale (default 1/√D).  `body` ("split" / "flash")
    and `split` (the split body's ranks, over B·H_kv·rep_groups clusters)
    override the shape rules for measurements; a forced body or split
    raises on a shape it does not take."""
    if q.device.type == "cpu":
        return decode_attention_smajor_plain(layer_idx, q, k_sm, v_sm, bias,
                                             k_scale, v_scale, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    b, h, d = q.shape
    _, b2, s, hd = k_sm.shape
    n_kv = hd // d
    if b2 != b or hd % d or h % n_kv or v_sm.shape != k_sm.shape:
        raise ValueError(f"K3 does not take q {tuple(q.shape)} over cache {tuple(k_sm.shape)}")
    chosen, c = plan("K3", q.dtype, b * n_kv, s, d, h // n_kv, body, split)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    _check_cache(q.device, k_sm, v_sm, k_scale, v_scale)
    q = q.contiguous()
    bias = bias.float().contiguous()
    if bias.shape != (b, s):
        raise ValueError(f"bias {tuple(bias.shape)} != {(b, s)}")
    _build.check_operands(q.device, bias=bias)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_sm[layer_idx].data_ptr(), v_sm[layer_idx].data_ptr(),
            k_scale[layer_idx].data_ptr(), v_scale[layer_idx].data_ptr(),
            bias.data_ptr(), out.data_ptr())
    ts = _pick_tile_s(s)
    if chosen == "split":
        _build.check(_build.lib().sq_decode_attn_smajor_split(
            *ptrs, b, h, n_kv, s, d, ts, c.bit_length() - 1, scale,
            _build.stream_ptr(q)), "sq_decode_attn_smajor_split")
    else:
        _build.check(_build.lib().sq_decode_attn_smajor(
            *ptrs, b, h, n_kv, s, d, ts, scale, _build.dt_code(q),
            _build.stream_ptr(q)), "sq_decode_attn_smajor")
    _build.LAUNCHES[LAUNCH_KEYS[chosen]] += 1
    return out

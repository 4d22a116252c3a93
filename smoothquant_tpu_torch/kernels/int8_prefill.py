"""Prefill int8 matmul with the scale epilogue and salient dot fused (K4),
with its plain PyTorch version.

K4  int8_prefill_matmul — port of smoothquant_tpu/kernels/int8_prefill.py:175
    (pallas_call :282), pre-quantized mode:
        out[n, o] = s_x[n]·s_w[o]·Σ_k x8[n, k]·w8[k, o] + Σ_s x_sal[n, s]·w_sal[s, o]
    with the int32 sum exact, the salient dot summed in f32 and the
    epilogue fma((acc·s_x), s_w, salient) in f32, as XLA fuses it.
    Operands: x8 (N, K) int8, s_x (N, 1) f32, w8 (K, O) int8, s_w (1, O)
    f32, x_sal (N, k_s) and w_sal (k_s, O) bf16 / f32, out bf16 / f32.
    The raw-x mode (ns_mask (1, K) given, :44-57): x arrives raw, bf16 /
    f32 in x_sal's dtype, and the kernel quantizes it itself, x8 =
    round((x·mask) / s_x) (the per-token s_x computed outside, as in JAX):
    the same bytes as quantize_raw_x gives the pre-quantized mode, so the
    output is the same bit for bit.  On the card it always quantizes in
    the kernel (the JAX wrapper falls back to the XLA prologue when no TPU
    tile keeps the slab resident, :205-213; this port has no such case).
    Nothing on the port's paths calls it, as in JAX.

The weight is read K-major: the wrapper takes the (K, O) weight the JAX
package's signature names, but its storage must be (O, K) — `k_major(w)`
makes such a tensor (kernels/pack.py); the port's identity-int8 packs
hold their weights so.
Two bodies, picked by prefill_body: pre-quantized codes with bf16 salient
operands or none (every promoted Llama site and the lm_head) take the
warp-specialized s8 wgmma body (csrc/int8_wg.cu + wg_s8_gemm.cuh, rules in
wg_s8.py); f32 salient operands and the raw-x mode keep the mma.sync
tiles (csrc/int8_prefill.cu), counted under keys of their own
(LAUNCH_KEYS).  A wrapper runs the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build, wg_s8
from smoothquant_tpu_torch.quant.core import fma_f32

INT_MM_MIN_ROWS = 32   # torch._int_mm's CUDA path refuses M <= 16 rows
# the launch counter of each body: the wgmma body's under the kernel's name,
# the mma.sync tiles' apart (the raw-x mode always runs the tiles)
LAUNCH_KEYS = {"wg": "int8_prefill_matmul", "tiles": "int8_prefill_matmul_tiles",
               "raw_x": "int8_prefill_matmul_rawx"}


def prefill_body(raw_x: bool, k_s: int, sal_dtype) -> str:
    """K4's body: "wg" (the s8 wgmma body) for pre-quantized codes with
    bf16 salient operands or none, else "tiles" (f32 salient operands, the
    raw-x mode)."""
    return "wg" if _takes("wg", raw_x, k_s, sal_dtype) else "tiles"


def _takes(body: str, raw_x: bool, k_s: int, sal_dtype) -> bool:
    if body == "wg":
        return not raw_x and (k_s == 0 or sal_dtype == torch.bfloat16)
    return body == "tiles"


def int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 → int32 product (torch._int_mm, rows padded to its
    minimum)."""
    n = x_q.shape[0]
    if n < INT_MM_MIN_ROWS:
        x_q = torch.nn.functional.pad(x_q, (0, 0, 0, INT_MM_MIN_ROWS - n))
    return torch._int_mm(x_q, w_q)[:n]


def scale_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw_t: torch.Tensor,
                   sal: torch.Tensor = None) -> torch.Tensor:
    """acc·s_x·s_w (+ sal) in f32: (acc·s_x)·s_w, fused with the salient
    add into one multiply-add as XLA compiles the JAX epilogue
    (int8_prefill.py:66-74, real_linear.py:118-124)."""
    y = acc.float() * sx.float()
    if sal is None:
        return y * sw_t.float()
    return fma_f32(y, sw_t.float(), sal.float())


def quantize_raw_x(x: torch.Tensor, ns_mask: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """The raw-x prologue: round((x·mask) / s_x), half to even, as int8 —
    the f32 chain of the XLA prologue (int8_prefill.py:54-56)."""
    return torch.round(x.float() * ns_mask.float() / sx.float()).to(torch.int8)


def int8_prefill_matmul_plain(x_q, sx, w_qt, sw_t, x_sal, w_sal_t, ns_mask=None, *,
                              out_dtype=torch.bfloat16):
    """Plain PyTorch K4 (same arguments as the wrapper)."""
    if ns_mask is not None:
        x_q = quantize_raw_x(x_q, ns_mask, sx)
    sal = x_sal.float() @ w_sal_t.float() if x_sal.shape[1] else None
    return scale_epilogue(int_mm(x_q, w_qt), sx, sw_t, sal).to(out_dtype)


def _pad_last(t: torch.Tensor, m: int) -> torch.Tensor:
    pad = -t.shape[-1] % m
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def int8_prefill_matmul(
    x_q: torch.Tensor,        # (N, K) int8 quantized activations — or, with
    #                           ns_mask, the RAW activations in x_sal's dtype
    sx: torch.Tensor,         # (N, 1) f32 per-token scales
    w_qt: torch.Tensor,       # (K, O) int8 per-column quantized weight
    sw_t: torch.Tensor,       # (1, O) f32 per-column scales
    x_sal: torch.Tensor,      # (N, K_s) salient activations (bf16 / f32)
    w_sal_t: torch.Tensor,    # (K_s, O) salient weight columns, x_sal's dtype
    ns_mask: Optional[torch.Tensor] = None,   # (1, K) 0/1: the raw-x mode
    *,
    out_dtype=torch.bfloat16,
    body: Optional[str] = None,
) -> torch.Tensor:
    """(N, O) prefill int8 matmul with the fused epilogue.  `body` ("wg" /
    "tiles") overrides prefill_body for measurements; a forced body raises
    on a call it does not take."""
    if (ns_mask is not None) != x_q.dtype.is_floating_point:
        raise TypeError("K4 takes int8 codes, or raw fp activations with an ns_mask "
                        f"(got {x_q.dtype}, ns_mask {'given' if ns_mask is not None else 'none'})")
    if ns_mask is not None and tuple(ns_mask.shape) != (1, x_q.shape[1]):
        raise ValueError(f"ns_mask {tuple(ns_mask.shape)} != (1, {x_q.shape[1]})")
    if x_q.device.type == "cpu":
        return int8_prefill_matmul_plain(x_q, sx, w_qt, sw_t, x_sal, w_sal_t, ns_mask,
                                         out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_q.device}")
    n, kk = x_q.shape
    o = w_qt.shape[1]
    k_s = x_sal.shape[1]
    raw_x = ns_mask is not None
    x_dt_ok = x_q.dtype == x_sal.dtype if raw_x else x_q.dtype == torch.int8
    if (not x_dt_ok or w_qt.dtype != torch.int8 or w_qt.shape[0] != kk
            or sx.shape != (n, 1) or sw_t.shape != (1, o) or w_sal_t.shape != (k_s, o)
            or x_sal.shape[0] != n):
        raise TypeError("K4 operand shapes or dtypes do not match (raw x comes in "
                        "x_sal's dtype)")
    if x_sal.dtype != w_sal_t.dtype:
        raise TypeError("x_sal and w_sal_t must share a dtype")
    if not w_qt.t().is_contiguous():
        raise ValueError("K4 reads the weight K-major: pass k_major(w_qt)")
    w_ok = w_qt.t()                                   # (O, K) storage
    x_q = x_q.contiguous()
    sx = sx.float().reshape(n).contiguous()
    sw = sw_t.float().reshape(o).contiguous()
    x_sal, w_sal_t = x_sal.contiguous(), w_sal_t.contiguous()
    mask = ns_mask.float().reshape(kk).contiguous() if raw_x else None
    # the kernel takes K and K_s in 16s and O in 8s; other shapes pad with
    # zeros (zero rows and columns add nothing; padded columns are cut)
    if kk % 16:
        x_q, w_ok = _pad_last(x_q, 16), _pad_last(w_ok, 16)
        mask = None if mask is None else _pad_last(mask, 16)
    if k_s % 16:
        x_sal = _pad_last(x_sal, 16)
        w_sal_t = _pad_last(w_sal_t.t(), 16).t().contiguous()
    o_pad = -(-o // 8) * 8
    if o_pad != o:
        w_ok = torch.nn.functional.pad(w_ok, (0, 0, 0, o_pad - o))
        sw = torch.nn.functional.pad(sw, (0, o_pad - o))
        w_sal_t = _pad_last(w_sal_t, 8)
    chosen = prefill_body(raw_x, k_s, x_sal.dtype) if body is None else body
    if not _takes(chosen, raw_x, k_s, x_sal.dtype):
        raise ValueError(f"K4's {chosen!r} body does not take this call (raw x: {raw_x}, "
                         f"k_s {k_s} in {x_sal.dtype})")
    _build.check_operands(x_q.device, sx=sx, w_ok=w_ok, sw=sw, x_sal=x_sal,
                          w_sal_t=w_sal_t, mask=mask)
    out = torch.empty((n, o_pad), dtype=out_dtype, device=x_q.device)
    if chosen == "wg":
        # TMA reads every operand from a 16-byte-aligned base
        x_q, w_ok, x_sal, w_sal_t = (_build.aligned(t) for t in (x_q, w_ok, x_sal, w_sal_t))
        _build.check(_build.lib().sq_int8_prefill_wg(
            x_q.data_ptr(), sx.data_ptr(), w_ok.data_ptr(), sw.data_ptr(), x_sal.data_ptr(),
            w_sal_t.data_ptr(), out.data_ptr(), n, x_q.shape[1], o_pad, x_sal.shape[1],
            _build.dt_code(out),
            wg_s8.blocks(n, o_pad, wg_s8.sm_count(x_q.device), wg_s8.tile_cols(k_s)),
            _build.stream_ptr(x_q)), "sq_int8_prefill_wg")
        _build.LAUNCHES[LAUNCH_KEYS["wg"]] += 1
        return out if o_pad == o else out[:, :o]
    tail = (out.data_ptr(), n, x_q.shape[1], o_pad, x_sal.shape[1], _build.dt_code(w_sal_t),
            _build.dt_code(out), _build.stream_ptr(x_q))
    if raw_x:
        _build.check(_build.lib().sq_int8_prefill_rawx(
            x_q.data_ptr(), mask.data_ptr(), sx.data_ptr(), w_ok.data_ptr(), sw.data_ptr(),
            x_sal.data_ptr(), w_sal_t.data_ptr(), *tail), "sq_int8_prefill_rawx")
    else:
        _build.check(_build.lib().sq_int8_prefill(
            x_q.data_ptr(), sx.data_ptr(), w_ok.data_ptr(), sw.data_ptr(),
            x_sal.data_ptr(), w_sal_t.data_ptr(), *tail), "sq_int8_prefill")
    _build.LAUNCHES[LAUNCH_KEYS["raw_x" if raw_x else "tiles"]] += 1
    return out if o_pad == o else out[:, :o]

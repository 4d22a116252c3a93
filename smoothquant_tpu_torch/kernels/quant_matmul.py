"""Dual-path dequant matmul (K9), with its plain PyTorch version.

K9  dual_path_matmul — port of smoothquant_tpu/kernels/quant_matmul.py:159
    (pallas_call :248 and :255), its four bodies:
      grouped (w_scales_t (G, O), G > 1; _kernel :71, _kernel_nosal :87):
          out = x_sal·w_sal + x_ns·T(f32(w_q)·f32(s[c // gs, o]))
      single group (w_scales_t (1, O); _kernel_colscale :98,
      _kernel_colscale_nosal :127):
          out = fma(x_ns·T(w_q), s[o], x_sal·w_sal)
    where T is x_ns's dtype (bf16 or f32): the weight is dequantized in f32
    and rounded to T to nearest even, as astype does, and the products sum
    in f32 (jitted XLA fuses the single-group epilogue into one multiply-
    add).  x_ns arrives already Q-DQ'd (pack.quantize_activations_packed).

CUDA source: csrc/quant_matmul.cu (the design notes live there): a bf16
body on the wgmma ring of csrc/wg_gemm.cuh, and a CUDA-core body for f32
(dual_path_body picks by dtype).  A
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import fma_f32

K_STEP = 64      # the kernels' k stage; they take rows zero-padded to it


def dual_path_matmul_plain(x_ns, x_sal, w_qt, w_scales_t, w_sal_t, *, group_size: int,
                           out_dtype=torch.float32):
    """Plain PyTorch K9 (same arguments as the wrapper)."""
    sal = x_sal.float() @ w_sal_t.float() if x_sal.shape[1] else None
    if w_scales_t.shape[0] == 1:
        acc = x_ns.float() @ w_qt.to(x_ns.dtype).float()
        s = w_scales_t.float()
        y = acc * s if sal is None else fma_f32(acc, s, sal)
    else:
        scales = w_scales_t.float().repeat_interleave(group_size, dim=0)
        w_deq = (w_qt.float() * scales).to(x_ns.dtype)
        y = x_ns.float() @ w_deq.float()
        if sal is not None:
            y = sal + y
    return y.to(out_dtype)


def _pad_cols(t: torch.Tensor, m: int) -> torch.Tensor:
    pad = -t.shape[-1] % m
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def dual_path_body(dtype) -> str:
    """The body a CUDA call of K9 runs, by the activation dtype alone:
    "wgmma" (bf16: dual_path_wg_kernel, bf16 wgmma over a TMA ring) or
    "fma" (f32: the CUDA-core body, never TF32)."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def dual_path_matmul(
    x_ns: torch.Tensor,       # (N, K_ns) Q-DQ'd activations, bf16 or f32
    x_sal: torch.Tensor,      # (N, K_s) salient activations, x_ns's dtype
    w_qt: torch.Tensor,       # (K_ns, O) int8 (int4- or int8-range values)
    w_scales_t: torch.Tensor, # (K_ns // group_size, O) or (1, O), f32 or bf16
    w_sal_t: torch.Tensor,    # (K_s, O) x_ns's dtype
    *,
    group_size: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """(N, O) dequant matmul in out_dtype."""
    if x_ns.device.type == "cpu":
        return dual_path_matmul_plain(x_ns, x_sal, w_qt, w_scales_t, w_sal_t,
                                      group_size=group_size, out_dtype=out_dtype)
    if x_ns.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_ns.device}")
    n, k = x_ns.shape
    o = w_qt.shape[1]
    k_s = x_sal.shape[1]
    grouped = w_scales_t.shape[0] != 1
    if grouped and (k % group_size or group_size % 2
                    or w_scales_t.shape[0] != k // group_size):
        raise ValueError("K9 needs K = G·group_size with an even group size")
    if o % 8:
        raise ValueError("K9 needs O % 8 == 0")
    dt = x_ns.dtype
    if dt not in _build.DT_CODE or out_dtype != dt or x_sal.dtype != dt or w_sal_t.dtype != dt:
        raise TypeError("K9 computes in the activation dtype (f32 or bf16): x_sal, w_sal "
                        "and out included")
    if (w_qt.dtype != torch.int8 or w_qt.shape[0] != k or w_scales_t.shape[1] != o
            or w_sal_t.shape != (k_s, o) or x_sal.shape[0] != n
            or w_scales_t.dtype not in _build.DT_CODE):
        raise TypeError("K9 operand shapes or dtypes do not match")
    dev = x_ns.device
    # whole 64-column stages, 16-byte aligned rows: the bf16 body reads them by TMA
    x_ns, x_sal = (_build.aligned(_pad_cols(t.contiguous(), K_STEP)) for t in (x_ns, x_sal))
    if x_sal.shape[1] != k_s:
        w_sal_t = torch.nn.functional.pad(w_sal_t, (0, 0, 0, x_sal.shape[1] - k_s))
    w_sal_t = _build.aligned(w_sal_t.contiguous())
    w_scales_t = _build.aligned(w_scales_t)   # the bf16 body reads it by TMA
    _build.check_operands(dev, x_sal=x_sal, w_qt=w_qt, w_scales_t=w_scales_t,
                          w_sal_t=w_sal_t)
    if w_qt.data_ptr() % 8:
        raise ValueError("K9 reads the weight in 8-byte runs: it must start 8-byte aligned")
    out = torch.empty((n, o), dtype=dt, device=dev)
    _build.check(_build.lib().sq_dual_path(
        x_ns.data_ptr(), x_sal.data_ptr(), w_qt.data_ptr(), w_scales_t.data_ptr(),
        w_sal_t.data_ptr(), out.data_ptr(), n, o, k, x_ns.shape[1], group_size,
        x_sal.shape[1], int(grouped), _build.dt_code(w_scales_t), _build.dt_code(x_ns),
        _build.stream_ptr(x_ns)), "sq_dual_path")
    _build.LAUNCHES["dual_path_matmul"] += 1
    return out

"""Fused normalization + static int8 quantization (K16), with its plain
PyTorch version.

K16  norm_quant — port of smoothquant_tpu/kernels/norm_quant.py:44
     (pallas_call :61), torch_int's LayerNormQ and its RMSNorm twin: x (N, C)
     f32 / bf16 → int8 (N, C).  LayerNorm takes a two-pass mean and
     variance in f32, as jnp.mean and jnp.var compute them;
     y = fma((x − μ)·r, γ, β) with r = 1/√(var + eps) (RMSNorm:
     y = fma(x·r, γ, 0), r from the mean square); then round-half-even(y ·
     f32(1/scale)) clipped to ±127 — the multiply by the reciprocal the JAX
     kernel computes (norm_quant.py:37), never a divide.

r is 1/√v with the square root and the division each correctly rounded
(on the card: __frcp_rn(__fsqrt_rn(v)); the plain version:
reciprocal(sqrt(v)), correctly rounded there too), so the kernel and its
plain version differ only in the order of the sums.  XLA's CPU rsqrt is
neither form, so the port and the JAX package may differ in the last bit of
r and then, rarely, by one code.

CUDA source: csrc/norm_quant.cu.  A wrapper runs the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import f32_reciprocal, fma_f32

MAX_C = 8192         # the row is staged in 32 KB of shared memory as f32


def norm_quant_plain(x, gamma, beta, scale, *, eps=1e-5, rms=False):
    """Plain PyTorch K16 (same arguments as the wrapper)."""
    xf = x.float()
    c = x.shape[-1]
    if rms:
        cen = xf
        v = (xf * xf).sum(dim=-1, keepdim=True) / c
    else:
        cen = xf - xf.sum(dim=-1, keepdim=True) / c
        v = (cen * cen).sum(dim=-1, keepdim=True) / c
    r = torch.reciprocal(torch.sqrt(v + np.float32(eps)))
    y = fma_f32(cen * r, gamma.float(), beta.float())
    inv = f32_reciprocal(float(np.float32(scale)))
    return torch.round(y * inv).clamp(-127, 127).to(torch.int8)


def norm_quant(
    x: torch.Tensor,         # (N, C) f32 / bf16
    gamma: torch.Tensor,     # (C,)
    beta: torch.Tensor,      # (C,) — zeros for RMSNorm
    scale,                   # f32 static output scale
    *,
    eps: float = 1e-5,
    rms: bool = False,
) -> torch.Tensor:
    """(N, C) int8 normalized rows (K16)."""
    if x.device.type == "cpu":
        return norm_quant_plain(x, gamma, beta, scale, eps=eps, rms=rms)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError("norm_quant takes x (N, C)")
    n, c = x.shape
    if c % 8 or c > MAX_C:
        raise ValueError(f"norm_quant takes C a multiple of 8 up to {MAX_C}, got {c}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("gamma and beta must be (C,)")
    dt = _build.dt_code(x)
    x = x.contiguous()
    if x.data_ptr() % 16:        # the kernel loads 16-byte words
        x = x.clone()
    g, b = gamma.float().contiguous(), beta.float().contiguous()
    _build.check_operands(x.device, x=x, gamma=g, beta=b)
    out = torch.empty((n, c), dtype=torch.int8, device=x.device)
    if n:
        _build.check(_build.lib().sq_norm_quant(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), n, c,
            float(eps), float(np.float32(scale)), int(rms), dt,
            _build.stream_ptr(x)), "sq_norm_quant")
        _build.LAUNCHES["norm_quant"] += 1
    return out


def layer_norm_q(x, gamma, beta, scale, eps=1e-5):
    """torch_int's LayerNormQ (norm_quant.py:79-81)."""
    return norm_quant(x, gamma, beta, scale, eps=eps, rms=False)


def rms_norm_q(x, gamma, scale, eps=1e-6):
    """RMSNorm → int8 with a static scale (norm_quant.py:84-87)."""
    return norm_quant(x, gamma, torch.zeros_like(gamma), scale, eps=eps, rms=True)

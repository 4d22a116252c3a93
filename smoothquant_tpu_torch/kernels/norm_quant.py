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

CUDA source: csrc/norm_quant.cu, two bodies.  Every call takes the row body
(a row held in registers by the W warps of k16_plan, the sums by warp
shuffles and one exchange among the row's warps under a named barrier; its
launches count under "norm_quant"); the block body (one block of 256
threads a row, the row staged in shared memory; "norm_quant_block") runs
only when body="block" forces it, to be timed beside the row body.  A
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import f32_reciprocal, fma_f32

MAX_C = 8192         # channels a row takes: 8 warps × 32 lanes × 4 chunks of 8
BODIES = ("rows", "block")
# the launch counter of each body: the row body counts under the kernel's
# name, so a path that expects it proves the row body served it
LAUNCH_KEYS = {"rows": "norm_quant", "block": "norm_quant_block"}
CHUNKS = 4           # 8-channel chunks a lane of the row body holds at most
MAX_WARPS = 8        # warps a block of the row body holds
SMS = 132            # streaming multiprocessors of an H100 SXM
SMALL_WARPS = 4      # warps a row takes at least below SMS rows


def k16_plan(n: int, c: int) -> tuple[int, int, bool]:
    """The row body's (warps a row, rows a block, γ / β loaded beside x): W
    the least power of two whose 32·W lanes hold the row in at most CHUNKS
    chunks of 8 channels a lane (at most 32 f32 registers: C = 2048 → 2,
    8192 → 8), or, at fewer rows than SMS (latency-bound: the card's SMs
    mostly idle), at least SMALL_WARPS with γ and β loaded beside x (one
    memory round trip before the sums, none after; measured faster at 4 rows
    by scripts/mlp_variants.py); R rows a block of at most MAX_WARPS warps,
    fewer where the rows would leave under two blocks an SM (so 4 × 512 rows
    of C = 2048 run 512 blocks of 4 rows, 4 rows 4 blocks of one)."""
    w = 1
    while 32 * w * CHUNKS * 8 < c:
        w *= 2
    small = n < SMS
    if small:
        w = max(w, SMALL_WARPS)
    return w, max(1, min(MAX_WARPS // w, n // (2 * SMS))), small


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
    gamma: torch.Tensor,     # (C,) f32 or bf16
    beta: torch.Tensor,      # (C,) — zeros for RMSNorm
    scale,                   # f32 static output scale
    *,
    eps: float = 1e-5,
    rms: bool = False,
    body: str = "rows",      # "block" forces the one-block-a-row body
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
    if body not in BODIES:
        raise ValueError(f"K16 has no {body!r} body")
    dt = _build.dt_code(x)
    x = _build.aligned(x.contiguous())     # the kernels load 16-byte words
    # the row body reads f32 or bf16 γ and β as they are stored (a model's
    # bf16 LayerNorm rows cost no conversion launch); the block body f32
    g_dt = gamma.dtype if body == "rows" and gamma.dtype == beta.dtype and \
        gamma.dtype in (torch.float32, torch.bfloat16) else torch.float32
    g, b = (_build.aligned(t.to(g_dt).contiguous()) for t in (gamma, beta))
    _build.check_operands(x.device, x=x, gamma=g, beta=b)
    out = torch.empty((n, c), dtype=torch.int8, device=x.device)
    if n:
        args = (x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), n, c)
        tail = (float(eps), float(np.float32(scale)), int(rms), dt)
        stream = _build.stream_ptr(x)
        if body == "rows":
            _build.check(_build.lib().sq_norm_quant_rows(
                *args, *k16_plan(n, c), *tail, _build.dt_code(g), stream), "sq_norm_quant_rows")
        else:
            _build.check(_build.lib().sq_norm_quant(*args, *tail, stream), "sq_norm_quant")
        _build.LAUNCHES[LAUNCH_KEYS[body]] += 1
    return out


def layer_norm_q(x, gamma, beta, scale, eps=1e-5):
    """torch_int's LayerNormQ (norm_quant.py:79-81)."""
    return norm_quant(x, gamma, beta, scale, eps=eps, rms=False)


def rms_norm_q(x, gamma, scale, eps=1e-6):
    """RMSNorm → int8 with a static scale (norm_quant.py:84-87)."""
    return norm_quant(x, gamma, torch.zeros_like(gamma), scale, eps=eps, rms=True)

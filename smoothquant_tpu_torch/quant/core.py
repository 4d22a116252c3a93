"""Integer quantize primitives used by packing and the int path
(port of smoothquant_tpu/quant/core.py:47-56,112-129,215-230).

Symmetric, no zero point: scale = max(absmax, 1e-5) / q_max in float32,
round half to even (torch.round, like jnp.round).

The division by the constant q_max is, by default, a multiply by its
float32 reciprocal: that is what XLA compiles the JAX package's `/ q_max`
to under jit, where its kernels, forwards and permuted packs run, and the
two differ in the last bit.  The JAX identity-layout pack runs eagerly,
where the division is exact; `exact_division=True` reproduces that.
"""

from __future__ import annotations

import numpy as np
import torch

SCALE_FLOOR = 1e-5


def qmax(n_bits: int) -> float:
    return float(2 ** (n_bits - 1) - 1)


def f32_reciprocal(v: float) -> float:
    """1/v rounded to float32 (exactly representable as a Python float)."""
    return float(np.float32(1.0) / np.float32(v))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in float32 with ONE rounding — the fused multiply-add XLA
    compiles jitted f32 `a * b + c` chains to (the rotary, the int8
    epilogue).  float64 holds the product of two float32 values exactly."""
    return (a.double() * b.double() + c.double()).float()


def compute_scale(absmax: torch.Tensor, n_bits: int,
                  exact_division: bool = False) -> torch.Tensor:
    """scale = clamp(absmax, 1e-5) / q_max, in float32."""
    a = torch.clamp_min(absmax.float(), SCALE_FLOOR)
    if exact_division:
        return a / qmax(n_bits)
    return a * f32_reciprocal(qmax(n_bits))


def sort_key(x2d: torch.Tensor, strategy: str = "max") -> torch.Tensor:
    """Per-column ranking key for sorted-group layouts (core.py:112-129)."""
    ax = x2d.float().abs()
    if strategy == "max":
        return ax.amax(dim=0)
    if strategy == "mean_std":
        return ax.mean(dim=0) + 3.0 * ax.std(dim=0, unbiased=False)
    if strategy == "argmax":
        return ax.argmax(dim=0).float()
    raise ValueError("sort strategy must be one of ('max', 'mean_std', 'argmax')")


def group_quant_params(w: torch.Tensor, n_bits: int, group_size: int,
                       exact_division: bool = False):
    """(out, in) weight → (q int8 (out, G, gs), scales f32 (out, G, 1)),
    zero-padding the input axis to whole groups."""
    n, c = w.shape
    num_groups = -(-c // group_size)
    pad = num_groups * group_size - c
    wf = w.float()
    if pad:
        wf = torch.nn.functional.pad(wf, (0, pad))
    g = wf.reshape(n, num_groups, group_size)
    scales = compute_scale(g.abs().amax(dim=-1, keepdim=True), n_bits,
                           exact_division)
    q = torch.round(g / scales).to(torch.int8)
    return q, scales


def quantize_groups_int(xf: torch.Tensor, n_bits: int, group_size: int):
    """Per-(row, group) activation quantize of a float32 (N, K) matrix whose
    K is a whole number of groups → (x_q int8 (N, K), scales f32 (N, G))."""
    n, k = xf.shape
    xg = xf.reshape(n, k // group_size, group_size)
    scales = compute_scale(xg.abs().amax(dim=-1, keepdim=True), n_bits)
    x_q = torch.round(xg / scales).to(torch.int8).reshape(n, k)
    return x_q, scales[..., 0]

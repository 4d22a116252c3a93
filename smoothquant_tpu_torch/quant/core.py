"""Integer quantize primitives used by packing and the int path, and the
activation Q-DQ quantizers of the dequant path (port of
smoothquant_tpu/quant/core.py:47-66,82-100,112-129,166-192,215-230).

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


def rms_factor(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """1/√(mean(x²) + eps) of each row of a float32 (..., C) tensor, by the
    rule K1's pre-pass and K14 take on the card: Σx² in float64 (exact
    squares), rounded to float32 once — so its value does not depend on the
    order of the sum, and the CPU, the card's torch ops and the kernels
    agree — times the f32 reciprocal of C, plus eps, then the square root
    and the reciprocal, each correctly rounded (torch.rsqrt is approximate
    and differs between devices)."""
    xd = xf.double()
    ss = (xd * xd).sum(dim=-1, keepdim=True).float()
    return torch.reciprocal(torch.sqrt(ss * f32_reciprocal(xf.shape[-1]) + eps))


def compute_scale(absmax: torch.Tensor, n_bits: int,
                  exact_division: bool = False) -> torch.Tensor:
    """scale = clamp(absmax, 1e-5) / q_max, in float32."""
    a = torch.clamp_min(absmax.float(), SCALE_FLOOR)
    if exact_division:
        return a / qmax(n_bits)
    return a * f32_reciprocal(qmax(n_bits))


def qdq(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric quantize-dequantize with a broadcastable f32 scale:
    round(x / scale)·scale in float32 (the division exact, as it is for a
    tensor divisor under jit), cast back to x's dtype (core.py:59-62)."""
    return (torch.round(x.float() / scale) * scale).to(x.dtype)


def quantize_activation_per_token_absmax(t: torch.Tensor, n_bits: int) -> torch.Tensor:
    """One scale per token, a row of the flattened (N, C) view (core.py:166-170)."""
    t2d = t.reshape(-1, t.shape[-1])
    absmax = t2d.float().abs().amax(dim=-1, keepdim=True)
    return qdq(t2d, compute_scale(absmax, n_bits)).reshape(t.shape)


def quantize_activation_per_tensor_absmax(t: torch.Tensor, n_bits: int) -> torch.Tensor:
    """One scale over the whole activation (core.py:173-177)."""
    return qdq(t, compute_scale(t.float().abs().amax(), n_bits))


def quantize_activation_per_group_absmax(t: torch.Tensor, n_bits: int,
                                         group_size: int = 128) -> torch.Tensor:
    """Per-(token, channel-group) scales, the channel axis zero-padded to
    whole groups and cut back after the Q-DQ (core.py:82-90,180-185)."""
    shape = t.shape
    t2d = t.reshape(-1, shape[-1])
    n, c = t2d.shape
    g = -(-c // group_size)
    if g * group_size != c:
        t2d = torch.nn.functional.pad(t2d, (0, g * group_size - c))
    tg = t2d.reshape(n, g, group_size)
    out = qdq(tg, compute_scale(tg.float().abs().amax(dim=-1, keepdim=True), n_bits))
    return out.reshape(n, g * group_size)[:, :c].reshape(shape)


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

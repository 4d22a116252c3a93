"""The Q-DQ library of the simulated (fake-quant) path and the integer
quantize primitives of packing and the int path (port of
smoothquant_tpu/quant/core.py).

Symmetric, no zero point: scale = max(absmax, 1e-5) / q_max in float32,
round half to even (torch.round, like jnp.round); group quantizers zero-pad
the channel axis to whole groups and cut the padding off after the Q-DQ;
the sorted group variants rank the columns by a sort key, quantize in that
order and scatter back, so only the grouping changes.

The division by the constant q_max is, by default, a multiply by its
float32 reciprocal: that is what XLA compiles the JAX package's `/ q_max`
to under jit, where its kernels, forwards (and so every activation Q-DQ)
and permuted packs run, and the two differ in the last bit.  Eager JAX
divides exactly: the identity-layout pack and the simulated path's weight
Q-DQ (quantize_linear_params, which the reference flow calls eagerly) run
so, and the weight quantizers here divide exactly.  `exact_division=True`
selects that rule where a function takes it.
"""

from __future__ import annotations

import functools

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
    """scale = clamp(absmax, 1e-5) / q_max, in float32.  The exact
    division divides by a tensor on absmax's device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which would
    give the other rule on the card."""
    a = torch.clamp_min(absmax.float(), SCALE_FLOOR)
    if exact_division:
        return a / torch.tensor(qmax(n_bits), dtype=torch.float32, device=a.device)
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


def _pad_to_groups(x2d: torch.Tensor, group_size: int):
    """(N, C) → (N, G·group_size) zero-padded on the right, and G."""
    c = x2d.shape[-1]
    g = -(-c // group_size)
    if g * group_size != c:
        x2d = torch.nn.functional.pad(x2d, (0, g * group_size - c))
    return x2d, g


def _group_qdq_2d(x2d: torch.Tensor, n_bits: int, group_size: int,
                  exact_division: bool) -> torch.Tensor:
    """Q-DQ of an (N, C) matrix with per-(row, group) scales (core.py:82-100)."""
    n, c = x2d.shape
    padded, g = _pad_to_groups(x2d, group_size)
    tg = padded.reshape(n, g, group_size)
    scale = compute_scale(tg.float().abs().amax(dim=-1, keepdim=True), n_bits,
                          exact_division)
    return qdq(tg, scale).reshape(n, g * group_size)[:, :c]


def quantize_activation_per_group_absmax(t: torch.Tensor, n_bits: int,
                                         group_size: int = 128) -> torch.Tensor:
    """Per-(token, channel-group) scales, the channel axis zero-padded to
    whole groups and cut back after the Q-DQ (core.py:180-185)."""
    t2d = t.reshape(-1, t.shape[-1])
    return _group_qdq_2d(t2d, n_bits, group_size, False).reshape(t.shape)


SORT_STRATEGIES = ("max", "mean_std", "argmax")


def sort_key(x2d: torch.Tensor, strategy: str = "max") -> torch.Tensor:
    """Per-column ranking key of the sorted group layouts (core.py:112-129):
    "max" the column's absmax, "mean_std" mean(|x|) + 3·std(|x|) (the
    population std, as jnp.std), "argmax" the row index of its absmax (the
    first, as jnp.argmax).  mean_std takes its mean and std in float64,
    each rounded to float32 once, then adds in float32 as the JAX function
    does: its value, and so the order, does not hang on the device's sum
    order (the card's and the CPU's f32 sums differ in the last bit, and a
    near-tie of two keys would then order two columns apart)."""
    ax = x2d.float().abs()
    if strategy == "max":
        return ax.amax(dim=0)
    if strategy == "mean_std":
        ad = ax.double()
        return ad.mean(dim=0).float() + 3.0 * ad.std(dim=0, unbiased=False).float()
    if strategy == "argmax":
        return ax.argmax(dim=0).float()
    raise ValueError(f"sort strategy must be one of {SORT_STRATEGIES}")


def sorted_group_perm(x2d: torch.Tensor, strategy: str = "max") -> torch.Tensor:
    """Ascending permutation of the columns by their sort key (core.py:
    132-138), ties in column order: a STABLE sort on every device, as
    jnp.argsort is (argmax keys are row indices, so ties are the rule)."""
    return torch.argsort(sort_key(x2d, strategy), stable=True)


def _sorted_group_qdq_2d(x2d: torch.Tensor, n_bits: int, group_size: int,
                         strategy: str, exact_division: bool) -> torch.Tensor:
    perm = sorted_group_perm(x2d, strategy)
    out = _group_qdq_2d(x2d.index_select(1, perm), n_bits, group_size, exact_division)
    return out.index_select(1, torch.argsort(perm))


# ------------------------------------------------ weights: w (out, in)


def quantize_weight_per_channel_absmax(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """One scale per output row (core.py:70-73); exact division."""
    absmax = w.float().abs().amax(dim=-1, keepdim=True)
    return qdq(w, compute_scale(absmax, n_bits, True))


def quantize_weight_per_tensor_absmax(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """One scale for the whole weight (core.py:76-79); exact division."""
    return qdq(w, compute_scale(w.float().abs().amax(), n_bits, True))


def quantize_weight_per_group_absmax(w: torch.Tensor, n_bits: int,
                                     group_size: int = 128) -> torch.Tensor:
    """Per-(row, group of group_size input channels) scales (core.py:
    103-107); exact division."""
    return _group_qdq_2d(w, n_bits, group_size, True)


def quantize_weight_per_group_absmax_sort(w: torch.Tensor, n_bits: int,
                                          group_size: int = 128,
                                          sort_strategy: str = "max") -> torch.Tensor:
    """Group Q-DQ in the order of the columns' sort key, returned in the
    original column order (core.py:149-160); exact division."""
    return _sorted_group_qdq_2d(w, n_bits, group_size, sort_strategy, True)


# ------------------------------------------ activations: t (..., C)


def quantize_activation_per_group_absmax_sort(t: torch.Tensor, n_bits: int,
                                              group_size: int = 128,
                                              sort_strategy: str = "max") -> torch.Tensor:
    """Sorted per-group activation Q-DQ (core.py:188-202): the permutation
    from this call's own (N, C) view, as the reference sorts each call."""
    t2d = t.reshape(-1, t.shape[-1])
    return _sorted_group_qdq_2d(t2d, n_bits, group_size, sort_strategy,
                                False).reshape(t.shape)


WEIGHT_QUANTIZERS = {
    "per_channel": quantize_weight_per_channel_absmax,
    "per_tensor": quantize_weight_per_tensor_absmax,
    "per_group": quantize_weight_per_group_absmax_sort,
    "per_group_unsorted": quantize_weight_per_group_absmax,
}

ACT_QUANTIZERS = {
    "per_token": quantize_activation_per_token_absmax,
    "per_tensor": quantize_activation_per_tensor_absmax,
    "per_group": quantize_activation_per_group_absmax_sort,
    "per_group_unsorted": quantize_activation_per_group_absmax,
}


def _bind(fn, name: str, n_bits: int, group_size: int, sort_strategy: str):
    if name == "per_group":
        return functools.partial(fn, n_bits=n_bits, group_size=group_size,
                                 sort_strategy=sort_strategy)
    if name == "per_group_unsorted":
        return functools.partial(fn, n_bits=n_bits, group_size=group_size)
    return functools.partial(fn, n_bits=n_bits)


def get_act_quantizer(name: str, n_bits: int, group_size: int = 128,
                      sort_strategy: str = "max"):
    """The activation quantizer `name` with its arguments bound (core.py:
    243-257); "per_group" is the sorted variant."""
    return _bind(ACT_QUANTIZERS[name], name, n_bits, group_size, sort_strategy)


def get_weight_quantizer(name: str, n_bits: int, group_size: int = 128,
                         sort_strategy: str = "max"):
    """The weight quantizer `name` with its arguments bound (core.py:
    260-269); "per_group" is the sorted variant."""
    return _bind(WEIGHT_QUANTIZERS[name], name, n_bits, group_size, sort_strategy)


def group_quant_params(w: torch.Tensor, n_bits: int, group_size: int,
                       exact_division: bool = False):
    """(out, in) weight → (q int8 (out, G, gs), scales f32 (out, G, 1)),
    zero-padding the input axis to whole groups."""
    n = w.shape[0]
    wf, num_groups = _pad_to_groups(w.float(), group_size)
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

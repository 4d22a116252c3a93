"""Per-group activation quantize into K5's layout: K7a and K7b, each with
its plain PyTorch version.

K7a quantize_acts_grouped_t — port of smoothquant_tpu/kernels/act_prep.py:40
    (pallas_call :66).  x_ns (N, k_ns), the zero-padded non-salient slice →
    x3 (G, N_pad, gs) int8 and xs_t (G, N_pad) f32 with N_pad =
    max(8, ⌈N/8⌉·8): scale = max(absmax, 1e-5)/qmax (the f32 reciprocal
    multiply jitted XLA compiles the division to) and codes round(y / scale)
    half to even; zero rows quantize to 0 with the floor scale.
K7b norm_quantize_acts_t — port of act_prep.py:127 (pallas_call :182).
    x (N, C) bf16 / f32 in the pack's channel order (pre-norm), the norm
    weight (C,) → K7a's x3 and xs_t over the k_ns non-salient columns and
    x_sal (N_pad, k_s) in sal_dtype: y = (x·r)·w, r the row's RMSNorm
    factor ("rms") or 1 (None); columns at or past C − num_salient zeroed
    before the quantize; x_sal the num_salient normed tail columns, zero-
    padded to k_s.  r takes the port's rule (quant.core.rms_factor: Σx² in
    f64, 1/√v correctly rounded) — K1's pre-pass takes it too, so K7b → K5
    and K1 quantize the same values on the card; the JAX kernel takes
    XLA's rsqrt, which may put r an ulp away and move a code on a rounding
    edge.  The stacked decode's fused-norm sites take K7b → K5 at 5-32
    rows (real_linear.k1_rows_operands: K1's codes, on K5's stream body);
    no module of the JAX package calls it.

CUDA source: csrc/act_prep.cu.  The wrapper runs the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from typing import Optional

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import compute_scale, f32_reciprocal, qmax, rms_factor

NORM_KINDS = ("rms", None)


def padded_rows(n: int) -> int:
    """N_pad of K7a's layout."""
    return max(8, -(-n // 8) * 8)


def quantize_acts_grouped_t_plain(x_ns: torch.Tensor, *, group_size: int,
                                  act_bits: int):
    """Plain PyTorch K7a (same arguments as the wrapper)."""
    n, k_ns = x_ns.shape
    g = k_ns // group_size
    n_pad = padded_rows(n)
    xf = torch.nn.functional.pad(x_ns.float(), (0, 0, 0, n_pad - n))
    blk = xf.reshape(n_pad, g, group_size).transpose(0, 1)      # (G, N_pad, gs)
    scale = compute_scale(blk.abs().amax(dim=-1, keepdim=True), act_bits)
    return torch.round(blk / scale).to(torch.int8), scale[..., 0]


def quantize_acts_grouped_t(x_ns: torch.Tensor, *, group_size: int,
                            act_bits: int):
    """(x3 (G, N_pad, gs) int8, xs_t (G, N_pad) f32) of x_ns (N, k_ns)."""
    if x_ns.device.type == "cpu":
        return quantize_acts_grouped_t_plain(x_ns, group_size=group_size,
                                             act_bits=act_bits)
    if x_ns.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_ns.device}")
    n, k_ns = x_ns.shape
    if k_ns % group_size or group_size > 128:
        raise ValueError("K7a needs whole groups of at most 128 channels")
    if not 2 <= act_bits <= 8:
        raise ValueError(f"K7a quantizes to 2..8 bits, not {act_bits}")
    x_ns = x_ns.contiguous()
    n_pad, g = padded_rows(n), k_ns // group_size
    x3 = torch.empty((g, n_pad, group_size), dtype=torch.int8, device=x_ns.device)
    xs_t = torch.empty((g, n_pad), dtype=torch.float32, device=x_ns.device)
    _build.check(_build.lib().sq_quantize_grouped_t(
        x_ns.data_ptr(), x3.data_ptr(), xs_t.data_ptr(), n, n_pad, k_ns, group_size,
        f32_reciprocal(qmax(act_bits)), _build.dt_code(x_ns), _build.stream_ptr(x_ns)),
        "sq_quantize_grouped_t")
    _build.LAUNCHES["quantize_acts_grouped_t"] += 1
    return x3, xs_t


def norm_quantize_acts_t_plain(x_perm: torch.Tensor, norm_w: torch.Tensor, *,
                               group_size: int, act_bits: int, k_ns: int,
                               num_salient: int, k_s: int, eps: float,
                               norm_kind: Optional[str] = "rms",
                               sal_dtype=torch.bfloat16):
    """Plain PyTorch K7b (same arguments as the wrapper)."""
    if norm_kind not in NORM_KINDS:
        raise ValueError(f"norm_kind {norm_kind!r}: 'rms' or None")
    n, c = x_perm.shape
    k_ns_raw = c - num_salient
    n_pad = padded_rows(n)
    p = max(c, k_ns)
    xf = torch.nn.functional.pad(x_perm.float(), (0, p - c, 0, n_pad - n))
    w = torch.nn.functional.pad(norm_w.float(), (0, p - c))
    if norm_kind == "rms":
        xf = xf * rms_factor(xf[:, :c], eps)
    y = xf * w
    x3, xs_t = quantize_acts_grouped_t_plain(
        torch.where(torch.arange(p, device=y.device) < k_ns_raw, y, 0.0)[:, :k_ns],
        group_size=group_size, act_bits=act_bits)
    x_sal = torch.zeros((n_pad, k_s), dtype=torch.float32, device=x_perm.device)
    if k_s:
        x_sal[:, :num_salient] = y[:, k_ns_raw:c]
    return x3, xs_t, x_sal.to(sal_dtype)


def norm_quantize_acts_t(
    x_perm: torch.Tensor,     # (N, C) pre-norm activations, the pack's channel order
    norm_w: torch.Tensor,     # (C,) norm weight in the same order
    *,
    group_size: int,
    act_bits: int,
    k_ns: int,
    num_salient: int,
    k_s: int,
    eps: float,
    norm_kind: Optional[str] = "rms",
    sal_dtype=torch.bfloat16,
):
    """(x3 (G, N_pad, gs) int8, xs_t (G, N_pad) f32, x_sal (N_pad, k_s)
    sal_dtype) of x_perm; see the module docstring."""
    if x_perm.device.type == "cpu":
        return norm_quantize_acts_t_plain(
            x_perm, norm_w, group_size=group_size, act_bits=act_bits, k_ns=k_ns,
            num_salient=num_salient, k_s=k_s, eps=eps, norm_kind=norm_kind,
            sal_dtype=sal_dtype)
    if x_perm.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_perm.device}")
    n, c = x_perm.shape
    if norm_kind not in NORM_KINDS:
        raise ValueError(f"norm_kind {norm_kind!r}: 'rms' or None")
    if k_ns % group_size or group_size > 128:
        raise ValueError("K7b needs whole groups of at most 128 channels")
    if not 2 <= act_bits <= 8:
        raise ValueError(f"K7b quantizes to 2..8 bits, not {act_bits}")
    if not (0 <= num_salient < c and c - num_salient <= k_ns
            and (k_s == 0 or num_salient <= k_s)):
        raise ValueError(f"K7b: {num_salient} salient of {c} channels do not fit "
                         f"k_ns {k_ns} and k_s {k_s}")
    if norm_w.shape != (c,):
        raise ValueError(f"norm weight {tuple(norm_w.shape)} != ({c},)")
    x_perm, norm_w = x_perm.contiguous(), norm_w.float().contiguous()
    _build.check_operands(x_perm.device, norm_w=norm_w)
    n_pad, g = padded_rows(n), k_ns // group_size
    dev = x_perm.device
    x3 = torch.empty((g, n_pad, group_size), dtype=torch.int8, device=dev)
    xs_t = torch.empty((g, n_pad), dtype=torch.float32, device=dev)
    x_sal = torch.empty((n_pad, k_s), dtype=sal_dtype, device=dev)
    _build.check(_build.lib().sq_norm_quantize_t(
        x_perm.data_ptr(), norm_w.data_ptr(), x3.data_ptr(), xs_t.data_ptr(),
        x_sal.data_ptr(), n, n_pad, c, k_ns, group_size, num_salient, k_s,
        int(norm_kind == "rms"), float(eps), f32_reciprocal(qmax(act_bits)),
        _build.dt_code(x_perm), _build.dt_code(x_sal), _build.stream_ptr(x_perm)),
        "sq_norm_quantize_t")
    _build.LAUNCHES["norm_quantize_acts_t"] += 1
    return x3, xs_t, x_sal

"""Per-group activation quantize into K5's layout: K7a, with its plain
PyTorch version.

K7a quantize_acts_grouped_t — port of smoothquant_tpu/kernels/act_prep.py:40
    (pallas_call :66).  x_ns (N, k_ns), the zero-padded non-salient slice →
    x3 (G, N_pad, gs) int8 and xs_t (G, N_pad) f32 with N_pad =
    max(8, ⌈N/8⌉·8): scale = max(absmax, 1e-5)/qmax (the f32 reciprocal
    multiply jitted XLA compiles the division to) and codes round(y / scale)
    half to even; zero rows quantize to 0 with the floor scale.

CUDA source: csrc/act_prep.cu.  The wrapper runs the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import compute_scale, f32_reciprocal, qmax


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

"""Stacked unquantized decode matmul (K13), with its plain PyTorch version.

K13 fp_matmul_stacked — port of smoothquant_tpu/kernels/fp_matmul.py:48
    (pallas_call :77): x (N, K) times layer `layer_idx` of an (L, K, O)
    weight stack, f32 sums, out in x's dtype.  The linear of
    the bf16 decode baseline (models/llama.pack_fp_decode).  The layer's
    slab is read in place; nothing is copied.

CUDA source: csrc/fp_matmul.cu.  A wrapper runs the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from smoothquant_tpu_torch.kernels import _build

MAX_N = 8           # token rows the CUDA kernel takes
_TILE_K = 512       # the TPU kernel's K step: its f32 sums advance per tile


@functools.lru_cache(maxsize=64)
def _workspace_bytes(n: int, kk: int, o: int) -> int:
    return _build.lib().sq_fp_matmul_workspace_bytes(n, kk, o)


def fp_matmul_stacked_plain(layer_idx: int, x, w_t):
    """Plain PyTorch K13 (same arguments as the wrapper): f32 sums advanced
    one K tile at a time, as the TPU kernel accumulates."""
    kk = x.shape[1]
    tile = _TILE_K
    while kk % tile:
        tile //= 2
    w = w_t[layer_idx]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, kk, tile):
        acc += x[:, k0:k0 + tile].float() @ w[k0:k0 + tile].float()
    return acc.to(x.dtype)


def fp_matmul_stacked(
    layer_idx: int,
    x: torch.Tensor,          # (N, K) bf16 / f32 activations
    w_t: torch.Tensor,        # (L, K, O) every layer's transposed weights
) -> torch.Tensor:
    """(N, O) = x · w_t[layer_idx], summed in f32."""
    if x.device.type == "cpu":
        return fp_matmul_stacked_plain(layer_idx, x, w_t)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    n, kk = x.shape
    _, k_w, o = w_t.shape
    if k_w != kk or n > MAX_N or o % 8:
        raise ValueError(f"K13 takes N <= {MAX_N} rows and O % 8 == 0: x "
                         f"{tuple(x.shape)}, w {tuple(w_t.shape)}")
    if w_t.dtype != x.dtype:
        raise TypeError("K13 takes x and the weights in one dtype")
    x = x.contiguous()
    _build.check_operands(x.device, w_t=w_t)
    out = torch.empty((n, o), dtype=x.dtype, device=x.device)
    workspace = torch.empty(_workspace_bytes(n, kk, o), dtype=torch.uint8,
                            device=x.device)
    _build.check(_build.lib().sq_fp_matmul(
        x.data_ptr(), w_t[layer_idx].data_ptr(), workspace.data_ptr(),
        out.data_ptr(), n, kk, o, _build.dt_code(x), _build.stream_ptr(x)),
        "sq_fp_matmul")
    _build.LAUNCHES["fp_matmul_stacked"] += 1
    return out

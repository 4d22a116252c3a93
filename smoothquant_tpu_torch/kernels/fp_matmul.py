"""Stacked unquantized decode matmul (K13), with its plain PyTorch version.

K13 fp_matmul_stacked — port of smoothquant_tpu/kernels/fp_matmul.py:48
    (pallas_call :77): x (N, K) times layer `layer_idx` of an (L, K, O)
    weight stack, f32 sums, out in x's dtype.  The linear of
    the bf16 decode baseline (models/llama.pack_fp_decode).  The layer's
    slab is read in place; nothing is copied.

CUDA source: csrc/fp_matmul.cu, in one of two bodies picked by shape alone
(fp_body): the weight-streaming body's bf16 kind (csrc/stream_gmm.cuh
stream_bf16_kernel: every bf16 decode call) or the __ldg body (f32).  A
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build, stream_gmm

MAX_N = 8           # token rows the CUDA kernel takes
_TILE_K = 512       # the TPU kernel's K step: its f32 sums advance per tile
BODIES = ("stream", "ldg")
# the launch counter of each body: the stream body counts under the kernel's
# name, so a path that expects it proves the stream body served the path
LAUNCH_KEYS = {"stream": "fp_matmul_stacked", "ldg": "fp_matmul_stacked_ldg"}


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


def fp_body(n: int, kk: int, o: int, dtype) -> str:
    """The body a CUDA call of K13 runs, by shape alone: "stream" (the
    weight-streaming body's bf16 kind: bf16 x and weights, 1 to 8 rows, K
    and O multiples of 8 for TMA's 16-byte rows — every bf16 decode
    linear) or "ldg" (the __ldg body with its reduce launch: f32)."""
    if dtype == torch.bfloat16 and 1 <= n <= stream_gmm.K13_ROWS and kk % 8 == 0 and o % 8 == 0:
        return "stream"
    return "ldg"


def fp_matmul_stacked(
    layer_idx: int,
    x: torch.Tensor,          # (N, K) bf16 / f32 activations
    w_t: torch.Tensor,        # (L, K, O) every layer's transposed weights
    *,
    body: Optional[str] = None,   # None: fp_body's pick; "stream" / "ldg" force one
) -> torch.Tensor:
    """(N, O) = x · w_t[layer_idx], summed in f32.  A forced body raises on
    a shape it does not take."""
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
    rule = fp_body(n, kk, o, x.dtype)
    body = rule if body is None else body
    if body not in BODIES or (body == "stream" and rule != "stream"):
        raise ValueError(f"K13's {body!r} body does not take N = {n}, K = {kk}, O = {o}, "
                         f"{x.dtype}")
    x = x.contiguous()
    _build.check_operands(x.device, w_t=w_t)
    out = torch.empty((n, o), dtype=x.dtype, device=x.device)
    if body == "stream":
        x, w = _build.aligned(x), _build.aligned(w_t[layer_idx])
        kb = stream_gmm.k13_kb(o, kk)
        n_split = stream_gmm.split(o, stream_gmm.k13_stages(kk, kb))
        _build.check(_build.lib().sq_fp_matmul_stream(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, kk, o, kb, n_split,
            _build.stream_ptr(x)), "sq_fp_matmul_stream")
        _build.LAUNCHES[LAUNCH_KEYS[body]] += 1
        return out
    workspace = torch.empty(_workspace_bytes(n, kk, o), dtype=torch.uint8,
                            device=x.device)
    _build.check(_build.lib().sq_fp_matmul(
        x.data_ptr(), w_t[layer_idx].data_ptr(), workspace.data_ptr(),
        out.data_ptr(), n, kk, o, _build.dt_code(x), _build.stream_ptr(x)),
        "sq_fp_matmul")
    _build.LAUNCHES[LAUNCH_KEYS[body]] += 1
    return out

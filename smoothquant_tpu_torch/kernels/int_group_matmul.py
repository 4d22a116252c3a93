"""Integer group matmul over int8-container weights (K8), with its plain
PyTorch version.

K8  int_group_matmul — port of smoothquant_tpu/kernels/int_group_matmul.py:78
    (pallas_call :157; bodies _kernel :48 with the salient dot and
    _kernel_nosal :63 without):
        out[n, o] = Σ_s x_sal[n, s]·w_sal[s, o]
                  + Σ_g f32(Σ_{c∈g} x_q[n, c]·w_q[c, o]) · s_x[n, g] · s_w[g, o]
    x_q (N, K) int8 codes, x_scales (N, G) f32, w_qt (K, O) int8 holding
    int4- or int8-range values, w_scales_t (G, O) f32 or bf16, the salient
    x_sal (N, k_s) and block (k_s, O).  The int32 group partial is exact and
    rounds to f32 once; the groups are added in K order after the salient
    dot, each as fma(partial·s_x, s_w, out) — the multiply-add jitted XLA
    compiles the TPU body's `out += partial * sx * sw` to.  (Without a
    salient block XLA may contract the first two groups' sum the other way;
    the plain version keeps one chain.)

CUDA source: csrc/int_group_matmul.cu, in one of two bodies picked by shape
alone (int_gmm_body): the weight-streaming body of csrc/stream_gmm.cuh
(decode rows) or the tile kernel of csrc/gmm_tiles.cuh (the design notes
live there).  A wrapper runs the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build, stream_gmm
from smoothquant_tpu_torch.quant.core import fma_f32

MAX_GROUP = 128     # the largest group of a grouped recipe the kernel takes
STREAM_GROUPS = (16, 32, 64, 128)   # group sizes whose groups fill 128-row stages
BODIES = ("stream", "tiles")


@functools.lru_cache(maxsize=64)
def _workspace_bytes(n: int, o: int, kk: int, gs: int) -> int:
    """Bytes of K8's f32 split partials (the C side plans the split)."""
    return _build.lib().sq_int_gmm_workspace_bytes(n, o, kk, gs)


def int_group_matmul_plain(x_q, x_scales, w_qt, w_scales_t, x_sal, w_sal_t, *,
                           group_size: int, out_dtype=torch.float32):
    """Plain PyTorch K8 (same arguments as the wrapper).  The integer
    partials are summed in float64, exact for any K a model has, so a
    partial above 2^24 rounds once, to nearest, as int32 → f32 does."""
    n, kk = x_q.shape
    o = w_qt.shape[1]
    acc = (x_sal.float() @ w_sal_t.float() if x_sal.shape[1]
           else torch.zeros((n, o), dtype=torch.float32, device=x_q.device))
    xd, wd = x_q.double(), w_qt.double()
    sx, sw = x_scales.float(), w_scales_t.float()
    for g in range(kk // group_size):
        lo, hi = g * group_size, (g + 1) * group_size
        p = (xd[:, lo:hi] @ wd[lo:hi]).float()
        acc = fma_f32(p * sx[:, g:g + 1], sw[g][None, :], acc)
    return acc.to(out_dtype)


def int_gmm_body(n: int, o: int, kk: int, group_size: int) -> str:
    """The body a CUDA call of K8 runs, by shape alone: "stream" (the
    weight-streaming body: 1 to 64 rows, so every call the "int" path makes
    at up to INT_PATH_MAX_TOKENS rows; more than one group, of 16, 32, 64
    or 128 channels, whole 128-row stages; weight rows of whole 16-byte
    runs for TMA, O % 16 == 0) or "tiles" (gmm_kernel's 64 x 64 tiles:
    more rows, a single group — whose int32 partial may pass 2^22, beyond
    the stream body's exact conversion — and every other group size)."""
    if (1 <= n <= stream_gmm.MAX_ROWS and group_size in STREAM_GROUPS
            and kk // group_size > 1 and o % 16 == 0):
        return "stream"
    return "tiles"


def int_group_matmul(
    x_q: torch.Tensor,        # (N, K) int8 quantized activations
    x_scales: torch.Tensor,   # (N, G) f32 per-(token, group) scales
    w_qt: torch.Tensor,       # (K, O) int8 (int4- or int8-range values)
    w_scales_t: torch.Tensor, # (G, O) f32 or bf16
    x_sal: torch.Tensor,      # (N, K_s) salient activations
    w_sal_t: torch.Tensor,    # (K_s, O) salient weight columns
    *,
    group_size: int,
    out_dtype=torch.float32,
    body: Optional[str] = None,   # None: int_gmm_body's pick; "stream" / "tiles" force one
) -> torch.Tensor:
    """(N, O) integer group matmul in out_dtype.  A forced body raises on a
    shape it does not take (chip_smoke.py times both bodies at one shape)."""
    if x_q.device.type == "cpu":
        return int_group_matmul_plain(x_q, x_scales, w_qt, w_scales_t, x_sal, w_sal_t,
                                      group_size=group_size, out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_q.device}")
    n, kk = x_q.shape
    o = w_qt.shape[1]
    k_s = w_sal_t.shape[0]
    g = kk // group_size
    if g * group_size != kk:
        raise ValueError(f"K = {kk} is not a whole number of {group_size}-channel groups")
    if g > 1 and (group_size % 16 or group_size > MAX_GROUP):
        raise ValueError(f"K8 takes groups of a multiple of 16 channels up to {MAX_GROUP}, "
                         f"or a single group; got {group_size}")
    if o % 4:
        raise ValueError("K8 needs O % 4 == 0")
    if (x_q.dtype != torch.int8 or w_qt.dtype != torch.int8 or w_qt.shape != (kk, o)
            or x_scales.shape != (n, g) or w_scales_t.shape != (g, o)
            or x_sal.shape != (n, k_s) or w_scales_t.dtype not in _build.DT_CODE):
        raise TypeError("K8 operand shapes or dtypes do not match")
    if out_dtype not in _build.DT_CODE or (k_s and not x_sal.dtype == w_sal_t.dtype == out_dtype):
        raise TypeError("K8 computes the salient dot in the output dtype (f32 or bf16)")
    rule = int_gmm_body(n, o, kk, group_size)
    body = rule if body is None else body
    if body not in BODIES or (body == "stream" and rule != "stream"):
        raise ValueError(f"K8's {body!r} body does not take N = {n}, O = {o}, "
                         f"group size {group_size}")
    dev = x_q.device
    x_rs = -(-kk // 16) * 16
    x_q = x_q.contiguous()
    if x_rs != kk:
        x_q = torch.nn.functional.pad(x_q, (0, x_rs - kk))
    x_scales = x_scales.float().contiguous()
    x_sal = x_sal.to(out_dtype).contiguous()
    w_sal_t = w_sal_t.to(out_dtype).contiguous()
    _build.check_operands(dev, x_scales=x_scales, w_qt=w_qt, w_scales_t=w_scales_t,
                          x_sal=x_sal, w_sal_t=w_sal_t)
    out = torch.empty((n, o), dtype=out_dtype, device=dev)
    if body == "stream":
        bf16 = out_dtype == torch.bfloat16
        pad = -k_s % 8 if bf16 else 0    # x_sal rows of whole 16 bytes (TMA)
        if pad:
            x_sal = torch.nn.functional.pad(x_sal, (0, pad))
        x_q, x_sal, w_qt, w_scales_t, w_sal_t = (
            _build.aligned(t) for t in (x_q, x_sal, w_qt, w_scales_t, w_sal_t))
        n_split = stream_gmm.split(o, stream_gmm.k8_stages(kk, k_s, bf16))
        _build.check(_build.lib().sq_int_gmm_stream(
            x_q.data_ptr(), x_scales.data_ptr(), w_qt.data_ptr(), w_scales_t.data_ptr(),
            x_sal.data_ptr(), w_sal_t.data_ptr(), out.data_ptr(), n, o, kk, group_size, k_s,
            x_rs, k_s + pad, n_split, _build.dt_code(w_scales_t), _build.DT_CODE[out_dtype],
            _build.stream_ptr(x_q)), "sq_int_gmm_stream")
        _build.LAUNCHES["int_group_matmul"] += 1
        return out
    workspace = torch.empty(_workspace_bytes(n, o, kk, group_size), dtype=torch.uint8,
                            device=dev)
    _build.check(_build.lib().sq_int_gmm(
        x_q.data_ptr(), x_scales.data_ptr(), w_qt.data_ptr(), w_scales_t.data_ptr(),
        x_sal.data_ptr(), w_sal_t.data_ptr(), workspace.data_ptr(), out.data_ptr(), n, o,
        kk, group_size, k_s, x_rs, _build.dt_code(w_scales_t), _build.DT_CODE[out_dtype],
        _build.stream_ptr(x_q)), "sq_int_gmm")
    _build.LAUNCHES["int_group_matmul"] += 1
    return out

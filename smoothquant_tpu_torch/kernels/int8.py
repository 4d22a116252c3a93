"""Static-scale INT8 GEMMs of the real-INT8 OPT path (K15a, K15b), with
their plain PyTorch versions.

K15a  int8_linear — port of smoothquant_tpu/kernels/int8.py:68 (pallas_call
      :105): x (N, K) int8 · w (O, K) int8ᵀ → int32 acc, exact; then
      y = fma(f32(acc), α, bias) with one rounding (the multiply-add jitted
      XLA fuses the JAX epilogue into), optional ReLU, and out f32, or int8
      as round-half-even(y) clipped to ±127.
K15b  int8_bmm — port of smoothquant_tpu/kernels/int8.py:145 (pallas_call
      :162): a (B, M, K) int8 · b int8 contracted on K → acc·α in f32; out
      f32, or int8 as above.  b is (B, N, K) as the JAX signature has it, or
      with b_kn=True (B, K, N): the PV product then reads the (Sk, d) value
      cache as it lies, where the JAX code hands it over transposed (a copy
      of the cache).  The JAX wrapper's padding (M, N to 32, K to 128) adds
      only zeros; the kernels compute the same sums without it.

K15a picks a body by its rows (linear_body): up to STREAM_MAX_ROWS the
weight-streaming body's (O, K) int8 kind (csrc/stream_gmm.cuh
stream_s8_kernel: TMA stages of the weight rows straight into mma.sync's A
fragments, K split over a cluster as stream_gmm.split plans it), above them
the warp-specialized s8 wgmma body K4 shares (csrc/wg_s8_gemm.cuh, rules in
wg_s8.py), both in csrc/int8_wg.cu and both under the launch key
"int8_linear"; `body=` forces one of them, or one of PR 3's kernels K15b
keeps (csrc/int8.cu: "gemv" at ≤ 8 rows, "tiles" above), which count under
keys of their own (LINEAR_LAUNCH_KEYS).  K15b picks a body by shape (bmm_body): the attention
products take bodies of their own — "qk" (QKᵀ at more than 8 rows, K ≤ 256,
f32 out: a persistent tile body that writes the logits at the store
bandwidth), "pv" (b_kn at more than 8 rows, K ≤ 1024: 128 × 64 tiles, as
wide as the head dimension), "kn_gemv" (b_kn at ≤ 8 rows: K split over a
thread-block cluster) and "nk_gemv" (QKᵀ at ≤ 8 rows, K ≤ 256: a b row a
thread) — and the rest K15a's old kernels ("gemv", "tiles").  Each
body counts its launches under its own key (BMM_LAUNCH_KEYS).  A wrapper
runs the plain version only for CPU tensors; for CUDA tensors it launches
the kernel or raises.  K and (with b_kn) N are zero-padded to 16s where
they are not (zeros add nothing).

The plain versions take the int32 sums exactly as f64 matmuls (|acc| ≤
127²·K < 2^53) and the fused multiply-add as quant.core.fma_f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch.kernels import _build, stream_gmm, wg_s8
from smoothquant_tpu_torch.quant.core import fma_f32

OUT_CODES = {torch.float32: 0, torch.int8: 2}

MAX_GEMV_ROWS = 8          # rows the GEMVs take (csrc/int8.cu MAX_M)
# K15a: up to this many rows the stream body's (O, K) int8 kind, above it the
# s8 wgmma body.  Measured by chip_smoke.py's k15a_row_crossover (NVIDIA H100
# 80GB HBM3, 700 W; the int8 OPT-1.3B's six linears, weights cold): the
# stream kind wins at every row count it takes, 0.050 against 0.132 ms at 1
# and 4 rows, 0.056 against 0.135 at 32, 0.067 against 0.136 at 64, so it
# takes all of them (stream_gmm.MAX_ROWS).
STREAM_MAX_ROWS = 64
LINEAR_BODIES = ("stream", "wg", "gemv", "tiles")
# launch counter of each K15a body: the main paths' two under the kernel's name
LINEAR_LAUNCH_KEYS = {"stream": "int8_linear", "wg": "int8_linear",
                      "gemv": "int8_linear_gemv", "tiles": "int8_linear_tiles"}
QK_MAX_K = 256             # the qk body's K: |acc| ≤ 127²·K < 2^22 takes the exact f32 add
PV_MAX_K = 1024            # the pv body's K: the block's (K, 64) slice of b lands whole
KN_MAX_ROWS = 4096         # k rows a rank of the kn GEMV stages at most
KN_SPLITS = (1, 2, 4, 8)   # cluster ranks of the kn GEMV
KN_MIN_ROWS = 256          # k rows a rank takes at least (four 16-byte loads a thread)
KN_MAX_CTAS = 2 * 132      # CTAs the kn GEMV fills the card with (2 an SM, measured)
NK_MAX_K = 256             # the nk GEMV's K: a b row in a thread's registers
BMM_BODIES = {"qk": 0, "pv": 1, "kn_gemv": 2, "nk_gemv": 3}   # sq_int8_bmm_attn's codes
# launch counter of each K15b body ("gemv" and "tiles" are K15a's kernels)
BMM_LAUNCH_KEYS = {"qk": "int8_bmm_qk", "pv": "int8_bmm_pv", "kn_gemv": "int8_bmm_kn",
                   "nk_gemv": "int8_bmm_nk", "gemv": "int8_bmm", "tiles": "int8_bmm"}


def bmm_body(m: int, n: int, kk: int, b_kn: bool, out_dtype) -> str:
    """K15b's body for a (B, M, K) · b call with N output columns (K and N
    before padding): the first of K15b's own bodies that takes the shape,
    else K15a's kernel for its row count."""
    return next(body for body in ("qk", "pv", "kn_gemv", "nk_gemv", "gemv", "tiles")
                if _takes(body, m, n, kk, b_kn, out_dtype, None))


def kn_ranks(batch: int, n: int, kk: int) -> Optional[int]:
    """Cluster ranks of the kn GEMV over K = kk (a multiple of 16): the most
    of KN_SPLITS that keep a rank at KN_MIN_ROWS rows or more and the CTAs
    within KN_MAX_CTAS (one query over OPT's 1024-position cache, 128
    heads: 2 ranks, PERF.md §6), at least as many as keep a rank within
    KN_MAX_ROWS; None where no split fits."""
    fits = [c for c in KN_SPLITS if kk % (16 * c) == 0 and kk // c <= KN_MAX_ROWS]
    if not fits:
        return None
    ctas = batch * -(-n // 64)
    within = [c for c in fits if kk // c >= KN_MIN_ROWS and ctas * c <= KN_MAX_CTAS]
    return max(within, default=min(fits))


def _alpha(alpha) -> float:
    """α as the float32 value the JAX code casts it to (jnp.asarray(α, f32))."""
    return float(np.float32(float(alpha)))


def _requant(y: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype == torch.int8:
        return torch.round(y).clamp(-127, 127).to(torch.int8)
    return y.to(out_dtype)


def _exact_acc(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a @ b_t of int8 operands as f32(int32 sum): the f64 product is the
    exact integer, and its cast rounds as int32 → f32 does."""
    return torch.matmul(a.double(), b_t.double()).float()


def int8_linear_plain(x, w, alpha, bias=None, *, relu=False, out_dtype=torch.float32):
    """Plain PyTorch K15a (same arguments as the wrapper)."""
    acc = _exact_acc(x, w.t())
    al = torch.tensor(_alpha(alpha), dtype=torch.float32, device=x.device)
    b = (torch.zeros(w.shape[0], dtype=torch.float32, device=x.device)
         if bias is None else bias.float())
    y = fma_f32(acc, al, b)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return _requant(y, out_dtype)


def int8_bmm_plain(a, b, alpha, *, out_dtype=torch.float32, b_kn=False):
    """Plain PyTorch K15b (same arguments as the wrapper)."""
    acc = _exact_acc(a, b if b_kn else b.transpose(1, 2))
    return _requant(acc * torch.tensor(_alpha(alpha), dtype=torch.float32,
                                       device=a.device), out_dtype)


def _pad_dim(t: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    pad = -t.shape[dim] % m
    if not pad:
        return t
    widths = [0, 0] * (t.ndim - 1 - dim % t.ndim) + [0, pad]
    return torch.nn.functional.pad(t, widths)


def linear_body(n: int) -> str:
    """K15a's body for n rows: "stream" up to STREAM_MAX_ROWS, else "wg"."""
    return "stream" if n <= STREAM_MAX_ROWS else "wg"


def linear_takes(body: str, n: int) -> bool:
    """Whether a K15a body takes n rows."""
    if body == "stream":
        return n <= stream_gmm.MAX_ROWS
    if body in ("gemv", "tiles"):
        return (n <= MAX_GEMV_ROWS) == (body == "gemv")
    return body == "wg"


def linear_split(o: int, kk: int) -> int:
    """Cluster ranks of the stream body over K = kk (a multiple of 16):
    stream_gmm.split of its 128-byte stages."""
    return stream_gmm.split(o, stream_gmm.k15_stages(kk))


def _check_types(a, b, out_dtype, name):
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 operands, got {a.dtype} and {b.dtype}")
    if out_dtype not in OUT_CODES:
        raise TypeError(f"{name} writes float32 or int8, not {out_dtype}")


def _gemm(a, b, bias, alpha, relu, b_kn, out_dtype, name, body="tiles", ranks=None,
          key=None):
    """Launch on a (B, M, K) and b (B, N, K) / (B, K, N): PR 3's kernel
    (body "tiles" / "gemv"), or one of K15b's (BMM_BODIES); the launch
    counts under `key` (K15b's body key by default)."""
    _check_types(a, b, out_dtype, name)
    batch, m, kk = a.shape
    n = b.shape[2] if b_kn else b.shape[1]
    if b.shape[0] != batch or (b.shape[1] if b_kn else b.shape[2]) != kk:
        raise ValueError(f"{name}: operand shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    if bias is not None and (bias.shape != (n,) or bias.dtype != torch.float32):
        raise TypeError(f"{name}: bias must be float32 ({n},)")
    if min(batch, m, n, kk) == 0:
        raise ValueError(f"{name}: empty operand")
    # rows of 16 bytes: K (and, for a (K, N) operand, N) zero-padded to 16s;
    # the kernels load 16-byte words from the base pointers
    a, b = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.contiguous().clone() for t in (a, b))
    a = _pad_dim(a, 2, 16)
    n_pad = n
    if b_kn:
        b = _pad_dim(_pad_dim(b, 1, 16), 2, 16)
        n_pad = b.shape[2]
    else:
        b = _pad_dim(b, 2, 16)
    _build.check_operands(a.device, a=a, b=b, bias=bias)
    out = torch.empty((batch, m, n_pad), dtype=out_dtype, device=a.device)
    if body in BMM_BODIES:
        if body == "kn_gemv":
            ranks = kn_ranks(batch, n_pad, a.shape[2]) if ranks is None else ranks
        _build.check(_build.lib().sq_int8_bmm_attn(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, n_pad, a.shape[2],
            _alpha(alpha), BMM_BODIES[body], ranks or 1, OUT_CODES[out_dtype],
            _build.stream_ptr(a)), f"sq_int8_bmm_attn ({body})")
    else:
        _build.check(_build.lib().sq_int8_gemm(
            a.data_ptr(), b.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), batch, m, n_pad, a.shape[2], _alpha(alpha), int(relu),
            int(b_kn), OUT_CODES[out_dtype], _build.stream_ptr(a)), "sq_int8_gemm")
    _build.LAUNCHES[key or BMM_LAUNCH_KEYS[body]] += 1
    return out if n_pad == n else out[..., :n]


def _linear(x, w, bias, alpha, relu, out_dtype, body):
    """K15a on the stream or the wgmma body (csrc/int8_wg.cu)."""
    n, o = x.shape[0], w.shape[0]
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"int8_linear: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "do not contract")
    if bias is not None and (bias.shape != (o,) or bias.dtype != torch.float32):
        raise TypeError(f"int8_linear: bias must be float32 ({o},)")
    if min(n, o, x.shape[1]) == 0:
        raise ValueError("int8_linear: empty operand")
    # TMA: rows of a multiple of 16 bytes from 16-byte-aligned bases
    x, w = (_build.aligned(_pad_dim(t.contiguous(), 1, 16)) for t in (x, w))
    bias = None if bias is None else bias.contiguous()
    _build.check_operands(x.device, x=x, w=w, bias=bias)
    kk = x.shape[1]
    out = torch.empty((n, o), dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), n, kk, o, _alpha(alpha), int(relu), OUT_CODES[out_dtype])
    if body == "stream":
        _build.check(_build.lib().sq_int8_linear_stream(
            *args, linear_split(o, kk), _build.stream_ptr(x)), "sq_int8_linear_stream")
    else:
        _build.check(_build.lib().sq_int8_linear_wg(
            *args, wg_s8.blocks(n, o, wg_s8.sm_count(x.device), wg_s8.WIDE_BN),
            _build.stream_ptr(x)),
            "sq_int8_linear_wg")
    _build.LAUNCHES[LINEAR_LAUNCH_KEYS[body]] += 1
    return out


def int8_linear(
    x: torch.Tensor,                 # (N, K) int8
    w: torch.Tensor,                 # (O, K) int8
    alpha,                           # f32 scalar: s_x·s_w [/ s_y for int8 out]
    bias: Optional[torch.Tensor] = None,  # (O,) f32 in the output domain
    *,
    relu: bool = False,
    out_dtype=torch.float32,
    body: Optional[str] = None,
) -> torch.Tensor:
    """(N, O) static-scale int8 linear (K15a).  `body` (LINEAR_BODIES)
    overrides linear_body for measurements; a forced body raises on a row
    count it does not take."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, w, alpha, bias, relu=relu, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError("int8_linear takes x (N, K) and w (O, K)")
    _check_types(x, w, out_dtype, "int8_linear")
    chosen = linear_body(x.shape[0]) if body is None else body
    if not linear_takes(chosen, x.shape[0]):
        raise ValueError(f"K15a's {chosen!r} body does not take {x.shape[0]} rows")
    if chosen in ("gemv", "tiles"):
        return _gemm(x[None], w[None], bias, alpha, relu, False, out_dtype, "int8_linear",
                     key=LINEAR_LAUNCH_KEYS[chosen])[0]
    return _linear(x, w, bias, alpha, relu, out_dtype, chosen)


def int8_bmm(
    a: torch.Tensor,                 # (B, M, K) int8
    b: torch.Tensor,                 # (B, N, K) int8, or (B, K, N) with b_kn
    alpha,                           # f32 scalar
    *,
    out_dtype=torch.float32,
    b_kn: bool = False,
    body: Optional[str] = None,
    ranks: Optional[int] = None,
) -> torch.Tensor:
    """(B, M, N) batched int8 product with the α epilogue (K15b).  `body`
    and `ranks` (the kn GEMV's split) override the shape rules (bmm_body,
    kn_ranks) for measurements; a forced body raises on a shape it does not
    take."""
    if a.device.type == "cpu":
        return int8_bmm_plain(a, b, alpha, out_dtype=out_dtype, b_kn=b_kn)
    if a.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {a.device}")
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError("int8_bmm takes a (B, M, K) and b (B, N, K) / (B, K, N)")
    m, kk = a.shape[1], a.shape[2]
    n = b.shape[2] if b_kn else b.shape[1]
    chosen = bmm_body(m, n, kk, b_kn, out_dtype) if body is None else body
    if not _takes(chosen, m, n, kk, b_kn, out_dtype, ranks):
        raise ValueError(f"K15b's {chosen!r} body does not take a {tuple(a.shape)} · b "
                         f"{tuple(b.shape)} (b_kn={b_kn}, {out_dtype})")
    return _gemm(a, b, None, alpha, False, b_kn, out_dtype, "int8_bmm", chosen, ranks)


def _takes(body: str, m: int, n: int, kk: int, b_kn: bool, out_dtype, ranks) -> bool:
    """Whether a K15b body takes the shape (the C entries' limits)."""
    kk16 = -(-kk // 16) * 16
    if body == "qk":
        return m > MAX_GEMV_ROWS and not b_kn and kk16 <= QK_MAX_K and out_dtype == torch.float32
    if body == "pv":
        return m > MAX_GEMV_ROWS and b_kn and kk16 <= PV_MAX_K
    if body == "kn_gemv":
        c = kn_ranks(1, n, kk16) if ranks is None else ranks
        return (m <= MAX_GEMV_ROWS and b_kn and c in KN_SPLITS and kk16 % (16 * c) == 0
                and kk16 // c <= KN_MAX_ROWS)
    if body == "nk_gemv":
        return m <= MAX_GEMV_ROWS and not b_kn and kk16 <= NK_MAX_K
    if body == "gemv":
        return m <= MAX_GEMV_ROWS
    return body == "tiles" and m > MAX_GEMV_ROWS


def quantize_to_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """round(x / scale) saturated to ±127 with a static scale
    (int8.py:183-187); plain tensor code, as in the JAX package."""
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)

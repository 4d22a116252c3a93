"""W4A4 group matmuls over split-half nibble packs: K1 (decode, up to 32
rows), K5 (stacked decode on quantized activations, 33+ rows) and K6
(prefill), each with its plain PyTorch version.

K1  int4_group_matmul_stacked_rawx — port of smoothquant_tpu/kernels/
    int4_group_matmul.py:430 (pallas_call :649).  One decode linear of
    layer `layer_idx` of a stacked tree: optional RMSNorm ("rms") or 0/1
    channel mask ("mask"), salient split (permuted tail, or an external
    pre-gathered x_sal), per-(row, group) activation quantize
    max(absmax, 1e-5)/qmax with round half to even, biased-nibble unpack and
    Σ_g s_x·s_w·(x_q·w_u − 8·Σx_q) + x_sal·w_sal; in one of two bodies
    picked by shape alone (rawx_body): one launch of the weight-streaming
    body with the pre-pass folded in (csrc/stream_gmm.cuh
    stream_rawx_kernel) or the __dp4a body's three launches.
K5  int4_group_matmul_stacked — port of :679 (pallas_call :807).  Layer
    `layer_idx` of a stacked pack on activations already quantized, either
    row-major (N, K) codes with (N, G) scales or, pre_laid = N, K7a's
    (G, N_pad, gs) codes with (G, N_pad) scales: f32 sums seeded by the
    salient dot, then ((p − 8·Σx)·s_x)·s_w for group g and g + G/2 in turn,
    cast to out_dtype; in one of two bodies picked by shape alone
    (stacked_body): the weight-streaming body K8 shares
    (csrc/stream_gmm.cuh) or the mma.sync tiles (gmm_tiles.cuh).  The
    stream body always runs as a programmatic dependent of the kernel
    launched before it (on the stacked path K7's row body): it reads its
    weight operands (w_packed, w_scales_t, w_sal_t) before it waits for
    that kernel, so they must not be that kernel's output.
K6  int4_group_matmul — port of :841 (pallas_call :950).  The same inner
    product on activations that are already quantized (prefill), in one of
    two bodies picked by shape alone (gmm_body): the wgmma ring
    (wg_gmm_kernel) or the mma.sync tiles K5 and K8 share (gmm_tiles.cuh).

CUDA sources: csrc/int4_group_matmul.cu (the design notes live there).
A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build, stream_gmm
from smoothquant_tpu_torch.quant.core import compute_scale, f32_reciprocal, rms_factor

RAWX_MAX_N = 32         # token rows K1 takes (the JAX rawx branch's gate)
RAWX_BODIES = ("stream", "dp4a")
# the launch counter of each K1 body: the stream body counts under the
# kernel's name, so a path that expects it proves the stream body served it
RAWX_LAUNCH_KEYS = {"stream": "int4_group_matmul_stacked_rawx",
                    "dp4a": "int4_group_matmul_stacked_rawx_dp4a"}


@functools.lru_cache(maxsize=64)
def _rawx_workspace_bytes(n: int, o: int, kk: int, gs: int, k_s: int) -> int:
    """Device workspace of one K1 call (the C side plans its split)."""
    return _build.lib().sq_rawx_workspace_bytes(n, o, kk, gs, k_s)


def _unpack_biased(w_packed: torch.Tensor) -> torch.Tensor:
    """(K/2, O) packed bytes → (K, O) float32 BIASED nibbles (value + 8)."""
    w32 = w_packed.to(torch.int32)
    return torch.cat([w32 & 0xF, (w32 >> 4) & 0xF], dim=0).float()


def _group_terms(x_q: torch.Tensor, x_scales: torch.Tensor,
                 w_packed: torch.Tensor, w_scales_t: torch.Tensor,
                 group_size: int) -> torch.Tensor:
    """Σ_g ((x_q·w_u − 8·Σx_q)·s_x)·s_w in f32, groups accumulated in
    order.  The integer products are exact in f32 (|p| < 2^24)."""
    n, kk = x_q.shape
    w_u = _unpack_biased(w_packed)
    xg = x_q.float().reshape(n, kk // group_size, group_size)
    s_x = xg.sum(-1)
    ws = w_scales_t.float()
    acc = torch.zeros((n, w_packed.shape[-1]), dtype=torch.float32,
                      device=x_q.device)
    for g in range(kk // group_size):
        p = xg[:, g] @ w_u[g * group_size:(g + 1) * group_size]
        acc += ((p - 8.0 * s_x[:, g:g + 1]) * x_scales[:, g:g + 1]) * ws[g][None, :]
    return acc


# ---------------------------------------------------------------- K1


def rawx_quantize_plain(x_raw, norm_row, x_sal, *, kk: int, k_s: int,
                        group_size: int, act_bits: int, num_salient: int,
                        eps: float, norm_kind: Optional[str], sal_dtype):
    """K1's activation side: (x_q int8 (N, kk), x_scales f32 (N, G),
    x_sal (N, k_s) rounded to sal_dtype, as f32)."""
    n, c = x_raw.shape
    k_ns_raw = c - num_salient
    p = max(c, kk)
    xf = torch.nn.functional.pad(x_raw.float(), (0, p - c))
    r = None
    if norm_kind == "rms":
        r = rms_factor(xf[:, :c], eps)
    nw = None
    if norm_kind is not None:
        nw = torch.nn.functional.pad(norm_row.float(), (0, p - c))
    if norm_kind == "rms":
        y = xf * r * nw[None, :]
    elif norm_kind == "mask":
        y = xf * nw[None, :]
    else:
        y = xf
    y = y[:, :kk]
    if x_sal is None and kk > k_ns_raw:
        y = y.clone()
        y[:, k_ns_raw:] = 0.0
    yg = y.reshape(n, kk // group_size, group_size)
    scales = compute_scale(yg.abs().amax(dim=-1, keepdim=True), act_bits)
    x_q = torch.round(yg / scales).to(torch.int8).reshape(n, kk)
    if x_sal is not None:
        xs = x_sal.to(sal_dtype).float()
    else:
        xs = torch.zeros((n, k_s), dtype=torch.float32, device=x_raw.device)
        if num_salient:
            sal = xf[:, k_ns_raw:k_ns_raw + num_salient]
            if norm_kind == "rms":
                sal = sal * r * nw[None, k_ns_raw:k_ns_raw + num_salient]
            xs[:, :num_salient] = sal
        xs = xs.to(sal_dtype).float()
    return x_q, scales[..., 0], xs


def rawx_plain(layer_idx: int, x_raw, norm_w, w_packed, w_scales_t, w_sal_t,
               x_sal=None, *, group_size: int, act_bits: int,
               num_salient: int, eps: float = 0.0,
               norm_kind: Optional[str] = "rms", out_dtype=None):
    """Plain PyTorch K1 (same arguments as the wrapper)."""
    half, o = w_packed.shape[1:]
    kk = 2 * half
    k_s = w_sal_t.shape[1]
    nk = norm_kind if norm_w is not None else None
    x_q, x_scales, xs = rawx_quantize_plain(
        x_raw, None if nk is None else norm_w[layer_idx], x_sal, kk=kk,
        k_s=k_s, group_size=group_size, act_bits=act_bits,
        num_salient=num_salient, eps=eps, norm_kind=nk,
        sal_dtype=w_sal_t.dtype)
    acc = (xs @ w_sal_t[layer_idx].float() if k_s
           else torch.zeros((x_raw.shape[0], o), device=x_raw.device))
    acc = acc + _group_terms(x_q, x_scales, w_packed[layer_idx],
                             w_scales_t[layer_idx], group_size)
    return acc.to(out_dtype or x_raw.dtype)


def rawx_body(n: int, c: int, o: int, kk: int, group_size: int, k_s: int, dtype) -> str:
    """The body a CUDA call of K1 runs, by shape alone: "stream" (one launch
    of the weight-streaming body, its pre-pass folded in: bf16 x, 1 to 32
    rows, group size 16, 32 or 64, C a multiple of 8 (16-byte row loads), O
    a multiple of 16 (TMA's weight rows), and a split whose ranks' salient
    tiles fit a block's shared memory — every bf16 decode linear of the
    paths) or
    "dp4a" (the pre-pass, __dp4a main and reduce launches: f32 x, group
    sizes 4-128 others)."""
    if (dtype == torch.bfloat16 and 1 <= n <= stream_gmm.K1_ROWS
            and group_size in STREAM_GROUPS and c % 8 == 0 and o % 16 == 0
            and stream_gmm.k1_split(o, stream_gmm.k5_stages(kk, group_size, k_s, True), n,
                                    group_size, -(-k_s // 32)) is not None):
        return "stream"
    return "dp4a"


def int4_group_matmul_stacked_rawx(
    layer_idx: int,
    x_raw: torch.Tensor,          # (N, C) pre-quant activations
    norm_w: Optional[torch.Tensor],  # (L, C) f32: RMSNorm weight or 0/1 mask
    w_packed: torch.Tensor,       # (L, K/2, O) int8 nibble bytes
    w_scales_t: torch.Tensor,     # (L, G, O) f32 or bf16
    w_sal_t: torch.Tensor,        # (L, k_s, O) compute dtype (= x dtype)
    x_sal: Optional[torch.Tensor] = None,  # (N, k_s) pre-gathered salient
    *,
    group_size: int,
    act_bits: int,
    num_salient: int,
    eps: float = 0.0,
    norm_kind: Optional[str] = "rms",
    out_dtype=None,
    body: Optional[str] = None,   # None: rawx_body's pick; "stream" / "dp4a" force one
) -> torch.Tensor:
    """Fused decode linear for one layer of a stacked tree → (N, O_pad).
    A forced body raises on a shape it does not take."""
    if x_raw.device.type == "cpu":
        return rawx_plain(layer_idx, x_raw, norm_w, w_packed, w_scales_t,
                          w_sal_t, x_sal, group_size=group_size,
                          act_bits=act_bits, num_salient=num_salient, eps=eps,
                          norm_kind=norm_kind, out_dtype=out_dtype)
    if x_raw.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_raw.device}")
    n, c = x_raw.shape
    l_num, half, o = w_packed.shape
    kk, k_s = 2 * half, w_sal_t.shape[1]
    if n > RAWX_MAX_N:
        raise NotImplementedError(f"decode kernel takes N <= {RAWX_MAX_N}")
    if (out_dtype or x_raw.dtype) != x_raw.dtype or w_sal_t.dtype != x_raw.dtype:
        raise TypeError("K1 computes in the activation dtype (w_sal and out)")
    if o % 4 or group_size % 4 or group_size > 128 or half % group_size:
        raise ValueError("K1 needs O % 4 == 0, group_size % 4 == 0 and <= 128, "
                         "and whole groups per half")
    x_raw = x_raw.contiguous()
    nk = norm_kind if norm_w is not None else None
    mode = {"rms": 1, "mask": 2, None: 0}[nk]
    if nk is not None and (norm_w.dtype != torch.float32 or norm_w.shape != (l_num, c)):
        raise TypeError("norm rows must be an (L, C) float32 tensor")
    if x_sal is not None:
        x_sal = x_sal.to(x_raw.dtype).contiguous()
        if x_sal.shape != (n, k_s):
            raise ValueError(f"x_sal {tuple(x_sal.shape)} != {(n, k_s)}")
    if w_packed.dtype != torch.int8 or w_scales_t.shape != (l_num, kk // group_size, o):
        raise TypeError("K1 takes int8 nibble bytes (L, K/2, O), scales (L, G, O)")
    rule = rawx_body(n, c, o, kk, group_size, k_s, x_raw.dtype)
    body = rule if body is None else body
    if body not in RAWX_BODIES or (body == "stream" and rule != "stream"):
        raise ValueError(f"K1's {body!r} body does not take N = {n}, C = {c}, O = {o}, "
                         f"group size {group_size}, {x_raw.dtype}")
    dev = x_raw.device
    _build.check_operands(dev, norm_w=norm_w if nk else None, x_sal=x_sal,
                          w_packed=w_packed, w_scales_t=w_scales_t, w_sal_t=w_sal_t)
    out = torch.empty((n, o), dtype=x_raw.dtype, device=dev)
    qmax_inv = f32_reciprocal(2 ** (act_bits - 1) - 1)
    need_mask = int(x_sal is None and kk > c - num_salient)
    if body == "stream":
        nw = None if nk is None else norm_w[layer_idx]
        x, nw, xs, w, ws, w_sal = (None if t is None else _build.aligned(t) for t in (
            x_raw, nw, x_sal, w_packed[layer_idx], w_scales_t[layer_idx], w_sal_t[layer_idx]))
        n_split = stream_gmm.k1_split(o, stream_gmm.k5_stages(kk, group_size, k_s, True), n,
                                      group_size, -(-k_s // 32))
        _build.check(_build.lib().sq_rawx_stream(
            x.data_ptr(), None if nw is None else nw.data_ptr(),
            None if xs is None else xs.data_ptr(), w.data_ptr(), ws.data_ptr(),
            w_sal.data_ptr(), out.data_ptr(), n, c, o, kk, group_size, c - num_salient,
            num_salient, k_s, mode, need_mask, float(eps), f32_reciprocal(c), qmax_inv,
            _build.dt_code(w_scales_t), n_split, _build.stream_ptr(x_raw)), "sq_rawx_stream")
        _build.LAUNCHES[RAWX_LAUNCH_KEYS[body]] += 1
        return out
    workspace = torch.empty(_rawx_workspace_bytes(n, o, kk, group_size, k_s),
                            dtype=torch.uint8, device=dev)
    _build.check(_build.lib().sq_rawx(
        x_raw.data_ptr(), None if nk is None else norm_w[layer_idx].data_ptr(),
        None if x_sal is None else x_sal.data_ptr(), w_packed[layer_idx].data_ptr(),
        w_scales_t[layer_idx].data_ptr(), w_sal_t[layer_idx].data_ptr(),
        workspace.data_ptr(), out.data_ptr(), n, c, o, kk, group_size,
        c - num_salient, num_salient, k_s, mode, need_mask, float(eps), qmax_inv,
        _build.dt_code(w_scales_t), _build.dt_code(x_raw), _build.stream_ptr(x_raw)), "sq_rawx")
    _build.LAUNCHES[RAWX_LAUNCH_KEYS[body]] += 1
    return out


# ---------------------------------------------------------------- K5


@functools.lru_cache(maxsize=64)
def _gmm_stacked_workspace_bytes(n: int, o: int, kk: int, gs: int) -> int:
    """Bytes of K5's f32 split partials (the C side plans the split)."""
    return _build.lib().sq_gmm_stacked_workspace_bytes(n, o, kk, gs)


def _row_major(x_q, x_scales, pre_laid: Optional[int]):
    """K5's activations as (N, K) int8 codes and (N, G) f32 scales."""
    if pre_laid is None:
        return x_q, x_scales
    g, _, gs = x_q.shape
    return (x_q[:, :pre_laid].permute(1, 0, 2).reshape(pre_laid, g * gs),
            x_scales[:, :pre_laid].t())


def int4_group_matmul_stacked_plain(layer_idx: int, x_q, x_scales, w_packed,
                                    w_scales_t, x_sal, w_sal_t, *,
                                    group_size: int, out_dtype=torch.float32,
                                    pre_laid: Optional[int] = None):
    """Plain PyTorch K5 (same arguments as the wrapper): the salient dot plus
    the group terms added in K order (the TPU kernel seeds its f32 sum with
    the salient dot and interleaves group g and g + G/2: another order)."""
    x_q, x_scales = _row_major(x_q, x_scales, pre_laid)
    acc = _group_terms(x_q, x_scales, w_packed[layer_idx], w_scales_t[layer_idx],
                       group_size)
    if w_sal_t.shape[1]:
        acc = x_sal.float() @ w_sal_t[layer_idx].float() + acc
    return acc.to(out_dtype)


STREAM_GROUPS = (16, 32, 64)   # group sizes of the stream body (one pair a stage)


def stacked_body(n: int, o: int, group_size: int) -> str:
    """The body a CUDA call of K5 runs, by shape alone: "stream" (the
    weight-streaming body K8 shares: 1 to 64 rows — every stacked decode
    linear above K1's 32 — group size 16, 32 or 64, weight rows of whole
    16-byte runs for TMA, O % 16 == 0; both input layouts, f32 and bf16) or
    "tiles" (gmm_kernel's 64 x 64 tiles: more rows, group size 48, O % 16
    != 0)."""
    if 1 <= n <= stream_gmm.MAX_ROWS and group_size in STREAM_GROUPS and o % 16 == 0:
        return "stream"
    return "tiles"


def int4_group_matmul_stacked(
    layer_idx: int,
    x_q: torch.Tensor,        # (N, K) int8, or pre_laid: (G, N_pad, gs) int8
    x_scales: torch.Tensor,   # (N, G) f32, or pre_laid: (G, N_pad) f32
    w_packed: torch.Tensor,   # (L, K/2, O) int8 nibble bytes
    w_scales_t: torch.Tensor, # (L, G, O) f32 or bf16
    x_sal: torch.Tensor,      # (N, k_s) compute dtype
    w_sal_t: torch.Tensor,    # (L, k_s, O) compute dtype
    *,
    group_size: int,
    out_dtype=torch.float32,
    pre_laid: Optional[int] = None,   # the true N of K7a's layout
    body: Optional[str] = None,       # None: stacked_body's pick; "stream" / "tiles" force one
) -> torch.Tensor:
    """Layer `layer_idx` of a stacked int4 group matmul → (N, O) out_dtype.
    A forced body raises on a shape it does not take."""
    if x_q.device.type == "cpu":
        return int4_group_matmul_stacked_plain(
            layer_idx, x_q, x_scales, w_packed, w_scales_t, x_sal, w_sal_t,
            group_size=group_size, out_dtype=out_dtype, pre_laid=pre_laid)
    if x_q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_q.device}")
    l_num, half, o = w_packed.shape
    kk, k_s = 2 * half, w_sal_t.shape[1]
    g = kk // group_size
    if pre_laid is not None:
        n = pre_laid
        n_pad = x_q.shape[1]
        x_shape, s_shape = (g, n_pad, group_size), (g, n_pad)
    else:
        n = x_q.shape[0]
        n_pad = 0
        x_shape, s_shape = (n, kk), (n, g)
    if half % group_size or group_size > 64 or group_size % 16:
        raise ValueError("K5 needs whole groups per half and a group size that is "
                         "a multiple of 16, at most 64")
    if o % 4:
        raise ValueError("K5 needs O % 4 == 0")
    if (x_q.dtype != torch.int8 or w_packed.dtype != torch.int8
            or tuple(x_q.shape) != x_shape or tuple(x_scales.shape) != s_shape
            or x_scales.dtype != torch.float32 or (pre_laid is not None and n > n_pad)
            or w_scales_t.shape != (l_num, g, o)):
        raise TypeError("K5 operand shapes or dtypes do not match: int8 codes "
                        f"{x_shape}, f32 scales {s_shape}")
    if x_sal.shape != (n, k_s) or x_sal.dtype != w_sal_t.dtype:
        raise TypeError(f"x_sal must be ({n}, {k_s}) in the salient block's dtype")
    if out_dtype != w_sal_t.dtype:
        raise TypeError("K5 computes in the salient (compute) dtype, out included")
    rule = stacked_body(n, o, group_size)
    body = rule if body is None else body
    if body not in ("stream", "tiles") or (body == "stream" and rule != "stream"):
        raise ValueError(f"K5's {body!r} body does not take N = {n}, O = {o}, "
                         f"group size {group_size}")
    dev = x_q.device
    x_q, x_scales, x_sal = x_q.contiguous(), x_scales.contiguous(), x_sal.contiguous()
    _build.check_operands(dev, x_scales=x_scales, w_packed=w_packed,
                          w_scales_t=w_scales_t, x_sal=x_sal, w_sal_t=w_sal_t)
    if body == "stream":
        out = torch.empty((n, o), dtype=out_dtype, device=dev)
        bf16 = out_dtype == torch.bfloat16
        pad = -k_s % 8 if bf16 else 0    # x_sal rows of whole 16 bytes (TMA)
        if pad:
            x_sal = torch.nn.functional.pad(x_sal, (0, pad))
        w, ws, w_sal = w_packed[layer_idx], w_scales_t[layer_idx], w_sal_t[layer_idx]
        x_q, x_sal, w, ws, w_sal = (_build.aligned(t) for t in (x_q, x_sal, w, ws, w_sal))
        n_split = stream_gmm.split(o, stream_gmm.k5_stages(kk, group_size, k_s, bf16))
        _build.check(_build.lib().sq_int4_gmm_stacked_stream(
            x_q.data_ptr(), x_scales.data_ptr(), w.data_ptr(), ws.data_ptr(),
            x_sal.data_ptr(), w_sal.data_ptr(), out.data_ptr(), n, o, kk, group_size, k_s,
            k_s + pad, n_pad, n_split, _build.dt_code(w_scales_t), _build.dt_code(w_sal_t),
            _build.stream_ptr(x_q)), "sq_int4_gmm_stacked_stream")
        _build.LAUNCHES["int4_group_matmul_stacked"] += 1
        return out
    workspace = torch.empty(_gmm_stacked_workspace_bytes(n, o, kk, group_size),
                            dtype=torch.uint8, device=dev)
    out = torch.empty((n, o), dtype=out_dtype, device=dev)
    _build.check(_build.lib().sq_int4_gmm_stacked(
        x_q.data_ptr(), x_scales.data_ptr(), w_packed[layer_idx].data_ptr(),
        w_scales_t[layer_idx].data_ptr(), x_sal.data_ptr(),
        w_sal_t[layer_idx].data_ptr(), workspace.data_ptr(), out.data_ptr(), n, o,
        kk, group_size, k_s, n_pad, _build.dt_code(w_scales_t), _build.dt_code(w_sal_t),
        _build.stream_ptr(x_q)), "sq_int4_gmm_stacked")
    _build.LAUNCHES["int4_group_matmul_stacked"] += 1
    return out


# ---------------------------------------------------------------- K6


def int4_group_matmul_plain(x_q, x_scales, w_packed, w_scales_t, x_sal,
                            w_sal_t, *, group_size: int, out_dtype=None):
    """Plain PyTorch K6 (same arguments as the wrapper)."""
    acc = (x_sal.to(w_sal_t.dtype).float() @ w_sal_t.float()
           if x_sal.shape[1] else
           torch.zeros((x_q.shape[0], w_packed.shape[1]), device=x_q.device))
    acc = acc + _group_terms(x_q, x_scales, w_packed, w_scales_t, group_size)
    return acc.to(out_dtype or x_sal.dtype)


def gmm_body(o: int, group_size: int, dtype) -> str:
    """The body a CUDA call of K6 runs, by shape alone: "wgmma" (the
    warp-specialized 128 x 128 tiles of wg_gmm_kernel: bf16 compute dtype,
    whole s8 wgmma k steps in a group (group size 32 or 64), weight rows of
    whole 16-byte runs for TMA (O % 16 == 0); at every row count, as it was
    faster than the tiles at every one chip_smoke.py times, 4 rows included) or
    "tiles" (gmm_kernel's 64 x 64 mma.sync tiles: every other shape K6 takes,
    f32 and group sizes 16 and 48 included)."""
    if dtype == torch.bfloat16 and group_size % 32 == 0 and o % 16 == 0:
        return "wgmma"
    return "tiles"


def int4_group_matmul(
    x_q: torch.Tensor,        # (N, K) int8 quantized activations
    x_scales: torch.Tensor,   # (N, G) f32
    w_packed: torch.Tensor,   # (K/2, O) int8 split-half nibble bytes
    w_scales_t: torch.Tensor, # (G, O) f32 or bf16
    x_sal: torch.Tensor,      # (N, K_s) compute dtype
    w_sal_t: torch.Tensor,    # (K_s, O) compute dtype
    *,
    group_size: int,
    out_dtype=None,
) -> torch.Tensor:
    """Prefill int4 group matmul → (N, O)."""
    if x_q.device.type == "cpu":
        return int4_group_matmul_plain(x_q, x_scales, w_packed, w_scales_t,
                                       x_sal, w_sal_t, group_size=group_size,
                                       out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_q.device}")
    n, kk = x_q.shape
    half, o = w_packed.shape
    k_s = w_sal_t.shape[0]
    dt = out_dtype or x_sal.dtype
    if kk != 2 * half or half % group_size or group_size > 64 or group_size % 16:
        raise ValueError("K6 needs K = 2·(K/2), whole groups per half and a "
                         "group size that is a multiple of 16, at most 64")
    if o % 4:
        raise ValueError("K6 needs O % 4 == 0")
    if dt != w_sal_t.dtype:
        raise TypeError("K6 computes in the salient (compute) dtype")
    if (x_q.dtype != torch.int8 or w_packed.dtype != torch.int8
            or x_scales.shape != (n, kk // group_size)
            or w_scales_t.shape != (kk // group_size, o) or x_sal.shape != (n, k_s)):
        raise TypeError("K6 operand shapes or dtypes do not match")
    x_q = x_q.contiguous()
    x_scales = x_scales.float().contiguous()
    x_sal = x_sal.to(w_sal_t.dtype).contiguous()
    _build.check_operands(x_q.device, x_scales=x_scales, w_packed=w_packed,
                          w_scales_t=w_scales_t, x_sal=x_sal, w_sal_t=w_sal_t)
    out = torch.empty((n, o), dtype=dt, device=x_q.device)
    if gmm_body(o, group_size, dt) == "wgmma":
        # whole 64-column stages of the salient block (zero rows add
        # nothing), every operand 16-byte aligned for TMA
        pad = -k_s % 64
        if pad:
            x_sal = torch.nn.functional.pad(x_sal, (0, pad))
            w_sal_t = torch.nn.functional.pad(w_sal_t, (0, 0, 0, pad))
        x_q, x_sal, w_packed, w_scales_t, w_sal_t = (
            _build.aligned(t) for t in (x_q, x_sal, w_packed, w_scales_t, w_sal_t))
        _build.check(_build.lib().sq_int4_gmm_wg(
            x_q.data_ptr(), x_scales.data_ptr(), w_packed.data_ptr(),
            w_scales_t.data_ptr(), x_sal.data_ptr(), w_sal_t.data_ptr(), out.data_ptr(),
            n, o, kk, group_size, k_s + pad, _build.dt_code(w_scales_t),
            _build.stream_ptr(x_q)), "sq_int4_gmm_wg")
    else:
        _build.check(_build.lib().sq_int4_gmm(
            x_q.data_ptr(), x_scales.data_ptr(),
            w_packed.data_ptr(), w_scales_t.data_ptr(), x_sal.data_ptr(),
            w_sal_t.data_ptr(), out.data_ptr(), n, o, kk, group_size, k_s,
            _build.dt_code(w_scales_t), _build.dt_code(out),
            _build.stream_ptr(x_q)), "sq_int4_gmm")
    _build.LAUNCHES["int4_group_matmul"] += 1
    return out

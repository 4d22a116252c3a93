"""The fused SwiGLU MLP of a decode layer (K14), with its plain PyTorch
version and the JAX gate that decides when it runs.

K14 mlp_swiglu_fused_stacked — port of smoothquant_tpu/kernels/
    mlp_fused.py:348 (pallas_call :534).  Layer `layer_idx` of stacked
    nibble packs: optional RMSNorm of the (N, C) residual (N <= 8), gate_up's
    per-group activation quantize and int4 group matmul, SiLU(gate)·up in
    f32, the salient and pad channels of down's input masked, its group
    quantize and down's int4 group matmul — the f32 composition of the two
    rawx launches (tests/test_mlp_fused.py:56-69), cast to out_dtype.  The
    layout contract (mlp_fused.py:22-28): gate_up's [gate | up] columns
    split at out_features / 2 and pre-permuted into down's packed channel
    order (fold_input_perm), down pre-permuted with its salient channels
    last.

CUDA source: csrc/mlp_fused.cu, two bodies picked by shape alone
(mlp_body).  The stream body — every bf16 call of 1-8 rows at group size
16, 32 or 64 with O % 16 == 0, each fuse_mlp site of the paths — is two
launches of the weight-streaming body (csrc/stream_gmm.cuh) and no grid
barrier: gate_up on K1's raw-x kind with a paired column map (tile t takes
gate columns 64t .. and up columns inter + 64t ..: stream_gmm.k14_columns),
its epilogue SiLU(gate)·up in f32 and down's group quantize into row-major
codes; then down on K5's stream kind over those codes, chained behind the
first launch as a programmatic dependent.  Its launches count under
"mlp_swiglu_fused_stacked" (gate_up) and "mlp_swiglu_fused_stacked_down".
The cooperative body (one launch, five grid barriers, K1's dp4a warp body:
f32 x, group size 128, or body="coop") counts under
"mlp_swiglu_fused_stacked_coop"; its K-splits follow the grid the card
holds.  The wrapper runs the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build, stream_gmm
from smoothquant_tpu_torch.kernels.int4_group_matmul import STREAM_GROUPS, rawx_plain
from smoothquant_tpu_torch.quant.core import f32_reciprocal

MAX_N = 8     # token rows (mlp_fused.py:326, 392)
BODIES = ("stream", "coop")
# each body's launch counters, one a kernel it launches
LAUNCH_KEYS = {"stream": ("mlp_swiglu_fused_stacked", "mlp_swiglu_fused_stacked_down"),
               "coop": ("mlp_swiglu_fused_stacked_coop",)}


def gate_up_split(n: int, inter: int, kk1: int, k_s1: int, group_size: int):
    """The ranks of the stream body's gate_up launch: K1's rule
    (stream_gmm.k1_split) over its k14_tiles(inter) tiles; None where no
    split fits a block's shared memory."""
    return stream_gmm.k1_split(stream_gmm.TILE_COLS * stream_gmm.k14_tiles(inter),
                               stream_gmm.k5_stages(kk1, group_size, k_s1, True), n,
                               group_size, -(-k_s1 // 32))


def mlp_body(n: int, c: int, o1: int, kk1: int, k_s1: int, o2: int, inter: int,
             group_size: int, dtype) -> str:
    """The body a CUDA call of K14 runs, by shape alone: "stream" (two
    launches of the weight-streaming body: bf16 x of 1-8 rows, C a multiple
    of 8, group size 16, 32 or 64, O1 and O2 multiples of 16, an
    intermediate width that is a multiple of 16 (the up halves' TMA boxes
    start at column inter + 64t, and a box starts on a 16-byte boundary),
    and a split of gate_up's tiles whose salient tiles fit a block's shared
    memory) or "coop" (the cooperative launch: f32 x, group size 128 and
    the rest)."""
    if (dtype == torch.bfloat16 and 1 <= n <= MAX_N and group_size in STREAM_GROUPS
            and c % 8 == 0 and o1 % 16 == 0 and o2 % 16 == 0 and inter % 16 == 0
            and gate_up_split(n, inter, kk1, k_s1, group_size) is not None):
        return "stream"
    return "coop"


def _pick_chunk(gs: int, inter_true: int, half2: int) -> Optional[int]:
    """The TPU kernel's scratch chunk (mlp_fused.py:335-339); the gate only."""
    for c in (256, 128, 64, 32, 16, 8):
        if c % gs == 0 and inter_true % c == 0 and half2 % c == 0:
            return c
    return None


def mlp_fused_supported(gu_meta, dn_meta, n_tokens: int) -> bool:
    """The JAX gate (mlp_fused.py:306-332): both linears nibble-packed with
    matching per-group recipes, both pre-permuted, gate_up twice as wide as
    down's input, at most 8 token rows, chunk-alignable widths."""
    if gu_meta is None or dn_meta is None:
        return False
    if not (gu_meta.nibble and dn_meta.nibble):
        return False
    for m in (gu_meta, dn_meta):
        if m.act_quant in ("per_token", "per_tensor") or m.act_group_size != m.group_size:
            return False
    if gu_meta.group_size != dn_meta.group_size:
        return False
    if not (gu_meta.pre_permuted and dn_meta.pre_permuted):
        return False
    if gu_meta.out_features != 2 * dn_meta.in_features or n_tokens > MAX_N:
        return False
    return _pick_chunk(gu_meta.group_size, dn_meta.in_features, dn_meta.k_ns // 2) is not None


def mlp_swiglu_fused_stacked_plain(layer_idx: int, x_raw, norm_w, gu_wp, gu_ws, gu_sal,
                                   dn_wp, dn_ws, dn_sal, *, group_size: int, act_bits: int,
                                   n_sal1: int, n_sal2: int, gu_out_true: int,
                                   dn_out_true: int, eps: float = 0.0, out_dtype=None):
    """Plain PyTorch K14 (the wrapper's arguments): K1's plain version for
    gate_up (norm fused, f32 out), SiLU(gate)·up in f32, K1's plain version
    for down (f32), cast to out_dtype."""
    kw = dict(group_size=group_size, act_bits=act_bits)
    norm = None if norm_w is None else norm_w.float()[None].expand(gu_wp.shape[0], -1)
    gu = rawx_plain(layer_idx, x_raw, norm, gu_wp, gu_ws, gu_sal, num_salient=n_sal1,
                    eps=eps, norm_kind="rms" if norm is not None else None,
                    out_dtype=torch.float32, **kw)
    inter = gu_out_true // 2
    h = torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:2 * inter]
    y = rawx_plain(layer_idx, h, None, dn_wp, dn_ws, dn_sal, num_salient=n_sal2,
                   norm_kind=None, out_dtype=torch.float32, **kw)
    return y[:, :dn_out_true].to(out_dtype or x_raw.dtype)


def mlp_swiglu_fused_stacked(
    layer_idx: int,
    x_raw: torch.Tensor,           # (N, C) pre-norm residual, permuted order
    norm_w: Optional[torch.Tensor],  # (C,) RMSNorm weight (rounded to x's dtype) or None
    gu_wp: torch.Tensor,           # (L, K1/2, O1p) int8 nibble bytes of gate_up
    gu_ws: torch.Tensor,           # (L, G1, O1p) f32 / bf16
    gu_sal: torch.Tensor,          # (L, k_s1, O1p) compute dtype
    dn_wp: torch.Tensor,           # (L, K2/2, O2p) int8 nibble bytes of down
    dn_ws: torch.Tensor,           # (L, G2, O2p)
    dn_sal: torch.Tensor,          # (L, k_s2, O2p)
    *,
    group_size: int,
    act_bits: int,
    n_sal1: int,
    n_sal2: int,
    gu_out_true: int,              # gate_up's true out_features (2 · intermediate)
    dn_out_true: int,              # down's true out_features (hidden)
    eps: float = 0.0,
    out_dtype=None,
    body: Optional[str] = None,    # None: mlp_body's pick; "stream" / "coop" force one
) -> torch.Tensor:
    """down(silu(gate(x)) · up(x)) of layer `layer_idx` → (N, dn_out_true).
    A forced body raises on a shape it does not take."""
    kw = dict(group_size=group_size, act_bits=act_bits, n_sal1=n_sal1, n_sal2=n_sal2,
              gu_out_true=gu_out_true, dn_out_true=dn_out_true, eps=eps,
              out_dtype=out_dtype)
    if x_raw.device.type == "cpu":
        return mlp_swiglu_fused_stacked_plain(layer_idx, x_raw, norm_w, gu_wp, gu_ws, gu_sal,
                                              dn_wp, dn_ws, dn_sal, **kw)
    if x_raw.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_raw.device}")
    n, c = x_raw.shape
    l_num, half1, o1 = gu_wp.shape
    _, half2, o2 = dn_wp.shape
    kk1, kk2, gs = 2 * half1, 2 * half2, group_size
    k_s1, k_s2 = gu_sal.shape[1], dn_sal.shape[1]
    inter = gu_out_true // 2
    if n > MAX_N:
        raise NotImplementedError(f"K14 takes at most {MAX_N} token rows, not {n}")
    if (out_dtype or x_raw.dtype) != x_raw.dtype or gu_sal.dtype != x_raw.dtype \
            or dn_sal.dtype != x_raw.dtype:
        raise TypeError("K14 computes in the activation dtype (salient blocks and out)")
    if (gs % 4 or gs > 128 or half1 % gs or half2 % gs or o1 % 4 or o2 % 4
            or gu_out_true > o1 or 2 * inter != gu_out_true or kk2 < inter - n_sal2
            or kk1 < c - n_sal1 or dn_out_true > o2):
        raise ValueError("K14 needs whole groups per half (group size a multiple of 4, "
                         "at most 128), O % 4 == 0 and widths that fit the packs")
    if (gu_wp.dtype != torch.int8 or dn_wp.dtype != torch.int8
            or gu_ws.shape != (l_num, kk1 // gs, o1) or dn_ws.shape != (l_num, kk2 // gs, o2)
            or dn_wp.shape[0] != l_num or gu_ws.dtype != dn_ws.dtype):
        raise TypeError("K14 takes int8 nibble bytes (L, K/2, O) and scales (L, G, O) "
                        "of one dtype for both linears")
    x_raw = x_raw.contiguous()
    if norm_w is not None:
        norm_w = norm_w.float().contiguous()
        if norm_w.shape != (c,):
            raise ValueError(f"norm row {tuple(norm_w.shape)} != ({c},)")
    dev = x_raw.device
    _build.check_operands(dev, norm_w=norm_w, gu_wp=gu_wp, gu_ws=gu_ws, gu_sal=gu_sal,
                          dn_wp=dn_wp, dn_ws=dn_ws, dn_sal=dn_sal)
    s_dt, x_dt = _build.dt_code(gu_ws), _build.dt_code(x_raw)
    rule = mlp_body(n, c, o1, kk1, k_s1, o2, inter, gs, x_raw.dtype)
    body = rule if body is None else body
    if body not in BODIES or (body == "stream" and rule != "stream"):
        raise ValueError(f"K14's {body!r} body does not take N = {n}, C = {c}, O1 = {o1}, "
                         f"O2 = {o2}, group size {gs}, {x_raw.dtype}")
    if body == "stream":
        split1 = gate_up_split(n, inter, kk1, k_s1, gs)
        split2 = stream_gmm.split(o2, stream_gmm.k5_stages(kk2, gs, k_s2, True))
        xsal_rs = k_s2 + (-k_s2 % 8)      # x_sal rows of whole 16 bytes (TMA)
        xq2 = torch.empty((n, kk2), dtype=torch.int8, device=dev)
        xs2 = torch.empty((n, kk2 // gs), dtype=torch.float32, device=dev)
        xsal2 = torch.empty((n, xsal_rs), dtype=x_raw.dtype, device=dev) if k_s2 else None
        out = torch.empty((n, o2), dtype=x_raw.dtype, device=dev)
        x, nw, w1, ws1, wsal1, w2, ws2, wsal2 = (None if t is None else _build.aligned(t) for t in (
            x_raw, norm_w, gu_wp[layer_idx], gu_ws[layer_idx], gu_sal[layer_idx],
            dn_wp[layer_idx], dn_ws[layer_idx], dn_sal[layer_idx]))
        ptr = lambda t: None if t is None else t.data_ptr()
        _build.check(_build.lib().sq_mlp_stream(
            x.data_ptr(), ptr(nw), w1.data_ptr(), ws1.data_ptr(), wsal1.data_ptr(),
            w2.data_ptr(), ws2.data_ptr(), wsal2.data_ptr(), xq2.data_ptr(), xs2.data_ptr(),
            ptr(xsal2), out.data_ptr(), n, c, o1, kk1, n_sal1, k_s1, inter, o2, kk2, n_sal2,
            k_s2, xsal_rs, gs, int(nw is not None), float(eps), f32_reciprocal(c),
            f32_reciprocal(2 ** (act_bits - 1) - 1), s_dt, split1, split2,
            _build.stream_ptr(x_raw)), "sq_mlp_stream")
        for key in LAUNCH_KEYS["stream"]:
            _build.LAUNCHES[key] += 1
        return out[:, :dn_out_true]
    workspace = torch.empty(_build.lib().sq_mlp_fused_workspace_bytes(
        n, o1, kk1, k_s1, inter, o2, kk2, k_s2, gs, s_dt, x_dt), dtype=torch.uint8, device=dev)
    out = torch.empty((n, o2), dtype=x_raw.dtype, device=dev)
    _build.check(_build.lib().sq_mlp_fused(
        x_raw.data_ptr(), None if norm_w is None else norm_w.data_ptr(),
        gu_wp[layer_idx].data_ptr(), gu_ws[layer_idx].data_ptr(), gu_sal[layer_idx].data_ptr(),
        dn_wp[layer_idx].data_ptr(), dn_ws[layer_idx].data_ptr(), dn_sal[layer_idx].data_ptr(),
        workspace.data_ptr(), out.data_ptr(), n, c, o1, kk1, n_sal1, k_s1, inter, o2, kk2,
        n_sal2, k_s2, gs, int(norm_w is not None), float(eps),
        f32_reciprocal(2 ** (act_bits - 1) - 1), s_dt, x_dt, _build.stream_ptr(x_raw)),
        "sq_mlp_fused")
    _build.LAUNCHES[LAUNCH_KEYS["coop"][0]] += 1
    return out[:, :dn_out_true]

"""Real-quantized linear forward (port of smoothquant_tpu/kernels/
real_linear.py:70-133,200-479).

  stacked (layer_idx given), nibble, per-group recipe, N <= K1_MAX_TOKENS (4):
    * fused RMSNorm (qkv, gate_up over the shared residual basis) → K1 "rms"
    * pre-permuted input, no norm (down_proj)                     → K1 raw
    * input in the original channel order (Bloom's packs): gathered by
      perm[layer_idx] first (real_linear.py:268-272), no norm    → K1 raw
    * identity layout (o_proj): 0/1 ns_mask + k_s-wide salient
      gather                                                     → K1 "mask"
  the same call sites at 4 < N <= RAWX_MAX_N (32), activations made as K1
    makes them (k1_rows_operands; the JAX package takes its rawx branch):
    * fused RMSNorm (qkv, gate_up) in f32, salient split, into K5's
      layout: one launch of K7's row body                       → K7b + K5
    * pre-permuted or gathered input, no norm: the salient split and
      the quantize in one launch of the row body                → K7a + K5
    * identity layout: _identity_nibble_quantize             → K5 row-major
  the same call sites at N > 32 (real_linear.py:320-331,351-386):
    * pre-permuted input with a fused norm (qkv, gate_up): the RMSNorm
      rounded to x's dtype ("rms_round"), salient split and quantize in
      one launch of the row body                                → K7b + K5
    * down, or gathered input: as at 5-32 rows                  → K7a + K5
    * identity layout: _identity_nibble_quantize             → K5 row-major
  K5's stream kind follows each prep as a programmatic dependent, nothing
  launched between them (the salient block in the rows' dtype comes from
  PackedLinear.salient_block, cast once a pack, before the prep)
  the whole MLP of a stacked decode layer at N <= 8 (ForwardContext.fuse_mlp,
    real_linear.py:148-197)                                     → K14
  per-layer (real_linear.py:400-470):
    * identity int8, not nibble (promote_int8's prefill packs, the
      per-channel lm_head) → masked per-token quantize, then K4 at >= 256
      rows, else one torch._int_mm product with the per-token × per-column
      epilogue (as the JAX package leaves it to an XLA int8 dot below 256
      rows);
    * identity nibble → _identity_nibble_quantize + K6;
    * permuted (the input gathered by perm unless pre-permuted), with
      `compute` choosing the kernel:
        nibble → always "int": quantize_activations_packed_int + K6 (per-
          group, per-token or per-tensor recipes, the latter two on
          broadcast scales);
        int8 container, "int" → quantize_activations_packed_int + K8;
        int8 container, "dequant" → quantize_activations_packed (Q-DQ) +
          K9;
        "auto" → "int" for a single-group recipe at any token count, or a
          grouped one up to INT_PATH_MAX_TOKENS rows, else "dequant" — and
          "dequant" whenever the int path cannot take the recipe (act_bits
          > 8, or activation groups unlike the weight's), where forcing
          "int" raises ValueError.

Every other branch raises NotImplementedError: nothing detours silently.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoothquant_tpu_torch.kernels.int8_prefill import (
    int8_prefill_matmul,
    int_mm,
    scale_epilogue,
)
from smoothquant_tpu_torch.kernels.act_prep import (
    norm_quantize_acts_t,
    quantize_acts_split_t,
)
from smoothquant_tpu_torch.kernels.mlp_fused import (
    mlp_fused_supported,
    mlp_swiglu_fused_stacked,
)
from smoothquant_tpu_torch.kernels.int4_group_matmul import (
    RAWX_MAX_N,
    int4_group_matmul,
    int4_group_matmul_stacked,
    int4_group_matmul_stacked_rawx,
)
from smoothquant_tpu_torch.kernels.int_group_matmul import int_group_matmul
from smoothquant_tpu_torch.kernels.pack import (
    PackedLinear,
    quantize_activations_packed,
    quantize_activations_packed_int,
)
from smoothquant_tpu_torch.kernels.quant_matmul import dual_path_matmul
from smoothquant_tpu_torch.quant import core

# identity-int8 forward: from this many rows K4, below them torch._int_mm
# plus the epilogue.  Measured by chip_smoke.py's prefill_kernel_crossover
# (NVIDIA H100 80GB HBM3, 700 W), with K4 on its s8 wgmma body: at
# Llama-2-7B's promoted gate_up and down K4 wins at every row count timed,
# from 4 (0.093 against 0.128 ms and 0.083 against 0.113; at 128 rows 0.104
# against 0.231 and 0.101 against 0.146).  (With K4's mma.sync tiles the two
# together crossed at 256 rows, and this was 256.)
PREFILL_KERNEL_MIN_TOKENS = 4
# per-layer int8-container packs of a grouped recipe, compute="auto": up to
# this many rows the int path (K8), above it the dequant path (K9).
# Measured by chip_smoke.py's int_path_crossover (NVIDIA H100 80GB HBM3,
# 700 W; real_quant_linear with its activation prep, the quick start's
# W4A4 g64 pack), with K9's warp-specialized wgmma body: the dequant path
# wins on both gate_proj and down_proj from 128 rows (gate 0.128 against
# 0.246 ms, down 0.249 against 0.263), the int path on down up to 64 (0.213
# against 0.231 ms).  (With K9's mma.sync body the crossover lay at 512 rows
# and this was 256; with its first wgmma body at 256, and this was 128.)
INT_PATH_MAX_TOKENS = 64
# stacked decode linears: up to this many rows K1, above it K5 (its stream
# body) on activations made as K1 makes them, up to RAWX_MAX_N rows.
# Measured by chip_smoke.py's k1_vs_k5 (NVIDIA H100 80GB HBM3, 700 W; a
# Llama-2-7B layer's four sites, activation prep included, cold), with K1 on
# its stream body (one launch, the pre-pass folded in): K1 0.092, 0.108,
# 0.155, 0.294, 0.653 ms against K5's route 0.139, 0.146, 0.147, 0.155,
# 0.182 at 1, 4, 8, 16, 32 rows.  K1's quantizer warps make every (row,
# group) of a block's K range, so its cost grows with the rows where the
# route quantizes once; the route wins from 8 rows, so K1 keeps 1-4.  (K1's
# dp4a body in the same run: 0.128, 0.160, 0.280, 0.367, 0.604 ms, the same
# boundary; before the stream body for K5 it was RAWX_MAX_N, the JAX rawx
# branch's gate.)
K1_MAX_TOKENS = 4
COMPUTE_CHOICES = ("auto", "int", "dequant")


def _int_path_supported(meta) -> bool:
    """The int path's recipes (real_linear.py:128-133): activation codes that
    fit int8, with one scale per weight group (per-token, per-tensor, or
    activation groups equal to the weight's)."""
    if meta.act_bits > 8:
        return False
    if meta.act_quant in ("per_token", "per_tensor"):
        return True
    return meta.act_group_size == meta.group_size


def choose_compute(meta, n_tokens: int, compute: str = "auto") -> str:
    """The kernel path a permuted pack takes (real_linear.py:432-445)."""
    if meta.nibble:
        compute = "int"   # nibble storage is only consumable by the int path
    elif compute == "auto":
        if not _int_path_supported(meta):
            compute = "dequant"
        elif meta.group_size >= meta.k_ns:
            compute = "int"   # one full-depth int8 contraction wins at any N
        else:
            compute = "int" if n_tokens <= INT_PATH_MAX_TOKENS else "dequant"
    if compute == "int" and not _int_path_supported(meta):
        raise ValueError("int compute path unsupported for this recipe")
    return compute


def _grouped(meta) -> bool:
    return (meta.act_quant not in ("per_token", "per_tensor")
            and meta.act_group_size == meta.group_size)


def can_fuse_norm(packed) -> bool:
    """A preceding RMSNorm folds into K1 for this pack: input pre-permuted
    (shared residual basis), nibble, permuted layout, matched groups."""
    if not isinstance(packed, PackedLinear):
        return False
    m = packed.meta
    return m.pre_permuted and m.nibble and m.layout != "identity" and _grouped(m)


def can_fuse_mlp(gu, dn, n_tokens: int) -> bool:
    """gate_up + SwiGLU + down run as one K14 launch (real_linear.py:148-161):
    both stacked nibble packs with matching per-group recipes, gate_up's
    rows pre-permuted into down's packed order, at most 8 token rows, a
    bias-free gate_up."""
    if not (isinstance(gu, PackedLinear) and isinstance(dn, PackedLinear)):
        return False
    if gu.bias is not None or gu.w_qt.ndim != 3 or dn.w_qt.ndim != 3:
        return False
    return mlp_fused_supported(gu.meta, dn.meta, n_tokens)


def real_mlp_fused(gu: PackedLinear, dn: PackedLinear, x: torch.Tensor, *,
                   layer_idx: int, norm: Optional[tuple] = None,
                   out_dtype=None) -> torch.Tensor:
    """down(silu(gate(x)) · up(x)) of layer `layer_idx` in one K14 call
    (real_linear.py:164-197); norm = (the layer's (C,) RMSNorm row, eps,
    "rms").  The salient blocks are taken in x's dtype, as the JAX wrapper
    casts them (cast once a pack, PackedLinear.salient_block)."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    norm_row, eps = None, 0.0
    if norm is not None:
        norm_row, n_eps, kind = norm
        if kind != "rms" or not can_fuse_norm(gu):
            raise NotImplementedError("K14 fuses an RMSNorm into a pre-permuted gate_up")
        norm_row = norm_row.to(x.dtype)
        eps = float(n_eps)
    y = mlp_swiglu_fused_stacked(
        layer_idx, x2d, norm_row, gu.w_qt, gu.w_scales_t, gu.salient_block(x.dtype),
        dn.w_qt, dn.w_scales_t, dn.salient_block(x.dtype), group_size=gu.meta.group_size,
        act_bits=gu.meta.act_bits, n_sal1=gu.meta.num_salient, n_sal2=dn.meta.num_salient,
        gu_out_true=gu.meta.out_features, dn_out_true=dn.meta.out_features, eps=eps,
        out_dtype=out_dtype or x.dtype)
    if dn.bias is not None:
        y = y + dn.bias[layer_idx].to(y.dtype)
    return y.reshape(*shape[:-1], y.shape[-1])


def identity_int8_quantize(packed: PackedLinear, x2d: torch.Tensor):
    """The prologue of the identity-int8 forward (real_linear.py:81-104):
    (x_q int8 (N, C), s_x f32 (N, 1), x_sal (N, k_s) and the salient block
    (k_s, O) in the block's dtype; k_s = 0 without salient channels).  The
    salient channels are masked out of the per-token int8 quantize and
    gathered k_s wide."""
    meta = packed.meta
    c = meta.in_features
    xf = x2d.float()
    k_s = packed.w_sal_t.shape[0] if meta.num_salient else 0
    x_sal = torch.zeros((x2d.shape[0], k_s), dtype=packed.w_sal_t.dtype, device=x2d.device)
    if meta.num_salient:
        sal_idx = packed.perm[c - meta.num_salient:]
        ns = packed.ns_mask
        if ns is None:
            ns = torch.ones(c, dtype=torch.float32, device=x2d.device)
            ns[sal_idx] = 0.0
        xf = xf * ns[None, :]
        x_sal[:, :meta.num_salient] = x2d.index_select(1, sal_idx).to(x_sal.dtype)
    sx = core.compute_scale(xf.abs().amax(dim=-1, keepdim=True), 8)
    x_q = torch.round(xf / sx).to(torch.int8)
    return x_q, sx, x_sal, packed.w_sal_t[:k_s]


def _identity_int8_forward(packed: PackedLinear, x2d: torch.Tensor,
                           out_dtype) -> torch.Tensor:
    """promote_int8's identity layout and the per-channel int8 lm_head
    (real_linear.py:70-125): the masked per-token int8 quantize, then ONE
    full-depth int8 product with the acc·s_x·s_w epilogue and the salient
    dot — K4 at PREFILL_KERNEL_MIN_TOKENS rows and above, below them
    torch._int_mm, the f32 epilogue and a matmul for the salient part (the
    JAX package leaves that case to XLA dots outside any Pallas kernel)."""
    x_q, sx, x_sal, w_sal_t = identity_int8_quantize(packed, x2d)
    sw_t = packed.w_scales_t.float().reshape(1, -1)
    if x2d.shape[0] >= PREFILL_KERNEL_MIN_TOKENS:
        return int8_prefill_matmul(x_q, sx, packed.w_qt, sw_t, x_sal, w_sal_t,
                                   out_dtype=out_dtype)
    sal = torch.matmul(x_sal, w_sal_t) if x_sal.shape[1] else None
    return scale_epilogue(int_mm(x_q, packed.w_qt), sx, sw_t, sal).to(out_dtype)


def _identity_nibble_quantize(packed: PackedLinear, x2d: torch.Tensor,
                              perm_row, mask_row):
    """(x_q, x_scales, x_sal) for the identity nibble layout: original-
    order group quantize with the salient channels masked to zero, the
    salient slice a k_s-wide gather (real_linear.py:200-223)."""
    meta = packed.meta
    n, c = x2d.shape
    xf = x2d.float() * mask_row.float()[None, :]
    if meta.k_ns != c:
        xf = torch.nn.functional.pad(xf, (0, meta.k_ns - c))
    x_q, x_scales = core.quantize_groups_int(xf, meta.act_bits, meta.group_size)
    return x_q, x_scales, _salient_gather(packed, x2d, perm_row)


def _salient_gather(packed: PackedLinear, x2d: torch.Tensor, perm_row):
    meta = packed.meta
    x_sal = torch.zeros((x2d.shape[0], meta.k_s), dtype=x2d.dtype,
                        device=x2d.device)
    if meta.num_salient:
        sal_idx = perm_row[meta.in_features - meta.num_salient:]
        x_sal[:, :meta.num_salient] = x2d.index_select(1, sal_idx)
    return x_sal


def _prep_operands(packed: PackedLinear, x2d: torch.Tensor, layer_idx: int,
                   norm: Optional[tuple], norm_kind: str):
    """K5's operands of a permuted layout in one launch of K7's row body:
    with a fused norm K7b in `norm_kind`, else K7a with the salient split.
    Returns (x_q, x_scales, x_sal, pre_laid), x_sal in x's dtype."""
    meta = packed.meta
    kw = dict(group_size=meta.group_size, act_bits=meta.act_bits, k_ns=meta.k_ns,
              num_salient=meta.num_salient, k_s=meta.k_s, sal_dtype=x2d.dtype)
    if norm is None:
        x3, xs_t, x_sal = quantize_acts_split_t(x2d, **kw)
    else:
        norm_rows, eps, kind = norm
        if kind != "rms":
            raise NotImplementedError(f"norm kind {kind!r}")
        x3, xs_t, x_sal = norm_quantize_acts_t(x2d, norm_rows[layer_idx], eps=float(eps),
                                               norm_kind=norm_kind, **kw)
    n = x2d.shape[0]
    return x3, xs_t, x_sal[:n], n


def many_rows_operands(packed: PackedLinear, x2d: torch.Tensor, layer_idx: int,
                       norm: Optional[tuple] = None):
    """K5's operands for the stacked decode linear at N > 32 rows
    (real_linear.py:320-331,351-386): (x_q, x_scales, x_sal, pre_laid).
    The identity layout quantizes in original channel order into row-major
    codes (pre_laid None); a permuted one takes one launch of K7's row body
    from x2d, in the pack's channel order (pre-permuted, or gathered by the
    caller): the preceding RMSNorm as models/common.rms_norm computes it,
    rounded to x's dtype ("rms_round", not K1's in-kernel f32), the salient
    tail split and K7a's quantize."""
    meta = packed.meta
    if meta.layout == "identity":
        if norm is not None:
            raise NotImplementedError("identity layout call sites fuse no norm")
        return (*_identity_nibble_quantize(packed, x2d, packed.perm[layer_idx],
                                           packed.ns_mask[layer_idx]), None)
    return _prep_operands(packed, x2d, layer_idx, norm, "rms_round")


def k1_rows_operands(packed: PackedLinear, x2d: torch.Tensor, layer_idx: int,
                     norm: Optional[tuple] = None):
    """K5's operands at K1's row counts (up to RAWX_MAX_N), made as K1 makes
    its codes: a fused RMSNorm in f32 by K7b's "rms" (the rule K1's pre-pass
    takes, so the same codes, where many_rows_operands rounds the normed
    rows to x's dtype first as the JAX many-rows branch does); the identity
    and no-norm sites as many_rows_operands makes them (the same codes as
    K1's mask and raw modes).  Returns (x_q, x_scales, x_sal, pre_laid)."""
    if norm is None:
        return many_rows_operands(packed, x2d, layer_idx)
    return _prep_operands(packed, x2d, layer_idx, norm, "rms")


def _stacked_linear(packed: PackedLinear, x2d: torch.Tensor, layer_idx: int,
                    norm: Optional[tuple], out_dtype) -> torch.Tensor:
    meta = packed.meta
    if not (meta.nibble and _grouped(meta) and meta.act_bits <= 8):
        raise NotImplementedError(
            "stacked decode takes nibble packs with a per-group recipe")
    if meta.layout != "identity" and not meta.pre_permuted:
        # input in the original channel order: gather it into the pack's
        # (real_linear.py:268-272; one index_select a call, as in JAX)
        if norm is not None:
            raise NotImplementedError("a fused norm needs pre-permuted input")
        x2d = x2d.index_select(1, packed.perm[layer_idx])
    # the salient block in x's dtype, cast once a pack (PackedLinear.salient_block)
    w_sal = packed.salient_block(x2d.dtype)
    if x2d.shape[0] > K1_MAX_TOKENS:
        prep = k1_rows_operands if x2d.shape[0] <= RAWX_MAX_N else many_rows_operands
        x_q, x_scales, x_sal, pre_laid = prep(packed, x2d, layer_idx, norm)
        # K5 next, with no launch between it and the prep that feeds it
        return int4_group_matmul_stacked(
            layer_idx, x_q, x_scales, packed.w_qt, packed.w_scales_t, x_sal,
            w_sal, group_size=meta.group_size, out_dtype=out_dtype, pre_laid=pre_laid)
    common = dict(group_size=meta.group_size, act_bits=meta.act_bits,
                  num_salient=meta.num_salient, out_dtype=out_dtype)
    if meta.layout == "identity":
        if norm is not None:
            raise NotImplementedError("identity layout call sites fuse no norm")
        x_sal = _salient_gather(packed, x2d, packed.perm[layer_idx])
        return int4_group_matmul_stacked_rawx(
            layer_idx, x2d, packed.ns_mask, packed.w_qt, packed.w_scales_t,
            w_sal, x_sal, norm_kind="mask", **common)
    if norm is None:
        return int4_group_matmul_stacked_rawx(
            layer_idx, x2d, None, packed.w_qt, packed.w_scales_t, w_sal,
            norm_kind=None, **common)
    norm_rows, eps, kind = norm
    if kind != "rms":
        raise NotImplementedError(f"fused norm kind {kind!r}")
    return int4_group_matmul_stacked_rawx(
        layer_idx, x2d, norm_rows, packed.w_qt, packed.w_scales_t, w_sal,
        eps=float(eps), norm_kind="rms", **common)


def _per_layer_linear(packed: PackedLinear, x2d: torch.Tensor, compute: str,
                      out_dtype) -> torch.Tensor:
    """The per-layer branches (real_linear.py:400-470)."""
    meta = packed.meta
    if meta.layout == "identity" and not meta.nibble:
        return _identity_int8_forward(packed, x2d, out_dtype)
    w_sal = packed.w_sal_t.to(x2d.dtype)
    # the activation preps return x_sal (and the Q-DQ'd x_ns) in x's dtype
    if meta.layout == "identity":
        x_q, x_scales, x_sal = _identity_nibble_quantize(packed, x2d, packed.perm,
                                                         packed.ns_mask)
        return int4_group_matmul(x_q, x_scales, packed.w_qt, packed.w_scales_t, x_sal,
                                 w_sal, group_size=meta.group_size, out_dtype=out_dtype)
    x_perm = x2d if meta.pre_permuted else x2d.index_select(1, packed.perm)
    if choose_compute(meta, x2d.shape[0], compute) == "int":
        x_q, x_scales, x_sal = quantize_activations_packed_int(x_perm, meta)
        kernel = int4_group_matmul if meta.nibble else int_group_matmul
        return kernel(x_q, x_scales, packed.w_qt, packed.w_scales_t, x_sal, w_sal,
                      group_size=meta.group_size, out_dtype=out_dtype)
    x_ns_q, x_sal = quantize_activations_packed(x_perm, meta)
    return dual_path_matmul(x_ns_q, x_sal, packed.w_qt, packed.w_scales_t, w_sal,
                            group_size=meta.group_size, out_dtype=out_dtype)


def real_quant_linear(
    packed: PackedLinear,
    x: torch.Tensor,
    *,
    compute: str = "auto",
    out_dtype=None,
    layer_idx: Optional[int] = None,
    norm: Optional[tuple] = None,  # ((L, C) f32 rows, eps, "rms")
) -> torch.Tensor:
    """y = act_q(x) @ W_q^T + bias with true int-weight storage.

    compute ("auto", "int" or "dequant") picks the kernel of a per-layer
    int8-container pack (module docstring); nibble and identity packs and
    the stacked paths take the one kernel they have.  layer_idx selects the
    layer of a stacked pack (every tensor carries a leading L axis).  norm
    fuses the preceding RMSNorm into K1 (up to 32 rows; above, it runs
    first); its rows must already be rounded to x's dtype (the JAX kernel
    casts them so) and held in f32.
    """
    if compute not in COMPUTE_CHOICES:
        raise ValueError(f"compute {compute!r}: one of {COMPUTE_CHOICES}")
    meta = packed.meta
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    out_dtype = out_dtype or x.dtype
    if layer_idx is not None:
        y = _stacked_linear(packed, x2d, layer_idx, norm, out_dtype)
        bias = None if packed.bias is None else packed.bias[layer_idx]
    else:
        if norm is not None:
            raise NotImplementedError("norm fusion is a stacked-decode path")
        bias = packed.bias
        y = _per_layer_linear(packed, x2d, compute, out_dtype)
    if y.shape[-1] > meta.out_features:
        y = y[:, :meta.out_features]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*shape[:-1], y.shape[-1])

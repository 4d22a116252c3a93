"""Load-time weight packing (port of smoothquant_tpu/kernels/pack.py).

Turns an FP linear weight + recipe + calibration stats into the layout the
int kernels consume:

  * one static channel permutation [non-salient (sorted) | salient];
  * int4 values stored TRANSPOSED (K_ns, O), optionally nibble-packed two
    per byte in the split-half, +8-biased layout: packed row r holds channel
    r in the low nibble and channel r + K_ns/2 in the high nibble;
  * per-group scales (G, O) (f32 or bf16 storage), the salient columns as a
    dense (K_s, O) block in the compute dtype.

Packing runs on the weight's device with torch ops; only the permutation
and salient selection (vectors of length C) are decided on the host.  The
TPU-only block-contiguous relayout (block_decode_tree) has no counterpart:
the CUDA kernels read the plain stacked (L, K_ns/2, O) layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch.quant import core
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.saliency import select_salient_indices

LANE = 128


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PackedMeta:
    in_features: int
    out_features: int
    num_salient: int        # true salient count (before padding)
    k_ns: int               # padded non-salient width (multiple of group_size)
    k_s: int                # padded salient width (multiple of 128; 0 if none)
    group_size: int         # effective weight group size in the packed domain
    nibble: bool = False    # w_qt holds (k_ns/2, O) split-half packed bytes
    act_quant: str = "per_token"
    act_bits: int = 8
    act_group_size: int = 128
    # "permuted": [sorted non-salient | salient] via perm; "identity":
    # original channel order with salient rows zeroed (ns_mask masks them
    # out of the activation quantize; they ride the salient side path)
    layout: str = "permuted"
    # the INPUT activation already arrives in this pack's channel order
    pre_permuted: bool = False


@dataclasses.dataclass
class PackedLinear:
    """Static-layout quantized linear.  Every tensor may carry a leading
    layer axis L (stack_packed) for the stacked decode tree."""

    w_qt: torch.Tensor          # (K_ns, O) int8, or (K_ns/2, O) nibble bytes
    w_scales_t: torch.Tensor    # (G, O) f32 or bf16
    w_sal_t: torch.Tensor       # (K_s, O) compute dtype
    bias: Optional[torch.Tensor]
    perm: torch.Tensor          # (C,) int64
    meta: PackedMeta
    ns_mask: Optional[torch.Tensor] = None   # identity layout: (C,) 0/1 f32
    # w_sal_t cast to another activation dtype, made once (salient_block)
    _sal_cast: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                        compare=False)

    def salient_block(self, dtype) -> torch.Tensor:
        """w_sal_t in `dtype` (the rows' dtype): as stored, or a cast made
        on the first call for that dtype and kept, so a decode step casts
        nothing between K7's activation prep and K5, its programmatic
        dependent.  The cast is launched before the prep on the same
        stream, so it has finished when K5 starts.  A pack is not changed
        after it is made, so the cast stays true."""
        if self.w_sal_t.dtype == dtype:
            return self.w_sal_t
        if dtype not in self._sal_cast:
            self._sal_cast[dtype] = self.w_sal_t.to(dtype)
        return self._sal_cast[dtype]

    def to(self, device) -> "PackedLinear":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, w_qt=mv(self.w_qt), w_scales_t=mv(self.w_scales_t),
            w_sal_t=mv(self.w_sal_t), bias=mv(self.bias), perm=mv(self.perm),
            ns_mask=mv(self.ns_mask))


def stack_packed(items: list) -> PackedLinear:
    """Stack per-layer packs along a new leading L axis (one copy)."""
    m0 = items[0].meta
    if any(p.meta != m0 for p in items):
        raise ValueError("stacked layers must share one packed layout")

    def st(name):
        vals = [getattr(p, name) for p in items]
        return None if vals[0] is None else torch.stack(vals)

    return PackedLinear(w_qt=st("w_qt"), w_scales_t=st("w_scales_t"),
                        w_sal_t=st("w_sal_t"), bias=st("bias"),
                        perm=st("perm"), meta=m0, ns_mask=st("ns_mask"))


def effective_group_size(cfg: QuantConfig, k_ns_raw: int) -> int:
    """per_group → cfg.group_size; per_channel / per_tensor → one group
    spanning every non-salient channel (pack.py:101-110)."""
    if cfg.weight_quant in ("per_group", "per_group_unsorted"):
        return cfg.group_size
    return max(k_ns_raw, 1)


def nibble_pack(w_qt: torch.Tensor) -> torch.Tensor:
    """(K, O) int8 int4-range → (K/2, O) split-half bytes, each nibble
    biased by +8 (pack.py:583-594)."""
    k = w_qt.shape[0]
    lo = (w_qt[: k // 2].to(torch.int32) + 8) & 0x0F
    hi = ((w_qt[k // 2:].to(torch.int32) + 8) & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_nibbles_to_int8(w_qt: torch.Tensor) -> torch.Tensor:
    """(K/2, O) split-half biased bytes → (K, O) int8 true values."""
    w32 = w_qt.to(torch.int32)
    lo = ((w32 & 0xF) - 8).to(torch.int8)
    hi = (((w32 >> 4) & 0xF) - 8).to(torch.int8)
    return torch.cat([lo, hi], dim=-2)


def k_major(w: torch.Tensor) -> torch.Tensor:
    """The (K, O) matrix w as a view of (O, K) contiguous storage: the
    layout the prefill int8 kernel (K4) reads.  Identity-int8 packs hold
    their weights so; shape and values stay those of the JAX package."""
    return w.t().contiguous().t()


def _pad_o(t: torch.Tensor, o_pad: int) -> torch.Tensor:
    o = t.shape[-1]
    return t if o_pad == o else torch.nn.functional.pad(t, (0, o_pad - o))


def pack_linear(
    params: dict,
    cfg: QuantConfig,
    importance: Optional[np.ndarray] = None,
    act_absmax: Optional[np.ndarray] = None,
    compute_dtype=torch.bfloat16,
    nibble: bool = False,
    align_k_groups: int = 1,
    align_o: int = 1,
    identity: bool = False,
) -> PackedLinear:
    """Packed layout from FP linear params {"weight" (O, C), "bias"}.

    align_k_groups / align_o: round the packed K-groups (per nibble half)
    and the output axis up to these multiples with zeros (zero scales
    nullify the padding); real_quant_linear slices the output back.
    """
    w = params["weight"]
    o, c = w.shape
    dev = w.device
    if nibble and cfg.quant_bits > 4:
        raise ValueError("nibble packing requires quant_bits <= 4")
    if identity:
        return _pack_linear_identity(
            params, cfg, importance=importance, compute_dtype=compute_dtype,
            nibble=nibble, align_k_groups=align_k_groups, align_o=align_o)

    k = cfg.num_salient(c) if importance is not None else 0
    sal_idx = (select_salient_indices(np.asarray(importance), k) if k
               else np.zeros(0, np.int32))
    is_sal = np.zeros(c, dtype=bool)
    is_sal[sal_idx] = True
    ns_idx = np.nonzero(~is_sal)[0]
    if cfg.weight_quant == "per_group" or cfg.act_quant == "per_group":
        key = (np.asarray(act_absmax, np.float64)[ns_idx]
               if act_absmax is not None
               else core.sort_key(w, cfg.sort_strategy).cpu().numpy()[ns_idx])
        ns_idx = ns_idx[np.argsort(key, kind="stable")]
    perm = np.concatenate([ns_idx, np.sort(sal_idx)]).astype(np.int64)
    k_ns_raw = c - k

    g = effective_group_size(cfg, k_ns_raw)
    k_ns = _ceil_to(max(k_ns_raw, 1), g)
    if nibble:
        k_ns = _ceil_to(k_ns, 2 * g * max(align_k_groups, 1))
    k_s = _ceil_to(k, LANE) if k else 0

    perm_t = torch.as_tensor(perm, device=dev)
    w_perm = w.float().index_select(1, perm_t)
    w_ns = w_perm[:, :k_ns_raw]
    if k_ns != k_ns_raw:
        w_ns = torch.nn.functional.pad(w_ns, (0, k_ns - k_ns_raw))
    w_sal = torch.zeros((o, k_s), dtype=torch.float32, device=dev)
    if k:
        w_sal[:, :k] = w_perm[:, k_ns_raw:]
    del w_perm
    if cfg.weight_quant == "per_tensor":
        scale = core.compute_scale(w_ns.abs().amax(), cfg.quant_bits)
        scales = scale.expand(o, k_ns // g).float()
        q = torch.round(w_ns / scale).to(torch.int8)
    else:
        q3, s3 = core.group_quant_params(w_ns, cfg.quant_bits, g)
        q = q3.reshape(o, k_ns)
        scales = s3.reshape(o, k_ns // g)
    w_qt = q.t().contiguous()
    scales_t = scales.t().contiguous()
    w_sal_t = w_sal.t().to(compute_dtype).contiguous()
    if nibble:
        w_qt = nibble_pack(w_qt)

    if align_o > 1:
        o_pad = _ceil_to(o, align_o)
        w_qt, scales_t, w_sal_t = (_pad_o(t, o_pad)
                                   for t in (w_qt, scales_t, w_sal_t))
    if cfg.scale_dtype == "bfloat16":
        scales_t = scales_t.to(torch.bfloat16)

    # a no-sort, no-salient, single-group int8 recipe (the W8A8 per-channel
    # lm_head) runs as ONE int8 product with a fused epilogue
    layout = "permuted"
    if (not nibble and k == 0 and k_ns == c
            and cfg.weight_quant in ("per_channel", "per_tensor")
            and cfg.act_quant == "per_token"
            and cfg.effective_act_bits == 8
            and np.array_equal(perm, np.arange(c))):
        layout = "identity"
        w_qt = k_major(w_qt)

    bias = params.get("bias")
    return PackedLinear(
        w_qt=w_qt, w_scales_t=scales_t, w_sal_t=w_sal_t,
        bias=None if bias is None else bias.to(dev),
        perm=perm_t,
        meta=PackedMeta(
            in_features=c, out_features=o, num_salient=k,
            k_ns=k_ns, k_s=k_s, group_size=g, nibble=nibble,
            act_quant=cfg.act_quant, act_bits=cfg.effective_act_bits,
            act_group_size=cfg.group_size, layout=layout),
    )


def _pack_linear_identity(params: dict, cfg: QuantConfig,
                          importance: Optional[np.ndarray] = None,
                          compute_dtype=torch.bfloat16, nibble: bool = True,
                          align_k_groups: int = 1,
                          align_o: int = 1) -> PackedLinear:
    """IDENTITY-layout nibble pack (pack.py:243-322): int weights in the
    original channel order with the salient columns zeroed; salient
    channels ride the fp side path via a k_s-wide gather and the 0/1
    ns_mask zeroes them out of the activation group quantize."""
    if not nibble:
        raise ValueError("identity layout is for nibble packs")
    if cfg.weight_quant not in ("per_group", "per_group_unsorted"):
        raise ValueError("identity layout needs a per-group weight recipe")
    w = params["weight"]
    o, c = w.shape
    dev = w.device
    k = cfg.num_salient(c) if importance is not None else 0
    sal_idx = (select_salient_indices(np.asarray(importance), k)
               if k else np.zeros(0, np.int32))
    sal_idx = np.sort(sal_idx).astype(np.int64)
    is_sal = np.zeros(c, dtype=bool)
    is_sal[sal_idx] = True
    ns_idx = np.nonzero(~is_sal)[0].astype(np.int64)
    perm = np.concatenate([ns_idx, sal_idx]).astype(np.int64)

    g = effective_group_size(cfg, c)
    k_ns = _ceil_to(c, 2 * g * max(align_k_groups, 1))
    k_s = _ceil_to(k, LANE) if k else 0

    wf = w.float()
    mask = torch.as_tensor(~is_sal, dtype=torch.float32, device=dev)
    w_main = wf * mask[None, :]
    if k_ns != c:
        w_main = torch.nn.functional.pad(w_main, (0, k_ns - c))
    # the JAX identity pack runs eagerly: its scale division is exact
    q3, s3 = core.group_quant_params(w_main, cfg.quant_bits, g,
                                     exact_division=True)
    del w_main
    w_qt = nibble_pack(q3.reshape(o, k_ns).t())
    scales_t = s3.reshape(o, k_ns // g).t().contiguous()
    w_sal = torch.zeros((o, k_s), dtype=torch.float32, device=dev)
    if k:
        w_sal[:, :k] = wf.index_select(1, torch.as_tensor(sal_idx, device=dev))
    w_sal_t = w_sal.t().to(compute_dtype).contiguous()
    if align_o > 1:
        o_pad = _ceil_to(o, align_o)
        w_qt, scales_t, w_sal_t = (_pad_o(t, o_pad)
                                   for t in (w_qt, scales_t, w_sal_t))
    if cfg.scale_dtype == "bfloat16":
        scales_t = scales_t.to(torch.bfloat16)

    bias = params.get("bias")
    return PackedLinear(
        w_qt=w_qt.contiguous(), w_scales_t=scales_t, w_sal_t=w_sal_t,
        bias=None if bias is None else bias.to(dev),
        perm=torch.as_tensor(perm, device=dev), ns_mask=mask,
        meta=PackedMeta(
            in_features=c, out_features=o, num_salient=k,
            k_ns=k_ns, k_s=k_s, group_size=g, nibble=True,
            act_quant=cfg.act_quant, act_bits=cfg.effective_act_bits,
            act_group_size=cfg.group_size, layout="identity",
            pre_permuted=True),
    )


def fold_input_perm(consumer: PackedLinear, producer_lin: dict,
                    n_splits: int = 1) -> tuple[PackedLinear, dict]:
    """Fold a packed consumer's input permutation into its FP producer's
    output rows (pack.py:325-363): down_proj ← silu(gate)*up then needs no
    runtime activation gather.  n_splits: fused producers (gate_up) get the
    perm applied within each of their n_splits output blocks."""
    perm = consumer.perm
    w = producer_lin["weight"]
    o = w.shape[0] // n_splits
    if o != perm.shape[0]:
        raise ValueError(
            f"producer rows per split ({o}) != consumer in_features "
            f"({perm.shape[0]})")
    idx = torch.cat([perm.to(w.device) + j * o for j in range(n_splits)])
    bias = producer_lin.get("bias")
    new_producer = {
        "weight": w.index_select(0, idx),
        "bias": None if bias is None else bias.index_select(0, idx),
    }
    new_consumer = dataclasses.replace(
        consumer, meta=dataclasses.replace(consumer.meta, pre_permuted=True))
    return new_consumer, new_producer


def permute_output_columns(packed: PackedLinear, idx) -> PackedLinear:
    """Relay a pack's OUTPUT columns: out'[j] = out[idx[j]] (pack.py:366-397).
    align_o padding columns stay zero at the end."""
    o = packed.meta.out_features
    take = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                           device=packed.w_qt.device)
    if take.shape[0] != o:
        raise ValueError(f"idx length {take.shape[0]} != out_features {o}")

    def gather_o(arr):
        if arr is None:
            return None
        out = arr[..., :o].index_select(-1, take)
        return _pad_o(out, arr.shape[-1]).contiguous()

    return dataclasses.replace(
        packed, w_qt=gather_o(packed.w_qt),
        w_scales_t=gather_o(packed.w_scales_t),
        w_sal_t=gather_o(packed.w_sal_t),
        bias=None if packed.bias is None else packed.bias.index_select(0, take))


def _rows_in_perm_order(packed: PackedLinear) -> bool:
    """True when w_qt's rows follow packed.perm — what the JAX promotion
    assumes when it scatters them back by perm (pack.py:477-478)."""
    m = packed.meta
    if m.layout != "identity":
        return True
    ident = torch.arange(m.in_features, device=packed.perm.device)
    return bool(torch.equal(packed.perm.to(torch.int64), ident))


def promote_int8(packed: PackedLinear) -> PackedLinear:
    """Re-express an int4-group pack as int8 per output column in ORIGINAL
    channel order (pack.py:465-524): the prefill recipe, one full-depth int8
    product with a per-token × per-column epilogue (K4), salient channels
    masked out of the int operand and riding the fp side path.

    Numerics mirror the jitted _promote_device: the W4 weight dequantized in
    f32, scale = max(column absmax, 1e-8)·(1/127 in f32), codes round(wf /
    scale) half to even, rows scattered back by perm.  The weight is stored
    K-major (k_major), the layout K4 reads.

    Raises NotImplementedError for the packs the JAX promotion gets wrong:
    an input that arrives pre-permuted (the shared residual basis, or a
    permutation folded into its producer by fold_input_perm — both set
    meta.pre_permuted) and an identity layout whose rows do not follow
    perm.  Their promoted forward would take activations in one channel
    order against weights scattered into another.
    """
    m = packed.meta
    if packed.w_qt.ndim != 2:
        raise NotImplementedError("promote_int8 takes per-layer packs, not stacks")
    if m.pre_permuted:
        raise NotImplementedError(
            "promote_int8 of a pre-permuted pack (shared residual basis or a "
            "folded input permutation): the promoted rows would land in the "
            "original channel order while the input arrives permuted")
    if not _rows_in_perm_order(packed):
        raise NotImplementedError(
            "promote_int8 of an identity-layout pack: its rows are already in "
            "original order, and scattering them by perm misplaces them")
    w_qt = unpack_nibbles_to_int8(packed.w_qt) if m.nibble else packed.w_qt
    k_ns, o = w_qt.shape
    k_ns_raw = m.in_features - m.num_salient
    gs = m.group_size
    wf = (w_qt.float().reshape(k_ns // gs, gs, o)
          * packed.w_scales_t.float()[:, None, :]).reshape(k_ns, o)
    absmax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * core.f32_reciprocal(127.0)
    q8 = torch.round(wf / scale).to(torch.int8)
    del wf
    perm = packed.perm
    q8_orig = torch.zeros((m.in_features, o), dtype=torch.int8, device=q8.device)
    q8_orig[perm[:k_ns_raw]] = q8[:k_ns_raw]
    ns_mask = None
    if m.num_salient:
        ns_mask = torch.ones(m.in_features, dtype=torch.float32, device=q8.device)
        ns_mask[perm[k_ns_raw:]] = 0.0
    return PackedLinear(
        w_qt=k_major(q8_orig), w_scales_t=scale, w_sal_t=packed.w_sal_t,
        bias=packed.bias, perm=perm, ns_mask=ns_mask,
        meta=dataclasses.replace(
            m, nibble=False, group_size=m.in_features, k_ns=m.in_features,
            act_quant="per_token", act_bits=8, layout="identity"))


def promote_model_int8(params):
    """promote_int8 over every PackedLinear of a per-layer packed tree: the
    prefill twin of a nibble decode tree (pack.py:527-537)."""
    if isinstance(params, PackedLinear):
        return promote_int8(params)
    if isinstance(params, dict):
        return {k: promote_model_int8(v) for k, v in params.items()}
    return params


def _salient_block(x_perm: torch.Tensor, meta: PackedMeta) -> torch.Tensor:
    """The permuted tail's salient channels, zero-padded to k_s, in x's dtype."""
    k_ns_raw = meta.in_features - meta.num_salient
    x_sal = torch.zeros((x_perm.shape[0], meta.k_s), dtype=x_perm.dtype,
                        device=x_perm.device)
    if meta.num_salient:
        x_sal[:, :meta.num_salient] = x_perm[:, k_ns_raw:]
    return x_sal


def quantize_activations_packed(x_perm: torch.Tensor, meta: PackedMeta):
    """(x_ns Q-DQ'd (N, k_ns) in x's dtype, x_sal (N, k_s)) for the dequant
    kernel from a PERMUTED activation (pack.py:625-656): the non-salient
    channels zero-padded to k_ns and quantized at meta.act_quant
    granularity (contiguous groups: the permutation already sorted them)."""
    k_ns_raw = meta.in_features - meta.num_salient
    x_ns = x_perm[:, :k_ns_raw]
    if meta.k_ns != k_ns_raw:
        x_ns = torch.nn.functional.pad(x_ns, (0, meta.k_ns - k_ns_raw))
    if meta.act_quant == "per_token":
        x_ns_q = core.quantize_activation_per_token_absmax(x_ns, meta.act_bits)
    elif meta.act_quant == "per_tensor":
        x_ns_q = core.quantize_activation_per_tensor_absmax(x_ns, meta.act_bits)
    else:
        x_ns_q = core.quantize_activation_per_group_absmax(x_ns, meta.act_bits,
                                                           meta.act_group_size)
    return x_ns_q, _salient_block(x_perm, meta)


def quantize_activations_packed_int(x_perm: torch.Tensor, meta: PackedMeta):
    """(x_q int8 (N, k_ns), x_scales f32 (N, G), x_sal (N, k_s)) for the
    int kernel from a PERMUTED activation (pack.py:659-707)."""
    n = x_perm.shape[0]
    k_ns_raw = meta.in_features - meta.num_salient
    g_w = meta.k_ns // meta.group_size
    xf = x_perm[:, :k_ns_raw].float()
    if meta.k_ns != k_ns_raw:
        xf = torch.nn.functional.pad(xf, (0, meta.k_ns - k_ns_raw))
    if meta.act_quant == "per_token":
        scales = core.compute_scale(xf.abs().amax(dim=-1, keepdim=True),
                                    meta.act_bits)
        x_q = torch.round(xf / scales).to(torch.int8)
        x_scales = scales.expand(n, g_w)
    elif meta.act_quant == "per_tensor":
        scale = core.compute_scale(xf.abs().amax(), meta.act_bits)
        x_q = torch.round(xf / scale).to(torch.int8)
        x_scales = scale.expand(n, g_w)
    else:
        if meta.act_group_size != meta.group_size:
            raise ValueError(
                f"int-compute path needs act group_size == weight group_size "
                f"({meta.act_group_size} != {meta.group_size})")
        x_q, x_scales = core.quantize_groups_int(xf, meta.act_bits,
                                                 meta.group_size)
    return x_q, x_scales.float().contiguous(), _salient_block(x_perm, meta)

"""Single-query decode attention over a head-major KV cache (K11), with its
plain PyTorch version.

K11 decode_attention_stacked — port of smoothquant_tpu/kernels/
    decode_attention.py:218 (pallas_call :306), and the per-layer wrapper
    decode_attention (:351), which runs the same kernel on a one-layer
    stack.  Caches (L, B, H_kv, S, D) in q's dtype, bf16 / f32 (the fp
    body), or int8 with (L, B, H_kv, S) f32 scales (the int8 body); a
    (B, S) additive f32 bias carries validity; q and out (B, H, D) in q's
    dtype.  Numerics (decode_attention.py:44-130): scores = q·k in f32 ×
    sm_scale (default 1/√D; OPT passes 1.0, its q scaled at projection)
    [× k_scale] [+ slope_h · key_pos] + bias; the TPU kernel's online
    softmax over tiles of _pick_tile_s(S) positions, the running max
    guarded at NEG_INF/2; p [× v_scale] rounded to the value dtype (bf16 for
    the int8 cache) before PV; the denominator guarded at 0, so a fully
    masked row gives 0.

The ALiBi body (Bloom; _alibi_row :133-139, added at :85-86): (H,) f32
slopes, MHA only (the JAX kernel asserts rep == 1, :276), the term
slope_h · f32(key position) with the ABSOLUTE position of the key, added
after the k_scale product and before the bias, in both bodies.
int8_dots (the opt-in int8 BMMs) has no caller in the port and raises.  Any
GQA / MQA rep the JAX kernel takes (H % H_kv == 0; Falcon-7B's 71 query
heads over one kv head): above 8 query rows a kv head both bodies run the
rows in groups of 8 (grid z), each group a block (flash) or cluster
(split) that reads the kv head's rows again; K3 and K12 run the same
groups (plan).  CUDA source:
csrc/decode_attention.cu, two bodies picked by a shape rule (attn_body):
bf16 queries at D = 64 / 128 take the split-S cluster body
(csrc/split_decode.cuh: the positions split over split_ranks(B·H_kv, S)
cluster ranks, the tile maxima exchanged and the partials reduced in rank
order through distributed shared memory), f32 queries and D = 256 the
flash body (csrc/flash_decode.cuh, which K12 shares).  Each body counts its
launches under its own key (LAUNCH_KEYS).  A wrapper runs the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build

NEG_INF = -1e30
_WARPS = 16            # warps per block (csrc/decode_attention.cu WARPS)
MAX_GROUP_REP = 8      # query rows a block / cluster holds (FLASH_MAX_REP, SD_MAX_REP)
_SMEM_LIMIT = 227 * 1024

# the split body (csrc/split_decode.cuh)
SPLITS = (1, 2, 4, 8)          # cluster ranks a (slot, kv head) takes
SPLIT_DIMS = (64, 128)
SPLIT_MAX_CHUNK = 2048         # positions a rank holds at most (SD_MAX_CHUNK)
SPLIT_MIN_CHUNK = 64           # two ring stages a rank at least
SPLIT_MAX_CTAS = 4 * 132       # CTAs the planner fills the card with (4 an SM, measured)
MAX_TILES = 64                 # softmax tiles of S (both bodies)
# launch counter of each body, without / with ALiBi slopes
LAUNCH_KEYS = {("split", False): "decode_attention_stacked",
               ("split", True): "decode_attention_stacked_alibi",
               ("flash", False): "decode_attention_stacked_flash",
               ("flash", True): "decode_attention_stacked_flash_alibi"}


def _pick_tile_s(s: int) -> Optional[int]:
    for ts in (512, 256, 128):
        if s % ts == 0:
            return ts
    return None


def supported(s: int, n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Shapes the JAX kernel tiles (decode_attention.py:342-346)."""
    return (_pick_tile_s(s) is not None and n_heads % n_kv == 0
            and head_dim % 64 == 0)


def rep_groups(rep: int) -> int:
    """Groups of up to MAX_GROUP_REP query rows a kv head's rep splits into
    (a block or cluster each)."""
    return -(-rep // MAX_GROUP_REP)


def attn_body(q_dtype, d: int, s: int, rep: int) -> str:
    """K11's body for a call: "split" (the cluster body) for bf16 queries at
    D = 64 / 128 over an S it can chunk, else "flash"; any rep."""
    del rep
    ts = _pick_tile_s(s)
    if (q_dtype == torch.bfloat16 and d in SPLIT_DIMS
            and ts is not None and s // ts <= MAX_TILES and _split_fits(s)):
        return "split"
    return "flash"


def _split_fits(s: int, c: Optional[int] = None) -> bool:
    """Whether c ranks (any of SPLITS when None) chunk S: whole multiples of
    16 positions (the bulk copies' 16-byte rows of bias and scales), at most
    SPLIT_MAX_CHUNK each."""
    return any(r in SPLITS and s % (16 * r) == 0 and s // r <= SPLIT_MAX_CHUNK
               for r in (SPLITS if c is None else (c,)))


def split_ranks(heads: int, s: int) -> int:
    """Cluster ranks of the split body for `heads` = B·H_kv (slot, kv head)
    pairs over S positions: the most of SPLITS that keep heads × ranks within
    SPLIT_MAX_CTAS and each rank at SPLIT_MIN_CHUNK positions or more (so
    B = 4 over 512 takes 4 ranks a head and B = 64 one: PERF.md §6 has the
    sweep); at least as many as keep a rank within SPLIT_MAX_CHUNK."""
    fits = [c for c in SPLITS if _split_fits(s, c)]
    if not fits:
        raise ValueError(f"no split of S = {s} fits the split body")
    within = [c for c in fits if heads * c <= SPLIT_MAX_CTAS and s // c >= SPLIT_MIN_CHUNK]
    return max(within, default=min(fits))


def plan(kernel: str, q_dtype, heads: int, s: int, d: int, rep: int,
         body: Optional[str] = None, split: Optional[int] = None) -> tuple[str, int]:
    """(body, cluster ranks) of a call of `kernel` (K11, K3, K12: each runs
    the split body of split_decode.cuh or the flash body of flash_decode.cuh)
    over `heads` = B·H_kv (slot, kv head) pairs of S positions at head_dim d,
    rep query rows a kv head: the shape rules' (attn_body, split_ranks)
    unless `body` / `split` force them (measurements).  Any GQA rep: above
    MAX_GROUP_REP query rows a kv head both bodies run rep_groups(rep)
    groups (grid z) that count as heads for the split planner, and the
    flash body's shared memory is one group's.  The flash body takes no
    ranks (0).  Raises ValueError on a shape the body does not take."""
    ts = _pick_tile_s(s)
    chosen = attn_body(q_dtype, d, s, rep) if body is None else body
    if ts is None or d not in (64, 128, 256):
        raise ValueError(f"{kernel} does not take S = {s}, D = {d} (S tileable by 128, "
                         "D in 64/128/256)")
    rg = min(rep, MAX_GROUP_REP)
    if chosen == "split":
        c = split_ranks(heads * rep_groups(rep), s) if split is None else split
        if (q_dtype != torch.bfloat16 or d not in SPLIT_DIMS or s // ts > MAX_TILES
                or not _split_fits(s, c)):
            raise ValueError(f"{kernel}'s split body does not take {q_dtype} queries at "
                             f"D = {d} over S = {s} in {c} ranks")
        return chosen, c
    if chosen == "flash":
        smem = (rg * s + _WARPS * rg * d + rg * (s // ts)) * 4
        if smem > _SMEM_LIMIT or s // ts > MAX_TILES:
            raise ValueError(f"{kernel}'s score rows and partials need {smem} B of shared "
                             "memory")
        return chosen, 0
    raise ValueError(f"{kernel} has no body {chosen!r}")


def _check_options(h: int, n_kv: int, alibi_slopes, int8_dots):
    if int8_dots:
        raise NotImplementedError("K11's int8_dots mode is not ported")
    if alibi_slopes is not None:
        if h != n_kv:
            raise ValueError("ALiBi slopes are per query head: MHA only "
                             f"({h} heads over {n_kv} kv heads)")
        if tuple(alibi_slopes.shape) != (h,):
            raise ValueError(f"ALiBi slopes {tuple(alibi_slopes.shape)} != ({h},)")


def online_softmax_tiles(qf, kl, vl, bias, ks=None, vs=None, slopes=None,
                         sm_scale: Optional[float] = None):
    """The TPU kernel's tile-by-tile online softmax of single queries over
    one layer's head-major cache: qf (B, H_kv, rep, D) f32, kl / vl
    (B, H_kv, S, D), bias (B, S), ks / vs (B, H_kv, S) scales of an int8
    cache, slopes (H_kv,) the ALiBi slopes (rep = 1), sm_scale the score
    scale (default 1/√D).  Returns the running max m, sum l (B, H_kv, rep,
    1) and numerator acc (B, H_kv, rep, D) after the last tile (K11 and
    K12)."""
    s, d = kl.shape[2], kl.shape[3]
    ts = _pick_tile_s(s)
    if ts is None:
        raise ValueError(f"cache length {s} not tileable")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    quant = ks is not None
    v_dt = torch.bfloat16 if quant else vl.dtype
    key_pos = torch.arange(s, device=qf.device).float()
    m = l_sum = acc = None
    for t in range(s // ts):
        sl = slice(t * ts, (t + 1) * ts)
        sc = torch.einsum("bgrd,bgsd->bgrs", qf, kl[:, :, sl].float()) * sm_scale
        if quant:
            sc = sc * ks[:, :, None, sl]
        if slopes is not None:
            sc = sc + slopes.float()[None, :, None, None] * key_pos[sl]
        sc = sc + bias[:, None, None, sl].float()
        m_cur = sc.amax(dim=-1, keepdim=True)
        m_new = m_cur if t == 0 else torch.maximum(m, m_cur)
        m_safe = torch.clamp_min(m_new, NEG_INF / 2)
        p = torch.exp(sc - m_safe)
        p_sum = p.sum(dim=-1, keepdim=True)
        alpha = None if t == 0 else torch.exp(m - m_safe)
        l_sum = p_sum if t == 0 else l_sum * alpha + p_sum
        if quant:
            p = p * vs[:, :, None, sl]
        pv = torch.einsum("bgrs,bgsd->bgrd", p.to(v_dt).float(), vl[:, :, sl].float())
        acc = pv if t == 0 else acc * alpha + pv
        m = m_new
    return m, l_sum, acc


def decode_attention_stacked_plain(layer_idx: int, q, k, v, bias, k_scale=None,
                                   v_scale=None, alibi_slopes=None, sm_scale=None):
    """Plain PyTorch K11 (same arguments as the wrapper): the TPU kernel's
    tile-by-tile online softmax."""
    b, h, d = q.shape
    n_kv = k.shape[2]
    qf = q.float().reshape(b, n_kv, h // n_kv, d)
    scales = ((None, None) if k_scale is None else (k_scale[layer_idx], v_scale[layer_idx]))
    _, l_sum, acc = online_softmax_tiles(qf, k[layer_idx], v[layer_idx], bias, *scales,
                                         slopes=alibi_slopes, sm_scale=sm_scale)
    denom = torch.where(l_sum > 0.0, l_sum, torch.ones_like(l_sum))
    return (acc / denom).reshape(b, h, d).to(q.dtype)


def decode_attention_stacked(
    layer_idx: int,
    q: torch.Tensor,          # (B, H, D) this layer's queries
    k: torch.Tensor,          # (L, B, H_kv, S, D) every layer
    v: torch.Tensor,
    bias: torch.Tensor,       # (B, S) f32 additive mask
    k_scale: Optional[torch.Tensor] = None,   # (L, B, H_kv, S) when k is int8
    v_scale: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    int8_dots: bool = False,
    body: Optional[str] = None,
    split: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, D) attention of layer `layer_idx` in q's dtype; sm_scale the
    score scale (default 1/√D, as the JAX kernel's).  `body` ("split" /
    "flash") and `split` (the split body's ranks, over B·H_kv·rep_groups
    clusters) override the shape rules (attn_body, split_ranks) for
    measurements; a forced body or split raises on a shape it does not
    take."""
    _check_options(q.shape[1], k.shape[2], alibi_slopes, int8_dots)
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(layer_idx, q, k, v, bias, k_scale, v_scale,
                                              alibi_slopes, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    b, h, d = q.shape
    _, b2, n_kv, s, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or h % n_kv:
        raise ValueError(f"K11 does not take q {tuple(q.shape)} over cache {tuple(k.shape)}")
    chosen, c = plan("K11", q.dtype, b * n_kv, s, d, h // n_kv, body, split)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    ts = _pick_tile_s(s)
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or v.dtype != k.dtype:
        raise TypeError("an int8 cache comes with its scales, an fp cache without")
    if not quant and k.dtype != q.dtype:
        raise TypeError(f"K11 takes an fp cache in q's dtype ({q.dtype}), not {k.dtype}")
    q = q.contiguous()
    bias = bias.float().contiguous()
    if bias.shape != (b, s):
        raise ValueError(f"bias {tuple(bias.shape)} != {(b, s)}")
    if quant:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != k.shape[:4]:
                raise TypeError("cache scales are (L, B, H_kv, S) float32")
    if alibi_slopes is not None:
        alibi_slopes = alibi_slopes.float().contiguous()
    _build.check_operands(q.device, k=k, v=v, bias=bias, k_scale=k_scale,
                          v_scale=v_scale, alibi_slopes=alibi_slopes)
    out = torch.empty_like(q)
    scale_ptr = (lambda t: t[layer_idx].data_ptr()) if quant else (lambda t: None)
    ptrs = (q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr(),
            scale_ptr(k_scale), scale_ptr(v_scale), bias.data_ptr(),
            None if alibi_slopes is None else alibi_slopes.data_ptr(), out.data_ptr())
    if chosen == "split":
        _build.check(_build.lib().sq_decode_attn_split(
            *ptrs, b, h, n_kv, s, d, ts, c.bit_length() - 1, scale, int(quant),
            _build.stream_ptr(q)), "sq_decode_attn_split")
    else:
        _build.check(_build.lib().sq_decode_attn(
            *ptrs, b, h, n_kv, s, d, ts, scale, _build.dt_code(q), int(quant),
            _build.stream_ptr(q)), "sq_decode_attn")
    _build.LAUNCHES[LAUNCH_KEYS[chosen, alibi_slopes is not None]] += 1
    return out


def decode_attention(
    q: torch.Tensor,          # (B, H, D)
    k: torch.Tensor,          # (B, H_kv, S, D) bf16 / f32, or int8
    v: torch.Tensor,
    bias: torch.Tensor,       # (B, S) f32 additive mask
    k_scale: Optional[torch.Tensor] = None,   # (B, H_kv, S) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    int8_dots: bool = False,
) -> torch.Tensor:
    """(B, H, D) attention over one layer's cache: the stacked kernel on a
    one-layer stack (views, nothing copied)."""
    b, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or h % k.shape[1] or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k.shape)}")
    return decode_attention_stacked(
        0, q, k[None], v[None], bias,
        None if k_scale is None else k_scale[None],
        None if v_scale is None else v_scale[None],
        alibi_slopes, sm_scale=sm_scale, int8_dots=int8_dots)

"""K7's row body (csrc/act_prep.cu act_rows_kernel: K7b's "rms",
"rms_round" and no-norm modes, K7a's quantize with the salient split) on
the CPU, where the wrappers take the plain version:

* the plain version in each mode against the JAX package: K7a
  (act_prep.py:40) and K7b (:127) jitted in interpret mode, and
  "rms_round" against the JAX stacked path's many-rows branch
  (real_linear.py:351-386: rms_norm, the pads, K7a);
* the stacked path's operands (many_rows_operands, k1_rows_operands) bit
  for bit what they were before each site's prep became one launch;
* a PyTorch emulation of the kernel's lane map (8 columns a lane, a group
  gs / 8 neighbouring lanes of one warp, the Σx² in f64 over lanes, warps
  and the row, the padding rows written by the warps of live rows, the
  scalar tail past C) held bit for bit to the plain version;
* the plan, the wrappers' refusals (a salient block that K5 chained behind
  the prep would need cast included), the launch accounting of a step,
  the variants script's edits, the entry points' ctypes signatures, and
  chip_smoke's k7_edges and chain phases rehearsed at small shapes.

Tolerances: K7a, and K7b without a norm, bit for bit against JAX.  With
the RMSNorm the port takes its own factor rule (quant.core.rms_factor:
Σx² in f64, 1/√v correctly rounded) where JAX takes XLA's f32 mean and
rsqrt: scales within 4 ulp and codes off by one in under 1 % of them, as
tests/test_torch_norm_quantize_acts.py holds K7b (8 ulp for "rms_round",
whose JAX side is the f32 mean of rms_norm over rows of very different
scales, a longer f32 chain than the kernel's); under "rms_round" the
factor's last-bit difference can also move a bf16 rounding, so a group's
scale may move by one bf16 step (2^-7 relative) in under 1 % of the
groups.  Everything else here is bit for bit."""

import inspect
import os
import re
import sys
import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.act_prep import norm_quantize_acts_t as j_k7b
from smoothquant_tpu.kernels.act_prep import quantize_acts_grouped_t as j_k7a
from smoothquant_tpu.models.common import rms_norm as j_rms_norm
from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.kernels import act_prep as k7
from smoothquant_tpu_torch.kernels import real_linear as rl
from smoothquant_tpu_torch.models.common import rms_norm
from smoothquant_tpu_torch.quant.core import f32_reciprocal, qmax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

torch.set_num_threads(1)

EPS = 1e-5
CASES = [  # (n, c, group_size, num_salient, k_ns, k_s)
    (5, 512, 64, 25, 512, 128),        # k_ns past the 487 non-salient columns
    (40, 256, 16, 12, 256, 128),
    (3, 320, 32, 0, 384, 0),           # no salient block, k_ns padded by 64
    (9, 1000, 64, 50, 1024, 53),       # k_s no multiple of 8
    (33, 1001, 128, 50, 1024, 128),    # C no multiple of 8
    (2, 600, 8, 30, 576, 32),          # one-lane groups
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(n, c, seed, dt):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c)) * rng.uniform(0.5, 4.0, size=(1, c))
         * rng.uniform(0.2, 3.0, size=(n, 1))).astype(np.float32)
    x[0, :] = 0.0 if n > 2 else x[0, :]          # a zero row
    w = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    xt = torch.from_numpy(x).to(DTYPES[dt][0])
    return xt, jnp.asarray(xt.float().numpy()).astype(DTYPES[dt][1]), torch.from_numpy(w)


def _ulps(got, ref):
    g = got.numpy().view(np.int32).astype(np.int64)
    return np.abs(g - np.asarray(ref, np.float32).view(np.int32).astype(np.int64))


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n,c,gs,n_sal,k_ns,k_s", CASES)
def test_k7a_split_matches_jax(n, c, gs, n_sal, k_ns, k_s, dt):
    """K7a with the salient split: JAX's K7a on the zero-padded non-salient
    slice, and the salient tail as it is: bit for bit."""
    x, xj, _ = _inputs(n, c, n + c, dt)
    got = k7.quantize_acts_split_t(x, group_size=gs, act_bits=4, k_ns=k_ns, num_salient=n_sal,
                                   k_s=k_s, sal_dtype=x.dtype)
    k_ns_raw = c - n_sal
    ref_q, ref_s = j_k7a(jnp.pad(xj[:, :k_ns_raw], ((0, 0), (0, k_ns - k_ns_raw))),
                         group_size=gs, act_bits=4, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_s))
    n_pad = k7.padded_rows(n)
    want = torch.zeros((n_pad, k_s), dtype=x.dtype)
    want[:n, :n_sal] = x[:, k_ns_raw:]
    assert got[2].dtype == x.dtype and torch.equal(got[2], want)
    # K7a's own entry is the same body with no salient columns
    q, s = k7.quantize_acts_grouped_t(x[:, :k_ns_raw] if k_ns == k_ns_raw else
                                      torch.nn.functional.pad(x[:, :k_ns_raw],
                                                              (0, k_ns - k_ns_raw)),
                                      group_size=gs, act_bits=4)
    assert torch.equal(q, got[0]) and torch.equal(s, got[1])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("norm_kind", ["rms", None])
@pytest.mark.parametrize("n,c,gs,n_sal,k_ns,k_s", [cs for cs in CASES if cs[5] % 128 == 0])
def test_k7b_matches_jax(n, c, gs, n_sal, k_ns, k_s, norm_kind, dt):
    """K7b with its norm row, bf16 or f32 rows, the salient block in x's
    dtype: bit for bit without a norm, within the factor rule's tolerance
    with it."""
    x, xj, w = _inputs(n, c, 2 * n + c, dt)
    kw = dict(group_size=gs, act_bits=4, k_ns=k_ns, num_salient=n_sal, k_s=k_s, eps=EPS)
    got = k7.norm_quantize_acts_t(x, w, **kw, norm_kind=norm_kind, sal_dtype=x.dtype)
    ref = j_k7b(xj, jnp.asarray(w.numpy()), **kw, norm_kind=norm_kind or "none",
                sal_dtype=DTYPES[dt][1], interpret=True)
    codes = np.abs(got[0].numpy().astype(int) - np.asarray(ref[0]).astype(int))
    sal_ref = np.asarray(ref[2], np.float32)
    if norm_kind is None:
        assert codes.max(initial=0) == 0 and _ulps(got[1], ref[1]).max(initial=0) == 0
        np.testing.assert_array_equal(got[2].float().numpy(), sal_ref)
    else:
        assert codes.max(initial=0) <= 1 and (codes != 0).mean() < 0.01
        assert _ulps(got[1], ref[1]).max(initial=0) <= 4
        rel = 2.0 ** -8 if dt == "bfloat16" else 1e-6
        np.testing.assert_allclose(got[2].float().numpy(), sal_ref, rtol=rel,
                                   atol=rel * np.abs(sal_ref).max(initial=1.0))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n,c,gs,n_sal,k_ns,k_s", CASES)
def test_rms_round_matches_jax_many_rows_branch(n, c, gs, n_sal, k_ns, k_s, dt):
    """"rms_round" against what the JAX stacked path computes above 32 rows
    (real_linear.py:351-386): rms_norm rounded to x's dtype, the pad of the
    non-salient slice, K7a, the salient tail in x's dtype."""
    x, xj, w = _inputs(n, c, 3 * n + c, dt)
    got = k7.norm_quantize_acts_t(x, w, group_size=gs, act_bits=4, k_ns=k_ns, num_salient=n_sal,
                                  k_s=k_s, eps=EPS, norm_kind="rms_round", sal_dtype=x.dtype)
    xn = jax.jit(j_rms_norm, static_argnums=2)({"weight": jnp.asarray(w.numpy())}, xj, EPS)
    k_ns_raw = c - n_sal
    ref_q, ref_s = j_k7a(jnp.pad(xn[:, :k_ns_raw], ((0, 0), (0, k_ns - k_ns_raw))),
                         group_size=gs, act_bits=4, interpret=True)
    codes = np.abs(got[0].numpy().astype(int) - np.asarray(ref_q).astype(int))
    assert codes.max(initial=0) <= 1 and (codes != 0).mean() < 0.01
    ulps = _ulps(got[1], ref_s)
    if dt == "float32":   # XLA's f32 mean and rsqrt put r a few ulp from the port's rule
        assert ulps.max(initial=0) <= 8
    else:   # a bf16 step of a group's absmax, in a few groups at most
        rel = np.abs(got[1].numpy() / np.asarray(ref_s) - 1.0)
        assert rel.max(initial=0) <= 2.0 ** -7 and (ulps > 4).mean() < 0.01
    sal = np.asarray(xn[:, k_ns_raw:], np.float32)
    step = 2.0 ** -7 if dt == "bfloat16" else 1e-6
    np.testing.assert_allclose(got[2][:n, :n_sal].float().numpy(), sal, rtol=step,
                               atol=step * np.abs(sal).max(initial=1.0))
    assert not got[2][:, n_sal:].any() and not got[2][n:].any()


# ---------------------------------------------------------------- the operands


def _old_k7b_plain(x_perm, norm_w, *, group_size, act_bits, k_ns, num_salient, k_s, eps,
                   norm_kind, sal_dtype):
    """K7b's plain version as it stood before the row body (norm_kind "rms"
    or None, a norm row always)."""
    n, c = x_perm.shape
    k_ns_raw = c - num_salient
    n_pad = k7.padded_rows(n)
    p = max(c, k_ns)
    xf = torch.nn.functional.pad(x_perm.float(), (0, p - c, 0, n_pad - n))
    w = torch.nn.functional.pad(norm_w.float(), (0, p - c))
    if norm_kind == "rms":
        from smoothquant_tpu_torch.quant.core import rms_factor

        xf = xf * rms_factor(xf[:, :c], eps)
    y = xf * w
    x3, xs_t = k7.quantize_acts_grouped_t_plain(
        torch.where(torch.arange(p) < k_ns_raw, y, 0.0)[:, :k_ns],
        group_size=group_size, act_bits=act_bits)
    x_sal = torch.zeros((n_pad, k_s), dtype=torch.float32)
    if k_s:
        x_sal[:, :num_salient] = y[:, k_ns_raw:c]
    return x3, xs_t, x_sal.to(sal_dtype)


def _old_many_rows(meta, x2d, layer_idx, norm=None):
    """many_rows_operands of a permuted layout before this change: torch's
    RMSNorm rounded to x's dtype, the two pads and K7a."""
    if norm is not None:
        x2d = rms_norm({"weight": norm[0][layer_idx]}, x2d, norm[1])
    k_ns_raw = meta.in_features - meta.num_salient
    x_ns = torch.nn.functional.pad(x2d[:, :k_ns_raw], (0, meta.k_ns - k_ns_raw))
    x3, xs_t = k7.quantize_acts_grouped_t_plain(x_ns, group_size=meta.group_size,
                                                act_bits=meta.act_bits)
    x_sal = torch.nn.functional.pad(x2d[:, k_ns_raw:], (0, meta.k_s - meta.num_salient))
    return x3, xs_t, x_sal, x2d.shape[0]


def _old_k1_rows(meta, x2d, layer_idx, norm=None):
    if norm is None:
        return _old_many_rows(meta, x2d, layer_idx)
    x3, xs_t, x_sal = _old_k7b_plain(
        x2d, norm[0][layer_idx], group_size=meta.group_size, act_bits=meta.act_bits,
        k_ns=meta.k_ns, num_salient=meta.num_salient, k_s=meta.k_s, eps=float(norm[1]),
        norm_kind="rms", sal_dtype=x2d.dtype)
    n = x2d.shape[0]
    return x3, xs_t, x_sal[:n], n


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", [5, 17, 32, 33, 64])
def test_stacked_operands_unchanged(n, fused, dt):
    """k1_rows_operands (up to 32 rows) and many_rows_operands (above) give
    the codes, scales and x_sal they gave before, bit for bit, at a
    fused-norm site and a no-norm one (a Llama-like 5 % salient layout)."""
    c, gs, n_sal, layers = 1000, 64, 50, 3
    meta = types.SimpleNamespace(layout="permuted", group_size=gs, act_bits=4, k_ns=1024,
                                 num_salient=n_sal, k_s=128, in_features=c)
    packed = types.SimpleNamespace(meta=meta)
    rng = np.random.default_rng(n + 7 * fused)
    x = torch.from_numpy((rng.normal(size=(n, c)) * 3).astype(np.float32)).to(DTYPES[dt][0])
    norm = None
    if fused:
        rows = torch.from_numpy(rng.uniform(0.5, 1.5, size=(layers, c)).astype(np.float32))
        norm = (rows.to(torch.bfloat16).float(), EPS, "rms")
    new = (rl.k1_rows_operands if n <= 32 else rl.many_rows_operands)(packed, x, 1, norm)
    old = (_old_k1_rows if n <= 32 else _old_many_rows)(meta, x, 1, norm)
    assert new[3] == old[3] == n
    for a, b in zip(new[:3], old[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_chained_w_sal():
    """K5 behind the prep takes the salient block in the rows' dtype, cast
    once a pack (PackedLinear.salient_block): as stored when the dtypes
    agree, else a cast made on the first call and kept, on any device (off
    the CPU too: nothing is cast between the prep and K5)."""
    from smoothquant_tpu_torch.kernels.pack import PackedLinear

    def pack(w_sal):
        return PackedLinear(w_qt=None, w_scales_t=None, w_sal_t=w_sal, bias=None,
                            perm=None, meta=None)

    same = pack(torch.zeros((1, 8, 16), dtype=torch.bfloat16))
    other = pack(torch.arange(128, dtype=torch.float32).reshape(1, 8, 16))
    assert same.salient_block(torch.bfloat16) is same.w_sal_t
    block = other.salient_block(torch.bfloat16)
    assert block.dtype == torch.bfloat16 and torch.equal(block, other.w_sal_t.bfloat16())
    assert other.salient_block(torch.bfloat16) is block
    assert other.salient_block(torch.float32) is other.w_sal_t
    on_meta = pack(other.w_sal_t.to("meta"))
    assert on_meta.salient_block(torch.bfloat16).device.type == "meta"
    # a moved pack casts anew (its own cache)
    assert other.to("cpu").salient_block(torch.bfloat16) is not block
    # the K5 route: the block taken before the prep, nothing called between
    # the prep and K5
    src = inspect.getsource(rl._stacked_linear)
    head, _, tail = src.partition("x_q, x_scales, x_sal, pre_laid = prep(")
    assert "w_sal = packed.salient_block(x2d.dtype)" in head
    between = tail.split("return int4_group_matmul_stacked(")[0]
    assert "(" not in between.replace("packed, x2d, layer_idx, norm)", "")


# ---------------------------------------------------------------- the lane map


def _tree(s):
    """A warp's xor-shuffle tree over the last axis of 32 (every lane ends
    with the same value: each step adds the same two values)."""
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    return s[..., 0]


def row_body_emulation(x, norm_w, *, group_size, act_bits, k_ns, num_salient, k_s, eps,
                       norm_kind, sal_dtype):
    """What act_rows_kernel writes, slot by slot: lane l of the row's 32·W
    lanes (k7_plan) takes slots l, l + 32·W, …; slot i < k_ns / 8 is x's
    columns 8i .. 8i + 7 (zero past C, quantized as zero past C −
    num_salient), the next slots up to ⌈C / 8⌉ feed only Σx², the last ⌈k_s
    / 8⌉ are x_sal's chunks of the tail; Σx² in f64 by lane, an xor tree
    in the warp and one over the warps; a group is gs / 8 neighbouring lanes of one warp; padding row p
    is written by live row (p − N) mod N.  Returns the outputs and the
    writers of each padding row."""
    n, c = x.shape
    gs, gl = group_size, group_size // 8
    q8, qe, s_end = k7.row_slots(c, k_ns, k_s)
    w, _, parts, ch = k7.k7_plan(n, s_end)
    lanes = 32 * w * parts
    assert ch * lanes >= s_end
    n_pad, g = k7.padded_rows(n), k_ns // gs
    k_ns_raw = c - num_salient
    inv_qmax = np.float32(f32_reciprocal(qmax(act_bits)))
    x3 = torch.full((g, n_pad, gs), 99, dtype=torch.int8)
    xs_t = torch.full((g, n_pad), float("nan"))
    x_sal = torch.full((n_pad, k_s), float("nan"))
    writers = Counter()
    xf = x.float()
    wf = torch.ones(c) if norm_w is None else norm_w.float()
    cols = torch.tensor([8 * i if i < qe else k_ns_raw + 8 * (i - qe) for i in range(s_end)])
    cols = cols[:, None] + torch.arange(8)[None, :]                 # (S, 8)
    live = cols < c
    idx = cols.clamp(max=c - 1)
    lane_of = torch.arange(s_end) % lanes
    for g0 in range(0, q8, gl):          # a group's lanes: neighbours in one warp
        ln = lane_of[g0:g0 + gl]
        assert torch.equal(ln, ln[0] + torch.arange(gl)) and len(set((ln // 32).tolist())) == 1
    for row in range(n):
        v = torch.where(live, xf[row][idx], 0.0)
        if norm_kind is not None:
            p = v.double() ** 2                         # a slot's 8 squares in order
            sq = p[:, 0]
            for e in range(1, 8):
                sq = sq + p[:, e]
            lane_sum = torch.zeros(ch * lanes, dtype=torch.float64)
            lane_sum[:qe] = sq[:qe]
            per_lane = lane_sum.reshape(ch, lanes)
            acc = torch.zeros(lanes, dtype=torch.float64)
            for k in range(ch):                                                # slots in order
                acc = acc + per_lane[k]
            ss = _tree(acc.reshape(parts, w, 32))   # (parts, warps)
            while ss.shape[1] > 1:                  # a block's warps' sums: an xor tree
                o = ss.shape[1] // 2
                ss = ss[:, :o] + ss[:, o:]
            tot = ss[0, 0]
            for rank in range(1, parts):            # the blocks of the row in rank order
                tot = tot + ss[rank, 0]
            # rounded to f32 once; then 1/√(v·f32(1/C) + eps) as rms_factor rounds it
            ss32 = torch.tensor([tot.item()], dtype=torch.float64).float()
            r = torch.reciprocal(torch.sqrt(ss32 * f32_reciprocal(c) + eps))
            v = v * r
        y = v * torch.where(live, wf[idx], 0.0 if norm_w is not None else 1.0)
        if norm_kind == "rms_round":
            y = y.to(x.dtype).float()
        quant = torch.arange(s_end)[:, None] < q8
        y = torch.where(quant & (cols >= k_ns_raw), 0.0, y)
        amax = y[:q8].abs().amax(-1).reshape(g, gl).amax(-1)                 # (G,)
        scale = torch.clamp_min(amax, 1e-5) * torch.tensor(inv_qmax)
        codes = torch.round(y[:q8].reshape(g, gl, 8) / scale[:, None, None]).to(torch.int8)
        x3[:, row] = codes.reshape(g, gs)
        xs_t[:, row] = scale
        for j in range(qe, s_end):
            j0 = 8 * (j - qe)
            x_sal[row, j0:min(j0 + 8, k_s)] = y[j, :min(8, k_s - j0)]
        for p in range(n + row, n_pad, n):
            writers[p] += 1
            x3[:, p] = 0
            xs_t[:, p] = float(np.float32(1e-5) * inv_qmax)
            x_sal[p] = 0.0
    assert not torch.isnan(xs_t).any() and not torch.isnan(x_sal).any() and (x3 != 99).all()
    return (x3, xs_t, x_sal.to(sal_dtype)), writers


@pytest.mark.parametrize("kind", ["rms", "rms_round", "none_w", "none"])
@pytest.mark.parametrize("n,c,gs,n_sal,k_ns,k_s", CASES + [(140, 1000, 32, 50, 960, 64),
                                                           (1, 7, 16, 0, 16, 0),
                                                           (2, 17000, 64, 850, 16192, 896)])
def test_lane_map_emulation_matches_plain(n, c, gs, n_sal, k_ns, k_s, kind):
    x, _, w = _inputs(n, c, 5 * n + c, "bfloat16")
    kw = dict(group_size=gs, act_bits=4, k_ns=k_ns, num_salient=n_sal, k_s=k_s, eps=EPS,
              sal_dtype=torch.bfloat16)
    norm_w = None if kind == "none" else w
    norm_kind = kind if kind.startswith("rms") else None
    got, writers = row_body_emulation(x, norm_w, **kw, norm_kind=norm_kind)
    ref = k7.norm_quantize_acts_t_plain(x, norm_w, **kw, norm_kind=norm_kind)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # every padding row written once, by a live row's warps
    assert writers == Counter({p: 1 for p in range(n, k7.padded_rows(n))})


# ---------------------------------------------------------------- plan and refusals


@pytest.mark.parametrize("n,c,k_ns,k_s,want", [
    (8, 4096, 4096, 256, (16, 1, 1, 2)),        # qkv / gate_up: 544 slots, two a lane
    (64, 4096, 4096, 256, (16, 1, 1, 2)),
    (64, 11008, 11264, 640, (16, 1, 2, 2)),     # down: 1488 slots over two blocks
    (4, 16384, 15616, 896, (16, 1, 4, 2)),      # Bloom's dense_4h_to_h at 4 rows: four
    (130, 16384, 15616, 896, (16, 1, 1, 8)),    # and at 130: one, the SMs taken
    (2048, 4096, 4096, 256, (16, 1, 1, 2)),
    (4, 8, 16, 0, (1, 1, 1, 1)),
    (4, 512, 512, 0, (1, 1, 1, 2)),
    (33, 1001, 960, 53, (4, 1, 1, 2)),
    (1, 40000, 40000, 0, (16, 1, 8, 2)),
])
def test_k7_plan(n, c, k_ns, k_s, want):
    slots = k7.row_slots(c, k_ns, k_s)[2]
    w, r, p, ch = k7.k7_plan(n, slots)
    assert (w, r, p, ch) == want
    assert 32 * w * p * ch >= slots and ch in k7.CHUNKS and r == 1
    # the least warps for two slots a lane; then blocks, while the SMs allow
    assert w == 1 or 32 * (w // 2) * k7.LANE_CHUNKS < slots
    assert p == 1 or (32 * w * (p // 2) * k7.LANE_CHUNKS < slots and n * p <= k7.SMS)


def test_row_slots():
    # quantize chunks, the Σx²-only chunks past k_ns, x_sal's chunks
    assert k7.row_slots(4096, 4096, 256) == (512, 512, 544)
    assert k7.row_slots(1001, 960, 53) == (120, 126, 133)
    assert k7.row_slots(320, 384, 0) == (48, 48, 48)


@pytest.mark.parametrize("case,exc,match", [
    (dict(group_size=48), ValueError, "group sizes"),
    (dict(group_size=512, k_ns=1024), ValueError, "group sizes"),
    (dict(act_bits=9), ValueError, "bits"),
    (dict(num_salient=600), ValueError, "salient"),
    (dict(norm_kind="layer"), ValueError, "norm_kind"),
    (dict(norm_kind="rms_round", body="groups"), ValueError, "groups body"),
    (dict(group_size=256, body="groups"), ValueError, "whole groups"),
    (dict(body="tiles"), ValueError, "no 'tiles' body"),
    (dict(norm_w=None, norm_kind="rms"), ValueError, "norm row"),
    (dict(c=300000, k_ns=300032), ValueError, "slots"),
])
def test_row_args_refuse(case, exc, match):
    """What the CUDA path refuses before any launch (on meta tensors: the
    checks run first, then no kernel for the device)."""
    args = dict(c=512, group_size=64, act_bits=4, k_ns=512, num_salient=25, k_s=128,
                norm_kind="rms", norm_w=torch.ones(512), body="rows")
    args.update(case)
    c = args.pop("c")
    if "norm_w" in case and case["norm_w"] is not None:
        pass
    norm_w = args.pop("norm_w")
    if norm_w is not None and norm_w.shape[0] != c:
        norm_w = torch.ones(c)
    with pytest.raises(exc, match=match):
        k7.row_args(torch.zeros((4, c), device="meta"), norm_w, **args)


def test_wrappers_off_the_cpu_launch_or_raise():
    """On a device with no kernel the wrappers check, then raise: no plain
    fallback; K7b refuses a missing norm row everywhere."""
    x = torch.zeros((4, 512), device="meta")
    kw = dict(group_size=64, act_bits=4, k_ns=512, num_salient=25, k_s=128)
    with pytest.raises(RuntimeError, match="no kernel"):
        k7.norm_quantize_acts_t(x, torch.ones(512, device="meta"), **kw, eps=EPS)
    with pytest.raises(RuntimeError, match="no kernel"):
        k7.quantize_acts_split_t(x, **kw)
    with pytest.raises(RuntimeError, match="no kernel"):
        k7.quantize_acts_grouped_t(x, group_size=64, act_bits=4, body="groups")
    with pytest.raises(ValueError, match="group sizes"):
        k7.quantize_acts_grouped_t(x, group_size=128 + 64, act_bits=4)
    for xx in (x, torch.zeros((4, 512))):
        with pytest.raises(ValueError, match="norm row"):
            k7.norm_quantize_acts_t(xx, None, **kw, eps=EPS, norm_kind=None)
    assert k7.LAUNCH_KEYS["quantize_acts_grouped_t"]["rows"] == "quantize_acts_grouped_t"
    assert k7.LAUNCH_KEYS["norm_quantize_acts_t"]["rows"] == "norm_quantize_acts_t"


def test_entry_signatures_match_the_sources():
    """Every exported C entry point has a ctypes signature of as many
    arguments as its declaration (a missing one lets ctypes guess)."""
    decls = {}
    for f in sorted(os.listdir(_build.CSRC)):
        if f.endswith(".cu"):
            text = open(os.path.join(_build.CSRC, f)).read()
            for m in re.finditer(r"SQ_EXPORT [\w ]+?(sq_\w+)\(([^)]*)\)", text):
                decls[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    assert set(decls) == set(_build._SIGNATURES)
    for name, n_args in decls.items():
        assert len(_build._SIGNATURES[name][0]) == n_args, name


# ---------------------------------------------------------------- accounting and scripts


def test_step_launches():
    """Above K1's rows every permuted site's prep is one launch of K7's row
    body: K7b at qkv and gate_up, K7a at down (o_proj quantizes by torch
    ops); the same counts at 5-32 rows and above."""
    import chip_smoke as cs
    from smoothquant_tpu_torch.models.bloom import BloomConfig
    from smoothquant_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama2_7b()
    n_l = cfg.num_hidden_layers
    for b in (5, 32, 33, 64):
        got = cs.step_launches(cfg, b, "off")
        assert got["norm_quantize_acts_t"] == 2 * n_l
        assert got["quantize_acts_grouped_t"] == n_l
        assert got["int4_group_matmul_stacked"] == 4 * n_l
        assert "norm_quantize_acts_t_groups" not in got and "quantize_acts_grouped_t_groups" \
            not in got
    assert "quantize_acts_grouped_t" not in cs.step_launches(cfg, 4, "off")
    fused = cs.step_launches(cfg, 8, "auto", fuse_mlp=True)
    assert fused["norm_quantize_acts_t"] == n_l and "quantize_acts_grouped_t" not in fused
    bloom = cs.bloom_step_launches(BloomConfig(num_hidden_layers=30), 64)
    assert bloom["quantize_acts_grouped_t"] == bloom["int4_group_matmul_stacked"] == 120


def test_act_variants_edits():
    """Each source variant's edits match the committed sources exactly once,
    each host variant's plan is one the C entry takes, and every case a
    variant reads exists."""
    import act_variants as av

    for name in av.VARIANTS:
        assert av.variant_sources(name, _build.CSRC)
    for name, opts in av.HOST.items():
        if "plan" in opts:
            for slots in (2, 64, 544, 1488, 2160):
                w, r, p, ch = opts["plan"](64, slots, k7.k7_plan(64, slots))
                assert w in (1, 2, 4, 8, 16) and r >= 1 and p in (1, 2, 4, 8)
                assert w * r <= 16 and (p == 1 or r == 1)
                assert ch not in k7.CHUNKS or 32 * w * p * ch >= slots
        else:
            assert opts == {"body": "groups"}
    assert set(av.READ_AT) == set(av.VARIANTS) | set(av.HOST)
    names = {case for case, _, _ in _tiny_cases()}
    assert all(set(v) <= names for v in av.READ_AT.values())
    with pytest.raises(ValueError, match="exactly once"):
        av.apply_edits("int x;", [("int y;", "int z;")])


def _tiny_cases():
    return [(n, None, None) for n in ("k7b@8", "k7b@32", "prep@64", "down@64", "rows@2048",
                                      "c16384@4", "none16384@4", "none@4",
                                      "c16384@130", "pair@32", "pair@64", "k5@32", "k5@64")]


def test_act_variants_case_names_are_the_scripts():
    import act_variants as av

    doc = av.__doc__
    for case, _, _ in _tiny_cases():
        assert case.split("@")[0] in doc


def test_k7_edges_rehearsal(monkeypatch):
    """chip_smoke's k7_edges at small shapes on the CPU (the plain versions
    against themselves: zero codes moved), its control flow and counts."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "K7_EDGE_SHAPES", ((8, 16, "pack"), (100, 32, "odd"),
                                               (1000, 64, "odd"), (520, 256, "odd")))
    monkeypatch.setattr(cs, "K7_EDGE_ROWS", (1, 9))
    out = cs.check_k7_edges(torch.device("cpu"))
    assert out["cases"] == 4 * 2 * 2 * 4 and out["n_diff"] == 0
    assert out["repeated_calls_identical"] == out["cases"]
    # the groups body beside: K7b with a norm row up to group size 128, and K7a's entry
    assert out["groups_body_cases"] == 3 * 2 * 2 * 3 and out["n_diff_groups_body"] == 0


def test_prep_and_chain_phases_rehearsal(monkeypatch):
    """chip_smoke's prep rows at 8, 32 and 40 rows and its k7_k5_chain phase
    on a small stacked Llama on the CPU (timing stubbed): the sites, modes
    and keys the card run reports, every code identical to the plain
    version's, the route before held to it too, and the old-route profile
    restoring the path's operand functions."""
    import dataclasses

    import chip_smoke as cs
    from smoothquant_tpu_torch.models.llama import LlamaConfig

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n_iter, reps=5: (fn(0), 0.0)[1])
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=512), hidden_size=256,
                              intermediate_size=512, num_attention_heads=2,
                              num_key_value_heads=2, num_hidden_layers=2, dtype="bfloat16")
    cpu = torch.device("cpu")
    _, _, stacked = cs.build_model(cfg, cpu, cs.SEED)
    gen = torch.Generator().manual_seed(3)
    rows = []
    for n, main in ((40, True), (8, False), (32, False)):
        rows += cs.check_act_prep(stacked, cpu, gen, n, main)
    got = [(r["kernel"], r["site"], r["norm_kind"]) for r in rows]
    assert got == [
        ("norm_quantize_acts_t", "qkv", "rms_round"), ("norm_quantize_acts_t", "gate_up",
                                                       "rms_round"),
        ("quantize_acts_grouped_t", "down", None),
        ("norm_quantize_acts_t", "qkv@8", "rms"), ("norm_quantize_acts_t", "gate_up@8", "rms"),
        ("quantize_acts_grouped_t", "down@8", None),
        ("norm_quantize_acts_t", "qkv@32", "rms"), ("norm_quantize_acts_t", "gate_up@32", "rms"),
        ("quantize_acts_grouped_t", "down@32", None)]
    assert all(r["max_err"] == 0 and r["n_diff"] == 0 and r["n_diff_old_route"] == 0
               for r in rows)
    assert [r["in_sum"] for r in rows] == [True] * 3 + [False] * 6
    # an old body beside each row but "rms_round", whose route before was several launches
    assert all(("old_body_ms" in r) == (r["norm_kind"] != "rms_round") for r in rows)
    assert "k7a_entry_ms" in rows[2] and "old_route_ms" in rows[0]
    chain = cs.check_k7_k5_chain(stacked, cpu, gen, rows=(8, 40))
    assert set(chain) == {8, 40} and chain[40]["site"] == "qkv"
    from smoothquant_tpu_torch.kernels import real_linear as rl

    before = rl.k1_rows_operands, rl.many_rows_operands
    monkeypatch.setattr(cs, "profile", lambda fn, steps: (fn(), {})[1])
    seen = []
    cs._old_route_profile(lambda n: seen.append(rl.many_rows_operands), 2)
    assert seen and seen[0] is not before[1]
    assert (rl.k1_rows_operands, rl.many_rows_operands) == before

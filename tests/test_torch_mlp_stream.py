"""K14's stream body (csrc/mlp_fused.cu sq_mlp_stream: gate_up on
stream_gmm.cuh's stream_swiglu_kernel, down on K5's stream kind) on the CPU:
its body rule, its paired column map and the cluster ranks' shares of its
epilogue, and a PyTorch emulation of that epilogue — from gate_up's f32
output to SiLU·up and down's row-major codes, scales and bf16 salient block,
tile by tile and rank share by rank share as the kernel walks them — held
bit for bit to the plain path's group quantize of the same SiLU·up, and the
whole composition (plain gate_up, the emulated epilogue, plain K5 over its
codes) to the JAX package's kernel.

Tolerances.  The emulated SiLU·up takes the kernel's expression, g / (1 +
exp(−g)) · u, whose exp differs from torch's silu in the last bits: the two
stay within 4 ulp (relative 2.4e-7 of the larger).  The whole is held to
JAX as tests/test_torch_mlp_fused.py holds the plain version (bf16 x:
rtol 2^-6, atol 5e-3 of the largest output): a last-bit difference may move
a down_proj activation code across a rounding edge; a wrong tile, group or
rank share misses by O(1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import real_linear as jreal
from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
from smoothquant_tpu_torch.kernels import mlp_fused as tk14
from smoothquant_tpu_torch.kernels import stream_gmm
from smoothquant_tpu_torch.quant.core import f32_reciprocal
from test_torch_int4_group_matmul import _sr_code
from test_torch_mlp_fused import _packs

torch.set_num_threads(1)

BF16 = torch.bfloat16


@pytest.mark.parametrize("case,want", [
    # the serving pack's gate_up + down (Llama-2-7B, g64, 5 % salient), 1-8 rows
    ((4, 4096, 22528, 4096, 256, 4096, 11008, 64, BF16), "stream"),
    ((1, 4096, 22528, 4096, 256, 4096, 11008, 64, BF16), "stream"),
    ((8, 4096, 22528, 4096, 256, 4096, 11008, 64, BF16), "stream"),
    ((4, 256, 512, 256, 16, 256, 256, 16, BF16), "stream"),
    ((4, 256, 512, 256, 16, 256, 256, 32, BF16), "stream"),
    ((4, 4096, 22528, 4096, 256, 4096, 11008, 64, torch.float32), "coop"),   # f32 x
    ((4, 4096, 22528, 4096, 256, 4096, 11008, 128, BF16), "coop"),   # group size 128
    ((9, 4096, 22528, 4096, 256, 4096, 11008, 64, BF16), "coop"),    # past 8 rows
    ((4, 4100, 22528, 4096, 256, 4096, 11008, 64, BF16), "coop"),    # C % 8
    ((4, 4096, 22520, 4096, 256, 4096, 11008, 64, BF16), "coop"),    # O1 % 16
    ((4, 4096, 22528, 4096, 256, 4100, 11008, 64, BF16), "coop"),    # O2 % 16
    ((4, 256, 400, 256, 16, 256, 200, 32, BF16), "coop"),    # inter % 16: up boxes off 16 bytes
    ((4, 256, 416, 256, 16, 256, 208, 32, BF16), "stream"),
    # gate_up's salient tiles fit a block's shared memory in no split of
    # its stages (over 297 salient stages a rank even in eight ranks)
    ((8, 4096, 22528, 4096, 80000, 4096, 11008, 64, BF16), "coop"),
    ((8, 4096, 22528, 4096, 15000, 4096, 11008, 64, BF16), "stream"),   # two ranks
])
def test_mlp_body_rule(case, want):
    n, c, o1, kk1, k_s1, o2, inter, gs, dt = case
    assert tk14.mlp_body(n, c, o1, kk1, k_s1, o2, inter, gs, dt) == want


def test_serving_pack_launch_plan():
    """At the serving pack's widths: 172 gate_up tiles (11008 / 64) in one
    rank each (more tiles than SMs), the last covering channels up to
    down's padded 11264 (four zero segments past inter); down's 32 tiles
    in four ranks, 128 blocks."""
    inter, kk2, n_sal2, k_s2 = 11008, 11264, 550, 640
    n_tiles = stream_gmm.k14_tiles(inter)
    assert n_tiles == 172
    assert stream_gmm.k1_split(128 * n_tiles, stream_gmm.k5_stages(4096, 64, 256, True), 4, 64,
                               8) == 1
    assert stream_gmm.k14_c_end(inter, kk2, inter - n_sal2, k_s2, k_s2) == 11264
    shares = stream_gmm.k14_shares(n_tiles - 1, n_tiles, 11264, 64, 1)
    assert len(shares[0]) == 5 * 8
    assert stream_gmm.split(4096, stream_gmm.k5_stages(kk2, 64, k_s2, True)) == 4


@pytest.mark.parametrize("inter,o1", [(704, 1536), (208, 416), (192, 384), (11008, 22528)])
def test_paired_column_map_covers_each_column_once(inter, o1):
    """Over the tiles, the gate halves cover gate columns 0 .. inter − 1 and
    the up halves up columns inter .. 2·inter − 1 once each, column i of a
    tile's gate half and of its up half being one channel of down's input;
    columns past 2·inter (O1's pad, or past O1: TMA's zero fill) and the
    last tile's gate columns past inter land on channels the epilogue
    masks."""
    seen = np.zeros(o1 + 64, np.int64)
    for t in range(stream_gmm.k14_tiles(inter)):
        gate, up = stream_gmm.k14_columns(t, inter)
        assert len(gate) == len(up) == 64
        for i, (g, u) in enumerate(zip(gate, up)):
            channel = 64 * t + i
            assert g == channel and u == inter + channel
            if channel < inter:
                seen[g] += 1
                seen[u] += 1
    assert (seen[:2 * inter] == 1).all() and not seen[2 * inter:].any()


@pytest.mark.parametrize("gs", [16, 32, 64])
@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
@pytest.mark.parametrize("inter,kk2,n_sal2,k_s2", [(704, 768, 35, 40), (208, 256, 10, 16),
                                                   (11008, 11264, 550, 640), (256, 256, 0, 0)])
def test_rank_shares_keep_groups_whole(gs, n_split, inter, kk2, n_sal2, k_s2):
    """The ranks' shares of each tile's epilogue partition its items, each
    item one whole group of down's input on one row (rows padded to 8):
    every group of every row up to c_end falls to exactly one rank, so no
    group's absmax spans two ranks, and the tiles together cover down's
    codes (kk2) and its salient columns."""
    xsal_rs = k_s2 + (-k_s2 % 8)
    n_tiles = stream_gmm.k14_tiles(inter)
    c_end = stream_gmm.k14_c_end(inter, kk2, inter - n_sal2, xsal_rs, k_s2)
    assert c_end % 64 == 0 and c_end >= max(kk2, 64 * n_tiles)
    if k_s2:
        assert c_end >= inter - n_sal2 + xsal_rs
    owner = {}
    for t in range(n_tiles):
        shares = stream_gmm.k14_shares(t, n_tiles, c_end, gs, n_split)
        assert len(shares) == n_split
        flat = [it for s in shares for it in s]
        assert len(flat) == len(set(flat))
        for r, share in enumerate(shares):
            for c0, row in share:
                assert c0 % gs == 0 and 0 <= row < 8
                assert (c0, row) not in owner
                owner[(c0, row)] = (t, r)
    assert set(owner) == {(c0, row) for c0 in range(0, c_end, gs) for row in range(8)}


def _swiglu_epilogue(gu, *, inter, kk2, n_sal2, k_s2, gs, n_split, act_bits=4):
    """PyTorch emulation of what launch 1's epilogue (sw_epilogue) writes
    from gate_up's f32 output gu (N, O1): each tile's partial tile — gate
    columns of k14_columns in its first 64 columns, up in the next 64, TMA's
    zero past O1 — then each rank's items in order, each group summed into
    SiLU·up by the kernel's expression, its channels from k_ns2_raw on
    masked, scale max(absmax, 1e-5)·(1/qmax), codes by _sr_code's rule
    (rint of the true quotient); codes and scale written where the group
    lies below kk2, the salient columns (zero past inter) rounded to bf16.
    Unwritten places keep sentinels (codes −99, NaN), so coverage shows."""
    n, o1 = gu.shape
    k_ns2 = inter - n_sal2
    xsal_rs = k_s2 + (-k_s2 % 8)
    n_tiles = stream_gmm.k14_tiles(inter)
    c_end = stream_gmm.k14_c_end(inter, kk2, k_ns2, xsal_rs, k_s2)
    inv_qmax = f32_reciprocal(2 ** (act_bits - 1) - 1)
    xq = torch.full((n, kk2), -99, dtype=torch.int8)
    xs = torch.full((n, kk2 // gs), float("nan"))
    xsal = torch.full((n, xsal_rs), float("nan")) if k_s2 else None
    h_all = torch.zeros((n, c_end))
    for t in range(n_tiles):
        tile = torch.zeros((8, 128))
        for half, cols in enumerate(stream_gmm.k14_columns(t, inter)):
            idx = torch.tensor([cl for cl in cols if cl < o1])
            tile[:n, 64 * half:64 * half + len(idx)] = gu[:, idx]
        for share in stream_gmm.k14_shares(t, n_tiles, c_end, gs, n_split):
            for c0, row in share:
                if row >= n:
                    continue
                cl = c0 - 64 * t
                if cl < 64:
                    g, u = tile[row, cl:cl + gs], tile[row, 64 + cl:64 + cl + gs]
                    h = g / (1.0 + torch.exp(-g)) * u
                else:
                    h = torch.zeros(gs)
                ch = c0 + torch.arange(gs)
                h_all[row, c0:c0 + gs] = h
                y = torch.where(ch < k_ns2, h, torch.zeros(()))
                scale = torch.clamp_min(y.abs().max(), 1e-5) * inv_qmax
                codes = _sr_code(y, scale).to(torch.uint8).view(torch.int8)
                if c0 < kk2:
                    xq[row, c0:c0 + gs] = codes
                    xs[row, c0 // gs] = scale
                if k_s2:
                    j = ch - k_ns2
                    keep = (j >= 0) & (j < xsal_rs)
                    val = torch.where(ch < inter, h, torch.zeros(())).to(BF16).float()
                    xsal[row, j[keep]] = val[keep]
    return xq, xs, xsal, h_all


def _gate_up_f32(tgu, x, norm_w, layer, kw):
    """gate_up's f32 output as the plain path makes it (K1's plain version,
    the norm fused, salient block in x's dtype)."""
    norm = None if norm_w is None else norm_w.float()[None].expand(tgu.w_qt.shape[0], -1)
    return k1.rawx_plain(layer, x, norm, tgu.w_qt, tgu.w_scales_t, tgu.w_sal_t.to(x.dtype),
                         group_size=kw["group_size"], act_bits=kw["act_bits"],
                         num_salient=kw["n_sal1"], eps=kw["eps"],
                         norm_kind="rms" if norm is not None else None,
                         out_dtype=torch.float32)


@pytest.mark.parametrize("salient_prop", [0.0, 0.05])
@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_epilogue_emulation_matches_plain_intermediates(salient_prop, n_split, n):
    """The emulated epilogue on the plain gate_up output: SiLU·up within 4
    ulp of torch's silu(gate)·up, and from the same SiLU·up the plain path's
    codes, scales and salient block bit for bit, every place written (the
    salient columns past n_sal2 zero)."""
    qcfg, gu, dn, (tgu, tdn) = _packs(salient_prop=salient_prop, scale_dtype="bfloat16")
    rng = np.random.default_rng(n + 11 * n_split)
    x = torch.from_numpy(rng.normal(size=(n, gu.meta.in_features)).astype(np.float32)).to(BF16)
    norm_w = torch.from_numpy(rng.uniform(0.5, 1.5, size=gu.meta.in_features).astype(np.float32))
    kw = dict(group_size=qcfg.group_size, act_bits=qcfg.effective_act_bits,
              n_sal1=gu.meta.num_salient, eps=1e-5)
    inter, gs = dn.meta.in_features, qcfg.group_size
    kk2, k_s2, n_sal2 = 2 * tdn.w_qt.shape[1], tdn.w_sal_t.shape[1], dn.meta.num_salient
    y = _gate_up_f32(tgu, x, norm_w.to(BF16), 1, kw)
    xq, xs, xsal, h = _swiglu_epilogue(y, inter=inter, kk2=kk2, n_sal2=n_sal2, k_s2=k_s2,
                                       gs=gs, n_split=n_split)
    ref_h = torch.nn.functional.silu(y[:, :inter]) * y[:, inter:2 * inter]
    ulp = torch.maximum(h[:, :inter].abs(), ref_h.abs()) * 2.0 ** -23
    assert ((h[:, :inter] - ref_h).abs() <= 4 * ulp + 1e-30).all()
    x_q, x_s, x_sal = k1.rawx_quantize_plain(
        h[:, :inter], None, None, kk=kk2, k_s=k_s2, group_size=gs, act_bits=kw["act_bits"],
        num_salient=n_sal2, eps=0.0, norm_kind=None, sal_dtype=BF16)
    assert torch.equal(xq, x_q) and torch.equal(xs, x_s)
    if k_s2:
        assert torch.equal(xsal[:, :k_s2], x_sal) and not xsal[:, k_s2:].any()
        assert xsal[:, n_sal2:].eq(0).all()
    else:
        assert xsal is None


@pytest.mark.parametrize("n", [1, 3, 8])
def test_stream_composition_matches_jax(n):
    """The stream body's whole chain on the CPU — plain gate_up with the
    RMSNorm fused, the emulated epilogue (ranks of the split its rule
    plans), plain K5 over its row-major codes — against the JAX package's
    real_mlp_fused (the Pallas kernel in interpret mode) on bf16 x, and
    against the port's plain K14 (torch's silu) within a bf16 rounding."""
    qcfg, gu, dn, (tgu, tdn) = _packs(salient_prop=0.05, seed=2, scale_dtype="bfloat16")
    rng = np.random.default_rng(9 + n)
    x = rng.normal(size=(n, gu.meta.in_features)).astype(np.float32)
    norm_w = rng.uniform(0.5, 1.5, size=(gu.meta.in_features,)).astype(np.float32)
    layer, gs = 2, qcfg.group_size
    kw = dict(group_size=gs, act_bits=qcfg.effective_act_bits, n_sal1=gu.meta.num_salient,
              eps=1e-5)
    xt = torch.from_numpy(x).to(BF16)
    y = _gate_up_f32(tgu, xt, torch.from_numpy(norm_w).to(BF16), layer, kw)
    inter, kk2, k_s2 = dn.meta.in_features, 2 * tdn.w_qt.shape[1], tdn.w_sal_t.shape[1]
    n_tiles = stream_gmm.k14_tiles(inter)
    split = stream_gmm.k1_split(128 * n_tiles,
                                stream_gmm.k5_stages(2 * tgu.w_qt.shape[1], gs,
                                                     tgu.w_sal_t.shape[1], True),
                                n, gs, -(-tgu.w_sal_t.shape[1] // 32))
    xq, xs, xsal, _ = _swiglu_epilogue(y, inter=inter, kk2=kk2, n_sal2=dn.meta.num_salient,
                                       k_s2=k_s2, gs=gs, n_split=split)
    got = k1.int4_group_matmul_stacked_plain(
        layer, xq, xs, tdn.w_qt, tdn.w_scales_t,
        (xsal[:, :k_s2] if k_s2 else torch.zeros((n, 0))).to(BF16), tdn.w_sal_t.to(BF16),
        group_size=gs, out_dtype=BF16)[:, :dn.meta.out_features]
    ref = jreal.real_mlp_fused(gu, dn, jnp.asarray(x[None], jnp.bfloat16), layer_idx=layer,
                               norm=(jnp.asarray(norm_w), 1e-5, "rms"), interpret=True)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))[0]
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -6,
                               atol=5e-3 * np.abs(ref).max())
    plain = tk14.mlp_swiglu_fused_stacked(
        layer, xt, torch.from_numpy(norm_w).to(BF16), tgu.w_qt, tgu.w_scales_t,
        tgu.w_sal_t.to(BF16), tdn.w_qt, tdn.w_scales_t, tdn.w_sal_t.to(BF16), **kw,
        n_sal2=dn.meta.num_salient, gu_out_true=gu.meta.out_features,
        dn_out_true=dn.meta.out_features)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=2.0 ** -7,
                               atol=5e-3 * plain.float().abs().max().item())


def test_wrapper_options_run_plain_on_cpu():
    """On CPU tensors every body option takes the plain version and no
    launch is counted."""
    from smoothquant_tpu_torch.kernels import _build

    qcfg, gu, dn, (tgu, tdn) = _packs(salient_prop=0.05, scale_dtype="bfloat16")
    x = torch.ones((2, gu.meta.in_features), dtype=BF16)
    args = (0, x, None, tgu.w_qt, tgu.w_scales_t, tgu.w_sal_t.to(BF16), tdn.w_qt,
            tdn.w_scales_t, tdn.w_sal_t.to(BF16))
    kw = dict(group_size=qcfg.group_size, act_bits=qcfg.effective_act_bits,
              n_sal1=gu.meta.num_salient, n_sal2=dn.meta.num_salient,
              gu_out_true=gu.meta.out_features, dn_out_true=dn.meta.out_features)
    _build.reset_launches()
    base = tk14.mlp_swiglu_fused_stacked(*args, **kw)
    for opts in ({"body": "coop"}, {"body": "stream"}):
        assert torch.equal(tk14.mlp_swiglu_fused_stacked(*args, **kw, **opts), base)
    assert sum(_build.LAUNCHES.values()) == 0
    assert tk14.LAUNCH_KEYS["stream"] == ("mlp_swiglu_fused_stacked",
                                          "mlp_swiglu_fused_stacked_down")

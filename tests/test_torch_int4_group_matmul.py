"""K1 (int4_group_matmul_stacked_rawx), K5 (int4_group_matmul_stacked) and
K6 (int4_group_matmul) plain PyTorch versions vs the JAX Pallas kernels in
interpret mode, plus the real_quant_linear dispatch that reaches them.
Tolerance rtol=atol=2e-4: both sides accumulate the same exact integer
group products in f32, in different orders (K5: within 1e-5 of the
output's norm)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.kernels import real_linear as jreal
from smoothquant_tpu.kernels.act_prep import quantize_acts_grouped_t as j_quant_t
from smoothquant_tpu.kernels.int4_group_matmul import (
    int4_group_matmul as j_gmm,
    int4_group_matmul_stacked as j_stacked,
    int4_group_matmul_stacked_rawx as j_rawx,
)
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.kernels import real_linear as treal
from smoothquant_tpu_torch.kernels.act_prep import quantize_acts_grouped_t
from smoothquant_tpu_torch.kernels import stream_gmm
from smoothquant_tpu_torch.kernels.int4_group_matmul import (
    gmm_body,
    int4_group_matmul,
    int4_group_matmul_stacked,
    int4_group_matmul_stacked_rawx,
    rawx_body,
    rawx_quantize_plain,
    stacked_body,
)
from smoothquant_tpu_torch.utils import roofline
from smoothquant_tpu_torch.utils.convert import packed_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
N, C, O, GS, L = 4, 200, 96, 16, 2
EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch(jp):
    d = {f: None if getattr(jp, f) is None else np.asarray(getattr(jp, f))
         for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")}
    d["meta"] = dataclasses.asdict(jp.meta)
    return packed_from_numpy(d, "cpu")


def _packs(identity: bool, scale_dtype: str, stacked: bool, seed=0,
           salient_prop=0.05):
    """JAX pack(s) of an (O, C) linear — stacked over L layers or one —
    and the port's converted twin."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(jw4a4_group(group_size=GS, salient_prop=salient_prop),
                              scale_dtype=scale_dtype)
    imp = rng.uniform(0.1, 1.0, size=(C,))
    packs = []
    for _ in range(L if stacked else 1):
        w = rng.normal(size=(O, C)).astype(np.float32) * C ** -0.5
        w[:, 5] *= 15.0
        packs.append(jpack.pack_linear(
            {"weight": jnp.asarray(w), "bias": None}, cfg, importance=imp,
            compute_dtype=jnp.float32, nibble=True, align_k_groups=8,
            align_o=128, identity=identity))
    jp = (jax.tree.map(lambda *xs: jnp.stack(xs), *packs) if stacked
          else packs[0])
    return jp, _to_torch(jp)


def _x(seed=1, n=N):
    x = np.random.default_rng(seed).normal(size=(n, C)).astype(np.float32)
    x[:, 7] *= 12.0
    return x


MODES = ["rms", "raw", "mask"]


def _rawx_case(mode, scale_dtype, n, seed):
    jp, tp = _packs(identity=mode == "mask", scale_dtype=scale_dtype,
                    stacked=True)
    x = _x(seed=seed, n=n)
    m = tp.meta
    common = dict(group_size=m.group_size, act_bits=m.act_bits,
                  num_salient=m.num_salient)
    x_sal = norm = None
    if mode == "rms":
        norm = np.random.default_rng(2).uniform(0.5, 1.5, size=(L, C)).astype(
            np.float32)
    elif mode == "mask":
        norm = np.asarray(jp.ns_mask)
        sal_idx = np.asarray(jp.perm)[1, C - m.num_salient:]
        x_sal = np.zeros((n, m.k_s), np.float32)
        x_sal[:, :m.num_salient] = x[:, sal_idx]
    kind = {"rms": "rms", "raw": None, "mask": "mask"}[mode]
    ref = j_rawx(jnp.ones((1,), jnp.int32), jnp.asarray(x),
                 None if norm is None else jnp.asarray(norm), jp.w_qt,
                 jp.w_scales_t, jp.w_sal_t,
                 None if x_sal is None else jnp.asarray(x_sal),
                 eps=EPS, norm_kind=kind or "rms", interpret=True, **common)
    got = int4_group_matmul_stacked_rawx(
        1, _t(x), None if norm is None else _t(norm), tp.w_qt, tp.w_scales_t,
        tp.w_sal_t, None if x_sal is None else _t(x_sal), eps=EPS,
        norm_kind=kind, **common)
    assert got.shape == (n, tp.w_qt.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_rawx_plain_matches_jax(mode, scale_dtype):
    """K1 in its three modes: fused RMSNorm (qkv / gate_up), raw pre-permuted
    tail-salient (down_proj), and the identity layout's 0/1 mask with a
    pre-gathered x_sal (o_proj)."""
    _rawx_case(mode, scale_dtype, N, seed=1)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("mode", MODES)
def test_rawx_plain_many_rows_matches_jax(mode, n):
    """K1 at 16 and 32 token rows (the JAX rawx branch's gate), each mode."""
    _rawx_case(mode, "bfloat16", n, seed=n)


@pytest.mark.parametrize("salient", [True, False])
@pytest.mark.parametrize("layout", ["pre_laid", "rows"])
def test_stacked_gmm_plain_matches_jax(layout, salient):
    """K5 on layer 1 of 2 at 40 rows: K7a's (G, N_pad, gs) layout or (N, K)
    row-major codes, with and without salient channels; f32 out within 1e-5
    of the output's norm (the same exact group products, summed in f32 in
    another order)."""
    jp, tp = _packs(identity=False, scale_dtype="bfloat16", stacked=True,
                    salient_prop=0.05 if salient else 0.0)
    m = tp.meta
    n = 40
    x = _x(seed=6, n=n)
    k_ns_raw = C - m.num_salient
    x_ns = np.zeros((n, m.k_ns), np.float32)
    x_ns[:, :k_ns_raw] = x[:, :k_ns_raw]
    x_sal = np.zeros((n, m.k_s), np.float32)
    x_sal[:, :m.num_salient] = x[:, k_ns_raw:]
    if layout == "pre_laid":
        jx = j_quant_t(jnp.asarray(x_ns), group_size=GS, act_bits=m.act_bits,
                       interpret=True)
        tx = quantize_acts_grouped_t(_t(x_ns), group_size=GS, act_bits=m.act_bits)
        pre = n
    else:
        jx = jax.jit(lambda v: jreal._identity_nibble_quantize(
            jp, v, jnp.arange(C), jnp.ones((C,)))[:2])(jnp.asarray(x))
        tx = treal._identity_nibble_quantize(tp, _t(x), torch.arange(C),
                                             torch.ones(C))[:2]
        pre = None
    ref = jax.jit(lambda a, b, c: j_stacked(
        jnp.ones((1,), jnp.int32), a, b, jp.w_qt, jp.w_scales_t, c, jp.w_sal_t,
        group_size=GS, interpret=True, pre_laid=pre))(*jx, jnp.asarray(x_sal))
    got = int4_group_matmul_stacked(1, *tx, tp.w_qt, tp.w_scales_t, _t(x_sal),
                                    tp.w_sal_t, group_size=GS, pre_laid=pre)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (n, tp.w_qt.shape[-1]) and got.dtype == torch.float32
    assert np.linalg.norm(got.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_jax(scale_dtype):
    """K6 on activations quantized by quantize_activations_packed_int."""
    jp, tp = _packs(identity=False, scale_dtype=scale_dtype, stacked=False)
    xp = _x(n=37)[:, np.asarray(jp.perm)]
    jq = jax.jit(lambda v: jpack.quantize_activations_packed_int(v, jp.meta))(
        jnp.asarray(xp))
    tq = tpack.quantize_activations_packed_int(_t(xp), tp.meta)
    ref = j_gmm(*jq[:2], jp.w_qt, jp.w_scales_t, jq[2], jp.w_sal_t,
                group_size=GS, interpret=True)
    got = int4_group_matmul(*tq[:2], tp.w_qt, tp.w_scales_t, tq[2], tp.w_sal_t,
                            group_size=GS, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("identity", [False, True])
def test_real_quant_linear_per_layer_matches_jax(identity):
    """The prefill dispatch: permuted or identity nibble pack → K6, output
    sliced back from the align_o padding."""
    jp, tp = _packs(identity=identity, scale_dtype="float32", stacked=False)
    x = _x(n=9)
    ref = jax.jit(lambda v: jreal.real_quant_linear(jp, v, interpret=True))(
        jnp.asarray(x))
    got = treal.real_quant_linear(tp, _t(x))
    assert got.shape == (9, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _stacked_dispatch_case(mode, n, seed):
    jp, tp = _packs(identity=mode == "mask", scale_dtype="bfloat16",
                    stacked=True)
    if mode in ("rms", "raw"):
        mark = lambda p: dataclasses.replace(
            p, meta=dataclasses.replace(p.meta, pre_permuted=True))
        jp, tp = mark(jp), mark(tp)
    x = _x(seed=seed, n=n)
    rows = np.random.default_rng(3).uniform(0.5, 1.5, size=(L, C)).astype(
        np.float32)
    jnorm = (jnp.asarray(rows)[:, None, :], EPS, "rms") if mode == "rms" else None
    tnorm = (_t(rows), EPS, "rms") if mode == "rms" else None
    ref = jax.jit(lambda v: jreal.real_quant_linear(
        jp, v, layer_idx=jnp.int32(1), norm=jnorm, interpret=True))(jnp.asarray(x))
    got = treal.real_quant_linear(tp, _t(x), layer_idx=1, norm=tnorm)
    assert got.shape == (n, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# "gather": a pack whose input arrives in the original channel order (Bloom's),
# gathered by perm[layer_idx] before K1 or K7a + K5 (real_linear.py:268-272)
DISPATCH_MODES = MODES + ["gather"]


@pytest.mark.parametrize("mode", DISPATCH_MODES)
def test_real_quant_linear_stacked_matches_jax(mode):
    """The decode dispatch with layer_idx: pre-permuted + fused RMSNorm,
    pre-permuted raw, identity (x_sal gathered by the dispatch), and the
    input gathered into the pack's order."""
    _stacked_dispatch_case(mode, N, seed=1)


@pytest.mark.parametrize("mode", DISPATCH_MODES)
def test_real_quant_linear_stacked_many_rows_matches_jax(mode):
    """The decode dispatch at 40 rows: RMSNorm rounded to x's dtype, K7a and
    K5 for the pre-permuted and gathered packs, the identity quantize and K5
    for o_proj."""
    _stacked_dispatch_case(mode, 40, seed=8)


def test_int8_lm_head_matches_jax():
    """The per-channel int8 identity lm_head: per-token quantize, one int8
    product, per-token × per-column epilogue."""
    from smoothquant_tpu.quant.config import QuantConfig as JQ
    from smoothquant_tpu_torch.quant.config import QuantConfig as TQ

    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 64)).astype(np.float32) * 0.125
    kw = dict(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": None}, JQ(**kw),
                           compute_dtype=jnp.float32)
    tp = tpack.pack_linear({"weight": _t(w), "bias": None}, TQ(**kw),
                           compute_dtype=torch.float32)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    ref = jax.jit(lambda v: jreal.real_quant_linear(jp, v))(jnp.asarray(x))
    got = treal.real_quant_linear(tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_unported_branches_raise():
    _, tp = _packs(identity=False, scale_dtype="float32", stacked=True)
    for n in (N, 33):                          # K1's rows and K5's
        with pytest.raises(NotImplementedError):   # a fused norm on gathered input
            treal.real_quant_linear(tp, _t(_x(n=n)), layer_idx=0,
                                    norm=(torch.ones((L, C)), EPS, "rms"))
    _, ti = _packs(identity=True, scale_dtype="float32", stacked=True)
    with pytest.raises(NotImplementedError):   # identity call sites fuse no norm
        treal.real_quant_linear(ti, torch.zeros((33, C)), layer_idx=0,
                                norm=(torch.ones((L, C)), EPS, "rms"))


@pytest.mark.parametrize("o, group_size, dtype, body", [
    (12288, 64, torch.bfloat16, "wgmma"),    # Llama-2-7B's qkv, the main path
    (4096, 32, torch.bfloat16, "wgmma"),
    (336, 64, torch.bfloat16, "wgmma"),      # a ragged column tile, 16-byte weight rows
    (200, 64, torch.bfloat16, "tiles"),      # weight rows TMA cannot take
    (4096, 48, torch.bfloat16, "tiles"),     # no whole s8 wgmma k steps in a group
    (4096, 16, torch.bfloat16, "tiles"),
    (4096, 64, torch.float32, "tiles"),      # f32: the CUDA-core salient dot
])
def test_gmm_body_rule(o, group_size, dtype, body):
    """K6's body on a CUDA tensor follows from the shape and dtype alone."""
    assert gmm_body(o, group_size, dtype) == body


def test_group_scaling_floor():
    """N·O·G scalings of three f32-pipe instructions over 132 SMs × 128
    lanes: Llama-2-7B's qkv at 1024 rows (62 groups) at 1980 MHz, and a
    ragged K that counts the groups it reaches."""
    ms = roofline.group_scaling_floor_ms(1024, 12288, 3968, 64, 1980.0)
    assert ms == pytest.approx(1e3 * 1024 * 12288 * 62 * 3 / (132 * 128 * 1980e6))
    assert 0.069 < ms < 0.071
    assert roofline.group_scaling_floor_ms(4, 128, 100, 64, 1000.0) == pytest.approx(
        1e3 * 4 * 128 * 2 * 3 / (132 * 128 * 1000e6))


@pytest.mark.parametrize("n, o, group_size, body", [
    (64, 12288, 64, "stream"),   # Llama-2-7B's qkv at B = 64, the main path
    (33, 22016, 64, "stream"),   # gate_up, K1's rows plus one
    (64, 16384, 64, "stream"),   # BLOOM-7b1's dense_h_to_4h
    (1, 336, 32, "stream"),      # a ragged column tile, 16-byte weight rows
    (4, 384, 16, "stream"),
    (65, 4096, 64, "tiles"),     # more rows than 8 n8 tiles
    (64, 200, 64, "tiles"),      # weight rows TMA cannot take
    (64, 4096, 48, "tiles"),
])
def test_stacked_body_rule(n, o, group_size, body):
    """K5's body on a CUDA tensor follows from the shape alone."""
    assert stacked_body(n, o, group_size) == body


def test_k5_stage_counts():
    """One group pair a K5 group stage, 32 salient rows a bf16 salient
    stage (none in f32)."""
    assert stream_gmm.k5_stages(3840, 64, 256, True) == 30 + 8
    assert stream_gmm.k5_stages(3840, 64, 256, False) == 30
    assert stream_gmm.k5_stages(10368, 64, 640, True) == 81 + 20


@pytest.mark.parametrize("gs", [16, 32, 64])
def test_nibble_operand_and_exact_f32(gs):
    """The stream body's K5 arithmetic: each biased nibble b (0..15) of the
    split-half bytes enters the int8 mma as 16·(b − 8), so the int32 product
    is 16·(p − 8·Σx) of the plain version's biased product p; read through
    the 0x4B400000 start as f32 less 1.5·2^23 it is bit-identical to
    float(16·(p − 8Σx)) over K5's whole range (|p − 8Σx| <= gs·8·8, the
    edges included), and times s_x/16 it gives the plain version's
    (p − 8Σx)·s_x to the bit."""
    rng = np.random.default_rng(gs)
    x = rng.integers(-8, 8, size=(512, gs))
    w = rng.integers(-128, 128, size=(gs, 64))
    x[0], w[:, 0] = -8, 0x77          # lo and hi nibbles 7 (codes −1) ...
    x[1], w[:, 1] = -8, -120          # ... and 8 / 8 (codes 0): the extremes
    x[2], w[:, 2] = 7, 0x00           # nibbles 0 (codes −8)
    wb = torch.from_numpy(w).to(torch.int8)
    xt = torch.from_numpy(x).to(torch.int32)
    for half in (0, 1):
        b = ((wb.to(torch.int32) & 0xFF) >> (4 * half)) & 0xF
        p = xt @ b - 8 * xt.sum(1, keepdim=True)               # the plain version's p − 8Σx
        q = xt @ stream_gmm.nibble_s8(wb, half).to(torch.int32)  # the body's int32 product
        assert torch.equal(q, 16 * p)
        got = stream_gmm.exact_f32(q)
        assert torch.equal(got.view(torch.int32), (16 * p).float().view(torch.int32))
        sx = torch.from_numpy(rng.uniform(1e-3, 0.3, size=(512, 1)).astype(np.float32))
        assert torch.equal(got * (sx * 0.0625), p.float() * sx)
        assert p.abs().max().item() <= 64 * gs
    assert (xt[2:3] @ (((wb[:, 2:3].to(torch.int32) & 0xF) - 8))).abs().item() == 56 * gs


# ---------------------------------------------------------------- K1's stream body


@pytest.mark.parametrize("n, c, o, kk, gs, k_s, dtype, body", [
    (4, 4096, 12288, 3840, 64, 256, torch.bfloat16, "stream"),   # Llama-2-7B's qkv, B = 4
    (4, 4096, 4096, 3840, 64, 256, torch.bfloat16, "stream"),    # o_proj (mask mode)
    (4, 11008, 4096, 10368, 64, 640, torch.bfloat16, "stream"),  # down_proj
    (32, 4096, 22016, 3840, 64, 256, torch.bfloat16, "stream"),  # gate_up at 32 rows
    (1, 256, 336, 256, 16, 0, torch.bfloat16, "stream"),         # a ragged column tile
    (4, 4096, 12288, 3840, 64, 256, torch.float32, "dp4a"),     # f32 activations
    (4, 4096, 12288, 3840, 128, 256, torch.bfloat16, "dp4a"),   # a group size the ring lacks
    (4, 4096, 200, 3840, 64, 256, torch.bfloat16, "dp4a"),      # O % 16 != 0
    (4, 4100, 4096, 3840, 64, 256, torch.bfloat16, "dp4a"),     # C % 8 != 0
    (33, 4096, 4096, 3840, 64, 256, torch.bfloat16, "dp4a"),    # more rows than four n8 tiles
])
def test_rawx_body_rule(n, c, o, kk, gs, k_s, dtype, body):
    """K1's body on a CUDA tensor follows from the shape alone: the stream
    body for every bf16 decode linear of the paths, the dp4a body else."""
    assert rawx_body(n, c, o, kk, gs, k_s, dtype) == body


def test_k1_stream_stages_and_split():
    """K1's stream body streams K5's stages (one group pair or 32 salient
    rows each) and splits them as K5 does while a rank's salient tiles fit
    a block's shared memory, over more ranks where they would not."""
    assert stream_gmm.k5_stages(3840, 64, 256, True) == 30 + 8
    # Llama-2-7B's sites at 4 rows: qkv and gate_up fill the card with their
    # tiles; o and down split over 4 ranks
    for o, kk, k_s, ranks in ((12288, 3840, 256, 1), (4096, 3840, 256, 4),
                              (22016, 3840, 256, 1), (4096, 10368, 640, 4)):
        stages = stream_gmm.k5_stages(kk, 64, k_s, True)
        assert stream_gmm.k1_split(o, stages, 4, 64, -(-k_s // 32)) == ranks
        assert stream_gmm.split(o, stages) == ranks
    # six slots of 13312 bytes (8192 of nibbles, 1024 of scales, two x tiles
    # of 8 rows of 64 bf16, two norm rows, two code tiles and their scales),
    # two copies of the RMS factors and three mbarriers a slot, then 8
    # salient tiles of 8 × 64 bytes: two blocks an SM
    assert stream_gmm.k1_smem(4, 64, 8) == 80128 + 8 * 512
    assert stream_gmm.k1_smem(4, 64, 8) <= stream_gmm.SMEM_MAX // 2 - 1024
    # at 32 rows a slot takes 22528 bytes; BLOOM-7b1's 20 salient stages fit
    assert stream_gmm.k1_smem(32, 64, 20) == 135680 + 20 * 2048 <= stream_gmm.SMEM_MAX
    # 100 salient stages fit neither one rank nor two or four (50 a rank):
    # eight
    assert stream_gmm.split(30000, 200) == 1
    assert stream_gmm.k1_smem(32, 64, 50) > stream_gmm.SMEM_MAX
    assert stream_gmm.k1_split(30000, 200, 32, 64, 100) == 8
    # and no split where even eight ranks' salient tiles would not fit
    assert stream_gmm.k1_split(30000, 600, 32, 64, 600) is None


def _sr_code(y, scale):
    """The code byte of K1's stream body (csrc/stream_gmm.cuh sr_code), in
    f32 steps: d = y·(1/scale), its nearest integer by the add of 1.5·2^23;
    where d lies within |d|·2^-20 of a half-integer, the true quotient
    y / scale plus 1.5·2^23 instead."""
    inv = torch.reciprocal(scale)
    d = y * inv
    m = d + stream_gmm.MAGIC
    frac = d - (m - stream_gmm.MAGIC)
    near = (frac.abs() - 0.5).abs() <= torch.clamp_min(d.abs(), 1.0) * 9.5367431640625e-7
    slow = (y / scale) + stream_gmm.MAGIC
    return torch.where(near, slow, m).view(torch.int32) & 0xFF


@pytest.mark.parametrize("act_bits", [4, 8])
def test_k1_code_rounding_matches_division(act_bits):
    """sr_code's rule gives rint of the f32 quotient y / scale (half to
    even) bit for bit: over random groups, and over values put at, next to
    and a few ulp around every half-integer of the code range, where the
    reciprocal's product and the quotient part."""
    rng = np.random.default_rng(act_bits)
    qmax = 2 ** (act_bits - 1) - 1
    inv_qmax = np.float32(1.0) / np.float32(qmax)
    y = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)
                         * rng.uniform(1e-3, 1e3, size=(4096, 1)).astype(np.float32))
    scale = torch.clamp_min(y.abs().amax(1, keepdim=True), 1e-5) * inv_qmax
    halves = torch.arange(-qmax - 1, qmax + 1, dtype=torch.float32) + 0.5
    s2 = torch.from_numpy(rng.uniform(1e-4, 1e2, size=(512, 1)).astype(np.float32))
    y2 = halves[None, :] * s2
    steps = torch.arange(-8, 9, dtype=torch.int32)
    y2 = (y2.view(torch.int32)[..., None] + steps).view(torch.float32).reshape(512, -1)
    for yy, ss in ((y, scale), (y2, s2)):
        ref = torch.round(yy / ss).to(torch.int32) & 0xFF
        assert torch.equal(_sr_code(yy, ss), ref)


def _stream_prepass(x, nw, x_sal, *, mode, kk, gs, k_s, num_salient, eps, act_bits, t0, t1):
    """Torch emulation of what one rank of K1's stream body makes of the
    raw rows over its stages t0 .. t1 − 1 (csrc/stream_gmm.cuh: the
    consumers' sr_prepass before the first stage, the quantizer warps'
    sr_quantize_stage at each group stage; salient stages first, then group
    pairs): ({group: (codes (N, gs) int8, scales
    (N,) f32)} of its pairs' lo and hi groups, {salient column: (N,) f32
    rounded to bf16} of its salient stages), each value made as the kernel
    makes it — the RMS factor by f64 squares rounded to f32 once; y =
    (x·r)·w_norm in two f32 steps; zero past C and, in tail mode, from
    k_ns_raw on; the scale max(absmax, 1e-5)·(1/qmax); the code by
    _sr_code's rule."""
    n, c = x.shape
    n_sal, g_half = -(-k_s // 32), kk // gs // 2
    k_ns_raw = c - num_salient
    need_mask = x_sal is None and kk > k_ns_raw
    xf = x.float()
    r = None
    if mode == "rms":
        ss = (xf.double() * xf.double()).sum(1, keepdim=True).float()
        r = torch.reciprocal(torch.sqrt(ss * np.float32(1.0 / np.float32(c)) + np.float32(eps)))
    inv_qmax = np.float32(1.0) / np.float32(2 ** (act_bits - 1) - 1)
    groups, salient = {}, {}
    for t in range(t0, t1):
        if t < n_sal:
            for j in range(32 * t, 32 * t + 32):
                if x_sal is not None:
                    v = x_sal[:, j].float() if j < k_s else torch.zeros(n)
                elif j < num_salient:
                    v = xf[:, k_ns_raw + j]
                    if mode == "rms":
                        v = (v * r[:, 0]) * nw[k_ns_raw + j]
                else:
                    v = torch.zeros(n)
                salient[j] = v.to(torch.bfloat16).float()
            continue
        j = t - n_sal
        for g in (j, j + g_half):
            cols = torch.arange(g * gs, (g + 1) * gs)
            y = torch.zeros((n, gs))
            inside = cols < c
            y[:, inside] = xf[:, cols[inside]]
            if mode == "rms":
                y = (y * r) * torch.where(inside, nw[cols.clamp(max=c - 1)], 0.0)[None]
            elif mode == "mask":
                y = y * torch.where(inside, nw[cols.clamp(max=c - 1)], 0.0)[None]
            if need_mask:
                y = torch.where(cols[None] >= k_ns_raw, 0.0, y)
            scale = torch.clamp_min(y.abs().amax(1), 1e-5) * inv_qmax
            q = _sr_code(y, scale[:, None])
            groups[g] = ((q - 256 * (q >> 7)).to(torch.int8), scale)
    return groups, salient


def _probe_weights(kk, o, k_s, salient: bool):
    """Layers (2, ...) of a nibble pack that make a linear show its own
    activations, in f32: group side — column k < kk takes channel k alone
    (its nibble value 1, every other 0), group scales 1, no salient column —
    so column k reads code·scale of channel k; salient side (salient=True)
    — every nibble 0 and column j < k_s takes salient channel j at 1."""
    half = kk // 2
    lo, hi = np.full((half, o), 8), np.full((half, o), 8)
    ws = np.zeros((k_s, o), np.float32)
    if salient:
        ws[np.arange(k_s), np.arange(k_s)] = 1.0
    else:
        for k in range(kk):
            (lo if k < half else hi)[k % half, k] = 9
    packed = (lo | (hi << 4)).astype(np.uint8).view(np.int8)
    return (np.stack([packed] * 2), np.ones((2, kk // GS, o), np.float32),
            np.stack([ws] * 2))


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_k1_stream_prepass_matches_plain_and_jax(mode, n_split):
    """K1's stream body makes each rank's activations in shared memory from
    the raw rows, stage by stage (a rank's K range starts mid-row at
    n_split > 1).  Emulated
    rank by rank in torch (_stream_prepass) over bf16 rows, in every mode
    (rms with the tail salient split and its masked channels, raw, mask with
    an external x_sal), the codes, scales and salient activations are
    bit-identical to rawx_quantize_plain's; and to the JAX rawx kernel's
    (interpret mode, under jit), read through probe weights: its codes
    identical, its code·scale products and salient activations identical
    in raw and mask mode — in rms mode within 3 ulp, one bf16 ulp for the
    salient values, as XLA's rsqrt gives the RMS factor a few ulp apart
    from the port's rule (quant.core.rms_factor)."""
    kk, k_s, o = 256, 16, 256
    num_salient = 12
    rng = np.random.default_rng(40 + n_split)
    x = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32) * 2)
    x[:, 7] *= 12.0
    x = x.to(torch.bfloat16)
    nw = x_sal = None
    if mode == "rms":
        nw = torch.from_numpy(rng.uniform(0.5, 1.5, size=(C,)).astype(np.float32))
        nw = nw.to(torch.bfloat16).float()
    elif mode == "mask":
        nw = torch.from_numpy((rng.uniform(size=(C,)) > 0.1).astype(np.float32))
        x_sal = torch.from_numpy(rng.normal(size=(N, k_s)).astype(np.float32)).to(torch.bfloat16)
    kind = {"rms": "rms", "raw": None, "mask": "mask"}[mode]
    common = dict(kk=kk, k_s=k_s, num_salient=num_salient, eps=EPS, act_bits=4)
    stages = stream_gmm.k5_stages(kk, GS, k_s, True)
    lg = n_split.bit_length() - 1
    groups, salient = {}, {}
    for rank in range(n_split):
        t0, t1 = (rank * stages) >> lg, ((rank + 1) * stages) >> lg
        g, s = _stream_prepass(x, nw, x_sal, mode=mode, gs=GS, t0=t0, t1=t1, **common)
        assert not set(g) & set(groups) and not set(s) & set(salient)
        groups.update(g)
        salient.update(s)
    n_groups = kk // GS
    assert sorted(groups) == list(range(n_groups)) and sorted(salient) == list(range(32))
    codes = torch.cat([groups[g][0] for g in range(n_groups)], dim=1)
    scales = torch.stack([groups[g][1] for g in range(n_groups)], dim=1)
    xs = torch.stack([salient[j] for j in range(k_s)], dim=1)
    assert all(salient[j].abs().max() == 0 for j in range(k_s, 32))

    p_q, p_s, p_xs = rawx_quantize_plain(x, nw, x_sal, group_size=GS, norm_kind=kind,
                                         sal_dtype=torch.bfloat16, **common)
    assert torch.equal(codes, p_q)
    assert torch.equal(scales.view(torch.int32), p_s.view(torch.int32))
    assert torch.equal(xs.view(torch.int32), p_xs.view(torch.int32))

    xj = jnp.asarray(x.float().numpy())
    norm_j = None if nw is None else jnp.asarray(np.stack([nw.numpy()] * L))
    xsal_j = None if x_sal is None else jnp.asarray(x_sal.float().numpy())
    reads = []
    for sal in (False, True):
        wp, wsc, wsal = _probe_weights(kk, o, k_s, sal)
        reads.append(np.asarray(j_rawx(
            jnp.ones((1,), jnp.int32), xj, norm_j, jnp.asarray(wp), jnp.asarray(wsc),
            jnp.asarray(wsal, jnp.bfloat16), xsal_j, group_size=GS, act_bits=4,
            num_salient=num_salient, eps=EPS, norm_kind=kind or "rms",
            out_dtype=jnp.float32, interpret=True)))
    prod = (codes.float() * scales.repeat_interleave(GS, dim=1)).numpy()
    j_codes = np.rint(reads[0][:, :kk] / scales.repeat_interleave(GS, dim=1).numpy())
    assert np.array_equal(j_codes, codes.numpy())
    if mode == "rms":
        np.testing.assert_allclose(reads[0][:, :kk], prod, rtol=3 * 2.0 ** -23, atol=0)
        np.testing.assert_allclose(reads[1][:, :k_s], xs.numpy(), rtol=2.0 ** -8, atol=0)
    else:
        assert np.array_equal(reads[0][:, :kk], prod)
        assert np.array_equal(reads[1][:, :k_s], xs.numpy())

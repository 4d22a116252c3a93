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

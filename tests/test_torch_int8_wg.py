"""The host rules of K4's and K15a's main-path bodies (csrc/int8_wg.cu): the
body rules and forced-body refusals, the persistent tile walk of the s8
wgmma body (wg_s8.py), K4's salient stage plan, the (O, K) stream kind's
stage and split plan, and the kernels' arithmetic emulated in PyTorch
against the JAX Pallas kernels in interpret mode:

- K4's epilogue with the salient dot summed in the kernel's k16 chunks, in
  order: against jitted JAX within 1e-5 relative (f32 out; XLA's salient
  dot sums in another order), one bf16 ulp (bf16 out);
- K15a's int32 → f32 as the kernels convert it (no I2F: the two 16-bit
  halves joined by one fma) at |acc| > 2^24, with the α / bias epilogue,
  ReLU and the int8 rounding: bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import int8 as jk15
from smoothquant_tpu.kernels.int8_prefill import int8_prefill_matmul as j_k4
from smoothquant_tpu_torch.kernels import int8 as k15
from smoothquant_tpu_torch.kernels import int8_prefill as k4
from smoothquant_tpu_torch.kernels import stream_gmm, wg_s8
from smoothquant_tpu_torch.kernels.pack import k_major
from smoothquant_tpu_torch.quant.core import fma_f32

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7


# ---------------------------------------------------------------- body rules


def test_k4_body_rule():
    """Pre-quantized codes with bf16 salient operands or none take the wgmma
    body; f32 salient operands and the raw-x mode keep PR 2's tiles."""
    bf, f32 = torch.bfloat16, torch.float32
    assert k4.prefill_body(False, 256, bf) == "wg"
    assert k4.prefill_body(False, 640, bf) == "wg"
    assert k4.prefill_body(False, 0, f32) == "wg"        # the lm_head
    assert k4.prefill_body(False, 16, f32) == "tiles"
    assert k4.prefill_body(True, 256, bf) == "tiles"
    assert k4.prefill_body(True, 0, f32) == "tiles"
    assert not k4._takes("wg", True, 0, bf) and not k4._takes("wg", False, 16, f32)
    assert k4._takes("tiles", False, 256, bf) and not k4._takes("dp4a", False, 0, bf)


def test_k15a_body_rule():
    """1 to STREAM_MAX_ROWS rows take the stream kind, more the wgmma body;
    a forced body takes only its rows (the stream kind up to 64, PR 3's
    GEMV up to 8 and its tiles above)."""
    assert 1 <= k15.STREAM_MAX_ROWS <= stream_gmm.MAX_ROWS
    for n in (1, 4, k15.STREAM_MAX_ROWS):
        assert k15.linear_body(n) == "stream"
    for n in (k15.STREAM_MAX_ROWS + 1, 333, 2048):
        assert k15.linear_body(n) == "wg"
    assert k15.linear_takes("stream", 64) and not k15.linear_takes("stream", 65)
    assert k15.linear_takes("gemv", 8) and not k15.linear_takes("gemv", 9)
    assert k15.linear_takes("tiles", 9) and not k15.linear_takes("tiles", 8)
    assert k15.linear_takes("wg", 1) and k15.linear_takes("wg", 4096)
    assert not k15.linear_takes("pv", 4)


def test_launch_keys_tell_the_bodies_apart():
    """The main paths' bodies count under the kernels' names, the old bodies
    under keys of their own, so a path's launch check proves which ran."""
    assert k4.LAUNCH_KEYS["wg"] == "int8_prefill_matmul"
    assert len(set(k4.LAUNCH_KEYS.values())) == len(k4.LAUNCH_KEYS)
    keys = k15.LINEAR_LAUNCH_KEYS
    assert keys["stream"] == keys["wg"] == "int8_linear"
    assert len({keys["gemv"], keys["tiles"], "int8_linear"}) == 3
    assert set(keys) == set(k15.LINEAR_BODIES)


def test_forced_bodies_on_cpu_run_plain():
    """On CPU tensors a forced body still takes the plain version (the body
    rules apply to CUDA tensors), bit for bit."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, (9, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (40, 64)).astype(np.int8))
    for body in k15.LINEAR_BODIES:
        assert torch.equal(k15.int8_linear(x, w, 0.01, body=body),
                           k15.int8_linear_plain(x, w, 0.01))
    sx, sw = torch.full((9, 1), 0.01), torch.full((1, 40), 0.02)
    args = (x, sx, k_major(w.t().contiguous()), sw, torch.zeros(9, 0), torch.zeros(0, 40))
    for body in ("wg", "tiles"):
        assert torch.equal(k4.int8_prefill_matmul(*args, body=body),
                           k4.int8_prefill_matmul_plain(*args))


# ---------------------------------------------------------------- the tile walk

WALK_SHAPES = [  # (N, O, k_s): K4's five sites at 1024 rows, K15a's at 2048, ragged
    (1024, 12288, 256), (1024, 4096, 256), (1024, 22016, 256), (1024, 32000, 0),
    (2048, 2048, 0), (2048, 8192, 0), (333, 520, 16), (800, 1000, 0), (1, 77, 0),
    (9, 300, 208), (4097, 136, 640)]


@pytest.mark.parametrize("n,o,k_s", WALK_SHAPES)
@pytest.mark.parametrize("sms", [132, 7])
def test_persistent_tile_walk_covers_every_tile_once(n, o, k_s, sms):
    bn = wg_s8.tile_cols(k_s)
    grid = wg_s8.blocks(n, o, sms, bn)
    tm, tn = wg_s8.tiles(n, o, bn)
    assert grid == min(sms, tm * tn)
    walk = wg_s8.tile_walk(n, o, grid, bn)
    got = [t for block in walk for t in block]
    want = [(r * wg_s8.BM, c * bn) for c in range(tn) for r in range(tm)]
    assert len(got) == len(set(got)) == tm * tn
    assert set(got) == set(want)
    # block b's tiles are b, b + grid, ... in the row-tile-fastest order, so
    # the blocks in flight share a few weight column tiles
    for b, block in enumerate(walk):
        assert block == [want[t] for t in range(b, tm * tn, grid)]
    assert all(r < n and c < o for r, c in got)


def test_tile_division_by_magic_is_exact():
    """t // tiles_m as the kernel's umulhi by the magic, over every tile of
    any row-tile count up to 32768 rows (the host refuses a shape where it
    would not be exact)."""
    for tm in range(2, 257):
        total = tm * 250
        assert wg_s8.fast_div_ok(tm, total)
        ts = np.arange(total, dtype=np.int64)
        assert np.array_equal((ts * wg_s8.magic(tm)) >> 32, ts // tm)


@pytest.mark.parametrize("k_s,n_sal", [(0, 0), (16, 1), (208, 4), (640, 10)])
def test_k4_salient_stage_plan(k_s, n_sal):
    """K4's salient channels in stages of 64 (TMA zero-fills the tail of
    the last one), then K in 128-byte stages: Llama-2-7B's K = 4096 in 32,
    down's 11008 in 86."""
    assert wg_s8.stages(4096, k_s) == (n_sal, 32)
    assert wg_s8.stages(11008, k_s)[1] == 86
    assert (n_sal - 1) * wg_s8.SAL_K < k_s <= n_sal * wg_s8.SAL_K or k_s == n_sal == 0
    assert wg_s8.tile_cols(k_s) == (wg_s8.SAL_BN if k_s else wg_s8.WIDE_BN)


@pytest.mark.parametrize("o,kk,ranks", [(2048, 2048, 8), (8192, 2048, 2), (2048, 8192, 8),
                                        (77, 208, 1), (1000, 2048, 8), (130, 1024, 4),
                                        (50272, 2048, 1)])
def test_stream_kind_stage_and_split_plan(o, kk, ranks):
    """K15a's stream kind: K in 128-byte stages, split over the most ranks
    that keep the blocks within one an SM and two stages a rank; each
    rank's range (rank·T >> lg .. (rank + 1)·T >> lg) takes every stage
    once."""
    stages = stream_gmm.k15_stages(kk)
    assert stages == -(-kk // 128)
    c = k15.linear_split(o, kk)
    assert c == ranks
    assert -(-o // stream_gmm.TILE_COLS) * c <= stream_gmm.MAX_BLOCKS or c == 1
    assert stages >= c * stream_gmm.MIN_STAGES or c == 1
    lg = c.bit_length() - 1
    spans = [range((r * stages) >> lg, ((r + 1) * stages) >> lg) for r in range(c)]
    assert [t for s in spans for t in s] == list(range(stages))
    assert all(len(s) >= 1 for s in spans)


# ---------------------------------------------------------------- arithmetic


def test_s32_f32_rn_is_the_int32_conversion():
    """The kernels' conversion (two exact halves, one fma) rounds every
    int32 as cvt.rn.f32.s32 does, across the range and at the ties above
    2^24."""
    edges = [0, 1, -1, 2 ** 24, 2 ** 24 + 1, 2 ** 24 + 3, -(2 ** 24) - 1, 2 ** 25 + 2,
             2 ** 31 - 1, -(2 ** 31), 127 * 127 * 11008, -127 * 127 * 8192, 65535, 65536,
             -65536, -65537]
    rng = np.random.default_rng(0)
    v = torch.tensor(edges + list(rng.integers(-2 ** 31, 2 ** 31, 20000)), dtype=torch.int64)
    v = v.to(torch.int32)
    assert torch.equal(wg_s8.s32_f32_rn(v), v.float())


def _k4_kernel_emulation(x_q, sx, w, sw, x_sal, w_sal, out_dtype):
    """K4's wgmma body in PyTorch: the exact int32 sum converted as the kernel
    converts it, the bf16 salient dot summed in f32 over k16 chunks in
    order (each chunk's products exact, its sum rounded once), then
    fma(f32(acc)·s_x, s_w, sal) — or the product alone without salient
    channels."""
    acc = torch.from_numpy(np.asarray(x_q, np.int64) @ np.asarray(w, np.int64)).to(torch.int32)
    p = wg_s8.s32_f32_rn(acc) * torch.from_numpy(sx)
    sw_t = torch.from_numpy(sw)
    k_s = x_sal.shape[1]
    if k_s == 0:
        y = p * sw_t
    else:
        xs, ws = x_sal.double(), w_sal.double()
        sal = torch.zeros(p.shape, dtype=torch.float32)
        for k0 in range(0, k_s, 16):
            sal = (sal.double() + xs[:, k0:k0 + 16] @ ws[k0:k0 + 16]).float()
        y = fma_f32(p, sw_t, sal)
    return y.to(out_dtype)


@pytest.mark.parametrize("n,kk,o,k_s", [(37, 160, 48, 16), (70, 256, 72, 208), (29, 96, 40, 0)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_k4_epilogue_emulation_matches_jax(n, kk, o, k_s, out):
    rng = np.random.default_rng(n + kk + k_s)
    x_q = rng.integers(-127, 128, size=(n, kk)).astype(np.int8)
    sx = rng.uniform(0.001, 0.02, size=(n, 1)).astype(np.float32)
    w = rng.integers(-127, 128, size=(kk, o)).astype(np.int8)
    sw = rng.uniform(0.001, 0.02, size=(1, o)).astype(np.float32)
    x_sal = torch.from_numpy(rng.normal(size=(n, k_s)).astype(np.float32)).to(torch.bfloat16)
    w_sal = torch.from_numpy(rng.normal(size=(k_s, o)).astype(np.float32)).to(torch.bfloat16)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[out]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[out]
    ref = jax.jit(lambda *a: j_k4(*a, out_dtype=jdt, interpret=True))(
        jnp.asarray(x_q), jnp.asarray(sx), jnp.asarray(w), jnp.asarray(sw),
        jnp.asarray(x_sal.float().numpy(), jnp.bfloat16),
        jnp.asarray(w_sal.float().numpy(), jnp.bfloat16))
    ref = np.asarray(ref, np.float32)
    got = _k4_kernel_emulation(x_q, sx, w, sw, x_sal, w_sal, tdt).float().numpy()
    rtol = 1e-5 if out == "float32" else BF16_ULP
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())
    if k_s == 0:   # no salient sum: the same bits
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["f32", "f32_bias", "int8_bias_relu"])
def test_k15a_conversion_above_2_24_matches_jax(mode):
    """K15a's epilogue on the kernels' conversion, bit for bit against the
    JAX kernel, on ±127 operands whose sums reach 127²·K = 3.3e7 > 2^24
    (where f32(acc) rounds): α and the bias put the outputs across the
    int8 range, some of them saturated."""
    rng = np.random.default_rng(13)
    n, kk, o = 8, 2048, 48
    xs = rng.choice([-1, 1], size=(n, kk))
    flips = np.where(rng.random((o, 1)) < 0.3, 1, rng.choice([-1, 1], size=(o, kk)))
    x = (xs * 127).astype(np.int8)
    w = (xs[np.arange(o) % n] * flips * 127).astype(np.int8)
    acc = x.astype(np.int64) @ w.astype(np.int64).T
    assert np.abs(acc).max() > 2 ** 24 and (np.abs(acc) > 2 ** 24).sum() >= 4
    alpha = np.float32(150.0 / np.abs(acc).max())
    bias = rng.normal(size=o).astype(np.float32) * 3 if mode != "f32" else None
    relu = mode == "int8_bias_relu"
    out_j, out_t = (jnp.int8, torch.int8) if relu else (jnp.float32, torch.float32)
    ref = np.asarray(jax.jit(lambda a, b, al, bi: jk15.int8_linear(
        a, b, al, bi, relu=relu, out_dtype=out_j, interpret=True))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha),
            None if bias is None else jnp.asarray(bias)))
    f = wg_s8.s32_f32_rn(torch.from_numpy(acc).to(torch.int32))
    al = torch.tensor(float(alpha))
    y = f * al if bias is None else fma_f32(f, al, torch.from_numpy(bias))
    if relu:
        y = torch.clamp_min(y, 0.0)
    got = torch.round(y).clamp(-127, 127).to(torch.int8) if relu else y
    np.testing.assert_array_equal(got.numpy(), ref)
    if relu:
        assert (np.abs(ref.astype(np.int32)) == 127).any() and (ref == 0).any()


# ---------------------------------------------------------------- the ablation script


def test_s8_variant_edits_apply_to_committed_sources():
    """scripts/s8_variants.py builds its variants as edits of the committed
    sources: each must still match exactly once (the script refuses
    otherwise) and leave the kernels the wrappers launch defined."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import s8_variants

    csrc = os.path.join(ROOT, "smoothquant_tpu_torch", "kernels", "csrc")
    for name in s8_variants.VARIANTS:
        out = s8_variants.variant_sources(name, csrc)
        assert out, name
        for f, text in out.items():
            with open(os.path.join(csrc, f)) as fh:
                assert text != fh.read(), (name, f)
    assert set(s8_variants.HOST_RULES).isdisjoint(s8_variants.VARIANTS)
    with pytest.raises(ValueError, match="exactly once"):
        s8_variants.apply_edits("int x;", [("int y;", "int z;")])

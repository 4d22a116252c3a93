"""K16's row body (csrc/norm_quant.cu norm_quant_rows_kernel) on the CPU:
its plan (warps a row, rows a block, γ and β loaded early), and a PyTorch
emulation of its sum order — each lane's chunks in order, the warp's
xor-shuffle tree, the row's
warps in order, the mean and then Σ(x − μ)² from the same registers —
held to the JAX package's norm_quant (Pallas, interpret mode) and to the
port's plain version.

Tolerance: codes identical or one off.  The emulation rounds every step as
the kernel does (1/√v correctly rounded twice, fma(t·r, γ, β), rint of
y·f32(1/scale)); it and the plain version differ only in the order of the
f32 sums, and from JAX also in XLA's CPU rsqrt, so a value on a .5 edge may
round the other way: at most 2e-3 of the codes here (the bound
tests/test_torch_int8_kernels.py holds the plain version to), none by two."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import norm_quant as jk16
from smoothquant_tpu_torch.kernels import norm_quant as k16
from smoothquant_tpu_torch.quant.core import f32_reciprocal, fma_f32

torch.set_num_threads(1)


@pytest.mark.parametrize("n,c,want", [
    (2048, 2048, (2, 4, False)),   # OPT-1.3B's prefill: 512 blocks of 4 rows, 2 warps a row
    (4, 2048, (4, 1, True)),       # its decode: 4 blocks of one row, 4 warps, γ / β early
    (2048, 8192, (8, 1, False)),   # eight warps a row fill a block
    (5, 1000, (4, 1, True)),       # few rows: spare warps
    (64, 8, (4, 1, True)),         # one chunk a row
    (131, 1000, (4, 1, True)),
    (132, 1000, (1, 1, False)),    # as many rows as SMs: the least warps
    (600, 1000, (1, 2, False)),    # two blocks an SM would leave under 2 rows a block
    (3000, 4096, (4, 2, False)),
    (100000, 1000, (1, 8, False)),
    (2048, 1025, (2, 4, False)),   # just past one warp's 32 · 4 chunks of 8
])
def test_k16_plan(n, c, want):
    w, r, early = k16.k16_plan(n, c)
    assert (w, r, early) == want
    assert 32 * w * k16.CHUNKS * 8 >= c and w * r <= k16.MAX_WARPS
    if not early:    # the least such power of two
        assert w == 1 or 32 * (w // 2) * k16.CHUNKS * 8 < c
    if n >= 2 * k16.SMS:
        assert -(-n // r) >= 2 * k16.SMS or r == 1


def _row_sums(vals, w):
    """Σ of each row of vals (N, C) f32 in the row body's order: lane l of
    warp wr (lw = 32·wr + l) adds its chunks lw, lw + 32·W, … of 8 values
    in order; the warp's xor tree (offsets 16 … 1: lane i and i ^ o add the
    same two values); the W warps' sums added in warp order."""
    n, c = vals.shape
    lanes = 32 * w
    chunks = torch.zeros((n, k16.CHUNKS * lanes, 8))
    chunks[:, :c // 8] = vals.reshape(n, c // 8, 8)
    per_lane = chunks.reshape(n, k16.CHUNKS, lanes, 8)
    s = torch.zeros((n, lanes))
    for k in range(k16.CHUNKS):
        if k * lanes >= c // 8:
            break
        live = (k * lanes + torch.arange(lanes)) < c // 8
        for j in range(8):
            s = torch.where(live, s + per_lane[:, k, :, j], s)
    s = s.reshape(n, w, 32)
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    tot = s[:, 0, 0]
    for wr in range(1, w):
        tot = tot + s[:, wr, 0]
    return tot[:, None]


def k16_rows_emulation(x, gamma, beta, scale, *, eps, rms):
    """What the row body writes for x (N, C): its plan's W, its sums'
    order, its roundings."""
    xf = x.float()
    n, c = xf.shape
    w = k16.k16_plan(n, c)[0]
    if rms:
        cen = xf
        v = _row_sums(xf * xf, w) / c
    else:
        mean = _row_sums(xf, w) / c
        cen = xf - mean
        v = _row_sums(cen * cen, w) / c
    r = torch.reciprocal(torch.sqrt(v + np.float32(eps)))
    y = fma_f32(cen * r, gamma.float(), beta.float())
    inv = f32_reciprocal(float(np.float32(scale)))
    return torch.round(y * inv).clamp(-127, 127).to(torch.int8)


def test_row_sums_order_is_the_kernels():
    """The emulated order is not torch's: on values that cancel, the sums of
    one row differ in the last bits between the two orders, so the
    emulation pins an order of its own (and agrees with f64 to f32
    rounding)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(64, 2048)) * 1e3).astype(np.float32))
    got = _row_sums(x, 2)[:, 0]
    ref = x.double().sum(-1)
    assert ((got.double() - ref).abs() <= 1e-5 * x.double().abs().sum(-1)).all()
    assert not torch.equal(got, x.sum(-1))


@pytest.mark.parametrize("n,c", [(3, 8), (5, 1000), (4, 2048), (64, 2048), (3, 4096),
                                 (2, 8192)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_row_body_emulation_matches_jax(n, c, rms, dt):
    rng = np.random.default_rng(n + c + 7 * rms)
    x = (rng.normal(size=(n, c)) * rng.uniform(0.5, 3.0, size=(n, 1)) + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    beta = rng.normal(size=c).astype(np.float32) * 0.1
    scale = float(np.float32(4.0 / 127))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    if rms:
        ref = np.asarray(jk16.rms_norm_q(xj, jnp.asarray(gamma), scale, interpret=True))
        eps = 1e-6
        b = torch.zeros_like(g)
    else:
        ref = np.asarray(jk16.layer_norm_q(xj, jnp.asarray(gamma), jnp.asarray(beta), scale,
                                           interpret=True))
        eps = 1e-5
    got = k16_rows_emulation(xt, g, b, scale, eps=eps, rms=rms)
    plain = k16.norm_quant_plain(xt, g, b, scale, eps=eps, rms=rms)
    for other in (ref, plain.numpy()):
        diff = np.abs(got.numpy().astype(np.int32) - other.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() <= 2e-3, f"{int((diff != 0).sum())} codes differ"
    assert np.abs(ref.astype(np.int32)).max() > 60


def test_body_option_on_cpu():
    """On CPU tensors both bodies take the plain version; an unknown body is
    the CUDA path's error, not the CPU's."""
    x = torch.randn((4, 64))
    g, b = torch.ones(64), torch.zeros(64)
    plain = k16.norm_quant_plain(x, g, b, 0.05)
    assert torch.equal(k16.norm_quant(x, g, b, 0.05, body="block"), plain)
    assert k16.LAUNCH_KEYS == {"rows": "norm_quant", "block": "norm_quant_block"}

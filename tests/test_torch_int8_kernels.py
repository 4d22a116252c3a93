"""K15a (int8_linear), K15b (int8_bmm) and K16 (norm_quant): the port's
plain PyTorch versions (what the wrappers run on CPU tensors) against the
JAX Pallas kernels in interpret mode, on the same numpy inputs.

K15a and K15b are held bit-exact: their int32 sums are exact and their
epilogues one fused multiply-add or one multiply.  K16's codes may differ
by one where XLA's CPU rsqrt (an estimate refined, not 1/√v correctly
rounded) moves y across a rounding edge; the count of such codes is bounded
and no code differs by more than one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import int8 as jk15
from smoothquant_tpu.kernels import norm_quant as jk16
from smoothquant_tpu_torch.kernels import int8 as k15
from smoothquant_tpu_torch.kernels import norm_quant as k16

torch.set_num_threads(1)


def _i8(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("n,kk,o", [(5, 70, 37), (64, 512, 256), (4, 128, 96),
                                    (40, 256, 130)])
@pytest.mark.parametrize("mode", ["f32", "int8", "relu_int8"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_linear_plain_matches_jax(n, kk, o, mode, with_bias):
    rng = np.random.default_rng(n * 1000 + kk + o)
    x, w = _i8(rng, (n, kk)), _i8(rng, (o, kk))
    # α that puts the outputs in int8 range, bias a few codes wide
    alpha = np.float32(rng.uniform(0.5, 2.0) / (127.0 * np.sqrt(kk)))
    bias = rng.normal(size=o).astype(np.float32) * 3 if with_bias else None
    out_j, out_t = {"f32": (jnp.float32, torch.float32)}.get(
        mode, (jnp.int8, torch.int8))
    relu = mode == "relu_int8"
    ref = np.asarray(jk15.int8_linear(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha),
        None if bias is None else jnp.asarray(bias), relu=relu, out_dtype=out_j,
        interpret=True))
    got = k15.int8_linear(torch.from_numpy(x), torch.from_numpy(w), float(alpha),
                          None if bias is None else torch.from_numpy(bias),
                          relu=relu, out_dtype=out_t)
    assert got.dtype == out_t and got.shape == (n, o)
    np.testing.assert_array_equal(got.numpy(), ref)
    if mode != "f32":
        assert np.abs(ref.astype(np.int32)).max() > 20   # the codes are not all tiny


@pytest.mark.parametrize("b,m,n,kk", [(6, 1, 300, 64), (3, 40, 33, 64), (4, 1, 64, 1024),
                                      (2, 37, 64, 200)])
@pytest.mark.parametrize("out", ["f32", "int8"])
@pytest.mark.parametrize("b_kn", [False, True])
def test_int8_bmm_plain_matches_jax(b, m, n, kk, out, b_kn):
    rng = np.random.default_rng(b * 100 + m + n + kk)
    a, bm = _i8(rng, (b, m, kk)), _i8(rng, (b, n, kk))
    alpha = float(rng.uniform(0.5, 2.0) / (127.0 * np.sqrt(kk)))   # a Python float, as the JAX caller passes
    out_j, out_t = (jnp.float32, torch.float32) if out == "f32" else (jnp.int8, torch.int8)
    ref = np.asarray(jk15.int8_bmm(jnp.asarray(a), jnp.asarray(bm), alpha, out_dtype=out_j,
                                   interpret=True))
    b_arg = np.ascontiguousarray(bm.transpose(0, 2, 1)) if b_kn else bm
    got = k15.int8_bmm(torch.from_numpy(a), torch.from_numpy(b_arg), alpha,
                       out_dtype=out_t, b_kn=b_kn)
    assert got.dtype == out_t and got.shape == (b, m, n)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quantize_to_int8_matches_jax():
    x = np.random.default_rng(3).normal(size=(7, 33)).astype(np.float32) * 4
    ref = np.asarray(jk15.quantize_to_int8(jnp.asarray(x), 0.03))
    np.testing.assert_array_equal(k15.quantize_to_int8(torch.from_numpy(x), 0.03).numpy(),
                                  ref)


@pytest.mark.parametrize("n,c", [(5, 64), (128, 2048), (3, 264)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_norm_quant_plain_matches_jax(n, c, rms, dt):
    rng = np.random.default_rng(n + c + rms)
    x = (rng.normal(size=(n, c)) * rng.uniform(0.5, 3.0, size=(n, 1)) + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    beta = rng.normal(size=c).astype(np.float32) * 0.1
    scale = float(np.float32(4.0 / 127))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    xj = jnp.asarray(x, jdt)
    if rms:
        ref = np.asarray(jk16.rms_norm_q(xj, jnp.asarray(gamma), scale, interpret=True))
        got = k16.rms_norm_q(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma), scale)
    else:
        ref = np.asarray(jk16.layer_norm_q(xj, jnp.asarray(gamma), jnp.asarray(beta), scale,
                                           interpret=True))
        got = k16.layer_norm_q(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                               torch.from_numpy(beta), scale)
    assert got.dtype == torch.int8 and got.shape == (n, c)
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    # off-by-one codes: XLA's CPU rsqrt vs 1/√v correctly rounded, one ulp of
    # r moves y·(1/scale) across a .5 edge about 1e-5 of the time
    assert (diff != 0).mean() <= 2e-3, f"{int((diff != 0).sum())} codes differ"
    assert np.abs(ref.astype(np.int32)).max() > 60


def test_wrappers_run_plain_on_cpu():
    """A CPU tensor takes the plain version, and the launch counts stay 0."""
    from smoothquant_tpu_torch.kernels import _build

    _build.reset_launches()
    x = torch.zeros((4, 32), dtype=torch.int8)
    k15.int8_linear(x, x, 1.0)
    k15.int8_bmm(x[None], x[None], 1.0)
    k16.layer_norm_q(torch.ones((4, 32)), torch.ones(32), torch.zeros(32), 0.1)
    assert sum(_build.LAUNCHES.values()) == 0


def test_int8_bmm_body_rules():
    """K15b's body rule at the int8 OPT's attention products (OPT-1.3B,
    head_dim 64): QKᵀ of a prefill takes the qk body (K ≤ 256, f32 out), PV
    of a prefill the pv body (b_kn, K ≤ 1024), PV of one query over the
    cache the kn GEMV, QKᵀ of one query the nk GEMV (K ≤ 256; above, K15a's
    GEMV); the kn GEMV's ranks
    keep a rank at 256 rows or more and the CTAs within two an SM."""
    f32, i8 = torch.float32, torch.int8
    table = {  # (M, N, K, b_kn, out): body
        (512, 512, 64, False, f32): "qk", (512, 1024, 64, False, f32): "qk",
        (512, 64, 512, True, i8): "pv", (512, 64, 1024, True, i8): "pv",
        (1, 1024, 64, False, f32): "nk_gemv", (1, 64, 1024, True, i8): "kn_gemv",
        (1, 77, 512, False, f32): "gemv", (8, 300, 256, False, i8): "nk_gemv",
        (4, 64, 40, True, i8): "kn_gemv", (9, 512, 64, False, f32): "qk",
        (512, 512, 64, False, i8): "tiles", (512, 512, 512, False, f32): "tiles",
        (512, 64, 2048, True, i8): "tiles", (8, 64, 1024, True, f32): "kn_gemv",
        (2, 64, 65536, True, i8): "gemv"}
    for (m, n, kk, b_kn, out), body in table.items():
        assert k15.bmm_body(m, n, kk, b_kn, out) == body, (m, n, kk, b_kn, out)
        assert k15._takes(body, m, n, kk, b_kn, out, None)
    ranks = {(128, 64, 1024): 2, (128, 64, 512): 2, (4, 64, 1024): 4, (1, 64, 48): 1,
             (128, 64, 4096): 2, (512, 64, 8192): 2, (256, 64, 4096): 1,
             (1, 64, 64 * 1024): None}
    for args, c in ranks.items():
        assert k15.kn_ranks(*args) == c, args
    assert not k15._takes("qk", 512, 512, 64, False, i8, None)
    assert not k15._takes("pv", 4, 64, 512, True, i8, None)
    assert not k15._takes("kn_gemv", 1, 64, 1024, True, i8, 16)
    assert not k15._takes("tiles", 4, 64, 64, False, f32, None)


def test_int8_bmm_exact_f32_of_the_qk_body():
    """The qk body's int32 → f32 without I2F: the accumulator seeded with
    the bits of 1.5·2^23 and one f32 subtract give f32(acc) exactly over
    the range K ≤ 256 reaches (|acc| ≤ 128²·256 = 2^22)."""
    from smoothquant_tpu_torch.kernels.stream_gmm import exact_f32

    lim = 128 * 128 * k15.QK_MAX_K
    assert lim == 2 ** 22
    p = torch.cat([torch.arange(-lim, -lim + 4096), torch.arange(-2048, 2048),
                   torch.arange(lim - 4096, lim + 1),
                   torch.from_numpy(np.random.default_rng(7).integers(-lim, lim, 10000))])
    assert torch.equal(exact_f32(p), p.float())


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm(x, y, s): result byte i is byte (s >> 4i) & 7 of
    the eight bytes y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def test_int8_bmm_byte_transpose_of_the_kn_bodies():
    """The 4 × 4 byte transpose the pv body and the kn GEMV run on a (K, N)
    operand (four row words in, four column words out), emulated with
    __byte_perm's selectors: column j's word holds k rows 0-3 of column j."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        rows = rng.integers(0, 256, size=(4, 4), dtype=np.uint8)      # [k][column]
        w = [int.from_bytes(rows[k].tobytes(), "little") for k in range(4)]
        lo01, lo23 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[2], w[3], 0x5140)
        hi01, hi23 = _byte_perm(w[0], w[1], 0x7362), _byte_perm(w[2], w[3], 0x7362)
        cols = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
                _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
        for j in range(4):
            assert cols[j].to_bytes(4, "little") == rows[:, j].tobytes()


def test_int8_bmm_forced_body_on_cpu_runs_plain():
    """A forced body on CPU tensors still takes the plain version (the
    shape rule applies to CUDA tensors only), bit-exact at the qk, pv and
    kn shapes."""
    rng = np.random.default_rng(11)
    for shape_a, shape_b, b_kn, out, body in (
            ((2, 20, 64), (2, 30, 64), False, torch.float32, "qk"),
            ((2, 1, 64), (2, 30, 64), False, torch.float32, "nk_gemv"),
            ((2, 20, 48), (2, 48, 64), True, torch.int8, "pv"),
            ((2, 1, 256), (2, 256, 64), True, torch.int8, "kn_gemv")):
        a, b = torch.from_numpy(_i8(rng, shape_a)), torch.from_numpy(_i8(rng, shape_b))
        got = k15.int8_bmm(a, b, 0.01, out_dtype=out, b_kn=b_kn, body=body)
        assert torch.equal(got, k15.int8_bmm_plain(a, b, 0.01, out_dtype=out, b_kn=b_kn))

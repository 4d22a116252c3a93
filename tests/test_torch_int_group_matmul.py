"""K8 (int_group_matmul) plain PyTorch version vs the JAX Pallas kernel in
interpret mode (jitted), with and without the salient block (_kernel /
_kernel_nosal), groups of 16 to 128 channels and a single group spanning
K, at N = 1, 5 and 130 (the kernel's padding paths), f32 and bf16 out.

Tolerance: the integer group partials are exact on both sides and each
group is folded in as fma(partial·s_x, s_w, out), as jitted XLA compiles
the TPU body; what may differ in the last bits is the salient dot's f32
sum order (XLA pads the rows to a tile, torch runs a GEMV at one row) and,
without a salient block, XLA's contraction of the first two groups' sum
(it fuses either product, by shape).  So: 2e-6 of the largest output in
f32, one bf16 rounding besides in bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.int_group_matmul import int_group_matmul as j_igmm
from smoothquant_tpu_torch.kernels import stream_gmm
from smoothquant_tpu_torch.kernels.int_group_matmul import (
    int_gmm_body,
    int_group_matmul,
    int_group_matmul_plain,
)

torch.set_num_threads(1)

O = 136


def _operands(n, k, gs, k_s, seed, bits=4):
    rng = np.random.default_rng(seed)
    g = k // gs
    q = 2 ** (bits - 1) - 1
    return dict(
        x_q=rng.integers(-q, q + 1, size=(n, k)).astype(np.int8),
        x_scales=rng.uniform(0.01, 0.2, size=(n, g)).astype(np.float32),
        w_qt=rng.integers(-q, q + 1, size=(k, O)).astype(np.int8),
        w_scales_t=rng.uniform(0.01, 0.2, size=(g, O)).astype(np.float32),
        x_sal=rng.normal(size=(n, k_s)).astype(np.float32),
        w_sal_t=rng.normal(size=(k_s, O)).astype(np.float32))


def _run_both(ops, gs, sal_dtype, out_dtype):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    jargs = [jnp.asarray(ops[k]) for k in ("x_q", "x_scales", "w_qt", "w_scales_t")]
    jargs += [jnp.asarray(ops[k]).astype(jd[sal_dtype]) for k in ("x_sal", "w_sal_t")]
    ref = j_igmm(*jargs, group_size=gs, out_dtype=jd[out_dtype], interpret=True)
    targs = [torch.from_numpy(ops[k]) for k in ("x_q", "x_scales", "w_qt", "w_scales_t")]
    targs += [torch.from_numpy(ops[k]).to(td[sal_dtype]) for k in ("x_sal", "w_sal_t")]
    got = int_group_matmul(*targs, group_size=gs, out_dtype=td[out_dtype])
    assert got.dtype == td[out_dtype] and got.shape == ref.shape
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


def _check(got, ref, out_dtype):
    if out_dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("gs", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 5, 130])
@pytest.mark.parametrize("k_s", [0, 128])
def test_grouped_matches_jax(gs, n, k_s):
    """Both bodies, every group size, the three row counts; f32 out."""
    ops = _operands(n, 4 * gs if gs < 128 else 384, gs, k_s, seed=gs + n + k_s)
    got, ref = _run_both(ops, gs, "f32", "f32")
    _check(got, ref, "f32")


@pytest.mark.parametrize("k_s", [0, 128])
@pytest.mark.parametrize("sal_dtype", ["f32", "bf16"])
def test_bf16_out_and_salient(k_s, sal_dtype):
    """bf16 output (and bf16 salient operands): one cast of the f32 sum."""
    ops = _operands(5, 512, 64, k_s, seed=3)
    got, ref = _run_both(ops, 64, sal_dtype, "bf16")
    _check(got, ref, "bf16")


@pytest.mark.parametrize("n", [1, 5, 130])
def test_single_group_int8_range(n):
    """G = 1 spanning K (a per-channel recipe), int8-range codes of one sign
    per column on both sides: the one int32 partial exceeds 2^24 and rounds
    to f32 once."""
    k = 3000
    ops = _operands(n, k, k, 128, seed=n, bits=8)
    rng = np.random.default_rng(n)
    ops["x_q"] = rng.integers(48, 128, size=(n, k)).astype(np.int8)
    sign = np.where(np.arange(O) % 2, 1, -1).astype(np.int8)
    ops["w_qt"] = (rng.integers(48, 128, size=(k, O)) * sign).astype(np.int8)
    got, ref = _run_both(ops, k, "f32", "f32")
    big = np.abs(ops["x_q"].astype(np.int64) @ ops["w_qt"].astype(np.int64)).max()
    assert big > 2 ** 24
    _check(got, ref, "f32")


def test_partials_round_once():
    """A partial above 2^24 rounds once, to nearest: the float64 sum of the
    plain version, not a float32 one (which rounds at every step)."""
    k = 2048
    x_q = torch.full((1, k), 127, dtype=torch.int8)
    w = torch.full((k, 4), 127, dtype=torch.int8)
    w[0, :] = 1   # 127·127·2047 + 127 = 33 016 950: odd, above 2^24
    one = torch.ones((1, 1))
    got = int_group_matmul_plain(x_q, one, w, torch.ones((1, 4)), torch.zeros((1, 0)),
                                 torch.zeros((0, 4)), group_size=k)
    exact = 127 * 127 * (k - 1) + 127
    assert got[0, 0].item() == float(np.float32(exact))


def test_cuda_tensors_never_take_the_plain_version():
    """On a device with no kernel the wrapper raises rather than computing."""
    ops = _operands(2, 64, 32, 0, seed=0)
    args = [torch.from_numpy(ops[k]).to("meta") for k in
            ("x_q", "x_scales", "w_qt", "w_scales_t", "x_sal", "w_sal_t")]
    with pytest.raises(RuntimeError):
        int_group_matmul(*args, group_size=32)


@pytest.mark.parametrize("n, o, kk, gs, body", [
    (4, 4096, 3904, 64, "stream"),     # the quick start's q_proj at decode
    (4, 11008, 3904, 64, "stream"),    # gate_proj
    (1, 4096, 10496, 64, "stream"),    # down_proj, one row
    (64, 4096, 10496, 64, "stream"),   # INT_PATH_MAX_TOKENS rows
    (65, 4096, 10496, 64, "tiles"),    # more rows than 8 n8 tiles
    (4, 336, 384, 128, "stream"),      # a ragged column tile, 16-byte weight rows
    (4, 336, 144, 16, "stream"),
    (4, 200, 384, 64, "tiles"),        # weight rows TMA cannot take
    (4, 4096, 192, 48, "tiles"),       # groups that do not fill 128-row stages
    (4, 4096, 3892, 3892, "tiles"),    # one group: |p| may pass 2^22
])
def test_int_gmm_body_rule(n, o, kk, gs, body):
    """K8's body on a CUDA tensor follows from the shape alone."""
    assert int_gmm_body(n, o, kk, gs) == body


@pytest.mark.parametrize("o, stages, n_split", [
    (4096, stream_gmm.k8_stages(3904, 256, True), 4),    # q_proj: 32 tiles x 4 ranks
    (11008, stream_gmm.k8_stages(3904, 256, True), 1),   # gate_proj: 86 tiles
    (4096, stream_gmm.k8_stages(10496, 640, True), 4),   # down_proj
    (12288, stream_gmm.k5_stages(3840, 64, 256, True), 1),
    (22016, stream_gmm.k5_stages(3840, 64, 256, True), 1),
    (1024, 40, 8),                                       # 8 tiles x 8 ranks
    (1024, 9, 4),                                        # each rank keeps two stages
    (128, 1, 1),
])
def test_stream_split_plan(o, stages, n_split):
    """The most cluster ranks that keep a call within one block an SM, each
    rank streaming at least two stages."""
    assert stream_gmm.split(o, stages) == n_split
    tiles = -(-o // stream_gmm.TILE_COLS)
    assert n_split in stream_gmm.SPLITS
    assert n_split == 1 or (tiles * n_split <= stream_gmm.MAX_BLOCKS
                            and stages >= stream_gmm.MIN_STAGES * n_split)
    bigger = 2 * n_split
    assert (bigger > max(stream_gmm.SPLITS) or tiles * bigger > stream_gmm.MAX_BLOCKS
            or stages < stream_gmm.MIN_STAGES * bigger)


def test_stream_stage_counts():
    """128 weight rows a K8 group stage (the last may be ragged), 64 salient
    rows a bf16 salient stage (none in f32: the CUDA cores take it)."""
    assert stream_gmm.k8_stages(3904, 256, True) == 31 + 4
    assert stream_gmm.k8_stages(3904, 256, False) == 31
    assert stream_gmm.k8_stages(10496, 640, True) == 82 + 10


@pytest.mark.parametrize("lo, hi", [(-2 ** 21, -2 ** 21 + 4096), (-4096, 4096),
                                    (2 ** 21 - 4096, 2 ** 21)])
def test_exact_f32_matches_int_to_float(lo, hi):
    """The stream body's conversion (the accumulator started at 0x4B400000,
    the bits read as f32, 1.5·2^23 subtracted) is bit-identical to
    p.float() over K8's whole range, |p| <= gs·128·128 = 2^21 at
    128-channel groups."""
    p = torch.arange(lo, hi + 1, dtype=torch.int32)
    got = stream_gmm.exact_f32(p)
    assert torch.equal(got.view(torch.int32), p.float().view(torch.int32))

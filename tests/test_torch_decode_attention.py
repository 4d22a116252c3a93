"""K11 (decode_attention_stacked / decode_attention) plain PyTorch version vs
the JAX Pallas kernel in interpret mode: fp and int8 head-major caches,
MHA and GQA, masked holes and fully masked rows, one and several S tiles;
the ALiBi body (Bloom's slopes) over fp and int8 caches.

Tolerance in f32: 1e-5 relative, plus 1e-5 of the output's largest
magnitude (sums of opposite-signed terms cancel toward zero), from f32
sums taken in another order; a bf16 output may round one bf16 ulp apart.
With ALiBi the scores carry slope·position (up to ~160 here, ~450 at
Bloom-7b1's head 0 over 640 positions), so a last-bit difference of the
q·k sum moves the rounded score by an ulp of that magnitude: 2e-4, the
JAX package's own bound for Bloom (tests/test_prefetch_scan_archs.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import decode_attention as jda
from smoothquant_tpu.models.bloom import alibi_slopes as j_alibi_slopes
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.models.common import decode_bias

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _cache(rng, shape, kind):
    if kind == "int8":
        vals = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(0.005, 0.02, size=shape[:-1]).astype(np.float32)
                  for _ in range(2)]
        return vals, scales
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)], [None, None]


def _bias(rng, b, s, pos):
    mask = rng.random((b, s)) > 0.3
    mask[-1, :] = False                      # a fully masked row gives 0
    return decode_bias(_t(pos), b, s, _t(mask))


CASES = [  # (h, n_kv, s, cache kind, dtype)
    (4, 4, 128, "f32", "float32"),
    (8, 2, 384, "f32", "float32"),          # GQA, three 128-wide tiles
    (4, 4, 1024, "int8", "float32"),        # two 512-wide tiles
    (8, 2, 256, "int8", "float32"),
    (8, 4, 128, "bf16", "bfloat16"),
    (8, 4, 256, "int8", "bfloat16"),
]


@pytest.mark.parametrize("h,n_kv,s,kind,dt", CASES)
def test_decode_attention_stacked_plain_matches_jax(h, n_kv, s, kind, dt):
    l_num, b, d = 2, 3, 64
    rng = np.random.default_rng(s + h)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (l_num, b, n_kv, s, d), kind)
    bias = _bias(rng, b, s, np.array([s // 3, s - 1, 9]))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if kind == "bf16" else jnp.asarray
    cast_t = (lambda a: _t(a).to(torch.bfloat16)) if kind == "bf16" else _t
    sc_j = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    sc_t = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    ref = jda.decode_attention_stacked(
        jnp.ones((1,), jnp.int32), jnp.asarray(q, jdt), cast_j(k), cast_j(v),
        jnp.asarray(bias.numpy()), interpret=True, **sc_j)
    got = k11.decode_attention_stacked(1, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                       **sc_t)
    assert got.dtype == tdt and got.shape == (b, h, d)
    ref = np.asarray(ref, np.float32)
    rtol = 1e-5 if dt == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())
    assert not got[-1].any()


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_decode_attention_per_layer_matches_jax(kind):
    """The per-layer wrapper (a one-layer stack)."""
    b, h, n_kv, s, d = 2, 8, 4, 256, 64
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (b, n_kv, s, d), kind)
    bias = _bias(rng, b, s, np.array([200, 17]))
    sc = [] if ks is None else [ks, vs]
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias.numpy()), *map(jnp.asarray, sc),
                               interpret=True)
    got = k11.decode_attention(_t(q), _t(k), _t(v), bias, *map(_t, sc))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


ALIBI_CASES = [  # (h, s, cache kind, dtype, layer): positions near the end
    (4, 640, "f32", "float32", 1),            # five 128-wide tiles, as Bloom's 640
    (8, 1024, "int8", "float32", 0),          # two 512-wide tiles
    (4, 256, "bf16", "bfloat16", 1),
    (4, 512, "int8", "bfloat16", 1),
]


@pytest.mark.parametrize("h,s,kind,dt,layer", ALIBI_CASES)
def test_decode_attention_alibi_matches_jax(h, s, kind, dt, layer):
    """The ALiBi body: score += slope_h · key position, over the fp and the
    int8 bodies, stacked (layer `layer` of 2) against the JAX kernel."""
    b, d = 3, 64
    rng = np.random.default_rng(s + h + 5)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (2, b, h, s, d), kind)
    bias = _bias(rng, b, s, np.array([s - 1, s - 40, 3]))
    slopes = j_alibi_slopes(h)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if kind == "bf16" else jnp.asarray
    cast_t = (lambda a: _t(a).to(torch.bfloat16)) if kind == "bf16" else _t
    sc_j = [None, None] if ks is None else [jnp.asarray(ks), jnp.asarray(vs)]
    sc_t = [None, None] if ks is None else [_t(ks), _t(vs)]
    ref = jda.decode_attention_stacked(
        jnp.full((1,), layer, jnp.int32), jnp.asarray(q, jdt), cast_j(k), cast_j(v),
        jnp.asarray(bias.numpy()), *sc_j, jnp.asarray(slopes), interpret=True)
    got = k11.decode_attention_stacked(layer, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                       *sc_t, _t(slopes))
    ref = np.asarray(ref, np.float32)
    rtol = 2e-4 if dt == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), ref, rtol=rtol, atol=2e-4 * np.abs(ref).max())
    assert not got[-1].any()
    # the slopes move the output: without them it differs
    plain = k11.decode_attention_stacked(layer, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                         *sc_t)
    assert (got.float() - plain.float()).abs().max() > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_decode_attention_alibi_per_layer_matches_jax(kind):
    """The per-layer wrapper with slopes (Bloom's per-layer decode)."""
    b, h, s, d = 2, 8, 384, 128
    rng = np.random.default_rng(23)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (b, h, s, d), kind)
    bias = _bias(rng, b, s, np.array([300, 17]))
    sc = [None, None] if ks is None else [ks, vs]
    slopes = j_alibi_slopes(h)
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias.numpy()),
                               *[None if a is None else jnp.asarray(a) for a in sc],
                               jnp.asarray(slopes), interpret=True)
    got = k11.decode_attention(_t(q), _t(k), _t(v), bias,
                               *[None if a is None else _t(a) for a in sc], _t(slopes))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())


def test_decode_attention_options_and_support():
    """int8_dots is not ported and raises on any device; ALiBi slopes take
    MHA only (the JAX kernel asserts rep == 1), one per query head; the
    support gate is the JAX one."""
    q = torch.zeros((1, 4, 64))
    k = torch.zeros((1, 1, 4, 128, 64))
    bias = torch.zeros((1, 128))
    with pytest.raises(NotImplementedError, match="int8_dots"):
        k11.decode_attention_stacked(0, q, k, k, bias, int8_dots=True)
    gqa = torch.zeros((1, 1, 2, 128, 64))
    with pytest.raises(ValueError, match="MHA only"):
        k11.decode_attention_stacked(0, q, gqa, gqa, bias, alibi_slopes=torch.ones(4))
    with pytest.raises(ValueError, match="ALiBi slopes"):
        k11.decode_attention_stacked(0, q, k, k, bias, alibi_slopes=torch.ones(2))
    out = k11.decode_attention_stacked(0, q, k, k, bias, alibi_slopes=torch.ones(4))
    assert out.shape == q.shape
    for args in ((128, 32, 32, 128), (384, 8, 2, 64), (100, 8, 8, 64), (128, 8, 8, 80),
                 (512, 6, 4, 64)):
        assert k11.supported(*args) == jda.supported(*args)
    assert k11._pick_tile_s(768) == jda._pick_tile_s(768) == 256

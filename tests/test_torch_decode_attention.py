"""K11 (decode_attention_stacked / decode_attention) plain PyTorch version vs
the JAX Pallas kernel in interpret mode: fp and int8 head-major caches,
MHA and GQA, masked holes and fully masked rows, one and several S tiles.

Tolerance in f32: 1e-5 relative, plus 1e-5 of the output's largest
magnitude (sums of opposite-signed terms cancel toward zero), from f32
sums taken in another order; a bf16 output may round one bf16 ulp apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import decode_attention as jda
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


def test_decode_attention_options_and_support():
    """ALiBi and int8_dots are not ported: they raise on any device; the
    support gate is the JAX one."""
    q = torch.zeros((1, 4, 64))
    k = torch.zeros((1, 1, 4, 128, 64))
    bias = torch.zeros((1, 128))
    with pytest.raises(NotImplementedError, match="ALiBi"):
        k11.decode_attention_stacked(0, q, k, k, bias, alibi_slopes=torch.ones(4))
    with pytest.raises(NotImplementedError, match="int8_dots"):
        k11.decode_attention_stacked(0, q, k, k, bias, int8_dots=True)
    for args in ((128, 32, 32, 128), (384, 8, 2, 64), (100, 8, 8, 64), (128, 8, 8, 80),
                 (512, 6, 4, 64)):
        assert k11.supported(*args) == jda.supported(*args)
    assert k11._pick_tile_s(768) == jda._pick_tile_s(768) == 256

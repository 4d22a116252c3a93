"""K10 (write_quant_cache_stacked): the plain PyTorch version vs the JAX
Pallas kernel in interpret mode (jitted).  The written int8 rows and their
scales are bit-identical; every other row of the cache stays as it was."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.cache_write import write_quant_cache_stacked as j_write
from smoothquant_tpu_torch.kernels.cache_write import write_quant_cache_stacked

torch.set_num_threads(1)

L, B, H, S, D = 2, 5, 4, 32, 64


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rotary", [True, False])
@pytest.mark.parametrize("per_slot", [True, False])
def test_write_cache_stacked_matches_jax(per_slot, rotary):
    rng = np.random.default_rng(int(per_slot) * 2 + int(rotary))
    k_new = (rng.normal(size=(B, H, D)) * rng.uniform(0.1, 8.0, size=(B, H, 1))
             ).astype(np.float32)
    v_new = rng.normal(size=(B, H, D)).astype(np.float32)
    ang = rng.uniform(0, 6.3, size=(B, 1, D)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    kq = rng.integers(-127, 128, size=(L, B, H, S, D)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(L, B, H, S, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.02, size=(L, B, H, S)).astype(np.float32)
    vs = rng.uniform(0.01, 0.02, size=(L, B, H, S)).astype(np.float32)
    # per slot: one row past the end (clamped to S - 1) and the first row
    pos = np.array([3, 0, S - 1, S + 6, 17], np.int32) if per_slot else np.int32(S + 2)

    ref = j_write(jnp.int32(1), jnp.asarray(pos), jnp.asarray(k_new), jnp.asarray(v_new),
                  jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kq), jnp.asarray(vq),
                  jnp.asarray(ks), jnp.asarray(vs), rotary=rotary, interpret=True)
    got = [_t(a) for a in (kq, vq, ks, vs)]
    write_quant_cache_stacked(1, torch.as_tensor(pos), _t(k_new), _t(v_new), _t(cos),
                              _t(sin), *got, rotary=rotary)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    rows = np.minimum(np.broadcast_to(pos, (B,)), S - 1)
    written = np.zeros((L, B, S), bool)
    written[1, np.arange(B), rows] = True
    for g, before in zip(got, (kq, vq, ks, vs)):
        g = g.numpy()
        assert not np.array_equal(g[1, np.arange(B), :, rows], before[1, np.arange(B), :, rows])
        untouched = ~written[:, :, None, :].repeat(H, axis=2)       # (L, B, H, S)
        np.testing.assert_array_equal(g[untouched], before[untouched])


def test_bf16_keys_match_jax():
    """bf16 k / v at the serving head_dim (128).  At head_dim 64 XLA's CPU
    code for the bf16 body contracts the second half of the rotary the
    other way round, fma(rot(x), sin, x·cos), and a scale in 20 moves by an
    ulp; at 128 it forms fma(x, cos, rot(x)·sin) throughout, as the port."""
    d = 128
    rng = np.random.default_rng(9)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    k_new, v_new = bf(rng.normal(size=(B, H, d))), bf(rng.normal(size=(B, H, d)))
    ang = rng.uniform(0, 6.3, size=(B, 1, d)).astype(np.float32)
    kq = np.zeros((L, B, H, S, d), np.int8)
    ks = np.zeros((L, B, H, S), np.float32)
    pos = np.array([1, 2, 3, 4, 5], np.int32)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    ref = j_write(jnp.int32(0), jnp.asarray(pos), j(k_new), j(v_new),
                  jnp.asarray(np.cos(ang)), jnp.asarray(np.sin(ang)), jnp.asarray(kq),
                  jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(ks), interpret=True)
    got = [_t(a) for a in (kq, kq, ks, ks)]
    write_quant_cache_stacked(0, _t(pos), k_new, v_new, _t(np.cos(ang)), _t(np.sin(ang)),
                              *got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("per_slot", [True, False])
def test_rotary_off_takes_no_tables(per_slot):
    """A non-rotary architecture (Bloom) passes no tables with rotary=False:
    the same bytes as the JAX kernel over its dummy zero tables; with
    rotary=True the missing tables raise."""
    rng = np.random.default_rng(11 + int(per_slot))
    k_new = rng.normal(size=(B, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, size=(L, B, H, S, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.02, size=(L, B, H, S)).astype(np.float32)
    pos = np.array([3, 0, S - 1, S + 6, 17], np.int32) if per_slot else np.int32(9)
    zero = jnp.zeros((B, 1, D), jnp.float32)
    ref = j_write(jnp.int32(0), jnp.asarray(pos), jnp.asarray(k_new), jnp.asarray(v_new),
                  zero, zero, jnp.asarray(kq), jnp.asarray(kq), jnp.asarray(ks),
                  jnp.asarray(ks), rotary=False, interpret=True)
    got = [_t(a) for a in (kq, kq, ks, ks)]
    write_quant_cache_stacked(0, torch.as_tensor(pos), _t(k_new), _t(v_new), None, None,
                              *got, rotary=False)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="cos and sin"):
        write_quant_cache_stacked(0, torch.as_tensor(pos), _t(k_new), _t(v_new), None, None,
                                  *got)

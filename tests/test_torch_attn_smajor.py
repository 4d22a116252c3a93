"""K2 (write_quant_cache_smajor) and K3 (decode_attention_smajor_stacked)
plain PyTorch versions vs the JAX Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.attn_smajor import (
    decode_attention_smajor_stacked as j_attn,
    write_quant_cache_smajor as j_write,
)
from smoothquant_tpu_torch.kernels.attn_smajor import (
    decode_attention_smajor_stacked,
    write_quant_cache_smajor,
)
from smoothquant_tpu_torch.models.common import decode_bias

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rotary", [True, False])
def test_write_cache_plain_matches_jax(rotary):
    """Per-slot positions, one past S-1 (clamped to the last row): the int8
    rows are bit-exact, the scales match to rtol 1e-6, nothing else moves."""
    l_num, b, h, s, d = 2, 4, 8, 64, 64
    rng = np.random.default_rng(1)
    k_new = rng.normal(size=(b, h, d)).astype(np.float32)
    v_new = rng.normal(size=(b, h, d)).astype(np.float32)
    ang = rng.uniform(0, 6.3, size=(b, 1, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    k_sm = rng.integers(-127, 128, size=(l_num, b, s, h * d)).astype(np.int8)
    v_sm = rng.integers(-127, 128, size=(l_num, b, s, h * d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.02, size=(l_num, b, h, s)).astype(np.float32)
    vs = rng.uniform(0.01, 0.02, size=(l_num, b, h, s)).astype(np.float32)
    pos = np.array([5, 0, 63, 70], np.int32)

    ref = j_write(jnp.int32(1), jnp.asarray(pos), jnp.asarray(k_new),
                  jnp.asarray(v_new), jnp.asarray(cos), jnp.asarray(sin),
                  jnp.asarray(k_sm), jnp.asarray(v_sm), jnp.asarray(ks),
                  jnp.asarray(vs), rotary=rotary, interpret=True)
    got = [_t(a) for a in (k_sm, v_sm, ks, vs)]
    write_quant_cache_smajor(1, _t(pos), _t(k_new), _t(v_new), _t(cos), _t(sin),
                             *got, rotary=rotary)
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(ref[2:], got[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    # row 63 of slot 3 was written (pos 70 clamped to S-1); others untouched
    assert not np.array_equal(got[0][1, 3, 63].numpy(), k_sm[1, 3, 63])
    np.testing.assert_array_equal(got[0][0].numpy(), k_sm[0])
    np.testing.assert_array_equal(got[0][1, 0, 6].numpy(), k_sm[1, 0, 6])


@pytest.mark.parametrize("h,n_kv", [(8, 8), (8, 2)])
def test_decode_attention_plain_matches_jax(h, n_kv):
    l_num, b, s, d = 2, 3, 128, 64
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    v_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[2, :] = False            # a fully masked row outputs 0
    pos = np.array([40, 127, 9])
    bias = decode_bias(_t(pos), b, s, _t(mask))
    ref = j_attn(jnp.ones((1,), jnp.int32), jnp.asarray(q), jnp.asarray(k_sm),
                 jnp.asarray(v_sm), jnp.asarray(bias.numpy()), jnp.asarray(ks),
                 jnp.asarray(vs), interpret=True)
    got = decode_attention_smajor_stacked(1, _t(q), _t(k_sm), _t(v_sm), bias,
                                          _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    assert not got[2].any()


def test_decode_bias_matches_jax():
    from smoothquant_tpu.models.common import decode_bias as j_bias

    rng = np.random.default_rng(5)
    mask = rng.random((3, 32)) > 0.4
    pos = np.array([3, 31, 40], np.int32)
    ref = j_bias(jnp.asarray(pos), 3, 32, jnp.asarray(mask))
    np.testing.assert_array_equal(decode_bias(_t(pos), 3, 32, _t(mask)).numpy(),
                                  np.asarray(ref))

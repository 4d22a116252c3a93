"""K7b (norm_quantize_acts_t) plain PyTorch version vs the JAX Pallas kernel
in interpret mode: the RMSNorm and no norm, odd row counts (N padded to a
multiple of 8), salient columns with k_s above num_salient, k_s = 0, a
k_ns padded past the non-salient width, f32 and bf16 activations.

Without a norm the port is the JAX kernel bit for bit.  With the RMSNorm
the port takes its own rule for the factor (quant.core.rms_factor: Σx² in
f64, 1/√v correctly rounded — K1's pre-pass takes it, so K7b → K5 and K1
quantize the same values on the card), where the JAX kernel takes XLA's
rsqrt: over these cases the factor moves the scales by up to 3 ulp and no
code (bounds: 4 ulp, and codes off by one in under 1 % of them), and the
salient outputs by a few f32 ulp (bound 1e-6 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.act_prep import norm_quantize_acts_t as j_k7b
from smoothquant_tpu_torch.kernels import act_prep as k7

torch.set_num_threads(1)

CASES = [  # (n, c, group_size, num_salient, k_ns, k_s, act_bits)
    (5, 512, 64, 25, 512, 128, 4),       # odd N, k_ns past the 487 non-salient
    (13, 256, 16, 12, 256, 128, 4),
    (3, 320, 32, 0, 384, 0, 8),          # no salient block, k_ns padded by 64
    (9, 1024, 64, 51, 1024, 128, 4),
]


def _scale_ulps(got, ref):
    g = got.numpy().view(np.int32).astype(np.int64)
    return np.abs(g - np.asarray(ref, np.float32).view(np.int32)).max(initial=0)


@pytest.mark.parametrize("norm_kind", ["rms", None])
@pytest.mark.parametrize("n,c,gs,n_sal,k_ns,k_s,bits", CASES)
def test_norm_quantize_acts_matches_jax(norm_kind, n, c, gs, n_sal, k_ns, k_s, bits):
    rng = np.random.default_rng(n + c)
    x = (rng.normal(size=(n, c)) * rng.uniform(0.5, 4.0, size=(1, c))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    kw = dict(group_size=gs, act_bits=bits, k_ns=k_ns, num_salient=n_sal, k_s=k_s, eps=1e-5)
    ref = j_k7b(jnp.asarray(x), jnp.asarray(w), **kw, norm_kind=norm_kind or "none",
                sal_dtype=jnp.float32, interpret=True)
    got = k7.norm_quantize_acts_t(torch.from_numpy(x), torch.from_numpy(w), **kw,
                                  norm_kind=norm_kind, sal_dtype=torch.float32)
    n_pad = k7.padded_rows(n)
    assert got[0].shape == (k_ns // gs, n_pad, gs) and got[0].dtype == torch.int8
    assert got[1].shape == (k_ns // gs, n_pad) and got[2].shape == (n_pad, k_s)
    codes = np.abs(got[0].numpy().astype(int) - np.asarray(ref[0]).astype(int))
    sal_ref = np.asarray(ref[2])
    if norm_kind is None:
        assert codes.max(initial=0) == 0 and _scale_ulps(got[1], ref[1]) == 0
        np.testing.assert_array_equal(got[2].numpy(), sal_ref)
    else:
        assert codes.max(initial=0) <= 1 and (codes != 0).mean() < 0.01
        assert _scale_ulps(got[1], ref[1]) <= 4
        np.testing.assert_allclose(got[2].numpy(), sal_ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(sal_ref).max(initial=1.0))
    # the padding rows: code 0 with the floor scale; the salient tail zeroed
    assert not got[0][:, n:].any() and not got[2][n:].any()
    k_ns_raw = c - n_sal
    x3 = got[0].permute(1, 0, 2).reshape(n_pad, k_ns)
    assert not x3[:, k_ns_raw:].any()


def test_bf16_input_and_salient():
    """bf16 activations and a bf16 salient block (the JAX default)."""
    n, c, gs, n_sal = 7, 512, 64, 25
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(n, c)) * 3, jnp.bfloat16)
    w = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    kw = dict(group_size=gs, act_bits=4, k_ns=512, num_salient=n_sal, k_s=128, eps=1e-5)
    ref = j_k7b(x, jnp.asarray(w), **kw, norm_kind="none", interpret=True)
    got = k7.norm_quantize_acts_t(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                                  torch.from_numpy(w), **kw, norm_kind=None)
    assert got[2].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].float().numpy(), np.asarray(ref[2], np.float32))


def test_rms_matches_k1_prepass_rule():
    """K7b's normed values are K1's pre-pass values (the same factor rule),
    so its codes and scales are K1's row-major ones laid out by group."""
    from smoothquant_tpu_torch.kernels.int4_group_matmul import rawx_quantize_plain

    n, c, gs, n_sal = 6, 512, 64, 25
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32) * 2)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32))
    x3, xs_t, x_sal = k7.norm_quantize_acts_t(
        x, w, group_size=gs, act_bits=4, k_ns=512, num_salient=n_sal, k_s=128, eps=1e-6,
        norm_kind="rms", sal_dtype=torch.float32)
    x_q, x_scales, xs = rawx_quantize_plain(
        x, w, None, kk=512, k_s=128, group_size=gs, act_bits=4, num_salient=n_sal,
        eps=1e-6, norm_kind="rms", sal_dtype=torch.float32)
    g = 512 // gs
    torch.testing.assert_close(x3[:, :n].permute(1, 0, 2).reshape(n, 512), x_q, rtol=0, atol=0)
    torch.testing.assert_close(xs_t[:, :n].t(), x_scales, rtol=0, atol=0)
    torch.testing.assert_close(x_sal[:n], xs, rtol=0, atol=0)
    assert x_scales.shape == (n, g)


def test_options_raise():
    x = torch.zeros((4, 256))
    kw = dict(group_size=64, act_bits=4, k_ns=256, num_salient=0, k_s=0, eps=1e-5)
    with pytest.raises(ValueError, match="norm_kind"):
        k7.norm_quantize_acts_t(x, torch.ones(256), **kw, norm_kind="layer")

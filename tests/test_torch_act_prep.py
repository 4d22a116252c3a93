"""K7a (quantize_acts_grouped_t): the plain PyTorch version vs the JAX
Pallas kernel in interpret mode (jitted, as the decode scan runs it).
Codes and scales bit-identical, the padding rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.act_prep import quantize_acts_grouped_t as j_quant
from smoothquant_tpu_torch.kernels.act_prep import (
    padded_rows,
    quantize_acts_grouped_t,
)

torch.set_num_threads(1)

GS, K_NS = 16, 256


def _x(n: int, seed: int) -> np.ndarray:
    """Rows of very different scales, one zero row, and a zero tail (the
    k_ns padding past the non-salient channels)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, K_NS)) * rng.uniform(1e-3, 20.0, size=(n, 1))
    x[:, 3] *= 40.0
    x[1] = 0.0
    x[:, K_NS - 24:] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("act_bits", [4, 8])
@pytest.mark.parametrize("n", [33, 40, 64])
def test_quantize_acts_grouped_t_matches_jax(n, act_bits):
    x = _x(n, seed=n + act_bits)
    ref_q, ref_s = j_quant(jnp.asarray(x), group_size=GS, act_bits=act_bits,
                           interpret=True)
    got_q, got_s = quantize_acts_grouped_t(torch.from_numpy(x), group_size=GS,
                                           act_bits=act_bits)
    n_pad = padded_rows(n)
    assert got_q.shape == (K_NS // GS, n_pad, GS) and got_q.dtype == torch.int8
    assert got_s.shape == (K_NS // GS, n_pad) and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    # padding rows and the zero row: code 0 at the floor scale
    assert not got_q[:, n:].any() and not got_q[:, 1].any()
    assert torch.all(got_s[:, 1] == got_s[0, 1])


def test_bf16_input_matches_jax():
    """bf16 activations are upcast to f32 before the quantize, as the kernel
    body does."""
    x = torch.from_numpy(_x(40, seed=5)).to(torch.bfloat16)
    ref_q, ref_s = j_quant(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                           group_size=GS, act_bits=4, interpret=True)
    got_q, got_s = quantize_acts_grouped_t(x, group_size=GS, act_bits=4)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))

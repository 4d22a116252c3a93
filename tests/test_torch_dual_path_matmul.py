"""K9 (dual_path_matmul) plain PyTorch version vs the JAX Pallas kernel in
interpret mode (jitted): its four bodies — grouped with and without the
salient block (_kernel / _kernel_nosal), single group with and without it
(_kernel_colscale / _kernel_colscale_nosal) — for bf16 and f32
activations, with f32 and bf16 group scales.

Tolerance: the dequantized weight is the same on both sides (f32(w_q)·s
rounded to the activation dtype, to nearest even), the products are exact
in f32, and the sums run in another order (XLA's dot over K-tiles of 1024
against torch's GEMM): 1e-5 of the largest output for f32 activations,
2e-6 of it plus one bf16 rounding for bf16 ones (the output is cast to
the activation dtype)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.quant_matmul import dual_path_matmul as j_dual
from smoothquant_tpu_torch.kernels.quant_matmul import dual_path_body, dual_path_matmul

torch.set_num_threads(1)

O, GS = 200, 64


def _operands(n, k, k_s, single, seed):
    rng = np.random.default_rng(seed)
    g = 1 if single else k // GS
    w_max = 127 if single else 7
    return dict(
        x_ns=rng.normal(size=(n, k)).astype(np.float32),
        x_sal=rng.normal(size=(n, k_s)).astype(np.float32) * 4.0,
        w_qt=rng.integers(-w_max, w_max + 1, size=(k, O)).astype(np.int8),
        w_scales_t=rng.uniform(0.001, 0.05, size=(g, O)).astype(np.float32),
        w_sal_t=rng.normal(size=(k_s, O)).astype(np.float32))


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("k_s", [0, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_bodies_match_jax(single, k_s, dtype, scale_dtype):
    n, k = 37, 1280 if not single else 1000
    ops = _operands(n, k, k_s, single, seed=int(single) * 10 + k_s)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    jx = {f: jnp.asarray(ops[f]).astype(jd[dtype]) for f in ("x_ns", "x_sal", "w_sal_t")}
    jsc = jnp.asarray(ops["w_scales_t"]).astype(jd[scale_dtype])
    ref = j_dual(jx["x_ns"], jx["x_sal"], jnp.asarray(ops["w_qt"]), jsc, jx["w_sal_t"],
                 group_size=GS if not single else k, out_dtype=jd[dtype], interpret=True)
    tx = {f: torch.from_numpy(ops[f]).to(td[dtype]) for f in ("x_ns", "x_sal", "w_sal_t")}
    tsc = torch.from_numpy(ops["w_scales_t"]).to(td[scale_dtype])
    got = dual_path_matmul(tx["x_ns"], tx["x_sal"], torch.from_numpy(ops["w_qt"]), tsc,
                           tx["w_sal_t"], group_size=GS if not single else k,
                           out_dtype=td[dtype])
    assert got.dtype == td[dtype] and tuple(got.shape) == ref.shape == (n, O)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    scale = np.abs(ref).max()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2e-6 * scale)


def test_cuda_tensors_never_take_the_plain_version():
    ops = _operands(2, 128, 0, False, seed=0)
    args = [torch.from_numpy(ops[f]).to("meta") for f in
            ("x_ns", "x_sal", "w_qt", "w_scales_t", "w_sal_t")]
    with pytest.raises(RuntimeError):
        dual_path_matmul(*args, group_size=GS)


@pytest.mark.parametrize("dtype, body", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
def test_dual_path_body_rule(dtype, body):
    """K9's body on a CUDA tensor follows from the activation dtype alone."""
    assert dual_path_body(dtype) == body

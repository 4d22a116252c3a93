"""K14, the fused SwiGLU MLP: the port's plain PyTorch version against the
JAX Pallas kernel (interpret mode) on stacked packs built as
tests/test_mlp_fused.py builds them, and the gate (mlp_fused_supported,
can_fuse_mlp) against the JAX package's on the same metas.

Tolerance: the JAX tests' own between the kernel and the two-launch
composition (rtol 5e-4, atol 5e-3 on outputs of magnitude ~1e3): both
sides compute the same f32 chain, but SiLU and the group sums round in
another order, which moves a down_proj activation code across a rounding
edge now and then; a wrong group, chunk or layer misses by O(1) and more."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import real_linear as jreal
from smoothquant_tpu.kernels.mlp_fused import mlp_fused_supported as j_supported
from smoothquant_tpu.kernels.mlp_fused import mlp_swiglu_fused_stacked as j_k14
from smoothquant_tpu_torch.kernels import mlp_fused as tk14
from smoothquant_tpu_torch.kernels import real_linear as treal
from smoothquant_tpu_torch.utils.convert import packed_from_numpy
from test_mlp_fused import L, _build
from test_torch_generate import to_numpy_tree

torch.set_num_threads(1)


def _packs(**kw):
    qcfg, gu, dn = _build(**kw)
    return qcfg, gu, dn, (packed_from_numpy(to_numpy_tree(gu), "cpu"),
                          packed_from_numpy(to_numpy_tree(dn), "cpu"))


def _kwargs(qcfg, gu, eps, dn):
    return dict(group_size=qcfg.group_size, act_bits=qcfg.effective_act_bits,
                n_sal1=gu.meta.num_salient, n_sal2=dn.meta.num_salient,
                gu_out_true=gu.meta.out_features, dn_out_true=dn.meta.out_features, eps=eps)


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("salient_prop", [0.0, 0.05])
@pytest.mark.parametrize("fuse_norm", [True, False])
def test_plain_matches_jax_kernel(fuse_norm, salient_prop, scale_dtype):
    qcfg, gu, dn, (tgu, tdn) = _packs(salient_prop=salient_prop, scale_dtype=scale_dtype)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, gu.meta.in_features)).astype(np.float32)
    norm_w = (rng.uniform(0.5, 1.5, size=(gu.meta.in_features,)).astype(np.float32)
              if fuse_norm else None)
    eps = 1e-6 if fuse_norm else 0.0
    kw = _kwargs(qcfg, gu, eps, dn)
    ref = j_k14(jnp.asarray([1], jnp.int32), jnp.asarray(x),
                None if norm_w is None else jnp.asarray(norm_w),
                gu.w_qt, gu.w_scales_t, gu.w_sal_t, dn.w_qt, dn.w_scales_t, dn.w_sal_t,
                out_dtype=jnp.float32, interpret=True, **kw)
    got = tk14.mlp_swiglu_fused_stacked(
        1, torch.from_numpy(x), None if norm_w is None else torch.from_numpy(norm_w),
        tgu.w_qt, tgu.w_scales_t, tgu.w_sal_t, tdn.w_qt, tdn.w_scales_t, tdn.w_sal_t,
        out_dtype=torch.float32, **kw)
    assert got.shape == (4, dn.meta.out_features) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-3)


def test_layer_selection():
    """Each layer index picks its own layer's weights in both linears."""
    qcfg, gu, dn, (tgu, tdn) = _packs(salient_prop=0.05, seed=7)
    x = np.random.default_rng(5).normal(size=(2, gu.meta.in_features)).astype(np.float32)
    kw = _kwargs(qcfg, gu, 0.0, dn)
    outs = []
    for i in range(L):
        ref = j_k14(jnp.asarray([i], jnp.int32), jnp.asarray(x), None, gu.w_qt,
                    gu.w_scales_t, gu.w_sal_t, dn.w_qt, dn.w_scales_t, dn.w_sal_t,
                    out_dtype=jnp.float32, interpret=True, **kw)
        got = tk14.mlp_swiglu_fused_stacked(
            i, torch.from_numpy(x), None, tgu.w_qt, tgu.w_scales_t, tgu.w_sal_t, tdn.w_qt,
            tdn.w_scales_t, tdn.w_sal_t, out_dtype=torch.float32, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-3)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1]) and not torch.allclose(outs[1], outs[2])


def test_real_mlp_fused_matches_jax():
    """The call site (real_mlp_fused) over bf16 activations with the RMSNorm
    row of one layer, against the JAX wrapper: both cast the salient blocks
    and the norm row to the activation dtype."""
    qcfg, gu, dn, (tgu, tdn) = _packs(salient_prop=0.05, seed=2)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 3, gu.meta.in_features)).astype(np.float32)
    norm_w = rng.uniform(0.5, 1.5, size=(gu.meta.in_features,)).astype(np.float32)
    ref = jreal.real_mlp_fused(gu, dn, jnp.asarray(x, jnp.bfloat16), layer_idx=2,
                               norm=(jnp.asarray(norm_w), 1e-5, "rms"), interpret=True)
    got = treal.real_mlp_fused(tgu, tdn, torch.from_numpy(x).to(torch.bfloat16), layer_idx=2,
                               norm=(torch.from_numpy(norm_w), 1e-5, "rms"))
    assert got.shape == (1, 3, dn.meta.out_features) and got.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -6,
                               atol=5e-3 * np.abs(ref).max())


def test_gate_matches_jax():
    """mlp_fused_supported and can_fuse_mlp give the JAX answers: the
    serving layout at 1-8 rows, not at 9, not without pre-permuted input,
    not across group sizes, not with a gate_up bias."""
    _, gu, dn, (tgu, tdn) = _packs(salient_prop=0.05)
    cases = {"ok": (gu, dn, tgu, tdn)}
    not_pre = lambda p: dataclasses.replace(p, meta=dataclasses.replace(p.meta,
                                                                        pre_permuted=False))
    cases["gu not pre-permuted"] = (not_pre(gu), dn, not_pre(tgu), tdn)
    cases["dn not pre-permuted"] = (gu, not_pre(dn), tgu, not_pre(tdn))
    gs32 = lambda p: dataclasses.replace(p, meta=dataclasses.replace(p.meta, group_size=32,
                                                                     act_group_size=32))
    cases["group sizes differ"] = (gu, gs32(dn), tgu, gs32(tdn))
    cases["gate_up bias"] = (dataclasses.replace(gu, bias=jnp.zeros((L, gu.w_qt.shape[-1]))),
                             dn, dataclasses.replace(tgu, bias=torch.zeros(L, 1)), tdn)
    seen = set()
    for name, (jg, jd, tg, td) in cases.items():
        for n in (1, 4, 8, 9):
            want = j_supported(jg.meta, jd.meta, n)
            assert tk14.mlp_fused_supported(tg.meta, td.meta, n) == want, (name, n)
            want = jreal.can_fuse_mlp(jg, jd, n)
            assert treal.can_fuse_mlp(tg, td, n) == want, (name, n)
            seen.add(want)
    assert seen == {True, False}
    assert treal.can_fuse_mlp(tgu, tdn, 8) and not treal.can_fuse_mlp(tgu, tdn, 9)

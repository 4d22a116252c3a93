"""The port's host pack (utils/native.py over its own kernels/csrc/packlib.cpp,
kernels/pack._pack_host, pack_model(host_pack=True)) against the JAX
package's native library and host pack, and against the port's device
pack.

The library's functions that the JAX package's packlib.cpp has are bit for
bit JAX's library (group_quant keeps JAX's host rule: the scale an IEEE
division by q_max, the codes a multiply by 1/scale).  The port's host pack
runs group_quant_rcp instead, the rule of the port's (and JAX's jitted)
device pack, so it is the device pack bit for bit.  Against JAX's host pack
its codes, permutations and salient blocks are bit for bit and its scales
within the one ulp by which JAX's own host and device packs differ
(tests/test_host_pack.py:36-38)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant import config as jconfig
from smoothquant_tpu.quant import core as jcore
from smoothquant_tpu.utils import native as jnative
from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.registry import pack_model
from smoothquant_tpu_torch.quant import config as tconfig
from smoothquant_tpu_torch.quant import core as tcore
from smoothquant_tpu_torch.utils import native
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy
from test_torch_llama_serve import to_numpy_tree
from torch_io_helpers import assert_trees_bit_equal, leaves, np_leaf

torch.set_num_threads(2)

PACKED = ("w_qt", "w_scales_t", "w_sal_t", "perm", "bias", "ns_mask")


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert jnative.available(), "the JAX package's library did not build"
    assert native.available(), "the port's library did not build"


def _w(rng, o, c, spread=True):
    w = rng.normal(size=(o, c)).astype(np.float32)
    if spread:
        w[:, 3] *= 40.0
    return w


@pytest.mark.parametrize("shape", [(64, 256), (33, 96), (1, 8)])
def test_library_functions_equal_jax_library(shape):
    rng = np.random.default_rng(sum(shape))
    o, c = shape
    w = _w(rng, o, c)
    perm = rng.permutation(c).astype(np.int32)
    np.testing.assert_array_equal(native.permute_cols(w, perm), jnative.permute_cols(w, perm))
    np.testing.assert_array_equal(native.permute_cols(w, perm),
                                  native.permute_cols_plain(w, perm))
    for group, bits in ((8, 4), (c, 8), (c // 2 if c > 2 else c, 4)):
        q, s = native.group_quant(w, group, bits)
        jq, js = jnative.group_quant(w, group, bits)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        pq, ps = native.group_quant_plain(w, group, bits, rule="jax")
        np.testing.assert_array_equal(q, pq)
        np.testing.assert_array_equal(s, ps)
    qt = rng.integers(-8, 8, size=(2 * o, c)).astype(np.int8)
    np.testing.assert_array_equal(native.pack_nibbles_split(qt), jnative.pack_nibbles_split(qt))
    np.testing.assert_array_equal(native.pack_nibbles_split(qt),
                                  native.pack_nibbles_split_plain(qt))
    for a in (qt, w):
        np.testing.assert_array_equal(native.transpose(a), jnative.transpose(a))
        np.testing.assert_array_equal(native.transpose(a), native.transpose_plain(a))


@pytest.mark.parametrize("group,bits", [(16, 4), (64, 4), (128, 8), (256, 8)])
def test_group_quant_rcp_is_the_device_rule(group, bits):
    """group_quant_rcp equals quant/core.group_quant_params (the port's device
    pack) and JAX's jitted group_quant_params bit for bit, and its numpy
    plain version."""
    rng = np.random.default_rng(group + bits)
    w = _w(rng, 40, 256)
    w[5, :group] = 0.0                                   # a group under the floor
    q, s = native.group_quant_rcp(w, group, bits)
    tq, ts = tcore.group_quant_params(torch.from_numpy(w), bits, group)
    np.testing.assert_array_equal(q, tq.reshape(40, 256).numpy())
    np.testing.assert_array_equal(s, ts.reshape(40, -1).numpy())
    jq, js = jax.jit(lambda x: jcore.group_quant_params(x, bits, group))(jnp.asarray(w))
    np.testing.assert_array_equal(q, np.asarray(jq).reshape(40, 256))
    np.testing.assert_array_equal(s, np.asarray(js).reshape(40, -1))
    pq, ps = native.group_quant_plain(w, group, bits, rule="rcp")
    np.testing.assert_array_equal(q, pq)
    np.testing.assert_array_equal(s, ps)


def _lin(rng, o, c, dtype=np.float32, bias=True):
    w = (rng.normal(size=(o, c)) * 0.05).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32) if bias else None
    return w, b


@pytest.mark.parametrize("nibble", [False, True])
@pytest.mark.parametrize("salient_prop", [0.0, 0.08])
def test_pack_linear_host_equals_device_and_jax_host(nibble, salient_prop):
    """tests/test_host_pack.py:22's case: the port's host pack is its device
    pack bit for bit, and JAX's host pack bit for bit but the scales (one
    ulp, JAX's own host-vs-device bound)."""
    rng = np.random.default_rng(0)
    o, c = 48, 160
    w, b = _lin(rng, o, c)
    imp = rng.uniform(0.1, 1.0, size=(c,)) if salient_prop else None
    tq = tconfig.w4a4_group(group_size=16, salient_prop=salient_prop)
    jq = jconfig.w4a4_group(group_size=16, salient_prop=salient_prop)
    lin = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    dev = tpack.pack_linear(lin, tq, importance=imp, nibble=nibble)
    host = tpack.pack_linear(lin, tq, importance=imp, nibble=nibble, host_pack=True)
    assert host.meta == dev.meta
    for f in PACKED:
        a, r = getattr(host, f), getattr(dev, f)
        assert (a is None) == (r is None), f
        if a is not None:
            assert a.dtype == r.dtype and torch.equal(a, r), f
    jh = jpack.pack_linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jq,
                           importance=imp, nibble=nibble, host_pack=True)
    _against_jax_host(host, params_from_numpy(to_numpy_tree(jh), "cpu"))


def _against_jax_host(got, ref):
    assert got.meta == ref.meta
    for f in PACKED:
        a, r = getattr(got, f), getattr(ref, f)
        assert (a is None) == (r is None), f
        if a is None:
            continue
        if f == "w_scales_t":
            np.testing.assert_allclose(a.float().numpy(), r.float().numpy(), rtol=3e-7)
        else:
            assert a.dtype == r.dtype and torch.equal(a, r), f


def test_pack_linear_host_bf16_weights_and_per_tensor():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(_lin(rng, 32, 64)[0]).to(torch.bfloat16)
    q = tconfig.QuantConfig(weight_quant="per_tensor", act_quant="per_token", quant_bits=8)
    dev = tpack.pack_linear({"weight": w, "bias": None}, q)
    host = tpack.pack_linear({"weight": w, "bias": None}, q, host_pack=True)
    for f in ("w_qt", "w_scales_t", "w_sal_t", "perm"):
        assert torch.equal(getattr(host, f), getattr(dev, f)), f
    assert host.w_sal_t.dtype == dev.w_sal_t.dtype == torch.bfloat16
    assert host.meta.layout == "identity" and host.w_qt.stride() == dev.w_qt.stride()


def _tiny():
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), intermediate_size=256)
    params = jllama.init_params(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(3)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}
    return cfg, params, feat


@pytest.mark.parametrize("nibble", [False, True])
@pytest.mark.parametrize("salient_prop", [0.0, 0.1])
def test_pack_model_host_equals_device_and_jax_host(nibble, salient_prop):
    cfg, params, feat = _tiny()
    tcfg = config_from(tllama.LlamaConfig, cfg)
    tparams = params_from_numpy(to_numpy_tree(params), "cpu")
    tq = tconfig.w4a4_group(group_size=32, salient_prop=salient_prop)
    jq = jconfig.w4a4_group(group_size=32, salient_prop=salient_prop)
    kw = dict(input_feat=feat if salient_prop else None, nibble=nibble)
    dev = pack_model("llama", tparams, tcfg, tq, compute_dtype=torch.float32, **kw)
    host = pack_model("llama", tparams, tcfg, tq, compute_dtype=torch.float32,
                      host_pack=True, **kw)
    assert_trees_bit_equal(host, dev)
    jh = jpack_model("llama", params, cfg, jq, compute_dtype=jnp.float32, host_pack=True,
                     **kw)
    ref = params_from_numpy(to_numpy_tree(jh), "cpu")
    got_l, ref_l = leaves(host), leaves(ref)
    assert sorted(got_l) == sorted(ref_l)
    for k in ref_l:
        a, r = np_leaf(got_l[k]), np_leaf(ref_l[k])
        if k.endswith("w_scales_t"):
            np.testing.assert_allclose(a, r, rtol=3e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(a, r, err_msg=k)


def test_pack_model_serving_recipe_host_equals_device():
    """The serving recipe (fused, folded, shared basis, identity o_proj,
    int8 lm_head, bf16 scales, aligned) packed on the host is the device
    pack bit for bit, leaf by leaf."""
    cfg, params, feat = _tiny()
    tcfg = config_from(tllama.LlamaConfig, cfg)
    tparams = params_from_numpy(to_numpy_tree(params), "cpu")
    tq = dataclasses.replace(tconfig.w4a4_group(group_size=16, salient_prop=0.05),
                             scale_dtype="bfloat16")
    head = tconfig.QuantConfig(weight_quant="per_channel", act_quant="per_token",
                               quant_bits=8)
    kw = dict(input_feat=feat, nibble=True, lm_head_qcfg=head, align_k_groups=2,
              align_o=128, fuse=True, fold_perms=True, shared_residual_basis=True,
              identity_keys=("o_proj",))
    dev = pack_model("llama", tparams, tcfg, tq, **kw)
    host = pack_model("llama", tparams, tcfg, tq, host_pack=True, **kw)
    assert_trees_bit_equal(host, dev)
    assert host["lm_head"].w_qt.stride() == dev["lm_head"].w_qt.stride()


def test_host_pack_raises_when_the_library_cannot_build(monkeypatch, tmp_path):
    """No drop to numpy: a source that does not compile, or no compiler,
    makes host_pack raise."""
    bad = tmp_path / "packlib.cpp"
    bad.write_text("this is not C++\n")
    lin = {"weight": torch.randn(16, 32), "bias": None}
    q = tconfig.w4a4_group(group_size=16)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="packlib.cpp failed"):
        tpack.pack_linear(lin, q, host_pack=True)
    assert not native.available()
    monkeypatch.setenv("CXX", os.path.join(str(tmp_path), "no-such-compiler"))
    with pytest.raises(RuntimeError, match="needs g"):
        tpack.pack_linear(lin, q, host_pack=True)

"""Packing in the PyTorch port vs the JAX package: decoded int codes,
scales, permutations and salient blocks must be bit-exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import QuantConfig as JQuantConfig
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.registry import pack_model as tpack_model
from smoothquant_tpu_torch.quant.config import QuantConfig, w4a4_group
from smoothquant_tpu_torch.utils import roofline
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

_FIELDS = ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.array(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _decoded(p, nibble):
    """(int codes, f32 scales, perm, f32 salient, mask) of a pack."""
    if nibble:
        codes = (tpack.unpack_nibbles_to_int8(p.w_qt).numpy()
                 if isinstance(p.w_qt, torch.Tensor)
                 else np.asarray(jpack.unpack_nibbles_to_int8(p.w_qt)))
    else:
        codes = _np(p.w_qt)
    mask = None if p.ns_mask is None else _np(p.ns_mask)
    return (codes, _np(p.w_scales_t), _np(p.perm).astype(np.int64),
            _np(p.w_sal_t), mask)


def assert_pack_equal(jp, tp):
    jm = dataclasses.asdict(jp.meta)
    jm.pop("tp_reduce")
    assert jm == dataclasses.asdict(tp.meta)
    for a, b in zip(_decoded(jp, jp.meta.nibble), _decoded(tp, tp.meta.nibble)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    if jp.bias is None:
        assert tp.bias is None
    else:
        np.testing.assert_array_equal(_np(jp.bias), _np(tp.bias))


def to_numpy_tree(node):
    """Flatten a JAX params tree into the converter's numpy form."""
    if isinstance(node, jpack.PackedLinear):
        d = {f: None if getattr(node, f) is None else np.asarray(getattr(node, f))
             for f in _FIELDS + ("sal_select",)}
        d["meta"] = dataclasses.asdict(node.meta)
        return d
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    return None if node is None else np.asarray(node)


def _lin(rng, o, c, bias=False):
    w = rng.normal(size=(o, c)).astype(np.float32) * c ** -0.5
    w[:, 3] *= 20.0   # an outlier channel
    b = rng.normal(size=(o,)).astype(np.float32) if bias else None
    return w, b


RECIPES = {
    "w4a4_g16_nibble": dict(cfg=(16, 0.05, "float32"), nibble=True, absmax=False),
    "w4a4_g16_bf16_scales_absmax": dict(cfg=(16, 0.05, "bfloat16"), nibble=True,
                                        absmax=True),
    "w4a4_g32_int8_container": dict(cfg=(32, 0.1, "float32"), nibble=False,
                                    absmax=False),
    "w4a4_g16_no_salient": dict(cfg=(16, 0.0, "float32"), nibble=True, absmax=False),
}


def _cfgs(gs, prop, sdt):
    j = dataclasses.replace(jw4a4_group(group_size=gs, salient_prop=prop),
                            scale_dtype=sdt)
    t = dataclasses.replace(w4a4_group(group_size=gs, salient_prop=prop),
                            scale_dtype=sdt)
    return j, t


@pytest.mark.parametrize("name,identity", [
    (name, identity) for name in sorted(RECIPES) for identity in (False, True)
    if RECIPES[name]["nibble"] or not identity])   # identity packs are nibble
def test_pack_linear_bit_exact(name, identity):
    r = RECIPES[name]
    rng = np.random.default_rng(0)
    o, c = 96, 200
    w, b = _lin(rng, o, c, bias=True)
    imp = rng.uniform(0.1, 1.0, size=(c,))
    absmax = rng.uniform(0.1, 5.0, size=(c,)) if r["absmax"] else None
    jcfg, tcfg = _cfgs(*r["cfg"])
    kw = dict(importance=imp, nibble=r["nibble"], align_k_groups=2, align_o=128,
              identity=identity)
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jcfg,
                           act_absmax=None if identity else absmax,
                           compute_dtype=jnp.float32, **kw)
    tp = tpack.pack_linear({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
                           tcfg, act_absmax=None if identity else absmax,
                           compute_dtype=torch.float32, **kw)
    assert_pack_equal(jp, tp)


def test_pack_int8_per_channel_lm_head_identity_layout():
    rng = np.random.default_rng(1)
    w, _ = _lin(rng, 256, 128)
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": None},
                           JQuantConfig(weight_quant="per_channel",
                                        act_quant="per_token", quant_bits=8),
                           compute_dtype=jnp.float32)
    tp = tpack.pack_linear({"weight": torch.from_numpy(w), "bias": None},
                           QuantConfig(weight_quant="per_channel",
                                       act_quant="per_token", quant_bits=8),
                           compute_dtype=torch.float32)
    assert tp.meta.layout == "identity"
    assert_pack_equal(jp, tp)


def test_fold_input_perm_and_permute_output_columns():
    rng = np.random.default_rng(2)
    jcfg, tcfg = _cfgs(16, 0.05, "float32")
    wd, _ = _lin(rng, 64, 160)
    wgu, bgu = _lin(rng, 320, 64, bias=True)
    imp = rng.uniform(0.1, 1.0, size=(160,))
    jd = jpack.pack_linear({"weight": jnp.asarray(wd), "bias": None}, jcfg,
                           importance=imp, compute_dtype=jnp.float32, nibble=True)
    td = tpack.pack_linear({"weight": torch.from_numpy(wd), "bias": None}, tcfg,
                           importance=imp, compute_dtype=torch.float32, nibble=True)
    jd2, jprod = jpack.fold_input_perm(
        jd, {"weight": jnp.asarray(wgu), "bias": jnp.asarray(bgu)}, n_splits=2)
    td2, tprod = tpack.fold_input_perm(
        td, {"weight": torch.from_numpy(wgu), "bias": torch.from_numpy(bgu)},
        n_splits=2)
    assert td2.meta.pre_permuted and jd2.meta.pre_permuted
    np.testing.assert_array_equal(np.asarray(jprod["weight"]), tprod["weight"].numpy())
    np.testing.assert_array_equal(np.asarray(jprod["bias"]), tprod["bias"].numpy())
    idx = rng.permutation(64)
    assert_pack_equal(jpack.permute_output_columns(jd2, idx),
                      tpack.permute_output_columns(td2, idx))


@pytest.mark.parametrize("act_quant", ["per_group", "per_token"])
def test_quantize_activations_packed_int_bit_exact(act_quant):
    rng = np.random.default_rng(3)
    jcfg, tcfg = _cfgs(16, 0.05, "float32")
    jcfg = dataclasses.replace(jcfg, act_quant=act_quant)
    tcfg = dataclasses.replace(tcfg, act_quant=act_quant)
    w, _ = _lin(rng, 64, 200)
    imp = rng.uniform(0.1, 1.0, size=(200,))
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": None}, jcfg,
                           importance=imp, compute_dtype=jnp.float32, nibble=True)
    tp = tpack.pack_linear({"weight": torch.from_numpy(w), "bias": None}, tcfg,
                           importance=imp, compute_dtype=torch.float32, nibble=True)
    x = rng.normal(size=(5, 200)).astype(np.float32) * 3.0
    xp = x[:, np.asarray(jp.perm)]
    # jitted, as it runs inside the JAX forward
    ja = jax.jit(lambda v: jpack.quantize_activations_packed_int(v, jp.meta))(
        jnp.asarray(xp))
    ta = tpack.quantize_activations_packed_int(torch.from_numpy(xp), tp.meta)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _tiny_cfgs():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=8, num_hidden_layers=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    return jcfg, tcfg


BENCH_PACK = dict(nibble=True, align_k_groups=8, align_o=256, fuse=True,
                  fold_perms=True, shared_residual_basis=True,
                  identity_keys=("o_proj",))


def test_pack_model_bench_recipe_bit_exact():
    """pack_model with the serving recipe (fused, folded, shared residual
    basis, identity o_proj, int8 lm_head) on the same fp weights."""
    jcfg, tcfg = _tiny_cfgs()
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(to_numpy_tree(jparams), device="cpu")
    rng = np.random.default_rng(1)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    jq = jw4a4_group(group_size=16, salient_prop=0.05)
    tq = w4a4_group(group_size=16, salient_prop=0.05)
    head_j = JQuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    head_t = QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    jpk = jpack_model("llama", jparams, jcfg, jq, input_feat=feat,
                      compute_dtype=jnp.float32, lm_head_qcfg=head_j, **BENCH_PACK)
    tpk = tpack_model("llama", tparams, tcfg, tq, input_feat=feat,
                      compute_dtype=torch.float32, lm_head_qcfg=head_t, **BENCH_PACK)

    def walk(j, t):
        if isinstance(j, jpack.PackedLinear):
            assert_pack_equal(j, t)
        elif isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                walk(j[k], t[k])
        elif j is None:
            assert t is None
        else:
            np.testing.assert_array_equal(np.asarray(j), t.numpy())

    walk(jpk, tpk)
    # the roofline's shape model reproduces the packs pack_model builds
    shapes = roofline.llama_pack_shapes(tcfg, group_size=16, salient_prop=0.05,
                                        align_k_groups=8, align_o=256)
    lp = tpk["layers"]["0"]
    for name, lin in (("qkv", lp["self_attn"]["qkv_proj"]),
                      ("o", lp["self_attn"]["o_proj"]),
                      ("gate_up", lp["mlp"]["gate_up_proj"]),
                      ("down", lp["mlp"]["down_proj"])):
        c, o_pad, kk, k_s = shapes[name]
        assert (lin.meta.in_features, lin.w_qt.shape[1], 2 * lin.w_qt.shape[0],
                lin.w_sal_t.shape[0]) == (c, o_pad, kk, k_s), name

"""The default per-layer pack (pack_model(fuse=False, nibble=False)) and its
dispatch against the JAX package: the unfused tree's packs bit-exact,
quantize_activations_packed bit-exact against jitted JAX, and
real_quant_linear in "int" (K8), "dequant" (K9) and "auto" for the W4A4
and W4A8 group recipes, a per-channel / per-token recipe with salient
channels (one group), and a per-channel weight under per-group
activations (the int path cannot take it: auto → dequant, forced int →
ValueError); the nibble branch on a per-token recipe (K6 on broadcast
scales).

Tolerance of the linears: the int path sums the same exact integer
partials in the same fma chain (the salient dot's f32 order may differ),
the dequant path the same dequantized weights in another f32 order:
2e-6 of the largest output in f32, 2e-6 plus one bf16 rounding in bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.kernels import real_linear as jreal
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant import config as jconfig
from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.kernels import real_linear as treal
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.registry import pack_model
from smoothquant_tpu_torch.quant import config as tconfig
from smoothquant_tpu_torch.utils.convert import params_from_numpy
from test_torch_llama_serve import to_numpy_tree

torch.set_num_threads(1)

C, O = 256, 200


def _recipes():
    """(name, JAX recipe, port recipe) of the per-layer paths."""
    per_channel = dict(weight_quant="per_channel", act_quant="per_token", quant_bits=4,
                       act_bits=8, salient_prop=0.05)
    mismatched = dict(weight_quant="per_channel", act_quant="per_group", quant_bits=4,
                      group_size=32)
    return [
        ("w4a4_g64", jconfig.w4a4_group(64, 0.05), tconfig.w4a4_group(64, 0.05)),
        ("w4a8_g64", jconfig.w4a8_group(64, 0.05), tconfig.w4a8_group(64, 0.05)),
        ("w4a8_per_channel", jconfig.QuantConfig(**per_channel),
         tconfig.QuantConfig(**per_channel)),
        ("mismatched_groups", jconfig.QuantConfig(**mismatched),
         tconfig.QuantConfig(**mismatched)),
    ]


RECIPES = {name: (j, t) for name, j, t in _recipes()}


def _pack(name, seed=0, scale_dtype="float32", nibble=False):
    jq, tq = RECIPES[name]
    jq = dataclasses.replace(jq, scale_dtype=scale_dtype)
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(O, C)) * C ** -0.5).astype(np.float32)
    w[:, 3] *= 20.0
    imp = rng.uniform(0.1, 1.0, size=(C,))
    absmax = rng.uniform(0.1, 2.0, size=(C,))
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": None}, jq, importance=imp,
                           act_absmax=absmax, compute_dtype=jnp.float32, nibble=nibble)
    return jp, params_from_numpy(to_numpy_tree(jp), "cpu")


def _x(n, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, C)).astype(np.float32)
    x[:, 3] *= 15.0
    x[:, 100] *= 6.0
    return x


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    atol = 2e-6 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0 if dtype == "f32" else 2 ** -7, atol=atol)


def _cfgs():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=128,
                               intermediate_size=256, num_attention_heads=4,
                               num_key_value_heads=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    return jcfg, tcfg


def test_unfused_pack_model_bit_exact():
    """pack_model's default tree: every projection its own int8-container
    pack, codes, scales, permutation and salient block as JAX packs them."""
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(2)
    size = lambda key: jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size
    feat = {k: rng.uniform(0.1, 1.0, size=(size(k),)) for _, k, _ in
            jllama.quantizable_linears(jcfg)}
    scales = {k: rng.uniform(0.1, 3.0, size=(size(k),)) for k in feat}
    ref = jpack_model("llama", params, jcfg, jconfig.w4a4_group(16, 0.05), input_feat=feat,
                      act_scales=scales)
    got = pack_model("llama", params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                     tcfg, tconfig.w4a4_group(16, 0.05), input_feat=feat, act_scales=scales)
    n = 0
    for path, _, _ in tllama.quantizable_linears(tcfg):
        r, g = ref, got
        for k in path:
            r, g = r[k], g[k]
        assert isinstance(g, tpack.PackedLinear) and not g.meta.nibble
        assert dataclasses.asdict(g.meta) == {k: v for k, v in dataclasses.asdict(r.meta).items()
                                              if k != "tp_reduce"}
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)))
        assert g.w_qt.dtype == torch.int8 and g.w_qt.shape == (g.meta.k_ns, g.meta.out_features)
        n += 1
    assert n == 7 * jcfg.num_hidden_layers
    assert isinstance(got["lm_head"], dict)        # left fp, as JAX leaves it


def test_unfused_pack_model_refuses_the_fused_options():
    """The unfused pack takes the shared residual basis and the folded perms
    for Llama now (tests/test_torch_unfused_basis.py holds it to JAX); an
    architecture without residual_consumers / perm_fold_pairs refuses the
    option, as the JAX pack_model does: Bloom both, OPT the shared basis."""
    from smoothquant_tpu.models import bloom as jbloom
    from smoothquant_tpu.models import opt as jopt
    from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
    from smoothquant_tpu_torch.models import bloom as tbloom
    from smoothquant_tpu_torch.models import opt as topt

    cases = (("bloom", jbloom, tbloom, jbloom.BloomConfig.tiny(), tbloom.BloomConfig,
              ({"shared_residual_basis": True}, {"fold_perms": True})),
             ("opt", jopt, topt, jopt.OPTConfig.tiny(), topt.OPTConfig,
              ({"shared_residual_basis": True},)))
    for arch, jmod, tmod, jcfg, tcls, refused in cases:
        tcfg = tcls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcls)})
        jparams = jmod.init_params(jax.random.PRNGKey(0), jcfg)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        wide = {"dense_4h_to_h": 4 * jcfg.hidden_size, "fc2": getattr(jcfg, "ffn_dim", 0)}
        feat = {k: np.ones(wide.get(k.rsplit(".", 1)[-1], jcfg.hidden_size))
                for _, k, _ in jmod.quantizable_linears(jcfg)}
        for kw in refused:
            with pytest.raises(NotImplementedError):
                jpack_model(arch, jparams, jcfg, jw4a4_group(16, 0.05), input_feat=feat, **kw)
            with pytest.raises(NotImplementedError):
                pack_model(arch, params, tcfg, tconfig.w4a4_group(16, 0.05),
                           input_feat=feat, **kw)


@pytest.mark.parametrize("name", ["w4a4_g64", "w4a8_g64", "w4a8_per_channel",
                                  "mismatched_groups"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_packed_bit_exact(name, dtype):
    """The dequant path's Q-DQ'd activations and salient block, per-group,
    per-token (and, below, per-tensor), as jitted JAX computes them."""
    jp, tp = _pack(name)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x = _x(7)
    metas = [(jp.meta, tp.meta)]
    if name == "w4a8_per_channel":
        metas.append((dataclasses.replace(jp.meta, act_quant="per_tensor"),
                      dataclasses.replace(tp.meta, act_quant="per_tensor")))
    for jm, tm in metas:
        xp = x[:, np.asarray(jp.perm)]
        ref_ns, ref_sal = jax.jit(lambda v: jpack.quantize_activations_packed(v, jm))(
            jnp.asarray(xp).astype(jd))
        got_ns, got_sal = tpack.quantize_activations_packed(torch.from_numpy(xp).to(td), tm)
        assert got_ns.dtype == td and got_ns.shape == ref_ns.shape
        np.testing.assert_array_equal(got_ns.float().numpy(),
                                      np.asarray(ref_ns.astype(jnp.float32)))
        np.testing.assert_array_equal(got_sal.float().numpy(),
                                      np.asarray(ref_sal.astype(jnp.float32)))


def _linear_pair(jp, tp, x, compute, dtype):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    ref = jax.jit(lambda v: jreal.real_quant_linear(jp, v, compute=compute, interpret=True))(
        jnp.asarray(x).astype(jd))
    got = treal.real_quant_linear(tp, torch.from_numpy(x).to(td), compute=compute)
    assert got.dtype == td and tuple(got.shape) == ref.shape
    return got, ref


@pytest.mark.parametrize("name", ["w4a4_g64", "w4a8_g64", "w4a8_per_channel"])
@pytest.mark.parametrize("compute", ["int", "dequant"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_real_quant_linear_matches_jax(name, compute, dtype):
    jp, tp = _pack(name, scale_dtype="bfloat16" if dtype == "bf16" else "float32")
    got, ref = _linear_pair(jp, tp, _x(9), compute, dtype)
    _close(got, ref, dtype)


@pytest.mark.parametrize("name", ["w4a4_g64", "w4a8_per_channel", "mismatched_groups"])
def test_auto_dispatch_matches_jax(name, monkeypatch):
    """"auto" picks the kernel JAX picks at the same crossover: a grouped
    recipe takes the int path up to it and the dequant path above it, a
    single-group one the int path at any N, an unsupported one dequant."""
    monkeypatch.setattr(jreal, "_TUNED_LOADED", True)
    monkeypatch.setattr(jreal, "_INT_PATH_MAX_TOKENS", 8)
    monkeypatch.setattr(treal, "INT_PATH_MAX_TOKENS", 8)
    jp, tp = _pack(name)
    picked = []
    for n in (8, 9):
        got, ref = _linear_pair(jp, tp, _x(n, seed=n), "auto", "f32")
        _close(got, ref, "f32")
        picked.append(treal.choose_compute(tp.meta, n))
    assert picked == {"w4a4_g64": ["int", "dequant"], "w4a8_per_channel": ["int", "int"],
                      "mismatched_groups": ["dequant", "dequant"]}[name]


def test_int_path_refuses_mismatched_groups():
    """Forcing the int path on activation groups unlike the weight's raises
    ValueError in both packages."""
    jp, tp = _pack("mismatched_groups")
    x = _x(4)
    with pytest.raises(ValueError):
        jreal.real_quant_linear(jp, jnp.asarray(x), compute="int", interpret=True)
    with pytest.raises(ValueError):
        treal.real_quant_linear(tp, torch.from_numpy(x), compute="int")
    with pytest.raises(ValueError):
        treal.real_quant_linear(tp, torch.from_numpy(x), compute="fast")


def test_nibble_branch_takes_per_token_recipes():
    """A nibble pack of a per-token recipe runs K6 on per-token scales
    broadcast over the groups, as JAX does (the port used to refuse it)."""
    recipe = dict(weight_quant="per_group", act_quant="per_token", quant_bits=4,
                  group_size=16, salient_prop=0.05)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(O, C)) * C ** -0.5).astype(np.float32)
    imp = rng.uniform(0.1, 1.0, size=(C,))
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": None},
                           jconfig.QuantConfig(**recipe), importance=imp,
                           compute_dtype=jnp.float32, nibble=True)
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    assert tp.meta.nibble and tp.meta.act_quant == "per_token"
    x = _x(6)
    ref = jax.jit(lambda v: jreal.real_quant_linear(jp, v, interpret=True))(jnp.asarray(x))
    got = treal.real_quant_linear(tp, torch.from_numpy(x), compute="dequant")
    _close(got, ref, "f32")


def test_params_from_numpy_carries_int8_container_packs():
    """A converted per-layer int8-container pack keeps its (K, O) int8
    weight as it lies (only identity-int8 packs are stored K-major)."""
    jp, tp = _pack("w4a4_g64")
    assert tp.meta.layout == "permuted" and not tp.meta.nibble
    assert tp.w_qt.dtype == torch.int8 and tp.w_qt.shape == (tp.meta.k_ns, O)
    assert tp.w_qt.is_contiguous()
    np.testing.assert_array_equal(tp.w_qt.numpy(), np.asarray(jp.w_qt))
    np.testing.assert_array_equal(tp.w_scales_t.numpy(), np.asarray(jp.w_scales_t))


@pytest.mark.parametrize("kernel", ["int_group_matmul", "dual_path_matmul"])
def test_roofline_costs_count_true_widths(kernel):
    """K8's and K9's roofline costs at a Llama-2-7B gate_proj of the quick
    start's pack (4096 → 11008, 5 % salient: 204 salient and 3892 other
    channels, g64), counted by hand at the true widths: 61 scale groups
    (3892 reaches into the 61st), none of the pack's padding to 3904 and to
    256 salient rows."""
    from smoothquant_tpu_torch.utils import roofline

    n, o, k_ns, gs, k_s = 4, 11008, 3892, 64, 204
    cost = getattr(roofline, f"{kernel}_cost")
    n_bytes, ops = cost(n, o, k_ns, gs, k_s)
    if kernel == "int_group_matmul":
        assert n_bytes == (n * k_ns + o * k_ns + n * 61 * 4 + o * 61 * 4
                           + (n + o) * k_s * 2 + n * o * 2)
        assert ops == {"int8": 2 * n * o * k_ns, "bf16": 2 * n * o * k_s}
    else:
        assert n_bytes == (n * (k_ns + k_s) * 2 + o * k_ns + o * 61 * 4
                           + o * k_s * 2 + n * o * 2)
        assert ops == {"bf16": 2 * n * o * (k_ns + k_s)}

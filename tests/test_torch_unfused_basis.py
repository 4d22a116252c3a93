"""pack_model(fuse=False) with the shared residual basis and / or the folded
permutations, the port against the JAX package on the same weights and
statistics (tiny f32 models):

  * Llama: every projection its own pack, the residual consumers (q / k / v,
    gate / up) packed pre-permuted in one shared basis, down_proj's input
    perm folded into gate_proj's and up_proj's output rows; OPT: fc2's
    input perm folded into fc1's rows (JAX builds no shared basis for OPT);
  * perms, codes, scales, salient blocks and metas bit for bit, and the fp
    leaves the basis relays (embedding, norms, the lm_head) identical;
  * logits of the per-layer forward over 2 × 5 tokens within 2e-4
    (relative and absolute) of JAX's jitted forward: f32 sums in another
    order, no int4 code moved at these rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant import config as jconfig
from smoothquant_tpu_torch.kernels.pack import PackedLinear
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models.registry import pack_model
from smoothquant_tpu_torch.quant import config as tconfig
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy
from test_torch_llama_serve import to_numpy_tree

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _same_tree(got, ref) -> int:
    """Every leaf of the port's pack equal to the JAX pack's (converted by
    utils.convert, which stores an identity int8 pack K-major as the port's
    packs hold it): PackedLinear metas and fields, every fp tensor.
    Returns the number of packs."""
    n = 0

    def walk(g, r):
        nonlocal n
        if isinstance(g, PackedLinear):
            assert isinstance(r, PackedLinear) and g.meta == r.meta
            for f in ("w_qt", "w_scales_t", "w_sal_t", "perm", "bias", "ns_mask"):
                a, b = getattr(g, f), getattr(r, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    assert a.dtype == b.dtype, f
                    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
            n += 1
        elif isinstance(g, dict):
            assert set(g) == set(r)
            for k in g:
                walk(g[k], r[k])
        elif g is not None:
            np.testing.assert_array_equal(g.numpy(), r.numpy())

    walk(got, params_from_numpy(to_numpy_tree(ref), "cpu"))
    return n


def _feat(mod, cfg, rng, wide):
    return {k: rng.uniform(0.1, 1.0, size=(wide.get(k.rsplit(".", 1)[-1], cfg.hidden_size),))
            for _, k, _ in mod.quantizable_linears(cfg)}


@pytest.mark.parametrize("basis,fold", [(True, False), (False, True), (True, True)])
def test_llama_unfused_basis_and_fold_match_jax(basis, fold):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=256,
                               intermediate_size=512, num_attention_heads=4,
                               num_key_value_heads=2)
    tcfg = config_from(tllama.LlamaConfig, jcfg)
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    feat = _feat(jllama, jcfg, rng, {"down_proj": jcfg.intermediate_size})
    scales = {k: rng.uniform(0.1, 3.0, size=v.shape) for k, v in feat.items()}
    kw = dict(input_feat=feat, act_scales=scales, shared_residual_basis=basis,
              fold_perms=fold, nibble=True, identity_keys=("o_proj",),
              align_k_groups=8, align_o=256)
    head = dict(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    ref = jpack_model("llama", params, jcfg, jconfig.w4a4_group(16, 0.05),
                      compute_dtype=jnp.float32, lm_head_qcfg=jconfig.QuantConfig(**head),
                      **kw)
    got = pack_model("llama", params_from_numpy(to_numpy_tree(params), "cpu"), tcfg,
                     tconfig.w4a4_group(16, 0.05),
                     lm_head_qcfg=tconfig.QuantConfig(**head), **kw)
    assert _same_tree(got, ref) == 7 * jcfg.num_hidden_layers + 1
    for i in range(jcfg.num_hidden_layers):
        sa, mlp = got["layers"][str(i)]["self_attn"], got["layers"][str(i)]["mlp"]
        for lin in (sa["q_proj"], sa["k_proj"], sa["v_proj"], mlp["gate_proj"],
                    mlp["up_proj"]):
            assert lin.meta.pre_permuted == basis
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, 5))
    jref, _ = jax.jit(lambda p, i: jllama.forward(p, i, jcfg, ctx=JCtx(interpret=True)))(
        ref, jnp.asarray(ids))
    tgot, _ = tllama.forward(got, torch.from_numpy(ids), tcfg)
    np.testing.assert_allclose(tgot.numpy(), np.asarray(jref), **TOL)


def test_opt_unfused_fold_matches_jax():
    jcfg = dataclasses.replace(jopt.OPTConfig.tiny(), hidden_size=256, ffn_dim=512,
                               num_attention_heads=4)
    tcfg = config_from(topt.OPTConfig, jcfg)
    params = jopt.init_params(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(a.dtype) * 0.05
                          if a.ndim == 1 else a, params)
    feat = _feat(jopt, jcfg, rng, {"fc2": jcfg.ffn_dim})
    kw = dict(input_feat=feat, fold_perms=True, nibble=True)
    ref = jpack_model("opt", params, jcfg, jconfig.w4a4_group(16, 0.05),
                      compute_dtype=jnp.float32, **kw)
    got = pack_model("opt", params_from_numpy(to_numpy_tree(params), "cpu"), tcfg,
                     tconfig.w4a4_group(16, 0.05), **kw)
    assert _same_tree(got, ref) == 6 * jcfg.num_hidden_layers
    ids = np.random.default_rng(8).integers(0, jcfg.vocab_size, size=(2, 5))
    jref, _ = jax.jit(lambda p, i: jopt.forward(p, i, jcfg, ctx=JCtx(interpret=True)))(
        ref, jnp.asarray(ids))
    tgot, _ = topt.forward(got, torch.from_numpy(ids), tcfg)
    np.testing.assert_allclose(tgot.numpy(), np.asarray(jref), **TOL)

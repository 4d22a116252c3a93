"""Mistral's sliding window in the port against the JAX package (the design
of tests/test_sliding_window.py:47-151): a tiny Mistral (hidden 512, 8 heads
of 64 over 2 kv heads, 2 layers, vocab 256, rope_theta 1e6, f32) with a
window of 8 over 24-token prompts, so the window binds:

  * the no-cache forward within 2e-4 of JAX's, and off by more than that
    from the same weights without the window;
  * the cached decode (a 16-token prefill, then 8 tokens one at a time) over
    per-layer fp caches (einsum, and K11 under attn="kernel") and int8
    caches (K11 with the window in its bias), each step within 2e-4 of
    JAX's in the same mode (interpret=True) and of the no-cache forward;
  * the stacked decode of the serving pack from JAX's prefilled caches:
    "smajor" over the S-major cache (K2 + K3, the window in the bias) and,
    over the head-major int8 cache at aligned positions, "off" (K10 + K11:
    the window forces it, as in JAX, where "auto" would take K12) — logits
    within 2e-4 of JAX's, the written rows and positions identical;
  * registry: "mistral" is Llama; mistral_7b is the JAX preset.

Tolerances: f32 sums in another order, K11's tile-by-tile softmax against
the TPU kernel's in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import common as jcommon
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import QuantConfig as JQ
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.models import common as tcommon
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models import registry as tregistry
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy
from test_torch_llama_serve import to_numpy_tree

torch.set_num_threads(1)

WINDOW, SEQ, MAX_LEN = 8, 24, 128
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def mistral():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=2, num_hidden_layers=2,
        rope_theta=1e6, sliding_window=WINDOW)
    tcfg = config_from(tllama.LlamaConfig, jcfg)
    params = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(3)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    qcfg = jw4a4_group(group_size=16, salient_prop=0.05)
    serve = jpack_model(
        "mistral", params, jcfg, qcfg, input_feat=feat, compute_dtype=jnp.float32,
        nibble=True, align_k_groups=8, align_o=256, fuse=True, fold_perms=True,
        shared_residual_basis=True, identity_keys=("o_proj",),
        lm_head_qcfg=JQ(weight_quant="per_channel", act_quant="per_token", quant_bits=8))
    t = lambda tree: params_from_numpy(to_numpy_tree(tree), "cpu")
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, SEQ))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, t_params=t(params), qcfg=qcfg,
                serve=serve, t_serve=t(serve), ids=ids)


def test_registry_and_preset():
    assert tregistry.get_arch("mistral") is tllama
    assert tllama.LlamaConfig.mistral_7b() == config_from(tllama.LlamaConfig,
                                                          jllama.LlamaConfig.mistral_7b())


def test_full_forward_matches_jax_and_window_binds(mistral):
    m = mistral
    ref, _ = jax.jit(lambda p, i: jllama.forward(p, i, m["jcfg"]))(m["params"],
                                                                   jnp.asarray(m["ids"]))
    got, _ = tllama.forward(m["t_params"], torch.from_numpy(m["ids"]), m["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    nw, _ = tllama.forward(m["t_params"], torch.from_numpy(m["ids"]),
                           dataclasses.replace(m["tcfg"], sliding_window=None))
    # the window binds past position 8: the logits there move far more than TOL
    assert np.abs(nw.numpy() - got.numpy())[:, WINDOW + 1:].max() > 100 * TOL["atol"]
    np.testing.assert_allclose(nw.numpy()[:, :WINDOW], got.numpy()[:, :WINDOW], **TOL)


@pytest.mark.parametrize("kind,attn", [("fp", "einsum"), ("fp", "kernel"), ("int8", "auto")])
def test_cached_decode_matches_jax(mistral, kind, attn):
    m = mistral
    jcfg, tcfg, ids = m["jcfg"], m["tcfg"], m["ids"]
    jcls = jcommon.QuantKVCache if kind == "int8" else jcommon.KVCache
    tcls = tcommon.QuantKVCache if kind == "int8" else tcommon.KVCache
    jctx, tctx = JCtx(attn=attn, interpret=True), ForwardContext(attn=attn)
    fwd = jax.jit(lambda p, i, c: jllama.forward(p, i, jcfg, ctx=jctx, caches=c))
    full, _ = tllama.forward(m["t_params"], torch.from_numpy(ids), tcfg)
    jc = [jcls.create(2, MAX_LEN, jcfg.num_key_value_heads, jcfg.head_dim, jnp.float32)
          for _ in range(jcfg.num_hidden_layers)]
    tc = [tcls.create(2, MAX_LEN, tcfg.num_key_value_heads, tcfg.head_dim, torch.float32,
                      "cpu") for _ in range(tcfg.num_hidden_layers)]
    _, jc = fwd(m["params"], jnp.asarray(ids[:, :16]), jc)
    _, tc = tllama.forward(m["t_params"], torch.from_numpy(ids[:, :16]), tcfg, caches=tc,
                           ctx=tctx)
    for t in range(16, SEQ):
        ref, jc = fwd(m["params"], jnp.asarray(ids[:, t:t + 1]), jc)
        got, tc = tllama.forward(m["t_params"], torch.from_numpy(ids[:, t:t + 1]), tcfg,
                                 caches=tc, ctx=tctx)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        if kind == "fp":       # the int8 cache quantizes k / v: not the fp forward
            np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, t], **TOL)
        assert int(tc[0].pos) == t + 1


@pytest.mark.parametrize("layout", ["smajor", "off"])
def test_stacked_decode_matches_jax(mistral, layout, monkeypatch):
    """JAX prefills per-layer caches of the serving pack over the 24-token
    prompt; both packages then decode one token over the stacked copy."""
    m = mistral
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True)
    fwd = jax.jit(lambda p, i, c: jllama.forward(p, i, jcfg, ctx=jctx, caches=c))
    jcls = jcommon.SMajorQuantKVCache if layout == "smajor" else jcommon.QuantKVCache
    jc = [jcls.create(2, MAX_LEN, jcfg.num_key_value_heads, jcfg.head_dim)
          for _ in range(jcfg.num_hidden_layers)]
    _, jc = fwd(m["serve"], jnp.asarray(m["ids"]), jc)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jc)
    if layout == "smajor":
        jst = jst._replace(pos=jnp.full((jcfg.num_hidden_layers, 2), SEQ, jnp.int32))
        tst = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, smajor=True,
                                    device="cpu")
    else:
        tst = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, device="cpu")
    for f in ("k_q", "v_q", "k_scale", "v_scale", "pos"):
        getattr(tst, f).copy_(torch.from_numpy(np.array(getattr(jst, f))))
    jstacked = jllama.stack_layers(m["serve"], jcfg)
    assert jllama._prefetch_capable(jstacked, jcfg, jctx, jst, 1)
    tok = np.array([[5], [17]])
    ref, ref_c = fwd(jstacked, jnp.asarray(tok), jst)
    # "off" is forced by the window: K12's bodies (aligned "auto") must not run
    for name in ("fused_virtual_attn_flat", "fused_virtual_attn_stacked",
                 "fused_rope_write_attn_stacked"):
        monkeypatch.setattr(tllama, name, lambda *a, **k: pytest.fail("K12 under a window"))
    got, got_c = tllama.forward(tllama.stack_layers(m["t_serve"], tcfg),
                                torch.from_numpy(tok), tcfg, caches=tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for f in ("k_q", "v_q", "pos"):
        np.testing.assert_array_equal(getattr(got_c, f).numpy(), np.asarray(getattr(ref_c, f)))

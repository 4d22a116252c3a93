"""The serving layer on every tree and pool the JAX package serves, the port
against the JAX package on the same weights (tiny f32 models, inputs from
numpy seeds):

  * per-slot per-layer cache writes of the three cache kinds, bit for bit
    against JAX's update (jitted), a start past the end included;
  * ContinuousBatcher tokens identical to the JAX batcher's: the fp pool
    under each pairing of a per-layer or stacked decode tree and prefill
    tree; the int8 head-major and S-major pools under per-layer and stacked
    decode trees; mixed prompt lengths and buckets, step_chunk(k), an EOS
    inside a chunk, a bucket longer than max_len; OPT and Bloom per-layer
    trees; a simulated tree under `quant`;
  * Generator tokens identical to JAX's under `quant` and under compute
    "int" / "dequant";
  * ForwardContext.attn "kernel" and "einsum" over fp and int8 caches,
    logits within 2e-4 of JAX's in the same mode;
  * tied embeddings, the stacked-tree fallback (Llama, Bloom) and the
    config / tree conversion.

Tolerances: tokens, positions, masks, cache codes and positions exact;
f32 logits within 2e-4 (relative and absolute: f32 sums in another order,
K11's tile-by-tile softmax against the TPU kernel's in interpret mode).
The JAX batcher and Generator run Pallas in interpret mode (interpret=True)
so their decode takes the kernels the port's plain versions mirror (OPT's
int8 pool: K11 with sm_scale 1.0 on both sides, OPT scaling q itself)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import bloom as jbloom
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models import common as jcommon
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import quantize_model as jquantize_model
from smoothquant_tpu.quant.config import QuantConfig as JQ
from smoothquant_tpu.quant.config import W8A8_SMOOTHQUANT as J_W8A8
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu.serve import GenerationConfig as JGenConfig
from smoothquant_tpu.serve import Generator as JGenerator
from smoothquant_tpu.serve.batching import ContinuousBatcher as JBatcher
from smoothquant_tpu.serve.batching import Request as JRequest
from smoothquant_tpu_torch.models import bloom as tbloom
from smoothquant_tpu_torch.models import common as tcommon
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.quant.config import W8A8_SMOOTHQUANT
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy
from test_torch_llama_serve import to_numpy_tree

torch.set_num_threads(1)

MAX_LEN = 128
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(tree):
    return params_from_numpy(to_numpy_tree(tree), "cpu")


@pytest.fixture(scope="module")
def llama():
    """f32 Llama at hidden 512, 8 heads of 64 over 4 kv heads, 2 layers,
    vocab 256: the fp tree, its pack_fp_decode stack, the serving pack
    (W4A4 g16, 5 % salient, fused, folded, shared basis, identity o_proj,
    int8 lm_head) per-layer and stacked, packed by JAX and converted."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=4, num_hidden_layers=2)
    tcfg = config_from(tllama.LlamaConfig, jcfg)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    qcfg = jw4a4_group(group_size=16, salient_prop=0.05)
    serve = jpack_model(
        "llama", params, jcfg, qcfg, input_feat=feat, compute_dtype=jnp.float32,
        nibble=True, align_k_groups=8, align_o=256, fuse=True, fold_perms=True,
        shared_residual_basis=True, identity_keys=("o_proj",),
        lm_head_qcfg=JQ(weight_quant="per_channel", act_quant="per_token", quant_bits=8))
    fp_st = jllama.stack_layers(jllama.pack_fp_decode(params, jcfg), jcfg)
    t_params = _t(params)
    return dict(jcfg=jcfg, tcfg=tcfg, qcfg=qcfg, feat=feat, params=params,
                t_params=t_params, fp_stacked=fp_st, t_fp_stacked=_t(fp_st),
                fp_stacked_plain=jllama.stack_layers(params, jcfg),
                t_fp_stacked_plain=tllama.stack_layers(t_params, tcfg),
                serve=serve, t_serve=_t(serve), stacked=jllama.stack_layers(serve, jcfg),
                t_stacked=tllama.stack_layers(_t(serve), tcfg))


def _prompts(vocab, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)) for n in lens]


def _serve(batcher, cls, prompts, new, chunk, eos=None):
    reqs = [cls(uid=i, prompt=p, max_new_tokens=new,
                eos_token_id=None if eos is None else eos.get(i))
            for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    batcher.run_to_completion(chunk=chunk)
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


def _same_serving(jb, tb, prompts, new, chunk, eos=None):
    ref = _serve(jb, JRequest, prompts, new, chunk, eos)
    got = _serve(tb, Request, prompts, new, chunk, eos)
    assert got == ref
    np.testing.assert_array_equal(tb.pool_pos, jb.pool_pos)
    np.testing.assert_array_equal(tb.key_valid, jb.key_valid)
    np.testing.assert_array_equal(tb.seq_pos, jb.seq_pos)
    return got


# ------------------------------------------------------------ caches


@pytest.mark.parametrize("per_slot", [True, False])
@pytest.mark.parametrize("kind", ["fp", "int8", "smajor"])
def test_per_slot_cache_update_matches_jax(kind, per_slot):
    """Two positions written into a per-layer cache of 3 slots at (0, 5,
    127) per slot (127 + 2 runs past the end: JAX's dynamic_update_slice
    clamps the start to 126) or at one position past the end: every field
    and the advanced positions bit for bit against JAX's jitted update."""
    b, s, h, d, sq = 3, MAX_LEN, 2, 64, 2
    rng = np.random.default_rng(5)
    k_new = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    v_new = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    pos = np.array([0, 5, 127], np.int32) if per_slot else np.int32(127)
    jcls, tcls = {"fp": (jcommon.KVCache, tcommon.KVCache),
                  "int8": (jcommon.QuantKVCache, tcommon.QuantKVCache),
                  "smajor": (jcommon.SMajorQuantKVCache, tcommon.SMajorQuantKVCache)}[kind]
    jc = jcls.create(b, s, h, d, jnp.float32, per_slot=per_slot)
    if kind == "smajor":
        tc = tcls.create(b, s, h, d, "cpu", per_slot=per_slot)
    else:
        tc = tcls.create(b, s, h, d, torch.float32, "cpu", per_slot=per_slot)
    init = {}
    for f in jc._fields:
        if f == "pos":
            continue
        a = np.asarray(getattr(jc, f))
        init[f] = (rng.integers(-127, 128, size=a.shape).astype(np.int8) if a.dtype == np.int8
                   else rng.normal(size=a.shape).astype(np.float32))
        getattr(tc, f).copy_(torch.from_numpy(init[f]))
    jc = jc._replace(pos=jnp.asarray(pos), **{f: jnp.asarray(v) for f, v in init.items()})
    tc = dataclasses.replace(tc, pos=torch.from_numpy(pos) if per_slot else int(pos))
    ref = jax.jit(lambda c, k, v: c.update(k, v))(jc, jnp.asarray(k_new), jnp.asarray(v_new))
    got = tc.update(torch.from_numpy(k_new), torch.from_numpy(v_new))
    for f in init:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(np.asarray(got.pos), np.asarray(ref.pos))


# ------------------------------------------------------------ batcher: fp pool


@pytest.mark.parametrize("prefill", ["per_layer", "stacked"])
@pytest.mark.parametrize("decode", ["per_layer", "stacked"])
def test_fp_pool_batcher_tokens_identical_to_jax(llama, decode, prefill):
    """The JAX defaults (quant_kv=False: the fp pool): the per-layer fp tree
    over per-layer per-slot KVCaches (einsum attention) or the stacked
    pack_fp_decode tree over the stacked pool (K13 + K11), prefilled on the
    per-layer fp tree or its stack (the per-layer body over the stack).
    Prompts of 5 / 40 / 9 / 70 tokens (buckets 32, 64, 128) through 2
    slots, 5 new, chunks of 3: identical tokens, positions and masks."""
    m = llama
    trees = {"per_layer": (m["params"], m["t_params"]),
             "stacked": (m["fp_stacked"], m["t_fp_stacked"])}
    pre = {"per_layer": (m["params"], m["t_params"]),
           "stacked": (m["fp_stacked_plain"], m["t_fp_stacked_plain"])}
    jb = JBatcher(jllama, trees[decode][0], m["jcfg"], max_batch=2, max_len=MAX_LEN,
                  interpret=True, prefill_params=pre[prefill][0])
    tb = ContinuousBatcher(tllama, trees[decode][1], m["tcfg"], max_batch=2,
                           max_len=MAX_LEN, prefill_params=pre[prefill][1], device="cpu")
    assert isinstance(tb.caches, tcommon.KVCache if decode == "stacked" else list)
    _same_serving(jb, tb, _prompts(m["jcfg"].vocab_size, [5, 40, 9, 70]), 5, 3)


def test_batcher_eos_in_a_chunk_and_bucket_past_max_len(llama):
    """An EOS inside a chunk of 4 stops its request there; a 70-token prompt
    whose bucket (128) is longer than the pool (max_len 96) is cropped into
    it: identical to JAX over the per-layer fp pool."""
    m = llama
    prompts = _prompts(m["jcfg"].vocab_size, [70, 6, 12], seed=9)
    mk = lambda: (JBatcher(jllama, m["params"], m["jcfg"], max_batch=2, max_len=96,
                           interpret=True),
                  ContinuousBatcher(tllama, m["t_params"], m["tcfg"], max_batch=2,
                                    max_len=96, device="cpu"))
    jb, _ = mk()
    free = _serve(jb, JRequest, prompts, 8, 4)
    eos = {1: free[1][2]}                   # the request's third token
    jb, tb = mk()
    got = _same_serving(jb, tb, prompts, 8, 4, eos)
    assert len(got[1]) == free[1].index(eos[1]) + 1 < 8


# ------------------------------------------------------------ batcher: int8 pools


@pytest.mark.parametrize("tree", ["per_layer", "stacked"])
@pytest.mark.parametrize("smajor", [False, True])
def test_int8_pool_batcher_tokens_identical_to_jax(llama, smajor, tree):
    """The serving pack over the int8 head-major pool (per-layer: K11 a
    layer; stacked: K10 + K11) or the S-major one (per-layer: the einsum, as
    JAX; stacked: K2 + K3), prefilled on the per-layer pack: identical
    tokens."""
    m = llama
    jt, tt = (m["serve"], m["t_serve"]) if tree == "per_layer" else (m["stacked"],
                                                                      m["t_stacked"])
    jb = JBatcher(jllama, jt, m["jcfg"], quant=m["qcfg"], max_batch=2, max_len=MAX_LEN,
                  quant_kv=True, interpret=True, prefill_params=m["serve"], smajor=smajor)
    tb = ContinuousBatcher(tllama, tt, m["tcfg"], max_batch=2, max_len=MAX_LEN,
                           quant_kv=True, prefill_params=m["t_serve"], smajor=smajor,
                           device="cpu")
    _same_serving(jb, tb, _prompts(m["jcfg"].vocab_size, [5, 9, 3, 20]), 4, 2)


# ------------------------------------------------------------ families


def _family(name):
    jmod, tmod, jcls, tcls = {"opt": (jopt, topt, jopt.OPTConfig, topt.OPTConfig),
                              "bloom": (jbloom, tbloom, jbloom.BloomConfig,
                                        tbloom.BloomConfig)}[name]
    jcfg = dataclasses.replace(jcls.tiny(), hidden_size=256, num_attention_heads=4)
    if name == "opt":
        jcfg = dataclasses.replace(jcfg, ffn_dim=512)
    params = jmod.init_params(jax.random.PRNGKey(1), jcfg)
    # biases and norms away from their init, so every term counts
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(a.dtype) * 0.05
                          if a.ndim == 1 else a, params)
    return jmod, tmod, jcfg, config_from(tcls, jcfg), params


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("family", ["opt", "bloom"])
def test_family_batcher_tokens_identical_to_jax(family, quant_kv):
    """OPT (learned positions from seq_pos; K11 with sm_scale 1.0 over the
    int8 pool) and Bloom (ALiBi; K11's ALiBi body over the int8 pool)
    per-layer fp trees through the batcher over the fp and the int8
    head-major pools: identical tokens."""
    jmod, tmod, jcfg, tcfg, params = _family(family)
    jb = JBatcher(jmod, params, jcfg, max_batch=2, max_len=MAX_LEN, quant_kv=quant_kv,
                  interpret=True)
    tb = ContinuousBatcher(tmod, _t(params), tcfg, max_batch=2, max_len=MAX_LEN,
                           quant_kv=quant_kv, device="cpu")
    _same_serving(jb, tb, _prompts(jcfg.vocab_size, [5, 33, 9, 14]), 5, 2)


def test_simulated_tree_batcher_tokens_identical_to_jax(llama):
    """quantize_model's W8A8 tree served under quant=W8A8_SMOOTHQUANT (the
    simulated linears, BMM inputs quantized) over the per-layer fp pool."""
    m = llama
    jsim = jquantize_model("llama", m["params"], m["jcfg"], J_W8A8, m["feat"])
    jb = JBatcher(jllama, jsim, m["jcfg"], quant=J_W8A8, max_batch=2, max_len=MAX_LEN,
                  interpret=True)
    tb = ContinuousBatcher(tllama, _t(jsim), m["tcfg"], quant=W8A8_SMOOTHQUANT,
                           max_batch=2, max_len=MAX_LEN, device="cpu")
    _same_serving(jb, tb, _prompts(m["jcfg"].vocab_size, [6, 11, 4]), 4, 2)


# ------------------------------------------------------------ Generator


@pytest.mark.parametrize("mode", ["quant", "int", "dequant"])
def test_generator_tokens_identical_to_jax(llama, mode):
    """The Generator under quant (the W8A8 simulated tree) and under compute
    "int" (K8) / "dequant" (K9) on the default per-layer int8-container pack
    (W4A8 g16, 5 % salient): 6 greedy tokens identical to JAX's."""
    from smoothquant_tpu.quant.config import w4a8_group as jw4a8_group

    m = llama
    if mode == "quant":
        jtree = jquantize_model("llama", m["params"], m["jcfg"], J_W8A8, m["feat"])
        jgen = JGenerator(jllama, jtree, m["jcfg"], J_W8A8, max_len=MAX_LEN, interpret=True)
        tgen = Generator(tllama, _t(jtree), m["tcfg"], W8A8_SMOOTHQUANT, max_len=MAX_LEN,
                         device="cpu")
    else:
        jtree = jpack_model("llama", m["params"], m["jcfg"],
                            jw4a8_group(group_size=16, salient_prop=0.05),
                            input_feat=m["feat"], compute_dtype=jnp.float32)
        jgen = JGenerator(jllama, jtree, m["jcfg"], max_len=MAX_LEN, quant_kv=True,
                          compute=mode, interpret=True)
        tgen = Generator(tllama, _t(jtree), m["tcfg"], max_len=MAX_LEN, quant_kv=True,
                         compute=mode, device="cpu")
    assert tgen.ctx.compute == ("auto" if mode == "quant" else mode)
    prompt = np.random.default_rng(3).integers(0, m["jcfg"].vocab_size, size=(2, 7))
    ref = jgen.generate(prompt, JGenConfig(max_new_tokens=6))
    got = tgen.generate(prompt, GenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ attn


@pytest.mark.parametrize("attn", ["kernel", "einsum"])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_attn_modes_match_jax(llama, quant_kv, attn):
    """One decode token over per-layer caches after a 9-token prefill, the
    fp tree under ForwardContext(attn=...): "kernel" runs K11 over the fp
    cache and the int8 one, "einsum" never: logits within 2e-4 of JAX's in
    the same mode (interpret=True), and "kernel" within 2e-4 of "einsum"
    over the fp cache."""
    m = llama
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab_size, size=(2, 9))
    jcls = jcommon.QuantKVCache if quant_kv else jcommon.KVCache
    tcls = tcommon.QuantKVCache if quant_kv else tcommon.KVCache
    jctx = JCtx(attn=attn, interpret=True)
    fwd = jax.jit(lambda p, ids, c: jllama.forward(p, ids, jcfg, ctx=jctx, caches=c))
    jc = [jcls.create(2, MAX_LEN, jcfg.num_key_value_heads, jcfg.head_dim, jnp.float32)
          for _ in range(jcfg.num_hidden_layers)]
    _, jc = fwd(m["params"], jnp.asarray(prompt), jc)
    ref, _ = fwd(m["params"], jnp.asarray([[3], [5]]), jc)
    tctx = ForwardContext(attn=attn)
    tc = [tcls.create(2, MAX_LEN, tcfg.num_key_value_heads, tcfg.head_dim, torch.float32,
                      "cpu") for _ in range(tcfg.num_hidden_layers)]
    _, tc = tllama.forward(m["t_params"], torch.from_numpy(prompt), tcfg, caches=tc, ctx=tctx)
    calls = []
    real = tcommon.k11.decode_attention
    tcommon.k11.decode_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got, _ = tllama.forward(m["t_params"], torch.tensor([[3], [5]]), tcfg, caches=tc,
                                ctx=tctx)
    finally:
        tcommon.k11.decode_attention = real
    assert len(calls) == (tcfg.num_hidden_layers if attn == "kernel" else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------ trees


def test_tied_embeddings_logits_match_jax(llama):
    """A tied tree (tie_word_embeddings, no lm_head) unembeds through
    embed_tokens: the no-cache forward and a cached decode step within
    2e-4 of JAX's; a tree without an lm_head unembeds so too."""
    m = llama
    jcfg = dataclasses.replace(m["jcfg"], tie_word_embeddings=True)
    tcfg = config_from(tllama.LlamaConfig, jcfg)
    params = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    assert "lm_head" not in params
    tp = _t(params)
    ids = np.random.default_rng(6).integers(0, jcfg.vocab_size, size=(2, 10))
    ref, _ = jax.jit(lambda p, i: jllama.forward(p, i, jcfg))(params, jnp.asarray(ids))
    got, _ = tllama.forward(tp, torch.from_numpy(ids), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    untied = tllama.forward(tp, torch.from_numpy(ids), m["tcfg"])[0]   # no lm_head
    np.testing.assert_array_equal(untied.numpy(), got.numpy())


def test_stacked_fallback_matches_jax(llama):
    """Stacked Llama trees that the stacked decode declines run the
    per-layer body over their layers, as JAX's scan does: the plain fp stack
    over a stacked fp cache (a 6-token prefill, then one token), and the
    serving stack under attn="einsum" over a stacked per-slot int8 cache
    (logits within 2e-4, positions and the int8 rows written identical)."""
    m = llama
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    ids = np.random.default_rng(10).integers(0, jcfg.vocab_size, size=(2, 6))
    jctx = JCtx(quant=m["qcfg"], attn="einsum", interpret=True)
    fwd = [jax.jit(lambda p, i, c, ctx=ctx: jllama.forward(p, i, jcfg, ctx=ctx, caches=c))
           for ctx in (None, jctx)]
    jc = jllama.stacked_caches(jcfg, 2, MAX_LEN, jnp.float32)
    tc = tllama.stacked_caches(tcfg, 2, MAX_LEN, torch.float32, device="cpu")
    for step in (ids, ids[:, :1]):
        ref, jc = fwd[0](m["fp_stacked_plain"], jnp.asarray(step), jc)
        got, tc = tllama.forward(m["t_fp_stacked_plain"], torch.from_numpy(step), tcfg,
                                 caches=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    jq = jllama.stacked_caches(jcfg, 2, MAX_LEN, jnp.float32, quant_kv=True, per_slot=True)
    jq = jq._replace(pos=jnp.broadcast_to(jnp.asarray([3, 7], jnp.int32), jq.pos.shape))
    tq = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, per_slot=True, device="cpu")
    tq.pos[:] = torch.tensor([3, 7])
    assert not jllama._prefetch_capable(m["stacked"], jcfg, jctx, jq, 1)
    ref, jq = fwd[1](m["stacked"], jnp.asarray([[4], [9]]), jq)
    got, tq = tllama.forward(m["t_stacked"], torch.tensor([[4], [9]]), tcfg, caches=tq,
                             ctx=ForwardContext(attn="einsum"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tq.pos.numpy(), np.asarray(jq.pos))
    np.testing.assert_array_equal(tq.k_q.numpy(), np.asarray(jq.k_q))


def test_bloom_stacked_fallback_matches_jax():
    """Bloom's fp stacked tree (which the stacked decode declines) over a
    stacked fp cache: a 6-token prefill, then one token with (L, B)
    per-slot positions and a key mask — the per-layer body over the stack,
    logits within 2e-4 of JAX's scan, the positions identical."""
    jmod, tmod, jcfg, tcfg, params = _family("bloom")
    jst_tree, tst_tree = jbloom.stack_layers(params, jcfg), tbloom.stack_layers(_t(params), tcfg)
    ids = np.random.default_rng(11).integers(0, jcfg.vocab_size, size=(2, 6))
    fwd = jax.jit(lambda p, i, c, **kw: jbloom.forward(p, i, jcfg, caches=c, **kw))
    jc = jbloom.stacked_caches(jcfg, 2, MAX_LEN, jnp.float32)
    tc = tbloom.stacked_caches(tcfg, 2, MAX_LEN, device="cpu")
    ref, jc = fwd(jst_tree, jnp.asarray(ids), jc)
    got, tc = tbloom.forward(tst_tree, torch.from_numpy(ids), tcfg, caches=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    pos = np.array([6, 4], np.int32)
    mask = np.zeros((2, MAX_LEN), bool)
    mask[0, :7] = mask[1, :5] = True
    jc = jc._replace(pos=jnp.broadcast_to(jnp.asarray(pos), (jcfg.num_hidden_layers, 2)))
    tc = dataclasses.replace(tc, pos=torch.from_numpy(pos)[None].repeat(tcfg.num_hidden_layers, 1))
    assert not tbloom._prefetch_capable(tst_tree, tcfg, None, tc, 1)
    ref, jc = fwd(jst_tree, jnp.asarray([[3], [8]]), jc, attn_mask=jnp.asarray(mask))
    got, tc = tbloom.forward(tst_tree, torch.tensor([[3], [8]]), tcfg, caches=tc,
                             attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_convert_carries_tied_tree_and_config_fields():
    """config_from carries every field the port's config declares (Mistral's
    sliding_window and rope_theta, tie_word_embeddings) from the JAX
    config or a dict; params_from_numpy converts a tied tree with no
    lm_head into a tied tree."""
    jcfg = jllama.LlamaConfig.mistral_7b()
    tcfg = config_from(tllama.LlamaConfig, jcfg)
    assert tcfg == tllama.LlamaConfig.mistral_7b()
    assert (tcfg.sliding_window, tcfg.rope_theta, tcfg.num_key_value_heads) == (4096, 1e6, 8)
    for f in dataclasses.fields(tllama.LlamaConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name)
    tied = config_from(tllama.LlamaConfig, {"tie_word_embeddings": True, "hidden_size": 64})
    assert tied.tie_word_embeddings and tied.hidden_size == 64 and tied.vocab_size == 32000
    small = dataclasses.replace(jllama.LlamaConfig.tiny(), tie_word_embeddings=True)
    params = jllama.init_params(jax.random.PRNGKey(0), small)
    tp = _t(params)
    assert "lm_head" not in tp and set(tp) == set(params)
    np.testing.assert_array_equal(tp["embed_tokens"]["weight"].numpy(),
                                  np.asarray(params["embed_tokens"]["weight"]))


def test_generator_refuses_stacked_trees_as_jax_cannot_serve_them(llama):
    """The JAX Generator's per-layer caches do not fit a stacked tree (its
    scan fallback reads a stacked cache): it fails; the port's Generator
    refuses such a tree up front, and the batcher serves it."""
    m = llama
    jgen = JGenerator(jllama, m["fp_stacked_plain"], m["jcfg"], max_len=MAX_LEN)
    with pytest.raises(AttributeError):
        jgen.generate(np.zeros((1, 5), np.int32), JGenConfig(max_new_tokens=2))
    with pytest.raises(NotImplementedError, match="per-layer"):
        Generator(tllama, m["t_fp_stacked_plain"], m["tcfg"], device="cpu")

"""The Mixtral slice on a 2-layer Mixtral (hidden 256, 4 heads of 64 over 2
kv heads, 4 experts of intermediate 256, top-2, vocab 256, f32; RMSNorm
weights made random): the same numpy weights through both packages — the
router (softmax in f32, top-2 with ties to the lower index,
renormalized), the capacity rule, dense and sparse dispatch with and
without overflow, the fp forward with and without caches, calibration,
smooth_lm("mixtral"), the nibble pack and the packed per-layer and stacked
decode over fp and int8 caches — each against the JAX package's (Pallas
in interpret mode, jitted).

Tolerances: routing indices, capacity buffers, packs and int8 cache codes
bit for bit; routing weights and fp logits 1e-5 of their largest
magnitude (f32 sums in another order); calibration statistics 1e-5;
smoothing within 3 ulp (jnp.power against torch.pow); decode logits 2e-4
relative and absolute (the JAX package's own bound for the Mixtral stacked
decode, tests/test_prefetch_scan_mixtral.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import mixtral as jmix
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu.models.common import QuantKVCache as JQuantKVCache
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import smooth_lm as j_smooth_lm
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.models import mixtral as tmix
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache, QuantKVCache
from smoothquant_tpu_torch.models.registry import get_arch, pack_model, smooth_lm
from smoothquant_tpu_torch.quant import calibrate as tcal
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy

torch.set_num_threads(1)

CACHE_LEN = 128
GS = 16
TOL = dict(rtol=2e-4, atol=2e-4)


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def mix():
    jcfg = dataclasses.replace(jmix.MixtralConfig.tiny(), hidden_size=256,
                               intermediate_size=256, num_attention_heads=4,
                               num_key_value_heads=2)
    tcfg = config_from(tmix.MixtralConfig, jcfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jmix.init_params(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05).astype(a.dtype)
                          if a.ndim == 1 else a, params)
    out = dict(jcfg=jcfg, tcfg=tcfg, params=params,
               jparams=jax.tree.map(jnp.asarray, params),
               tparams=params_from_numpy(params, "cpu"))
    feat_rng = np.random.default_rng(1)
    out["feat"] = {key: feat_rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if key.endswith(".w2") else jcfg.hidden_size,))
        for _, key, _ in jmix.quantizable_linears(jcfg)}
    kw = dict(input_feat=out["feat"], nibble=True, align_k_groups=8, align_o=256)
    out["qj"] = jw4a4_group(group_size=GS, salient_prop=0.05)
    out["j_packed"] = jpack_model("mixtral", out["jparams"], jcfg, out["qj"],
                                  compute_dtype=jnp.float32, **kw)
    out["t_packed"] = pack_model("mixtral", params_from_numpy(params, "cpu"), tcfg,
                                 w4a4_group(GS, 0.05), **kw)
    return out


def test_config_capacity_and_registry():
    """Mixtral-8x7B's defaults equal the JAX config's; moe_capacity is
    JAX's rule; the registry resolves "mixtral"; a context names no expert
    parallel group unless asked (ep_group, parallel/ep.py) and an unknown
    dispatch raises."""
    assert dataclasses.asdict(tmix.MixtralConfig()) == dataclasses.asdict(jmix.MixtralConfig())
    cfg, jcfg = tmix.MixtralConfig.tiny(), jmix.MixtralConfig.tiny()
    for n in (1, 3, 4, 12, 64, 100):
        for cf in (0.25, 0.5, 1.0, 1.3, 2.0, 4.0):
            assert tmix.moe_capacity(n, cfg, cf) == jmix.moe_capacity(n, jcfg, cf)
    assert tmix.moe_capacity(64, tmix.MixtralConfig(), 2.0) == 32
    assert get_arch("mixtral") is tmix
    assert ForwardContext().ep_group is None
    with pytest.raises(ValueError, match="moe_dispatch"):
        ForwardContext(moe_dispatch="ragged")


def test_top_k_ties_to_the_lower_index():
    """Rows with tied probabilities: the experts jax.lax.top_k picks, in its
    order, bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=(64, 8)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(x), 2)
    tv, ti = tmix.top_k(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_route_matches_jax(mix):
    """The router on random rows: indices identical, weights to 1e-5."""
    x = np.random.default_rng(4).normal(size=(3, 7, 256)).astype(np.float32)
    bp = mix["params"]["layers"]["0"]["block_sparse_moe"]
    jp, ji = jmix._route(jax.tree.map(jnp.asarray, bp), jnp.asarray(x), mix["jcfg"], "m", None)
    tp, ti = tmix._route(params_from_numpy(bp, "cpu"), torch.from_numpy(x), mix["tcfg"], "m",
                         None)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp.numpy(), jp)


@pytest.mark.parametrize("dispatch,cf", [("dense", 2.0), ("sparse", 4.0), ("sparse", 0.25)])
def test_moe_block_matches_jax(mix, dispatch, cf):
    """One MoE block on 12 tokens: dense, sparse with room for every
    assignment (equal to dense), and sparse past its capacity (0.25: 2
    rows an expert, overflow dropped, unlike dense) — each against JAX's."""
    x = np.random.default_rng(5).normal(size=(2, 6, 256)).astype(np.float32)
    bp = mix["params"]["layers"]["1"]["block_sparse_moe"]
    jctx = JCtx(moe_dispatch=dispatch, moe_capacity_factor=cf)
    ctx = ForwardContext(moe_dispatch=dispatch, moe_capacity_factor=cf)
    ref = jax.jit(lambda p, v: jmix._moe_block(p, v, mix["jcfg"], "m", jctx))(
        jax.tree.map(jnp.asarray, bp), jnp.asarray(x))
    tbp = params_from_numpy(bp, "cpu")
    got = tmix._moe_block(tbp, torch.from_numpy(x), mix["tcfg"], "m", ctx)
    _close(got.numpy(), ref)
    dense = tmix._moe_block(tbp, torch.from_numpy(x), mix["tcfg"], "m", None)
    if cf < 1:
        assert (got - dense).abs().max() > 1e-3
    else:
        _close(got.numpy(), dense.numpy())


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_fp_forward_matches_jax(mix, dispatch):
    """The per-layer fp forward with no cache."""
    ids = np.random.default_rng(2).integers(0, 256, size=(2, 9))
    ref = jax.jit(lambda p, i: jmix.forward(p, i, mix["jcfg"],
                                            ctx=JCtx(moe_dispatch=dispatch))[0])(
        mix["jparams"], jnp.asarray(ids))
    got, caches = tmix.forward(mix["tparams"], torch.from_numpy(ids), mix["tcfg"],
                               ctx=ForwardContext(moe_dispatch=dispatch))
    assert caches is None and got.shape == (2, 9, 256)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_fp_cached_decode_matches_jax(mix, quant_kv):
    """A 7-token prefill into per-layer caches, then two decode steps (K11
    at rep 2 over the int8 cache), sparse dispatch."""
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    jcfg, tcfg = mix["jcfg"], mix["tcfg"]
    jctx = JCtx(interpret=True, moe_dispatch="sparse")
    step = jax.jit(lambda p, i, c: jmix.forward(p, i, jcfg, ctx=jctx, caches=c))
    ctx = ForwardContext(moe_dispatch="sparse")
    rng = np.random.default_rng(3)
    jc = [jcls.create(2, CACHE_LEN, 2, 64, jnp.float32) for _ in range(2)]
    tc = [tcls.create(2, CACHE_LEN, 2, 64, torch.float32, "cpu") for _ in range(2)]
    for ids in (rng.integers(0, 256, size=(2, 7)), rng.integers(0, 256, size=(2, 1)),
                rng.integers(0, 256, size=(2, 1))):
        ref, jc = step(mix["jparams"], jnp.asarray(ids), jc)
        got, tc = tmix.forward(mix["tparams"], torch.from_numpy(ids), tcfg, ctx=ctx, caches=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if quant_kv:
        for jl, tl in zip(jc, tc):
            np.testing.assert_array_equal(tl.k_q.numpy(), np.asarray(jl.k_q))


def test_calibration_and_smoothing_match_jax(mix):
    """The tapped forward names every call site of each layer as JAX does
    (q / k / v / o, the router gate, every expert's w1 / w3 / w2), with the
    same statistics; smooth_lm pairs post_attention_layernorm with the gate
    and every w1 / w3, and agrees within 3 ulp."""
    jcfg, tcfg = mix["jcfg"], mix["tcfg"]
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, size=(1, 16)) for _ in range(2)]
    jfwd = lambda p, ids, col: jmix.forward(p, jnp.asarray(ids), jcfg, ctx=JCtx(taps=col))
    tfwd = lambda p, ids, col: tmix.forward(p, torch.as_tensor(ids), tcfg,
                                            ctx=ForwardContext(taps=col))
    ref = jcal.get_act_scales(jfwd, mix["jparams"], batches)
    got = tcal.get_act_scales(tfwd, mix["tparams"], batches)
    assert sorted(got) == sorted(ref) and len(got) == (5 + 3 * 4) * 2
    for name in ref:
        r = np.asarray(ref[name], np.float64)
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    key = lambda pairs: [(p[0], [tuple(q) for q in p[1]], p[2]) for p in pairs]
    assert key(tmix.smoothing_map(tcfg)) == key(jmix.smoothing_map(jcfg))
    j_sm = jax.tree.map(np.asarray, j_smooth_lm("mixtral", mix["jparams"], jcfg, ref, 0.5))
    t_sm = smooth_lm("mixtral", mix["tparams"], tcfg, ref, 0.5)
    for i in range(2):
        rl, gl = j_sm["layers"][str(i)], t_sm["layers"][str(i)]
        pairs = [(gl[n]["weight"], rl[n]["weight"])
                 for n in ("input_layernorm", "post_attention_layernorm")]
        pairs.append((gl["block_sparse_moe"]["gate"]["weight"],
                      rl["block_sparse_moe"]["gate"]["weight"]))
        pairs += [(gl["block_sparse_moe"]["experts"][str(e)][w]["weight"],
                   rl["block_sparse_moe"]["experts"][str(e)][w]["weight"])
                  for e in range(4) for w in ("w1", "w3")]
        for g, r in pairs:
            assert _ulp_diff(g.numpy(), r).max() <= 3


def test_nibble_pack_matches_jax(mix):
    """pack_model("mixtral", nibble=True, align_k_groups=8, align_o=256): every
    field of every pack bit for bit; the router gate's 4 outputs padded to
    256."""
    for path, _, _ in tmix.quantizable_linears(mix["tcfg"]):
        r, g = mix["j_packed"], mix["t_packed"]
        for k in path:
            r, g = r[k], g[k]
        assert g.meta.nibble and g.w_qt.shape[-1] % 256 == 0
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)))
    gate = mix["t_packed"]["layers"]["0"]["block_sparse_moe"]["gate"]
    assert gate.meta.out_features == 4 and gate.w_qt.shape[-1] == 256


def _stack_caches(cfg, caches, quant_kv):
    b = (caches[0].k_scale if quant_kv else caches[0].k).shape[0]
    st = tmix.stacked_caches(cfg, b, CACHE_LEN, torch.float32, quant_kv=quant_kv,
                             pos=caches[0].pos, device="cpu")
    for i, c in enumerate(caches):
        for f in (("k_q", "v_q", "k_scale", "v_scale") if quant_kv else ("k", "v")):
            getattr(st, f)[i].copy_(getattr(c, f))
    return st


@pytest.mark.parametrize("dispatch,quant_kv", [("dense", True), ("sparse", False)])
def test_packed_decode_per_layer_and_stacked_match_jax(mix, dispatch, quant_kv):
    """The twin of test_mixtral_prefetch_matches_per_layer: a 5-token
    prefill of the packed per-layer tree, then one token through it and
    through stack_layers' tree (experts stacked, then layers; the expert
    leaves viewed as (L·E, ...), expert e of layer i at i·E + e) over the
    stacked copy of the caches — each held to the other and to JAX's."""
    jcfg, tcfg = mix["jcfg"], mix["tcfg"]
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    jctx = JCtx(quant=mix["qj"], compute="int", interpret=True, moe_dispatch=dispatch)
    ctx = ForwardContext(moe_dispatch=dispatch)
    jstep = jax.jit(lambda p, i, c: jmix.forward(p, i, jcfg, ctx=jctx, caches=c))
    rng = np.random.default_rng(2)
    prompt, tok = rng.integers(0, 256, size=(2, 5)), np.asarray([[7], [9]])
    _, jc = jstep(mix["j_packed"], jnp.asarray(prompt),
                  [jcls.create(2, CACHE_LEN, 2, 64, jnp.float32) for _ in range(2)])
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jc)
    jref, _ = jstep(mix["j_packed"], jnp.asarray(tok), jc)
    jgot, jgot_c = jstep(jmix.stack_layers(mix["j_packed"], jcfg), jnp.asarray(tok), jst)

    _, tc = tmix.forward(mix["t_packed"], torch.from_numpy(prompt), tcfg, ctx=ctx,
                         caches=[tcls.create(2, CACHE_LEN, 2, 64, torch.float32, "cpu")
                                 for _ in range(2)])
    tst = _stack_caches(tcfg, tc, quant_kv)
    stacked = tmix.stack_layers(mix["t_packed"], tcfg)
    w1 = stacked["layers"]["stacked"]["block_sparse_moe"]["experts"]["stacked"]["w1"]
    assert w1.w_qt.shape[:2] == (2, 4)
    flat = tmix._flatten_le(stacked["layers"]["stacked"]["block_sparse_moe"]["experts"]
                            ["stacked"])
    ref_w = mix["t_packed"]["layers"]["1"]["block_sparse_moe"]["experts"]["2"]["w1"].w_qt
    assert torch.equal(flat["w1"].w_qt[1 * 4 + 2], ref_w)
    assert tmix._prefetch_capable(stacked, tcfg, ctx, tst, 1)
    ref, ref_c = tmix.forward(mix["t_packed"], torch.from_numpy(tok), tcfg, ctx=ctx, caches=tc)
    got, got_c = tmix.forward(stacked, torch.from_numpy(tok), tcfg, ctx=ctx, caches=tst)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    for i, rc in enumerate(ref_c):
        assert int(got_c.pos[i]) == rc.pos == int(jgot_c.pos[i]) == 6
        if quant_kv:
            np.testing.assert_array_equal(got_c.k_q[i].numpy(), rc.k_q.numpy())
            np.testing.assert_array_equal(got_c.k_q[i].numpy(), np.asarray(jgot_c.k_q[i]))


def test_packed_serving_stacked_and_per_layer(mix):
    """The packed tree through the Generator over per-layer int8 caches and
    its stacked tree through the batcher's stacked int8 pool, sparse
    dispatch: the same tokens."""
    tcfg = mix["tcfg"]
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8))
    gen = Generator(tmix, mix["t_packed"], tcfg, max_len=CACHE_LEN, quant_kv=True,
                    device="cpu")
    gen.ctx = ForwardContext(compute=gen.ctx.compute, attn=gen.ctx.attn, moe_dispatch="sparse")
    ref = gen.generate(prompt, GenerationConfig(max_new_tokens=5))
    tb = ContinuousBatcher(tmix, tmix.stack_layers(mix["t_packed"], tcfg), tcfg, max_batch=2,
                           max_len=CACHE_LEN, quant_kv=True, prefill_params=mix["t_packed"],
                           device="cpu")
    tb.ctx = ForwardContext(moe_dispatch="sparse")
    reqs = [Request(uid=i, prompt=prompt[i], max_new_tokens=5) for i in range(2)]
    for r in reqs:
        tb.submit(r)
    tb.run_to_completion()
    assert [r.generated for r in reqs] == ref[:, 8:].tolist()


def test_quantize_model_leaves_bit_exact(mix):
    """registry.quantize_model("mixtral", ...) (the attention projections,
    the router gate, every expert's w1 / w2 / w3) on the same weights and
    importance vectors: every leaf JAX's, bit for bit."""
    from smoothquant_tpu.models.registry import quantize_model as j_quantize_model
    from smoothquant_tpu.quant.config import QuantConfig as JQuantConfig
    from smoothquant_tpu_torch.models.registry import quantize_model

    q = w4a4_group(16, 0.1)
    ref = jax.tree.map(np.asarray, j_quantize_model(
        "mixtral", mix["jparams"], mix["jcfg"], JQuantConfig(**dataclasses.asdict(q)),
        mix["feat"]))
    got = quantize_model("mixtral", params_from_numpy(mix["params"], "cpu"), mix["tcfg"], q,
                         mix["feat"])

    def leaves(t, pre=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, pre + (k,))
        elif t is not None:
            yield pre, t

    ref, got = dict(leaves(ref)), dict(leaves(got))
    assert set(got) == set(ref) and len(got) > 4 * 29
    for path, r in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), r.astype(got[path].numpy().dtype),
                                      err_msg=str(path))

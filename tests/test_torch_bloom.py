"""The Bloom slice on a 2-layer Bloom (hidden 256, 4 heads of 64, vocab 256,
f32; LayerNorms and biases made random so each one counts): the same numpy
weights through both packages — the ALiBi slopes, the fp forward with and
without per-layer caches, calibration, smooth_lm("bloom"), the nibble pack
of pack_model("bloom"), the packed per-layer and stacked decode over fp and
int8 caches, the shape gate and a short Generator run — each stage of the
port against the JAX package's (Pallas in interpret mode, JITTED).

Tolerances: slopes, packs and int8 cache codes bit for bit; calibration
statistics 1e-5 relative (f32 sums in another order); smoothing scales
within 2 ulp and smoothed weights within 3 (jnp.power against torch.pow);
logits 2e-4 relative and absolute — the JAX package's own bound for the
Bloom stacked decode (tests/test_prefetch_scan_archs.py), since the ALiBi
term (slope · position) makes the scores larger than Llama's, so an ulp of
the q·k sum moves them further; the Generator's tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import bloom as jbloom
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu.models.common import QuantKVCache as JQuantKVCache
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import smooth_lm as j_smooth_lm
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu.serve.batching import ContinuousBatcher as JBatcher
from smoothquant_tpu.serve.batching import Request as JRequest
from smoothquant_tpu.serve.generate import GenerationConfig as JGenConfig
from smoothquant_tpu.serve.generate import Generator as JGenerator
from smoothquant_tpu_torch.models import bloom as tbloom
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache, QuantKVCache
from smoothquant_tpu_torch.models.registry import pack_model, smooth_lm
from smoothquant_tpu_torch.quant import calibrate as tcal
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

CACHE_LEN = 128       # K11 tiles the cache in 128s
GS = 16
TOL = dict(rtol=2e-4, atol=2e-4)


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _randomize(params, rng):
    """LayerNorm weights near 1 and small biases everywhere (JAX's
    init_params makes them 1 and 0)."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name == "bias":
            return rng.normal(size=a.shape).astype(a.dtype) * 0.05
        if a.ndim == 1:            # a LayerNorm weight
            return rng.uniform(0.8, 1.2, size=a.shape).astype(a.dtype)
        return a
    return walk(params)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def bloom():
    jcfg = dataclasses.replace(jbloom.BloomConfig.tiny(), hidden_size=256,
                               num_attention_heads=4)
    tcfg = tbloom.BloomConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tbloom.BloomConfig)})
    params = _randomize(jax.tree.map(np.asarray, jbloom.init_params(
        jax.random.PRNGKey(0), jcfg)), np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_numpy(params, "cpu")
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, jcfg.vocab_size, size=(1, 32)) for _ in range(2)]
    jfwd = lambda p, ids, col: jbloom.forward(p, jnp.asarray(ids), jcfg, ctx=JCtx(taps=col))
    out = dict(jcfg=jcfg, tcfg=tcfg, params=params, jparams=jparams, tparams=tparams)
    out["j_scales"] = jcal.get_act_scales(jfwd, jparams, batches)
    out["j_feat"] = jcal.get_calib_feat(jfwd, jparams, batches)
    tfwd = lambda p, ids, col: tbloom.forward(p, torch.as_tensor(ids), tcfg,
                                              ctx=ForwardContext(taps=col))
    out["t_scales"] = tcal.get_act_scales(tfwd, tparams, batches)
    out["t_feat"] = tcal.get_calib_feat(tfwd, tparams, batches)
    out["j_smoothed"] = j_smooth_lm("bloom", jparams, jcfg, out["j_scales"], 0.5)
    qj = jw4a4_group(group_size=GS, salient_prop=0.05)
    kw = dict(input_feat=out["j_feat"], act_scales=out["j_scales"], nibble=True,
              align_k_groups=8, align_o=256)
    out["qj"] = qj
    out["j_packed"] = jpack_model("bloom", out["j_smoothed"], jcfg, qj,
                                  compute_dtype=jnp.float32, **kw)
    # the port's pack of JAX's smoothed weights and statistics
    out["t_packed"] = pack_model("bloom", _to_torch(out["j_smoothed"]), tcfg,
                                 w4a4_group(GS, 0.05), **kw)
    return out


@pytest.mark.parametrize("n_heads", [4, 6, 8, 32])
def test_alibi_slopes_match_jax(n_heads):
    got = tbloom.alibi_slopes(n_heads)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jbloom.alibi_slopes(n_heads))


def test_fp_forward_matches_jax(bloom):
    """The per-layer fp forward with no cache (einsum attention with the
    ALiBi term, embedding LayerNorm, exact GELU, tied unembedding)."""
    b = bloom
    ids = np.random.default_rng(2).integers(0, 256, size=(2, 9))
    ref = jax.jit(lambda p, i: jbloom.forward(p, i, b["jcfg"])[0])(b["jparams"],
                                                                 jnp.asarray(ids))
    got, caches = tbloom.forward(b["tparams"], torch.from_numpy(ids), b["tcfg"])
    assert caches is None and got.dtype == torch.float32 and got.shape == (2, 9, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def _jax_caches(cls, cfg, b):
    return [cls.create(b, CACHE_LEN, cfg.num_attention_heads, cfg.head_dim, jnp.float32)
            for _ in range(cfg.num_hidden_layers)]


def _port_caches(cls, cfg, b):
    return [cls.create(b, CACHE_LEN, cfg.num_attention_heads, cfg.head_dim, torch.float32,
                       "cpu") for _ in range(cfg.num_hidden_layers)]


@pytest.mark.parametrize("quant_kv", [False, True])
def test_fp_cached_decode_matches_jax(bloom, quant_kv):
    """A 7-token prefill into per-layer caches, then two decode steps: the
    int8 cache's single query runs K11 with the slopes (interpret mode in
    JAX, the plain version here), the fp cache the einsum."""
    b = bloom
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    ctx = JCtx(interpret=True)
    step = jax.jit(lambda p, i, c: jbloom.forward(p, i, b["jcfg"], ctx=ctx, caches=c))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, size=(2, 7))
    jc, tc = _jax_caches(jcls, b["jcfg"], 2), _port_caches(tcls, b["tcfg"], 2)
    for ids in (prompt, rng.integers(0, 256, size=(2, 1)), rng.integers(0, 256, size=(2, 1))):
        ref, jc = step(b["jparams"], jnp.asarray(ids), jc)
        got, tc = tbloom.forward(b["tparams"], torch.from_numpy(ids), b["tcfg"], caches=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for jl, tl in zip(jc, tc):
        assert tl.pos == int(jl.pos) == 9
        if quant_kv:
            np.testing.assert_array_equal(tl.k_q.numpy(), np.asarray(jl.k_q))
            np.testing.assert_array_equal(tl.v_q.numpy(), np.asarray(jl.v_q))


@pytest.mark.parametrize("stat", ["scales", "feat"])
def test_calibration_matches_jax(bloom, stat):
    """The tapped per-layer forward names the four call sites of each layer
    as JAX does, with the same statistics."""
    ref, got = bloom[f"j_{stat}"], bloom[f"t_{stat}"]
    assert sorted(got) == sorted(ref) and len(got) == 4 * 2
    assert "transformer.h.1.self_attention.query_key_value" in got
    for name in ref:
        r = np.asarray(ref[name], np.float64)
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


def test_smooth_lm_matches_jax(bloom):
    """smoothing_map pairs input_layernorm with query_key_value and
    post_attention_layernorm with dense_h_to_4h; from the same statistics
    the LayerNorm weights and biases and the smoothed weights agree within
    3 ulp, and dense / dense_4h_to_h are untouched."""
    b = bloom
    assert [(p[0][-1], [q[-1] for q in p[1]], p[2]) for p in tbloom.smoothing_map(b["tcfg"])] \
        == [(p[0][-1], [q[-1] for q in p[1]], p[2]) for p in jbloom.smoothing_map(b["jcfg"])]
    ref = jax.tree.map(np.asarray, b["j_smoothed"])
    got = smooth_lm("bloom", b["tparams"], b["tcfg"], b["j_scales"], 0.5)
    for i in range(2):
        rl, gl, ol = ref["layers"][str(i)], got["layers"][str(i)], b["params"]["layers"][str(i)]
        pairs = [(gl[n][f], rl[n][f]) for n in ("input_layernorm", "post_attention_layernorm")
                 for f in ("weight", "bias")]
        pairs += [(gl["self_attention"]["query_key_value"]["weight"],
                   rl["self_attention"]["query_key_value"]["weight"]),
                  (gl["mlp"]["dense_h_to_4h"]["weight"], rl["mlp"]["dense_h_to_4h"]["weight"])]
        for g, r in pairs:
            assert _ulp_diff(g.numpy(), r).max() <= 3
        assert np.abs(gl["mlp"]["dense_h_to_4h"]["weight"].numpy()
                      - ol["mlp"]["dense_h_to_4h"]["weight"]).max() > 0
        for n, p in (("self_attention", "dense"), ("mlp", "dense_4h_to_h")):
            np.testing.assert_array_equal(gl[n][p]["weight"].numpy(), ol[n][p]["weight"])


def test_nibble_pack_matches_jax(bloom):
    """pack_model("bloom", nibble=True, align_k_groups=8, align_o=256) of the
    same smoothed weights and statistics: every field bit for bit."""
    b = bloom
    for path, _, _ in tbloom.quantizable_linears(b["tcfg"]):
        r, g = b["j_packed"], b["t_packed"]
        for k in path:
            r, g = r[k], g[k]
        assert g.meta.nibble and (g.meta.k_ns // (2 * GS)) % 8 == 0
        assert g.w_qt.shape[-1] % 256 == 0 and not g.meta.pre_permuted
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm", "bias"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)))


def _stack_caches(cfg, caches, quant_kv):
    st = tbloom.stacked_caches(cfg, caches[0].k_scale.shape[0] if quant_kv
                               else caches[0].k.shape[0], CACHE_LEN, torch.float32,
                               quant_kv=quant_kv, pos=caches[0].pos, device="cpu")
    fields = ("k_q", "v_q", "k_scale", "v_scale") if quant_kv else ("k", "v")
    for i, c in enumerate(caches):
        for f in fields:
            getattr(st, f)[i].copy_(getattr(c, f))
    return st


@pytest.mark.parametrize("quant_kv", [False, True])
def test_packed_decode_per_layer_and_stacked_match_jax(bloom, quant_kv):
    """The twin of test_bloom_prefetch_matches_per_layer: a 5-token prefill
    of the packed per-layer tree into per-layer caches, then one token
    through the per-layer tree (K6, K11 with slopes over the int8 cache)
    and through stack_layers' tree over the stacked copy of those caches
    (input gathered, K1, K10 with rotary off, K11 with slopes) — each held
    to the other (logits 2e-4, int8 cache codes identical, positions) and
    to the JAX package's run of the same."""
    b = bloom
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    jctx = JCtx(quant=b["qj"], compute="int", interpret=True)
    jstep = jax.jit(lambda p, i, c: jbloom.forward(p, i, b["jcfg"], ctx=jctx, caches=c))
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 256, size=(2, 5))
    tok = np.asarray([[7], [9]])
    _, jc = jstep(b["j_packed"], jnp.asarray(prompt), _jax_caches(jcls, b["jcfg"], 2))
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jc)
    jref, _ = jstep(b["j_packed"], jnp.asarray(tok), jc)
    jgot, jgot_c = jstep(jbloom.stack_layers(b["j_packed"], b["jcfg"]), jnp.asarray(tok), jst)

    tcfg = b["tcfg"]
    _, tc = tbloom.forward(b["t_packed"], torch.from_numpy(prompt), tcfg,
                           caches=_port_caches(tcls, tcfg, 2))
    tst = _stack_caches(tcfg, tc, quant_kv)
    stacked = tbloom.stack_layers(b["t_packed"], tcfg)
    assert tbloom._prefetch_capable(stacked, tcfg, None, tst, 1)
    ref, ref_c = tbloom.forward(b["t_packed"], torch.from_numpy(tok), tcfg, caches=tc)
    got, got_c = tbloom.forward(stacked, torch.from_numpy(tok), tcfg, caches=tst)

    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    for i, rc in enumerate(ref_c):
        assert int(got_c.pos[i]) == rc.pos == int(jgot_c.pos[i]) == 6
        if quant_kv:
            np.testing.assert_array_equal(got_c.k_q[i].numpy(), rc.k_q.numpy())
            np.testing.assert_array_equal(got_c.v_q[i].numpy(), rc.v_q.numpy())
            np.testing.assert_array_equal(got_c.k_q[i].numpy(), np.asarray(jgot_c.k_q[i]))
        else:
            np.testing.assert_allclose(got_c.k[i].numpy(), rc.k.numpy(), atol=1e-5)
            np.testing.assert_allclose(got_c.k[i].numpy(), np.asarray(jgot_c.k[i]), atol=1e-5)


def test_stacked_gate_respects_unsupported_shapes(bloom):
    """head_dim 16 (< 64) cannot ride K11: the gate declines the stacked
    tree, and the forward runs the per-layer body over its layers, as the
    JAX package scans it (logits to 2e-4)."""
    jcfg = jbloom.BloomConfig.tiny()
    tcfg = tbloom.BloomConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tbloom.BloomConfig)})
    params = jbloom.init_params(jax.random.PRNGKey(0), jcfg)
    feat = {key: np.random.default_rng(1).uniform(0.1, 1.0, size=(
        4 * jcfg.hidden_size if "dense_4h_to_h" in key else jcfg.hidden_size,))
        for _, key, _ in jbloom.quantizable_linears(jcfg)}
    kw = dict(input_feat=feat, nibble=True, align_k_groups=8, align_o=256)
    jp = jpack_model("bloom", params, jcfg, jw4a4_group(group_size=GS, salient_prop=0.05),
                     compute_dtype=jnp.float32, **kw)
    logits, _ = jbloom.forward(jbloom.stack_layers(jp, jcfg), jnp.asarray([[3]]), jcfg,
                               ctx=JCtx(compute="int", interpret=True),
                               caches=jbloom.stacked_caches(jcfg, 1, CACHE_LEN, jnp.float32))
    assert np.isfinite(np.asarray(logits)).all()
    tp = tbloom.stack_layers(pack_model("bloom", _to_torch(params), tcfg,
                                        w4a4_group(GS, 0.05), **kw), tcfg)
    caches = tbloom.stacked_caches(tcfg, 1, CACHE_LEN, device="cpu")
    assert not tbloom._prefetch_capable(tp, tcfg, None, caches, 1)
    got, got_c = tbloom.forward(tp, torch.tensor([[3]]), tcfg, caches=caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_array_equal(got_c.pos.numpy(), [1] * tcfg.num_hidden_layers)


def test_stacked_gate_declines_per_slot_positions(bloom):
    """The stacked decode takes the (L,) aligned positions stacked_caches
    builds and, as JAX's generic gate does (common.py:695-699), the (L, B)
    per-slot positions of the batcher's pool (the name is the gate's
    earlier rule, which declined them): each layer's bias and K10's row
    write from each slot's own position, as JAX's scan reads pos[i].
    Logits to 2e-4 of the JAX stacked decode's over the same per-slot
    cache (slots at positions 5 and 9), the written int8 rows identical."""
    b = bloom
    tcfg = b["tcfg"]
    stacked = tbloom.stack_layers(b["t_packed"], tcfg)
    aligned = tbloom.stacked_caches(tcfg, 2, CACHE_LEN, quant_kv=True, pos=5, device="cpu")
    assert aligned.pos.shape == (2,)
    assert tbloom._prefetch_capable(stacked, tcfg, None, aligned, 1)
    per_slot = QuantKVCache.create(2, CACHE_LEN, tcfg.num_attention_heads, tcfg.head_dim,
                                   device="cpu", per_slot=True, n_layers=2, pos=5)
    per_slot.pos[:, 1] = 9
    assert per_slot.pos.shape == (2, 2)
    assert tbloom._prefetch_capable(stacked, tcfg, None, per_slot, 1)
    jcfg = b["jcfg"]
    jst = jbloom.stacked_caches(jcfg, 2, CACHE_LEN, jnp.float32, pos=5, quant_kv=True)
    jst = jst._replace(pos=jnp.asarray([[5, 9], [5, 9]], jnp.int32))
    ref, ref_c = jax.jit(lambda p, t, c: jbloom.forward(
        p, t, jcfg, ctx=JCtx(compute="int", interpret=True), caches=c))(
        jbloom.stack_layers(b["j_packed"], jcfg), jnp.asarray([[3], [4]]), jst)
    calls, scan = [], tbloom._prefetch_scan_decode
    tbloom._prefetch_scan_decode = lambda *a, **k: calls.append(1) or scan(*a, **k)
    try:
        got, got_c = tbloom.forward(stacked, torch.tensor([[3], [4]]), tcfg, caches=per_slot)
    finally:
        tbloom._prefetch_scan_decode = scan
    assert calls == [1]                       # the stacked decode, not the per-layer body
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got_c.k_q.numpy(), np.asarray(ref_c.k_q))
    np.testing.assert_array_equal(got_c.pos.numpy(), np.asarray(ref_c.pos))


def test_stacked_batcher_over_per_slot_pool_tokens_identical_to_jax(bloom):
    """The packed stacked tree through the batcher over its per-slot stacked
    int8 pool ((L, B) positions), prefilled on the stacked tree (the
    per-layer body over the stack on both sides): every decode step the
    port's stacked decode (K1, K10 with rotary off, K11's ALiBi body at each
    slot's positions; plain versions here), JAX's its per-slot stacked scan
    (interpret mode).  Mixed prompt lengths and buckets, chunks of 2: the
    same tokens, pool positions, masks and sequence positions."""
    b = bloom
    jst = jbloom.stack_layers(b["j_packed"], b["jcfg"])
    tst = tbloom.stack_layers(b["t_packed"], b["tcfg"])
    jb = JBatcher(jbloom, jst, b["jcfg"], max_batch=2, max_len=CACHE_LEN, quant_kv=True,
                  compute="int", interpret=True)
    tb = ContinuousBatcher(tbloom, tst, b["tcfg"], max_batch=2, max_len=CACHE_LEN,
                           quant_kv=True, device="cpu")
    assert tb.caches.pos.shape == (b["tcfg"].num_hidden_layers, 2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=(n,)) for n in (5, 40, 9)]
    out = []
    calls, scan = [], tbloom._prefetch_scan_decode
    tbloom._prefetch_scan_decode = lambda *a, **k: calls.append(1) or scan(*a, **k)
    try:
        for batcher, cls in ((jb, JRequest), (tb, Request)):
            reqs = [cls(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
            for r in reqs:
                batcher.submit(r)
            batcher.run_to_completion(chunk=2)
            out.append([r.generated for r in reqs])
    finally:
        tbloom._prefetch_scan_decode = scan
    assert out[1] == out[0]
    assert len(calls) == tb._steps > 0          # every decode step took the stacked decode
    np.testing.assert_array_equal(tb.pool_pos, jb.pool_pos)
    np.testing.assert_array_equal(tb.key_valid, jb.key_valid)
    np.testing.assert_array_equal(tb.seq_pos, jb.seq_pos)


def test_generator_tokens_identical_to_jax(bloom):
    """6 greedy tokens over per-layer int8 caches: the prefill on K6, each
    decode step on K6 and K11 with the slopes."""
    b = bloom
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8))
    jgen = JGenerator(jbloom, b["j_packed"], b["jcfg"], max_len=CACHE_LEN, quant_kv=True,
                      interpret=True)
    tgen = Generator(tbloom, b["t_packed"], b["tcfg"], max_len=CACHE_LEN, quant_kv=True,
                     device="cpu")
    ref = jgen.generate(prompt, JGenConfig(max_new_tokens=6))
    got = tgen.generate(prompt, GenerationConfig(max_new_tokens=6))
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got, ref)

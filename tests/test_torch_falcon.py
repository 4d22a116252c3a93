"""The Falcon slice on 2-layer Falcons (4 heads of 64, vocab 256, f32;
LayerNorms made random so each one counts) in HF's three block layouts —
the 7B's multi-query parallel block ("mqa"), the new decoder ("new", 2 kv
groups), the classic sequential block ("classic") — and a multi-query
Falcon of 9 heads over one kv head ("mqa9", rep 9: K11's two groups of
query rows): the same numpy weights through both packages, each stage of
the port against the JAX package's (Pallas in interpret mode).

The JAX module's MLP takes jax.nn.gelu's default, the tanh approximation;
HF Falcon's activation is the exact GELU, which the port takes.  These
tests hold the port to the JAX module with its GELU made exact (the
`jax` its module reads is a view of jax whose nn.gelu is exact), and
test_jax_falcon_gelu_is_the_tanh_form pins the difference.

Tolerances: packs and int8 cache codes bit for bit; calibration
statistics 1e-5 relative (f32 sums in another order); smoothing scales
and weights within 3 ulp (jnp.power against torch.pow); fp logits 1e-5 of
their largest magnitude; decode logits 2e-4 relative and absolute (the
JAX package's own bound for the Falcon stacked decode, tests/
test_prefetch_scan_archs.py: K11's tile-by-tile softmax and the packed
linears' f32 sums in another order); tokens identical."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import falcon as jfalcon
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu.models.common import QuantKVCache as JQuantKVCache
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import smooth_lm as j_smooth_lm
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu.serve.generate import GenerationConfig as JGenConfig
from smoothquant_tpu.serve.generate import Generator as JGenerator
from smoothquant_tpu_torch.models import falcon as tfalcon
from smoothquant_tpu_torch.models.bloom import gelu
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache, QuantKVCache
from smoothquant_tpu_torch.models.registry import get_arch, pack_model, smooth_lm
from smoothquant_tpu_torch.quant import calibrate as tcal
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy

torch.set_num_threads(1)

CACHE_LEN = 128       # K11 tiles the cache in 128s
GS = 16
TOL = dict(rtol=2e-4, atol=2e-4)
VARIANTS = {
    "mqa": dict(),
    "new": dict(new_decoder_architecture=True, multi_query=False),
    "classic": dict(parallel_attn=False, multi_query=False, num_kv_heads=4),
    "mqa9": dict(hidden_size=576, num_attention_heads=9),
}


class _ExactGeluJax:
    """jax as the JAX Falcon module reads it, with nn.gelu exact (HF's)."""

    nn = types.SimpleNamespace(
        gelu=lambda x, approximate=False: jax.nn.gelu(x, approximate=False))

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture(scope="module", autouse=True)
def exact_gelu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfalcon, "jax", _ExactGeluJax())
        yield


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _randomize(params, rng):
    """LayerNorm weights near 1 and small LayerNorm biases (init_params
    makes them 1 and 0)."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node is None:
            return None
        a = np.asarray(node)
        if a.ndim == 1:
            base = 0.0 if name == "bias" else 1.0
            return (base + rng.normal(size=a.shape) * 0.05).astype(a.dtype)
        return a
    return walk(params)


def _feat(cfg, mod, seed=1):
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size
    return {key: rng.uniform(0.1, 1.0, size=(4 * h if "4h_to_h" in key else h,))
            for _, key, _ in mod.quantizable_linears(cfg)}


_BUILT = {}


def build(variant):
    """Weights, configs and the nibble packs of both packages (the port's
    pack of the same weights and statistics), once per variant."""
    if variant in _BUILT:
        return _BUILT[variant]
    jcfg = jfalcon.FalconConfig.tiny(**{"hidden_size": 256, **VARIANTS[variant]})
    tcfg = config_from(tfalcon.FalconConfig, jcfg)
    params = _randomize(jax.tree.map(np.asarray, jfalcon.init_params(
        jax.random.PRNGKey(0), jcfg)), np.random.default_rng(0))
    feat = _feat(jcfg, jfalcon)
    kw = dict(input_feat=feat, nibble=True, align_k_groups=8, align_o=256)
    qj = jw4a4_group(group_size=GS, salient_prop=0.05)
    out = dict(jcfg=jcfg, tcfg=tcfg, params=params, qj=qj,
               jparams=jax.tree.map(jnp.asarray, params),
               tparams=params_from_numpy(params, "cpu"))
    out["j_packed"] = jpack_model("falcon", out["jparams"], jcfg, qj,
                                  compute_dtype=jnp.float32, **kw)
    out["t_packed"] = pack_model("falcon", params_from_numpy(params, "cpu"), tcfg,
                                 w4a4_group(GS, 0.05), **kw)
    _BUILT[variant] = out
    return out


def _jax_caches(cls, cfg, b):
    return [cls.create(b, CACHE_LEN, cfg.effective_kv_heads, cfg.head_dim, jnp.float32)
            for _ in range(cfg.num_hidden_layers)]


def _port_caches(cls, cfg, b):
    return [cls.create(b, CACHE_LEN, cfg.effective_kv_heads, cfg.head_dim, torch.float32,
                       "cpu") for _ in range(cfg.num_hidden_layers)]


def test_config_and_registry():
    """Falcon-7B's preset is the defaults (tiiuae/falcon-7b: 71 heads of 64
    over one kv head, hidden 4544, 32 layers, vocab 65024) and every field
    equals the JAX config's; the registry resolves "falcon"."""
    cfg = tfalcon.FalconConfig.falcon_7b()
    assert cfg == tfalcon.FalconConfig()
    assert (cfg.head_dim, cfg.effective_kv_heads, tfalcon._qkv_dim(cfg)) == (64, 1, 4672)
    ref = dataclasses.asdict(jfalcon.FalconConfig())
    assert dataclasses.asdict(cfg) == ref
    for kw in VARIANTS.values():
        j = jfalcon.FalconConfig.tiny(**kw)
        assert config_from(tfalcon.FalconConfig, j).effective_kv_heads == j.effective_kv_heads
    assert get_arch("falcon") is tfalcon


def test_jax_falcon_gelu_is_the_tanh_form():
    """The JAX module's MLP takes jax.nn.gelu's default (the tanh form): on
    the same weights its logits differ from the exact-GELU forward by far
    more than f32 noise; the port's gelu is jax.nn.gelu(approximate=False)
    to f32 rounding."""
    b = build("mqa")
    ids = jnp.asarray(np.random.default_rng(5).integers(0, 256, size=(2, 9)))
    exact = np.asarray(jfalcon.forward(b["jparams"], ids, b["jcfg"])[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfalcon, "jax", jax)
        tanh = np.asarray(jfalcon.forward(b["jparams"], ids, b["jcfg"])[0])
    assert np.abs(tanh - exact).max() > 1e-4 * np.abs(exact).max()
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x, approximate=False)),
                               rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp_forward_matches_jax(variant):
    """The per-layer fp forward with no cache (the layout's qkv split,
    rotary, einsum attention at its rep, the parallel or sequential MLP,
    tied unembedding)."""
    b = build(variant)
    ids = np.random.default_rng(2).integers(0, 256, size=(2, 9))
    ref = np.asarray(jax.jit(lambda p, i: jfalcon.forward(p, i, b["jcfg"])[0])(
        b["jparams"], jnp.asarray(ids)))
    got, caches = tfalcon.forward(b["tparams"], torch.from_numpy(ids), b["tcfg"])
    assert caches is None and got.shape == (2, 9, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp_cached_decode_matches_jax(variant, quant_kv):
    """A 7-token prefill into per-layer caches of effective_kv_heads heads,
    then two decode steps: over the int8 cache the single query runs K11
    at the layout's rep (interpret mode in JAX, the plain version here)."""
    b = build(variant)
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    step = jax.jit(lambda p, i, c: jfalcon.forward(p, i, b["jcfg"], ctx=JCtx(interpret=True),
                                                   caches=c))
    rng = np.random.default_rng(3)
    jc, tc = _jax_caches(jcls, b["jcfg"], 2), _port_caches(tcls, b["tcfg"], 2)
    for ids in (rng.integers(0, 256, size=(2, 7)), rng.integers(0, 256, size=(2, 1)),
                rng.integers(0, 256, size=(2, 1))):
        ref, jc = step(b["jparams"], jnp.asarray(ids), jc)
        got, tc = tfalcon.forward(b["tparams"], torch.from_numpy(ids), b["tcfg"], caches=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for jl, tl in zip(jc, tc):
        assert tl.pos == int(jl.pos) == 9
        if quant_kv:
            np.testing.assert_array_equal(tl.k_q.numpy(), np.asarray(jl.k_q))
            np.testing.assert_array_equal(tl.v_q.numpy(), np.asarray(jl.v_q))


@pytest.mark.parametrize("variant", ["mqa", "new", "classic"])
def test_calibration_and_smoothing_match_jax(variant):
    """The tapped forward names the four call sites of each layer as JAX
    does, with the same statistics (1e-5); smoothing_map pairs the layout's
    norms with its linears (the 7B's one LayerNorm feeds qkv and
    dense_h_to_4h), and smooth_lm from the same statistics gives the same
    norms and weights within 3 ulp."""
    b = build(variant)
    jcfg, tcfg = b["jcfg"], b["tcfg"]
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, size=(1, 16)) for _ in range(2)]
    jfwd = lambda p, ids, col: jfalcon.forward(p, jnp.asarray(ids), jcfg, ctx=JCtx(taps=col))
    tfwd = lambda p, ids, col: tfalcon.forward(p, torch.as_tensor(ids), tcfg,
                                               ctx=ForwardContext(taps=col))
    ref = jcal.get_act_scales(jfwd, b["jparams"], batches)
    got = tcal.get_act_scales(tfwd, b["tparams"], batches)
    assert sorted(got) == sorted(ref) and len(got) == 4 * 2
    for name in ref:
        r = np.asarray(ref[name], np.float64)
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    key = lambda pairs: [(p[0][-1], [q[-2:] for q in p[1]], p[2]) for p in pairs]
    assert key(tfalcon.smoothing_map(tcfg)) == key(jfalcon.smoothing_map(jcfg))
    j_sm = jax.tree.map(np.asarray, j_smooth_lm("falcon", b["jparams"], jcfg, ref, 0.5))
    t_sm = smooth_lm("falcon", b["tparams"], tcfg, ref, 0.5)
    for i in range(2):
        rl, gl = j_sm["layers"][str(i)], t_sm["layers"][str(i)]
        for n in tfalcon._norm_names(tcfg):
            for f in ("weight", "bias"):
                assert _ulp_diff(gl[n][f].numpy(), rl[n][f]).max() <= 3
        for n, p in (("self_attention", "query_key_value"), ("mlp", "dense_h_to_4h")):
            assert _ulp_diff(gl[n][p]["weight"].numpy(), rl[n][p]["weight"]).max() <= 3


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_nibble_pack_matches_jax(variant):
    """pack_model("falcon", nibble=True, align_k_groups=8, align_o=256) of the
    same weights and statistics: every field bit for bit."""
    b = build(variant)
    for path, _, _ in tfalcon.quantizable_linears(b["tcfg"]):
        r, g = b["j_packed"], b["t_packed"]
        for k in path:
            r, g = r[k], g[k]
        assert g.meta.nibble and (g.meta.k_ns // (2 * GS)) % 8 == 0
        assert g.w_qt.shape[-1] % 256 == 0
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)))


def _stack_caches(cfg, caches, quant_kv):
    b = (caches[0].k_scale if quant_kv else caches[0].k).shape[0]
    st = tfalcon.stacked_caches(cfg, b, CACHE_LEN, torch.float32, quant_kv=quant_kv,
                                pos=caches[0].pos, device="cpu")
    for i, c in enumerate(caches):
        for f in (("k_q", "v_q", "k_scale", "v_scale") if quant_kv else ("k", "v")):
            getattr(st, f)[i].copy_(getattr(c, f))
    return st


@pytest.mark.parametrize("variant,quant_kv", [("mqa", False), ("mqa9", True), ("new", True),
                                              ("classic", False)])
def test_packed_decode_per_layer_and_stacked_match_jax(variant, quant_kv):
    """The twin of test_falcon_prefetch_matches_per_layer: a 5-token
    prefill of the packed per-layer tree, then one token through the
    per-layer tree (K6, K11 over the int8 cache) and through stack_layers'
    tree over the stacked copy of the caches (input gathered, K1, K10 with
    q rotated in its launch over the int8 cache, K11 at the layout's rep) —
    each held to the other (logits 2e-4, int8 codes identical, positions)
    and to the JAX package's run of the same."""
    b = build(variant)
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    jctx = JCtx(quant=b["qj"], compute="int", interpret=True)
    jstep = jax.jit(lambda p, i, c: jfalcon.forward(p, i, b["jcfg"], ctx=jctx, caches=c))
    rng = np.random.default_rng(2)
    prompt, tok = rng.integers(0, 256, size=(2, 5)), np.asarray([[7], [9]])
    _, jc = jstep(b["j_packed"], jnp.asarray(prompt), _jax_caches(jcls, b["jcfg"], 2))
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jc)
    jref, _ = jstep(b["j_packed"], jnp.asarray(tok), jc)
    jgot, jgot_c = jstep(jfalcon.stack_layers(b["j_packed"], b["jcfg"]), jnp.asarray(tok), jst)

    tcfg = b["tcfg"]
    _, tc = tfalcon.forward(b["t_packed"], torch.from_numpy(prompt), tcfg,
                            caches=_port_caches(tcls, tcfg, 2))
    tst = _stack_caches(tcfg, tc, quant_kv)
    stacked = tfalcon.stack_layers(b["t_packed"], tcfg)
    assert tfalcon._prefetch_capable(stacked, tcfg, None, tst, 1)
    ref, ref_c = tfalcon.forward(b["t_packed"], torch.from_numpy(tok), tcfg, caches=tc)
    got, got_c = tfalcon.forward(stacked, torch.from_numpy(tok), tcfg, caches=tst)
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


def _greedy_no_cache(forward, ids, new):
    """Greedy tokens by full forwards with no cache (the reference decode)."""
    ids = np.asarray(ids)
    for _ in range(new):
        logits = np.asarray(forward(ids))
        ids = np.concatenate([ids, logits[:, -1].argmax(-1)[:, None]], axis=1)
    return ids


def test_serving_kv_heads_from_the_model():
    """The reference's Falcon serving fault, pinned from both sides, on
    FalconConfig.tiny() (4 heads over one kv head, seed 0): the JAX
    Generator builds caches of num_attention_heads heads (it reads
    num_key_value_heads, which FalconConfig lacks), writes head 0 alone and
    parts from the no-cache greedy decode; the port's Generator and batcher
    (caches of effective_kv_heads) give the no-cache tokens, and one decode
    step agrees with JAX's falcon.forward over caches of effective_kv_heads."""
    jcfg = jfalcon.FalconConfig.tiny()
    tcfg = config_from(tfalcon.FalconConfig, jcfg)
    assert jcfg.effective_kv_heads == 1 and not hasattr(jcfg, "num_key_value_heads")
    params = jax.tree.map(np.asarray, jfalcon.init_params(jax.random.PRNGKey(0), jcfg))
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")
    prompt = np.random.default_rng(0).integers(0, 256, size=(2, 6))
    new = 8
    jfwd = jax.jit(lambda i: jfalcon.forward(jp, i, jcfg)[0])
    ref = _greedy_no_cache(lambda i: jfwd(jnp.asarray(i)), prompt, new)
    tref = _greedy_no_cache(lambda i: tfalcon.forward(tp, torch.as_tensor(i), tcfg)[0], prompt,
                            new)
    np.testing.assert_array_equal(tref, ref)
    jgen = JGenerator(jfalcon, jp, jcfg, max_len=64).generate(prompt, JGenConfig(max_new_tokens=new))
    assert (np.asarray(jgen) != ref).any()
    got = Generator(tfalcon, tp, tcfg, max_len=64, device="cpu").generate(
        prompt, GenerationConfig(max_new_tokens=new))
    np.testing.assert_array_equal(got, ref)
    tb = ContinuousBatcher(tfalcon, tp, tcfg, max_batch=2, max_len=64, device="cpu")
    reqs = [Request(uid=i, prompt=prompt[i], max_new_tokens=new) for i in range(2)]
    for r in reqs:
        tb.submit(r)
    tb.run_to_completion()
    assert [r.generated for r in reqs] == ref[:, 6:].tolist()
    # one step over caches of effective_kv_heads: JAX's forward and the port's
    jc = [JKVCache.create(2, 64, 1, jcfg.head_dim, jnp.float32) for _ in range(2)]
    tc = [KVCache.create(2, 64, 1, tcfg.head_dim, torch.float32, "cpu") for _ in range(2)]
    for ids in (prompt, ref[:, 6:7]):
        jl, jc = jfalcon.forward(jp, jnp.asarray(ids), jcfg, caches=jc)
        tl, tc = tfalcon.forward(tp, torch.as_tensor(ids), tcfg, caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())


_GREEDY = {}


def _jax_greedy(b, prompt, new):
    """A JAX greedy loop over per-layer int8 caches of effective_kv_heads on
    the packed tree (compute "int", interpret mode): the prompt and its new
    tokens, once per (variant, prompt, new)."""
    key = (b["jcfg"], prompt.tobytes(), new)
    if key not in _GREEDY:
        jcfg = b["jcfg"]
        jctx = JCtx(quant=b["qj"], compute="int", interpret=True)
        jstep = jax.jit(lambda i, c: jfalcon.forward(b["j_packed"], i, jcfg, ctx=jctx,
                                                     caches=c))
        jc = _jax_caches(JQuantKVCache, jcfg, prompt.shape[0])
        ids, ref = prompt, [prompt]
        for _ in range(new):
            logits, jc = jstep(jnp.asarray(ids), jc)
            ids = np.asarray(logits)[:, -1].argmax(-1)[:, None]
            ref.append(ids)
        _GREEDY[key] = np.concatenate(ref, axis=1)
    return _GREEDY[key]


@pytest.mark.parametrize("variant", ["mqa9"])
def test_packed_serving_stacked_and_per_layer(variant):
    """The packed tree served over per-layer int8 caches (the Generator: K6,
    K11 at the layout's rep) and its stacked tree through the batcher's
    stacked int8 pool ((L, B) per-slot positions: the stacked decode) give
    the tokens of a JAX greedy loop over caches of effective_kv_heads."""
    b = build(variant)
    jcfg, tcfg = b["jcfg"], b["tcfg"]
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8))
    new = 5
    ref = _jax_greedy(b, prompt, new)
    got = Generator(tfalcon, b["t_packed"], tcfg, max_len=CACHE_LEN, quant_kv=True,
                    device="cpu").generate(prompt, GenerationConfig(max_new_tokens=new))
    np.testing.assert_array_equal(got, ref)
    stacked = tfalcon.stack_layers(b["t_packed"], tcfg)
    tb = ContinuousBatcher(tfalcon, stacked, tcfg, max_batch=2, max_len=CACHE_LEN,
                           quant_kv=True, prefill_params=b["t_packed"], device="cpu")
    assert tb.caches.k_q.shape[2] == tcfg.effective_kv_heads and tb.caches.pos.ndim == 2
    reqs = [Request(uid=i, prompt=prompt[i], max_new_tokens=new) for i in range(2)]
    for r in reqs:
        tb.submit(r)
    tb.run_to_completion()
    assert [r.generated for r in reqs] == ref[:, 8:].tolist()


def test_stacked_reference_helper_gives_jaxs_tokens():
    """chip_smoke.stacked_reference, the reference the card's Falcon and
    Bloom serving phases hold the batcher to (the stacked tree's own greedy
    decode at the pool's width, prefilled on the stacked tree, the request
    in every row, no batcher), on the f32 mqa9 Falcon (rep 9: K11 in two
    groups of query rows): each request's tokens those of the JAX greedy
    loop and of the batcher serving the same stacked tree; its gaps
    positive."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    b = build("mqa9")
    tcfg = b["tcfg"]
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8))
    new = 5
    ref = _jax_greedy(b, prompt, new)
    stacked = tfalcon.stack_layers(b["t_packed"], tcfg)
    cpu = torch.device("cpu")
    tb = ContinuousBatcher(tfalcon, stacked, tcfg, max_batch=2, max_len=CACHE_LEN,
                           quant_kv=True, device="cpu")
    reqs = [Request(uid=i, prompt=prompt[i], max_new_tokens=new) for i in range(2)]
    for r in reqs:
        tb.submit(r)
    tb.run_to_completion()
    for i in range(2):
        got = cs.stacked_reference(tfalcon, stacked, tcfg, prompt[i], new, cpu,
                                   max_len=CACHE_LEN, copies=2)
        assert got["tokens"] == ref[i, 8:].tolist() == reqs[i].generated
        assert len(got["gaps"]) == new and min(got["gaps"]) > 0


@pytest.mark.parametrize("variant", ["mqa", "classic"])
def test_quantize_model_leaves_bit_exact(variant):
    """registry.quantize_model("falcon", ...) (the simulated path's weight
    quantization: query_key_value, dense, dense_h_to_4h, dense_4h_to_h) on
    the same weights and importance vectors: every leaf JAX's, bit for bit
    (the salient permutations int64 against JAX's int32)."""
    from smoothquant_tpu.models.registry import quantize_model as j_quantize_model
    from smoothquant_tpu.quant.config import QuantConfig as JQuantConfig
    from smoothquant_tpu_torch.models.registry import quantize_model

    b = build(variant)
    feat = _feat(b["jcfg"], jfalcon)
    q = w4a4_group(16, 0.1)
    ref = jax.tree.map(np.asarray, j_quantize_model(
        "falcon", b["jparams"], b["jcfg"], JQuantConfig(**dataclasses.asdict(q)), feat))
    got = quantize_model("falcon", params_from_numpy(b["params"], "cpu"), b["tcfg"], q, feat)

    def leaves(t, pre=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, pre + (k,))
        elif t is not None:
            yield pre, t

    ref, got = dict(leaves(ref)), dict(leaves(got))
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), r.astype(got[path].numpy().dtype),
                                      err_msg=str(path))

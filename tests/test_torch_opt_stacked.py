"""OPT's fused, folded and stacked decode on a 2-layer OPT (hidden 256, 4
heads of 64, ffn 512, vocab 256, f32; LayerNorms and biases made random so
each one counts): fuse_projections, the serving pack (nibble, fused qkv,
fc2's perm folded into fc1, tile-aligned), the per-layer packed decode
(K11 with sm_scale 1.0 over the int8 cache: OPT scales q at projection)
and stack_layers' stacked decode (input gathered, K1, K10 with rotary
off, K11 with sm_scale 1.0, the linears' biases) over fp and int8 caches,
fused and unfused — each against the JAX package (Pallas in interpret
mode, jitted) and each other; a post-LN tree declines the stacked decode.

Tolerances: the fused tree, packs and int8 cache codes bit for bit;
logits 2e-4 relative and absolute (the JAX package's own bound for the OPT
stacked decode, tests/test_opt_prefetch.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu.models.common import QuantKVCache as JQuantKVCache
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models.common import KVCache, QuantKVCache
from smoothquant_tpu_torch.models.registry import pack_model
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy

torch.set_num_threads(1)

CACHE_LEN = 128
GS = 16
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jopt.OPTConfig.tiny(), hidden_size=256, ffn_dim=512,
                               num_attention_heads=4, num_hidden_layers=2)
    tcfg = config_from(topt.OPTConfig, jcfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jopt.init_params(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.05).astype(a.dtype)
                          if a.ndim == 1 else a, params)
    feat_rng = np.random.default_rng(1)
    feat = {}
    for i in range(2):
        pre = f"model.decoder.layers.{i}"
        attn_in = feat_rng.uniform(0.1, 1.0, size=(256,))
        for p in ("q_proj", "k_proj", "v_proj"):
            feat[f"{pre}.self_attn.{p}"] = attn_in
        feat[f"{pre}.self_attn.out_proj"] = feat_rng.uniform(0.1, 1.0, size=(256,))
        feat[f"{pre}.fc1"] = feat_rng.uniform(0.1, 1.0, size=(256,))
        feat[f"{pre}.fc2"] = feat_rng.uniform(0.1, 1.0, size=(512,))
    out = dict(jcfg=jcfg, tcfg=tcfg, params=params, qj=jw4a4_group(group_size=GS,
                                                                   salient_prop=0.05),
               jparams=jax.tree.map(jnp.asarray, params),
               tparams=params_from_numpy(params, "cpu"))
    for fused in (True, False):
        kw = dict(input_feat=feat, act_scales=feat, nibble=True, fuse=fused,
                  fold_perms=True, align_k_groups=8, align_o=256)
        out[f"j_packed{fused}"] = jpack_model("opt", out["jparams"], jcfg, out["qj"],
                                              compute_dtype=jnp.float32, **kw)
        out[f"t_packed{fused}"] = pack_model("opt", params_from_numpy(params, "cpu"), tcfg,
                                             w4a4_group(GS, 0.05), **kw)
    return out


def test_fuse_projections_and_listing_match_jax(setup):
    """q / k / v weights and biases concatenated into qkv_proj bit for bit;
    the fused listing shares q_proj's key; the fused fp forward equals the
    unfused one to f32 rounding."""
    s = setup
    ref = jax.tree.map(np.asarray, jopt.fuse_projections(s["jparams"], s["jcfg"]))
    got = topt.fuse_projections(s["tparams"], s["tcfg"])
    for i in range(2):
        r, g = ref["layers"][str(i)]["self_attn"], got["layers"][str(i)]["self_attn"]
        assert sorted(g) == sorted(r) == ["out_proj", "qkv_proj"]
        for f in ("weight", "bias"):
            np.testing.assert_array_equal(g["qkv_proj"][f].numpy(), r["qkv_proj"][f])
    assert topt.quantizable_linears_fused(s["tcfg"]) == [
        (tuple(p), k, q) for p, k, q in jopt.quantizable_linears_fused(s["jcfg"])]
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(2, 9)))
    a = topt.forward(got, ids, s["tcfg"])[0]
    b = topt.forward(s["tparams"], ids, s["tcfg"])[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_serving_pack_matches_jax(setup, fused):
    """pack_model("opt", nibble, fuse, fold_perms, aligned): every field bit
    for bit (fc1's rows carry fc2's folded perm)."""
    s = setup
    listing = (topt.quantizable_linears_fused if fused else topt.quantizable_linears)
    for path, _, _ in listing(s["tcfg"]):
        r, g = s[f"j_packed{fused}"], s[f"t_packed{fused}"]
        for k in path:
            r, g = r[k], g[k]
        assert g.meta.nibble and g.w_qt.shape[-1] % 256 == 0
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm", "bias"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)))


def _stack(cfg, caches, quant_kv):
    b = (caches[0].k_scale if quant_kv else caches[0].k).shape[0]
    st = topt.stacked_caches(cfg, b, CACHE_LEN, torch.float32, quant_kv=quant_kv,
                             pos=caches[0].pos, device="cpu")
    for i, c in enumerate(caches):
        for f in (("k_q", "v_q", "k_scale", "v_scale") if quant_kv else ("k", "v")):
            getattr(st, f)[i].copy_(getattr(c, f))
    return st


@pytest.mark.parametrize("fused,quant_kv", [(True, True), (False, False)])
def test_packed_decode_per_layer_and_stacked_match_jax(setup, fused, quant_kv):
    """A 5-token prefill of the packed per-layer tree, then one token through
    it (K6; K11 with sm_scale 1.0 over the int8 cache) and through
    stack_layers' tree over the stacked copy of its caches (K1, K10 rotary
    off, K11 with sm_scale 1.0, biases) — each against the other and the
    JAX package's run of the same."""
    s = setup
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    jcls, tcls = (JQuantKVCache, QuantKVCache) if quant_kv else (JKVCache, KVCache)
    jctx = JCtx(quant=s["qj"], compute="int", interpret=True)
    jstep = jax.jit(lambda p, i, c: jopt.forward(p, i, jcfg, ctx=jctx, caches=c))
    jp, tp = s[f"j_packed{fused}"], s[f"t_packed{fused}"]
    rng = np.random.default_rng(3)
    prompt, tok = rng.integers(0, 256, size=(2, 5)), np.asarray([[7], [9]])
    _, jc = jstep(jp, jnp.asarray(prompt),
                  [jcls.create(2, CACHE_LEN, 4, 64, jnp.float32) for _ in range(2)])
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jc)
    jref, _ = jstep(jp, jnp.asarray(tok), jc)
    jgot, jgot_c = jstep(jopt.stack_layers(jp, jcfg), jnp.asarray(tok), jst)

    _, tc = topt.forward(tp, torch.from_numpy(prompt), tcfg,
                         caches=[tcls.create(2, CACHE_LEN, 4, 64, torch.float32, "cpu")
                                 for _ in range(2)])
    tst = _stack(tcfg, tc, quant_kv)
    stacked = topt.stack_layers(tp, tcfg)
    assert topt._prefetch_capable(stacked, tcfg, None, tst, 1)
    ref, ref_c = topt.forward(tp, torch.from_numpy(tok), tcfg, caches=tc)
    got, got_c = topt.forward(stacked, torch.from_numpy(tok), tcfg, caches=tst)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    for i, rc in enumerate(ref_c):
        assert int(got_c.pos[i]) == rc.pos == int(jgot_c.pos[i]) == 6
        if quant_kv:
            np.testing.assert_array_equal(got_c.k_q[i].numpy(), rc.k_q.numpy())
            np.testing.assert_array_equal(got_c.v_q[i].numpy(), np.asarray(jgot_c.v_q[i]))


def test_per_layer_int8_decode_runs_k11_at_scale_one(setup, monkeypatch):
    """The per-layer OPT decode over int8 caches under "auto" sends each
    layer's single query to K11 with sm_scale 1.0, once a layer a step (no
    einsum); the Generator's tokens equal those of the einsum ("einsum")."""
    s = setup
    seen = []
    plain = k11.decode_attention_stacked

    def spy(*a, **kw):
        seen.append(kw.get("sm_scale"))
        return plain(*a, **kw)

    monkeypatch.setattr(k11, "decode_attention_stacked", spy)
    prompt = np.random.default_rng(4).integers(0, 256, size=(2, 8))
    gen = Generator(topt, s["t_packedTrue"], s["tcfg"],
                    max_len=CACHE_LEN, quant_kv=True, device="cpu")
    toks = gen.generate(prompt, GenerationConfig(max_new_tokens=4))
    assert seen == [1.0] * (2 * 3)                  # 3 decode steps, 2 layers
    ein = Generator(topt, s["t_packedTrue"], s["tcfg"], max_len=CACHE_LEN, quant_kv=True,
                    attn="einsum", device="cpu").generate(prompt,
                                                          GenerationConfig(max_new_tokens=4))
    assert len(seen) == 6
    np.testing.assert_array_equal(toks, ein)


def test_post_ln_tree_declines_the_stacked_decode(setup):
    """do_layer_norm_before=False (OPT-350m's post-LN) keeps the per-layer
    body over the stack, as JAX's gate does: logits 2e-4 of JAX's."""
    s = setup
    jcfg = dataclasses.replace(s["jcfg"], do_layer_norm_before=False)
    tcfg = config_from(topt.OPTConfig, jcfg)
    stacked = topt.stack_layers(s["t_packedTrue"], tcfg)
    cache = topt.stacked_caches(tcfg, 2, CACHE_LEN, quant_kv=True, pos=3, device="cpu")
    assert not topt._prefetch_capable(stacked, tcfg, None, cache, 1)
    jcache = jopt.stacked_caches(jcfg, 2, CACHE_LEN, jnp.float32, pos=3, quant_kv=True)
    tok = np.asarray([[7], [9]])
    ref, ref_c = jax.jit(lambda p, t, c: jopt.forward(
        p, t, jcfg, ctx=JCtx(compute="int", interpret=True), caches=c))(
        jopt.stack_layers(s["j_packedTrue"], jcfg), jnp.asarray(tok), jcache)
    got, got_c = topt.forward(stacked, torch.from_numpy(tok), tcfg, caches=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got_c.pos.numpy(), np.asarray(ref_c.pos))

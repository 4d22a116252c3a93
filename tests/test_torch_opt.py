"""The fp OPT port (models/opt.py), its calibration (quant/calibrate.py) and
SmoothQuant smoothing (quant/smooth.py, registry.smooth_lm) against the JAX
package on OPTConfig.tiny(), f32, the same weights carried across.

Tolerances: logits and calibration statistics 1e-5 relative (f32 sums in
another order; XLA's CPU rsqrt in the LayerNorm is not 1/√v correctly
rounded); smoothed weights within 2 ulp (jnp.power and torch.pow may round
the last bit apart)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu.models.registry import smooth_lm as j_smooth_lm
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache
from smoothquant_tpu_torch.models.registry import smooth_lm
from smoothquant_tpu_torch.quant import calibrate as tcal
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def model():
    jcfg = jopt.OPTConfig.tiny()
    tcfg = topt.OPTConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(topt.OPTConfig)})
    params = jopt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab_size, size=(1, 16)) for _ in range(3)]
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batches=batches,
                tparams=params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def _jfwd(cfg):
    return lambda p, ids, col: jopt.forward(p, ids, cfg, ctx=JCtx(taps=col))


def _tfwd(cfg):
    return lambda p, ids, col: topt.forward(p, torch.as_tensor(ids), cfg,
                                            ctx=ForwardContext(taps=col))


@pytest.mark.parametrize("variant", [{}, {"do_layer_norm_before": False},
                                     {"word_embed_proj_dim": 32}])
def test_forward_matches_jax(variant):
    """Pre-LN, post-LN (opt-350m's layout) and project_in / project_out."""
    jcfg = dataclasses.replace(jopt.OPTConfig.tiny(), **variant)
    tcfg = topt.OPTConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(topt.OPTConfig)})
    params = jopt.init_params(jax.random.PRNGKey(1), jcfg)
    assert ("project_in" in params) == ("word_embed_proj_dim" in variant)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 9))
    ref = jax.jit(lambda p, i: jopt.forward(p, i, jcfg)[0])(params, jnp.asarray(ids))
    got, caches = topt.forward(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                               torch.from_numpy(ids), tcfg)
    assert caches is None and got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_cached_forward_matches_jax(model):
    """A 6-token prefill into per-layer fp caches, then two single-token
    steps: logits and the written cache rows as JAX's."""
    m = model
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 8))
    jc = [JKVCache.create(2, 32, jcfg.num_attention_heads, jcfg.head_dim, jnp.float32)
          for _ in range(jcfg.num_hidden_layers)]
    tc = [KVCache.create(2, 32, tcfg.num_attention_heads, tcfg.head_dim, torch.float32,
                         "cpu") for _ in range(tcfg.num_hidden_layers)]
    step = jax.jit(lambda p, i, c: jopt.forward(p, i, jcfg, caches=c))
    for lo, hi in ((0, 6), (6, 7), (7, 8)):
        ref, jc = step(m["params"], jnp.asarray(ids[:, lo:hi]), jc)
        got, tc = topt.forward(m["tparams"], torch.from_numpy(ids[:, lo:hi]), tcfg,
                               caches=tc)
        _close(got.numpy(), ref)
        assert tc[0].pos == hi
    _close(tc[1].k.numpy(), jc[1].k)
    _close(tc[1].v.numpy(), jc[1].v)


@pytest.mark.parametrize("stat", ["act_scales", "calib_feat", "static"])
def test_calibration_matches_jax(model, stat):
    m = model
    fn = {"act_scales": "get_act_scales", "calib_feat": "get_calib_feat",
          "static": "get_static_act_dict"}[stat]
    ref = getattr(jcal, fn)(_jfwd(m["jcfg"]), m["params"],
                            [jnp.asarray(b) for b in m["batches"]])
    got = getattr(tcal, fn)(_tfwd(m["tcfg"]), m["tparams"], m["batches"])
    assert sorted(got) == sorted(ref)
    assert len(got) == 6 * m["jcfg"].num_hidden_layers
    for name in ref:
        if stat == "static":
            assert sorted(got[name]) == ["input", "output"]
            for k in ("input", "output"):
                assert isinstance(got[name][k], float)
                _close(got[name][k], ref[name][k])
        else:
            assert got[name].dtype == ref[name].dtype
            _close(got[name], ref[name])


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_smooth_lm_matches_jax(model):
    """The same activation scales smooth the same weights to within 2 ulp."""
    m = model
    act = jcal.get_act_scales(_jfwd(m["jcfg"]), m["params"],
                              [jnp.asarray(b) for b in m["batches"]])
    ref = jax.tree.map(np.asarray, j_smooth_lm("opt", m["params"], m["jcfg"], act, 0.5))
    got = smooth_lm("opt", m["tparams"], m["tcfg"], act, 0.5)
    moved = 0
    for i in range(m["jcfg"].num_hidden_layers):
        rl, gl = ref["layers"][str(i)], got["layers"][str(i)]
        pairs = [(gl[n][k], rl[n][k]) for n in ("self_attn_layer_norm", "final_layer_norm")
                 for k in ("weight", "bias")]
        pairs += [(gl["self_attn"][p]["weight"], rl["self_attn"][p]["weight"])
                  for p in ("q_proj", "k_proj", "v_proj")]
        pairs.append((gl["fc1"]["weight"], rl["fc1"]["weight"]))
        for g, r in pairs:
            assert _ulp_diff(g.numpy(), r).max() <= 2
        moved += int(np.abs(gl["fc1"]["weight"].numpy()
                            - np.asarray(m["params"]["layers"][str(i)]["fc1"]["weight"])
                            ).max() > 0)
        # untouched by smoothing
        np.testing.assert_array_equal(gl["fc2"]["weight"].numpy(), rl["fc2"]["weight"])
    assert moved == m["jcfg"].num_hidden_layers


def test_static_layer_scales_match_jax(model):
    m = model
    batches = [jnp.asarray(b) for b in m["batches"]]
    n_l = m["jcfg"].num_hidden_layers
    ref = jcal.get_static_decoder_layer_scales_opt(
        jcal.get_static_act_dict(_jfwd(m["jcfg"]), m["params"], batches), n_l)
    got = tcal.get_static_decoder_layer_scales_opt(
        tcal.get_static_act_dict(_tfwd(m["tcfg"]), m["tparams"], m["batches"]), n_l)
    assert len(got) == n_l
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert isinstance(g[k], float) and g[k] > 0
            _close(g[k], r[k])


def test_make_calib_batches():
    stream = np.arange(50)
    blocks = tcal.make_calib_batches(stream, 4, 16)
    assert [b.shape for b in blocks] == [(1, 16)] * 3
    np.testing.assert_array_equal(blocks[2][0], np.arange(32, 48))


def test_unported_trees_raise(model):
    """stack_layers and fuse_projections build their trees now (a leading L
    axis; q / k / v fused into qkv_proj); what the port still refuses
    raises: a stacked tree under calibration taps (JAX: taps unsupported
    with scan) and OPT's shared residual basis (no residual_consumers)."""
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model
    from smoothquant_tpu_torch.quant.config import w4a4_group

    tcfg = model["tcfg"]
    stacked = topt.stack_layers(model["tparams"], tcfg)
    w = stacked["layers"]["stacked"]["fc1"]["weight"]
    assert w.shape[0] == tcfg.num_hidden_layers
    fused = topt.fuse_projections(model["tparams"], tcfg)
    assert "qkv_proj" in fused["layers"]["0"]["self_attn"]
    with pytest.raises(NotImplementedError):
        topt.forward(stacked, torch.zeros((1, 4), dtype=torch.int64), tcfg,
                     ctx=ForwardContext(taps=object()))
    with pytest.raises(NotImplementedError):
        pack_model("opt", model["tparams"], tcfg, w4a4_group(16, 0.0),
                   shared_residual_basis=True)

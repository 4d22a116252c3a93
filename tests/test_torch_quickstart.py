"""The README quick start as a slice, on a 2-layer Llama (hidden 256, 4
heads over 2 kv heads, f32): the same numpy weights through calibration
(get_act_scales, get_calib_feat over the tapped per-layer forward) →
smooth_lm("llama", α = 0.85) → pack_model with its defaults (per-layer
int8-container packs, W4A4 g64, 5 % salient) → forward logits in "int" and
"dequant" compute → 8 greedy Generator tokens over int8 caches, each stage
of the port against the JAX package's own run of it.

Tolerances: calibration statistics 1e-5 relative (f32 sums in another
order); from the same activation statistics, smoothing scales within 2
ulp (jnp.power and torch.pow each round the last bit apart) and smoothed
weights within 3 (the product carries the scale's difference); from the
same smoothed weights and statistics, packs bit for bit; on those packs,
logits within 1e-3 of their norm (each linear agrees to f32 rounding, and
a per-group int4 activation code on a rounding edge may move between the
two) and the Generator's tokens identical; the port's own pipeline end to
end within 1e-2 of the norm of JAX's logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import real_linear as jreal
from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import smooth_lm as j_smooth_lm
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu.serve.generate import GenerationConfig as JGenConfig
from smoothquant_tpu.serve.generate import Generator as JGenerator
from smoothquant_tpu_torch.kernels import real_linear as treal
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.models.registry import pack_model, smooth_lm
from smoothquant_tpu_torch.quant import calibrate as tcal
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

ALPHA = 0.85
CROSSOVER = 16      # both packages' int-path row limit, set alike for the test


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def quickstart():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=256,
                               intermediate_size=512, num_attention_heads=4,
                               num_key_value_heads=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab_size, size=(1, 32)) for _ in range(2)]

    jfwd = lambda p, ids, col: jllama.forward(p, jnp.asarray(ids), jcfg, ctx=JCtx(taps=col))
    tfwd = lambda p, ids, col: tllama.forward(p, torch.as_tensor(ids), tcfg,
                                              ctx=ForwardContext(taps=col))
    out = dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams)
    for side, fwd, p, cal in (("j", jfwd, params, jcal), ("t", tfwd, tparams, tcal)):
        out[f"{side}_scales"] = cal.get_act_scales(fwd, p, batches)
        out[f"{side}_feat"] = cal.get_calib_feat(fwd, p, batches)
    qj, qt = jw4a4_group(group_size=64, salient_prop=0.05), w4a4_group(64, 0.05)
    out["j_smoothed"] = j_smooth_lm("llama", params, jcfg, out["j_scales"], ALPHA)
    out["t_smoothed"] = smooth_lm("llama", tparams, tcfg, out["t_scales"], ALPHA)
    out["j_packed"] = jpack_model("llama", out["j_smoothed"], jcfg, qj,
                                  input_feat=out["j_feat"], act_scales=out["j_scales"])
    # the port's pack of JAX's smoothed weights and statistics (each stage
    # held to JAX's on the same inputs), and its own pipeline end to end
    out["t_packed"] = pack_model(
        "llama", params_from_numpy(jax.tree.map(np.asarray, out["j_smoothed"]), "cpu"),
        tcfg, qt, input_feat=out["j_feat"], act_scales=out["j_scales"])
    out["t_own"] = pack_model("llama", out["t_smoothed"], tcfg, qt,
                              input_feat=out["t_feat"], act_scales=out["t_scales"])
    return out


@pytest.mark.parametrize("stat", ["scales", "feat"])
def test_calibration_keys_and_values_match_jax(quickstart, stat):
    """The tapped per-layer forward names every call site as JAX does."""
    ref, got = quickstart[f"j_{stat}"], quickstart[f"t_{stat}"]
    n_l = quickstart["jcfg"].num_hidden_layers
    assert sorted(got) == sorted(ref)
    assert len(got) == 7 * n_l
    assert "model.layers.1.self_attn.q_proj" in got and "model.layers.0.mlp.down_proj" in got
    for name in ref:
        assert got[name].dtype == ref[name].dtype
        _close(got[name], ref[name])


@pytest.mark.parametrize("alpha", [0.5, ALPHA])
def test_smooth_lm_matches_jax(quickstart, alpha):
    """With the same activation scales, smooth_lm("llama") smooths the norms
    and the q/k/v and gate/up weights as JAX does and leaves o / down
    untouched.  jnp.power and torch.pow each round the last bit apart, so
    every smoothing map entry's scales agree within 2 ulp; the smoothed
    weights, each a correctly rounded w·s (or norm / s), within 3."""
    from smoothquant_tpu.quant.smooth import compute_smoothing_scales as j_scales_of
    from smoothquant_tpu_torch.quant.smooth import compute_smoothing_scales

    q = quickstart
    params = jax.tree.map(np.asarray, q["params"])
    for norm_path, lin_paths, key in tllama.smoothing_map(q["tcfg"]):
        ws = []
        for p in lin_paths:
            node = params
            for k in p:
                node = node[k]
            ws.append(node["weight"])
        ref = np.asarray(j_scales_of(jnp.asarray(q["j_scales"][key]),
                                     [jnp.asarray(w) for w in ws], alpha))
        got = compute_smoothing_scales(q["j_scales"][key],
                                       [torch.from_numpy(np.array(w)) for w in ws], alpha)
        assert _ulp_diff(got.numpy(), ref).max() <= 2
    ref = jax.tree.map(np.asarray, j_smooth_lm("llama", q["params"], q["jcfg"],
                                               q["j_scales"], alpha))
    got = smooth_lm("llama", q["tparams"], q["tcfg"], q["j_scales"], alpha)
    for i in range(q["jcfg"].num_hidden_layers):
        rl, gl, ol = ref["layers"][str(i)], got["layers"][str(i)], params["layers"][str(i)]
        pairs = [(gl[n]["weight"], rl[n]["weight"])
                 for n in ("input_layernorm", "post_attention_layernorm")]
        pairs += [(gl["self_attn"][p]["weight"], rl["self_attn"][p]["weight"])
                  for p in ("q_proj", "k_proj", "v_proj")]
        pairs += [(gl["mlp"][p]["weight"], rl["mlp"][p]["weight"])
                  for p in ("gate_proj", "up_proj")]
        for g, r in pairs:
            assert _ulp_diff(g.numpy(), r).max() <= 3
        assert np.abs(gl["mlp"]["gate_proj"]["weight"].numpy()
                      - ol["mlp"]["gate_proj"]["weight"]).max() > 0
        for n, p in (("self_attn", "o_proj"), ("mlp", "down_proj")):
            np.testing.assert_array_equal(gl[n][p]["weight"].numpy(), rl[n][p]["weight"])


def test_packs_match_jax(quickstart):
    """From JAX's smoothed weights and statistics, the port's default pack
    is JAX's, bit for bit."""
    q = quickstart
    for path, _, _ in tllama.quantizable_linears(q["tcfg"]):
        r, g = q["j_packed"], q["t_packed"]
        for k in path:
            r, g = r[k], g[k]
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(r, f)))


def test_own_pipeline_end_to_end(quickstart):
    """The port's quick start from its own calibration, smoothing and pack:
    near-ties of the statistics' last bits may order a few channels
    differently in the static sort, so its logits are held to 1e-2 of the
    norm of JAX's (W4A4 itself moves them ~0.3 from fp)."""
    q = quickstart
    ids = np.random.default_rng(5).integers(0, q["jcfg"].vocab_size, size=(2, 12))
    ref = np.asarray(jax.jit(lambda p, i: jllama.forward(
        p, i, q["jcfg"], ctx=JCtx(interpret=True))[0])(q["j_packed"], jnp.asarray(ids)))
    got, _ = tllama.forward(q["t_own"], torch.from_numpy(ids), q["tcfg"])
    assert np.linalg.norm(got.numpy() - ref) <= 1e-2 * np.linalg.norm(ref)


@pytest.fixture
def same_crossover(monkeypatch):
    monkeypatch.setattr(jreal, "_TUNED_LOADED", True)
    monkeypatch.setattr(jreal, "_INT_PATH_MAX_TOKENS", CROSSOVER)
    monkeypatch.setattr(treal, "INT_PATH_MAX_TOKENS", CROSSOVER)


@pytest.mark.parametrize("compute", ["int", "dequant", "auto"])
def test_forward_logits_match_jax(quickstart, compute, same_crossover):
    """The packed per-layer forward over two 12-token prompts (24 rows:
    "auto" takes the dequant path) in each compute mode."""
    q = quickstart
    ids = np.random.default_rng(3).integers(0, q["jcfg"].vocab_size, size=(2, 12))
    ref = jax.jit(lambda p, i: jllama.forward(
        p, i, q["jcfg"], ctx=JCtx(compute=compute, interpret=True))[0])(
        q["j_packed"], jnp.asarray(ids))
    got, _ = tllama.forward(q["t_packed"], torch.from_numpy(ids), q["tcfg"],
                            ctx=ForwardContext(compute=compute))
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got.numpy()).all()
    assert np.linalg.norm(got.numpy() - ref) <= 1e-3 * np.linalg.norm(ref)


def test_generator_tokens_identical_to_jax(quickstart, same_crossover):
    """8 greedy tokens over int8 caches: a 2 × 16-row prefill on the dequant
    path (K9), then 2-row decode steps on the int path (K8)."""
    q = quickstart
    prompt = np.random.default_rng(4).integers(0, q["jcfg"].vocab_size, size=(2, 16))
    jgen = JGenerator(jllama, q["j_packed"], q["jcfg"], max_len=32, quant_kv=True,
                      interpret=True)
    tgen = Generator(tllama, q["t_packed"], q["tcfg"], max_len=32, quant_kv=True,
                     device="cpu")
    ref = jgen.generate(prompt, JGenConfig(max_new_tokens=8))
    got = tgen.generate(prompt, GenerationConfig(max_new_tokens=8))
    assert got.shape == (2, 24)
    np.testing.assert_array_equal(got, ref)


def test_forward_context_rules(quickstart, same_crossover):
    """compute is validated; quant on an fp linear runs the simulated path
    (the activation Q-DQ moves the fp logits); on a packed tree
    quantize_bmm_input quantizes the q / k / v outputs with the recipe's
    activation quantizer, held to JAX's packed forward as
    test_forward_logits_match_jax is (its prompts; an int8 per-token BMM
    quantizer: with the int4 sorted-group one a code at a rounding edge
    moves, and its effect spreads through the pack's own int4 activation
    codes to 0.17 of the norm), and a recipe that does not quantize BMM
    inputs changes nothing."""
    q = quickstart
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, q["jcfg"].vocab_size,
                                                             size=(2, 12)))
    with pytest.raises(ValueError):
        ForwardContext(compute="fast")
    fp, _ = tllama.forward(q["tparams"], ids, q["tcfg"])
    sim, _ = tllama.forward(q["tparams"], ids, q["tcfg"], ctx=ForwardContext(quant=w4a4_group()))
    assert torch.isfinite(sim).all() and not torch.equal(sim, fp)
    kw = dict(quantize_bmm_input=True, act_quant="per_token", act_bits=8)
    bmm = dataclasses.replace(w4a4_group(64, 0.05), **kw)
    got, _ = tllama.forward(q["t_packed"], ids, q["tcfg"], ctx=ForwardContext(quant=bmm))
    jbmm = dataclasses.replace(jw4a4_group(64, 0.05), **kw)
    ref = np.asarray(jax.jit(lambda p, i: jllama.forward(
        p, i, q["jcfg"], ctx=JCtx(quant=jbmm, interpret=True))[0])(
        q["j_packed"], jnp.asarray(ids.numpy())))
    assert np.linalg.norm(got.numpy() - ref) <= 1e-3 * np.linalg.norm(ref)
    a, _ = tllama.forward(q["t_packed"], ids, q["tcfg"],
                          ctx=ForwardContext(quant=w4a4_group(64, 0.05)))
    b, _ = tllama.forward(q["t_packed"], ids, q["tcfg"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(got, b)

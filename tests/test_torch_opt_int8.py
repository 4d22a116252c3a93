"""The real-INT8 OPT port (models/opt_int8.py over K15a, K15b, K16 in their
plain versions) against the JAX package on OPTConfig.tiny(): the JAX export
(tests/test_opt_int8.py's pipeline: calibrate → smooth → static scales →
from_float) carried across by utils/convert.py, so both packages run the
same int8 model; and the port's own export end to end.

from_float is bit-identical.  Logits: the int8 codes match on these
inputs, and the logits differ only in the last bits of the f32 glue (XLA's
rsqrt in the final LayerNorm, sum orders): held to 1e-5 of their norm
and identical argmax.  A last-bit difference of the glue could move a
softmax probability or a LayerNorm output across a rounding edge on other
inputs, and attention would spread it; a wrong kernel or scale misses by
the logits' whole norm."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models import opt_int8 as jint8
from smoothquant_tpu.models.registry import smooth_lm as j_smooth_lm
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu.serve import GenerationConfig as JGenCfg
from smoothquant_tpu.serve import Generator as JGenerator
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models import opt_int8 as tint8
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache
from smoothquant_tpu_torch.models.registry import smooth_lm
from smoothquant_tpu_torch.quant import calibrate as tcal
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import int8_opt_from_numpy, params_from_numpy

torch.set_num_threads(1)

REL_NORM = 1e-5


@pytest.fixture(scope="module")
def exported():
    jcfg = jopt.OPTConfig.tiny()
    tcfg = topt.OPTConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(topt.OPTConfig)})
    params = jopt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab_size, size=(1, 16)) for _ in range(3)]

    def fwd(p, ids, col):
        jopt.forward(p, ids, jcfg, ctx=JCtx(taps=col))

    jb = [jnp.asarray(b) for b in batches]
    act_scales = jcal.get_act_scales(fwd, params, jb)
    smoothed = j_smooth_lm("opt", params, jcfg, act_scales, alpha=0.5)
    layer_scales = jcal.get_static_decoder_layer_scales_opt(
        jcal.get_static_act_dict(fwd, smoothed, jb), jcfg.num_hidden_layers)
    int8_params = jint8.from_float(smoothed, jcfg, layer_scales)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, smoothed=smoothed,
                layer_scales=layer_scales, int8=int8_params, batches=batches,
                tparams=params_from_numpy(np_tree(params), "cpu"),
                tsmoothed=params_from_numpy(np_tree(smoothed), "cpu"),
                tint8=int8_opt_from_numpy(np_tree(int8_params), "cpu"))


def test_from_float_bit_identical(exported):
    e = exported
    got = tint8.from_float(e["tsmoothed"], e["tcfg"], e["layer_scales"])
    assert sorted(got) == ["embed_positions", "embed_tokens", "final_layer_norm",
                           "int8_layers"]
    for gl, rl in zip(got["int8_layers"], e["int8"]["int8_layers"]):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            g, r = getattr(gl, p), getattr(rl, p)
            assert g.w_q.dtype == torch.int8 and g.bias.dtype == torch.float32
            np.testing.assert_array_equal(g.w_q.numpy(), np.asarray(r.w_q))
            np.testing.assert_array_equal(g.bias.numpy(), np.asarray(r.bias))
            assert isinstance(g.alpha, float)
            assert np.float32(g.alpha) == np.asarray(r.alpha)
        assert gl.scales == rl.scales


def _rel_norm(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref) / np.linalg.norm(ref))


def test_forward_matches_jax(exported):
    e = exported
    ids = np.concatenate(e["batches"][:2])                       # (2, 16)
    ref = np.asarray(jint8.forward(e["int8"], jnp.asarray(ids), e["jcfg"],
                                   interpret=True)[0])
    got, caches = tint8.forward(e["tint8"], torch.from_numpy(ids), e["tcfg"])
    assert caches is None and got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_norm(got.numpy(), ref) <= REL_NORM
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


def test_forward_is_causal(exported):
    e = exported
    ids = e["batches"][0].copy()
    full, _ = tint8.forward(e["tint8"], torch.from_numpy(ids), e["tcfg"])
    ids[0, -1] = (ids[0, -1] + 1) % e["tcfg"].vocab_size
    pert, _ = tint8.forward(e["tint8"], torch.from_numpy(ids), e["tcfg"])
    np.testing.assert_array_equal(full[:, :-1].numpy(), pert[:, :-1].numpy())


def test_cached_decode_equals_teacher_forced(exported):
    """A 6-token prefill into int8 KVCaches then single-token steps give the
    teacher-forced logits at each position bit for bit: the caches hold the
    exact static-scale int8 k / v the full forward computes."""
    e = exported
    cfg = e["tcfg"]
    ids = torch.from_numpy(e["batches"][1][:, :9])
    full, _ = tint8.forward(e["tint8"], ids, cfg)
    caches = [KVCache.create(1, 16, cfg.num_attention_heads, cfg.head_dim, torch.int8, "cpu")
              for _ in range(cfg.num_hidden_layers)]
    lg, caches = tint8.forward(e["tint8"], ids[:, :6], cfg, caches=caches)
    assert caches[0].k.dtype == torch.int8 and caches[0].pos == 6
    torch.testing.assert_close(lg, full[:, :6], rtol=1e-6, atol=1e-6)
    for t in range(6, 9):
        lg, caches = tint8.forward(e["tint8"], ids[:, t:t + 1], cfg, caches=caches)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=1e-6, atol=1e-6)


def test_generator_tokens_match_jax(exported):
    """Generator(kv_dtype=int8): greedy tokens identical to the JAX
    Generator(kv_dtype=jnp.int8) on the same prompts."""
    e = exported
    prompts = np.concatenate([e["batches"][0][:, :6], e["batches"][2][:, 3:9]])
    ref = JGenerator(jint8, e["int8"], e["jcfg"], kv_dtype=jnp.int8, max_len=32,
                     interpret=True).generate(prompts, JGenCfg(max_new_tokens=8))
    got = Generator(tint8, e["tint8"], e["tcfg"], kv_dtype=torch.int8, max_len=32,
                    device="cpu").generate(prompts, GenerationConfig(max_new_tokens=8))
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_own_export_tracks_fp(exported):
    """The port's own pipeline (calibrate → smooth_lm → static scales →
    from_float) on the same fp weights: the int8 model's top-1 agrees with
    the smoothed fp model's on most positions (test_opt_int8.py:57-66)."""
    e = exported
    cfg = e["tcfg"]

    def fwd(p, ids, col):
        topt.forward(p, torch.as_tensor(ids), cfg, ctx=ForwardContext(taps=col))

    act = tcal.get_act_scales(fwd, e["tparams"], e["batches"])
    smoothed = smooth_lm("opt", e["tparams"], cfg, act, alpha=0.5)
    scales = tcal.get_static_decoder_layer_scales_opt(
        tcal.get_static_act_dict(fwd, smoothed, e["batches"]), cfg.num_hidden_layers)
    int8 = tint8.from_float(smoothed, cfg, scales)
    ids = torch.from_numpy(e["batches"][0])
    fp, _ = topt.forward(smoothed, ids, cfg)
    q, _ = tint8.forward(int8, ids, cfg)
    assert torch.isfinite(q).all()
    agree = (fp.argmax(-1) == q.argmax(-1)).float().mean().item()
    assert agree > 0.7, f"top-1 agreement {agree}"

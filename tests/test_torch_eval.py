"""The port's perplexity evaluation and model-size accounting
(smoothquant_tpu_torch/eval) against the JAX package's.

Tolerances: window_nll within 1e-6 relative (log_softmax in float32, its
sum of exponentials in another order); the Evaluator's perplexity within
1e-6 relative on the same logits, and within 1e-5 over a tiny fp Llama
(its logits themselves differ by f32 rounding); the model-size functions
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.eval import Evaluator as JEvaluator
from smoothquant_tpu.eval import bits_to_mib as j_bits_to_mib
from smoothquant_tpu.eval import count_params as j_count_params
from smoothquant_tpu.eval import get_model_size as j_get_model_size
from smoothquant_tpu.eval import get_model_size_bits as j_get_model_size_bits
from smoothquant_tpu.eval.ppl import window_nll as j_window_nll
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu_torch.eval import (
    Evaluator,
    bits_to_mib,
    count_params,
    get_model_size,
    get_model_size_bits,
    window_nll,
)
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.registry import pack_model
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("vocab,window", [(32, 16), (257, 64), (1000, 9)])
def test_window_nll_matches_jax(vocab, window):
    rng = np.random.default_rng(vocab)
    logits = (rng.normal(size=(1, window, vocab)) * 4.0).astype(np.float32)
    ids = rng.integers(0, vocab, size=(1, window))
    ref = float(jax.jit(j_window_nll, static_argnums=2)(jnp.asarray(logits),
                                                          jnp.asarray(ids), window))
    got = window_nll(torch.from_numpy(logits), torch.from_numpy(ids), window)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("n_samples", [None, 3])
def test_evaluator_matches_jax_on_the_same_logits(n_samples):
    """The same logits through both evaluators: each token's row of one
    random (V, V) table (a function of the ids, as the JAX evaluator jits
    its logits_fn once and runs it on every window)."""
    vocab, window, n = 48, 32, 4
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, vocab, size=(window * n + 5,))
    table = (rng.normal(size=(vocab, vocab)) * 3.0).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    ref = JEvaluator(tokens, n_samples, window).evaluate(lambda ids: jt[ids])
    got = Evaluator(tokens, n_samples, window, device="cpu").evaluate(lambda ids: tt[ids])
    assert got == pytest.approx(ref, rel=1e-6)


def test_evaluator_reference_cases():
    """Uniform logits give PPL = V exactly (the window multiplier telescopes),
    a model that puts its mass on the next token gives 1, too few tokens
    raise, and the default device is the card."""
    vocab, window = 64, 32
    tokens = np.random.default_rng(0).integers(0, vocab, size=(window * 3,))
    ev = Evaluator(tokens, window=window, device="cpu")
    assert ev.evaluate(lambda ids: torch.zeros((1, ids.shape[1], vocab))) == pytest.approx(
        vocab, rel=1e-4)

    def perfect(ids):
        nxt = torch.cat([ids[:, 1:], ids[:, -1:]], dim=1)
        return torch.nn.functional.one_hot(nxt, vocab).float() * 100.0

    assert ev.evaluate(perfect) == pytest.approx(1.0, abs=1e-3)
    with pytest.raises(ValueError):
        Evaluator(np.arange(10), n_samples=2, window=32, device="cpu").evaluate(
            lambda ids: torch.zeros((1, ids.shape[1], 4)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Evaluator(tokens, window=window)


def test_evaluator_on_a_tiny_llama_matches_jax():
    """4 windows of 32 tokens through a tiny fp Llama, each package's own
    forward on the same weights."""
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(4 * 32,))
    ref = JEvaluator(tokens, 4, 32).evaluate(lambda ids: jllama.forward(params, ids, jcfg)[0])
    got = Evaluator(tokens, 4, 32, device="cpu").evaluate(
        lambda ids: tllama.forward(tparams, ids, tcfg)[0])
    assert got == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("n,width,p,g", [(6_738_415_616, 16, 0.0, -1),
                                         (6_738_415_616, 4, 0.10, 128),
                                         (1000, 4, 0.1, 64), (1000, 8, 0.0, 32)])
def test_model_size_formula_exact(n, width, p, g):
    """The reference's model_size.py formula, exactly as JAX computes it;
    Llama-2-7B in fp16 is the README's 12852 MiB."""
    got = get_model_size_bits(n, width, p, g)
    assert got == j_get_model_size_bits(n, width, p, g)
    assert bits_to_mib(got) == j_bits_to_mib(got)
    if (n, width) == (6_738_415_616, 16):
        assert abs(bits_to_mib(got) - 12852) < 1


def test_count_params_matches_jax():
    """Every array leaf counted: the fp tiny Llama as JAX counts it, and a
    packed tree (its PackedLinear leaves walked through) as the sum of its
    fields."""
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert count_params(tparams) == j_count_params(params)
    assert get_model_size(tparams, 4, 0.05, 64) == j_get_model_size(params, 4, 0.05, 64)
    packed = pack_model("llama", tparams, tcfg, w4a4_group(32))
    lin = packed["layers"]["0"]["self_attn"]["q_proj"]
    per_lin = sum(t.numel() for t in (lin.w_qt, lin.w_scales_t, lin.w_sal_t, lin.bias,
                                      lin.perm, lin.ns_mask) if t is not None)
    assert count_params(lin) == per_lin
    assert count_params({"a": [np.zeros(3), (torch.ones(2, 2), None)]}) == 7

"""The simulated path's Q-DQ library (quant/core.py), saliency
(quant/saliency.py) and quantized linear (quant/linear.py) against the JAX
package, on the same numpy inputs from a seed.

Each function is held to JAX in the mode the reference flow runs it: the
weight quantizers and quantize_linear_params EAGERLY (cli/ppl_eval.py
quantizes the weights before it jits anything: the division by q_max is
exact), the activation quantizers under jax.jit (the forward: a multiply by
the f32 reciprocal of q_max).  Tolerances: every quantizer, the salient
permutations and the importance vector bit for bit; quant_linear's Q-DQ'd
input bit for bit and its output within 1e-6 of its largest magnitude (an
f32 matmul summed in another order)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from smoothquant_tpu.quant import core as jcore
from smoothquant_tpu.quant import saliency as jsal
from smoothquant_tpu.quant.config import QuantConfig as JQuantConfig
from smoothquant_tpu_torch.quant import core, saliency
from smoothquant_tpu_torch.quant.config import (
    W4A4_PER_CHANNEL,
    W8A8_SMOOTHQUANT,
    QuantConfig,
    w4a4_group,
)

# the packages' quant/__init__ export a function named `linear`, which hides
# the submodule from `from ... import linear`
jlinear = importlib.import_module("smoothquant_tpu.quant.linear")
linear = importlib.import_module("smoothquant_tpu_torch.quant.linear")

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}

# (granularity, sort strategy or None); group sizes apply to the group kinds
KINDS = [("per_channel", None), ("per_tensor", None), ("per_group_unsorted", None),
         ("per_group", "max"), ("per_group", "mean_std"), ("per_group", "argmax")]


def _cases(act: bool):
    out = []
    for name, strat in KINDS:
        if act and name == "per_channel":
            name = "per_token"
        for gs in ((64, 128) if name.startswith("per_group") else (None,)):
            for bits in (4, 8):
                for dt in DTYPES:
                    out.append((name, strat, gs, bits, dt))
    return out


def _ids(case):
    name, strat, gs, bits, dt = case
    return "-".join(str(p) for p in (name, strat, gs, f"{bits}b", dt) if p is not None)


def _to_torch(a: np.ndarray, dt: str) -> torch.Tensor:
    if dt == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t) -> np.ndarray:
    """The raw bits of a tensor / array, for bit-for-bit comparison."""
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().view(np.int16 if t.dtype == torch.int16 else np.int32)
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _weights(rng, shape, dt):
    """Rows of mixed magnitude, a few outlier columns and a dead column:
    the grouping and the sort both matter."""
    w = rng.normal(size=shape) * rng.uniform(0.2, 3.0, size=(shape[0], 1))
    w[:, rng.choice(shape[1], 3, replace=False)] *= 20.0
    w[:, 5] = 0.0
    return w.astype(DTYPES[dt][0])


@pytest.mark.parametrize("case", _cases(act=False), ids=_ids)
def test_weight_quantizer_bit_exact_against_eager_jax(case):
    """Every weight quantizer at an odd input width (padded to whole groups)
    and at a whole number of groups: bit for bit as JAX's, run eagerly."""
    name, strat, gs, bits, dt = case
    rng = np.random.default_rng(bits + (gs or 0))
    kw = dict(group_size=gs or 128, sort_strategy=strat or "max")
    jq = jcore.get_weight_quantizer(name, bits, **kw)
    tq = core.get_weight_quantizer(name, bits, **kw)
    for shape in ((24, 200), (33, 256)):
        w = _weights(rng, shape, dt)
        ref = jq(jnp.asarray(w))
        got = tq(_to_torch(w, dt))
        assert got.dtype == DTYPES[dt][1] and got.shape == shape
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("case", _cases(act=True), ids=_ids)
def test_act_quantizer_bit_exact_against_jitted_jax(case):
    """Every activation quantizer over a (2, 9, C) activation, C odd and a
    whole number of groups: bit for bit as JAX's under jit."""
    name, strat, gs, bits, dt = case
    rng = np.random.default_rng(100 + bits + (gs or 0))
    kw = dict(group_size=gs or 128, sort_strategy=strat or "max")
    jq = jax.jit(jcore.get_act_quantizer(name, bits, **kw))
    tq = core.get_act_quantizer(name, bits, **kw)
    for c in (200, 256):
        x = rng.normal(size=(2, 9, c)) * rng.uniform(0.5, 2.0, size=(2, 9, 1))
        x[..., rng.choice(c, 2, replace=False)] *= 30.0
        x = x.astype(DTYPES[dt][0])
        ref = jq(jnp.asarray(x))
        got = tq(_to_torch(x, dt))
        assert got.shape == x.shape
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("strategy", ["max", "mean_std", "argmax"])
@pytest.mark.parametrize("act", [False, True])
def test_sorted_ties_and_dead_columns(strategy, act):
    """Ties are the rule under "argmax" (the key is a row index: here every
    column peaks in one of 3 rows) and dead (all-zero) columns tie under
    every key: the port's permutation is JAX's stable one, and the sorted
    Q-DQ bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(12, 160)).astype(np.float32)
    peak = rng.integers(0, 3, size=160)
    x[peak, np.arange(160)] = 40.0 * np.sign(rng.normal(size=160))
    x[:, ::9] = 0.0
    key = np.asarray(jcore.sort_key(jnp.asarray(x), strategy))
    assert len(np.unique(key)) < 160 - 10
    perm = core.sorted_group_perm(torch.from_numpy(x), strategy)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jcore.sorted_group_perm(
        jnp.asarray(x), strategy)))
    if act:
        ref = jax.jit(lambda a: jcore.quantize_activation_per_group_absmax_sort(
            a, 4, 32, strategy))(jnp.asarray(x))
        got = core.quantize_activation_per_group_absmax_sort(torch.from_numpy(x), 4, 32,
                                                             strategy)
    else:
        ref = jcore.quantize_weight_per_group_absmax_sort(jnp.asarray(x), 4, 32, strategy)
        got = core.quantize_weight_per_group_absmax_sort(torch.from_numpy(x), 4, 32, strategy)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("in_features,k", [(1, 1), (50, 0), (50, 5), (257, 12), (4096, 204)])
def test_salient_partition_perm_exact(in_features, k):
    """The top-k selection (ties to the lower index) and the partition —
    non-salient channels first, salient last, each ascending: the same
    int32 arrays as JAX's."""
    imp = np.random.default_rng(in_features + k).integers(0, 8, size=in_features)
    idx = saliency.select_salient_indices(imp, k)
    np.testing.assert_array_equal(idx, jsal.select_salient_indices(imp, k))
    got = saliency.salient_partition_perm(in_features, idx)
    ref = jsal.salient_partition_perm(in_features, idx)
    for g, r in zip(got, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_weight_magnitude_importance_exact(dt):
    """From a numpy array or a torch tensor (bf16 read as f32): JAX's float64
    vector, exactly."""
    w = _weights(np.random.default_rng(3), (40, 96), dt)
    ref = jsal.weight_magnitude_importance(jnp.asarray(w))
    for src in (w, _to_torch(w, dt)):
        got = saliency.weight_magnitude_importance(src)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)


def _jcfg(cfg: QuantConfig) -> JQuantConfig:
    return JQuantConfig(**dataclasses.asdict(cfg))


RECIPES = {
    "w8a8_smoothquant": W8A8_SMOOTHQUANT,
    "w4a4_per_channel": W4A4_PER_CHANNEL,
    "w4a4_g32_sorted": w4a4_group(32, 0.1),
    "w4a4_g32_unsorted": QuantConfig(weight_quant="per_group_unsorted",
                                     act_quant="per_group_unsorted", salient_prop=0.1,
                                     group_size=32),
    "w4a4_g32_mean_std": QuantConfig(weight_quant="per_group", act_quant="per_group",
                                     salient_prop=0.1, group_size=32,
                                     sort_strategy="mean_std"),
    "w4a8_per_tensor": QuantConfig(weight_quant="per_tensor", act_quant="per_tensor",
                                   act_bits=8, salient_prop=0.05),
}


def _linear_params(rng, out_f, in_f, dt, bias=True):
    w = _weights(rng, (out_f, in_f), dt)
    b = rng.normal(size=(out_f,)).astype(DTYPES[dt][0]) if bias else None
    return w, b


@pytest.mark.parametrize("salient", [False, True])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_quantize_linear_params_bit_exact(recipe, dt, salient):
    """The Q-DQ'd weight with its salient columns restored, the bias
    untouched, and the salient permutations (int64 here, int32 in JAX)."""
    cfg = RECIPES[recipe]
    rng = np.random.default_rng(5)
    w, b = _linear_params(rng, 48, 200, dt)
    imp = rng.uniform(size=200) if salient else None
    ref = jlinear.quantize_linear_params({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                         _jcfg(cfg), imp)
    got = linear.quantize_linear_params({"weight": _to_torch(w, dt), "bias": _to_torch(b, dt)},
                                        cfg, imp)
    assert set(got) == set(ref)
    assert (("sal_perm" in got) == (salient and cfg.salient_prop > 0))
    np.testing.assert_array_equal(_bits(got["weight"]), _bits(ref["weight"]))
    np.testing.assert_array_equal(_bits(got["bias"]), _bits(ref["bias"]))
    for key in ("sal_perm", "sal_inv_perm", "salient_indices"):
        if key in got:
            assert got[key].dtype == torch.int64
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("quantize_output", [False, True])
@pytest.mark.parametrize("salient", [False, True])
@pytest.mark.parametrize("recipe", ["w8a8_smoothquant", "w4a4_g32_sorted",
                                    "w4a4_g32_unsorted", "w4a8_per_tensor"])
def test_quant_linear_matches_jitted_jax(recipe, salient, quantize_output):
    """quant_linear on the same quantized params and input (2, 5, 200), f32:
    the Q-DQ'd input (the salient columns passed through, the rest
    compacted and quantized as one matrix) bit for bit, y within 1e-6 of its
    largest magnitude; with quantize_output the output's own Q-DQ can move
    a code where y differs in the last bit, so it is held at one step of
    its scale."""
    cfg = RECIPES[recipe]
    if salient and cfg.salient_prop == 0:
        cfg = dataclasses.replace(cfg, salient_prop=0.1)
    rng = np.random.default_rng(9)
    w, b = _linear_params(rng, 48, 200, "float32")
    imp = rng.uniform(size=200) if salient else None
    jp = jlinear.quantize_linear_params({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                        _jcfg(cfg), imp)
    tp = linear.quantize_linear_params({"weight": torch.from_numpy(w),
                                        "bias": torch.from_numpy(b)}, cfg, imp)
    x = (rng.normal(size=(2, 5, 200)) * 2.0).astype(np.float32)
    x[..., 7] *= 25.0
    jx = jax.jit(lambda p, a: jlinear._act_qdq(a.reshape(-1, 200), p, _jcfg(cfg)))(
        jp, jnp.asarray(x))
    tx = linear._act_qdq(torch.from_numpy(x).reshape(-1, 200), tp, cfg)
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    if salient:
        sal = tp["salient_indices"]
        np.testing.assert_array_equal(tx[:, sal].numpy(), x.reshape(-1, 200)[:, sal.numpy()])
    ref = np.asarray(jax.jit(lambda p, a: jlinear.quant_linear(
        p, a, _jcfg(cfg), quantize_output))(jp, jnp.asarray(x)))
    got = linear.quant_linear(tp, torch.from_numpy(x), cfg, quantize_output).numpy()
    assert got.shape == (2, 5, 48)
    step = np.abs(ref).max() / cfg.q_max if quantize_output else 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max() + step)


def test_linear_plain_and_presets():
    """The plain linear; the presets are JAX's."""
    rng = np.random.default_rng(2)
    w, b = _linear_params(rng, 16, 40, "float32")
    x = rng.normal(size=(3, 40)).astype(np.float32)
    ref = np.asarray(jax.jit(jlinear.linear)({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                             jnp.asarray(x)))
    got = linear.linear({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    from smoothquant_tpu.quant import config as jconfig

    assert _jcfg(W8A8_SMOOTHQUANT) == jconfig.W8A8_SMOOTHQUANT
    assert _jcfg(W4A4_PER_CHANNEL) == jconfig.W4A4_PER_CHANNEL

"""The simulated (fake-quant) path of the port on 2-layer Llama, OPT and
Bloom (hidden 128, f32; LayerNorm / RMSNorm weights and biases made random)
against the JAX package: registry.quantize_model's leaves, the forward under
ForwardContext(quant=...) (JAX's under jax.jit, as its Evaluator runs it),
each layer fed the same input, and the port's packed W8A8 path against its
simulated one.  Both packages take the same numpy weights and the JAX
package's calibration vectors (get_calib_feat over two 16-token batches).

Tolerances and why:
  * quantize_model's leaves bit for bit (weights, biases, salient indices);
  * a layer fed the same input: the quantizer codes of its first linears
    (those reading the norm of that input) identical, and at least 99.9 %
    of all its codes.  A code moves only where last-bit differences inside
    the layer (the f32 matmul's sum order, the softmax, SiLU / GELU, the
    RMSNorm factor's rule) push a value across the rounding edge of its
    step, or a sorted group's two columns whose keys lie within a few ulps
    trade places across a group boundary; once one code moves, the
    linears after it in the layer read its effect, so theirs can move too.
    The layer's output: within 1e-5 of its norm where no code moved, else
    within 5e-2 (a moved int4 code is one step of its group's scale);
  * the whole forward (2 × 12 tokens): within 1e-5 of the logits' norm, or,
    since one moved code spreads through every later row and layer, within
    half the quantization's own effect (the norm of JAX's quantized logits
    less its fp logits) — on these models every recipe moves the logits
    2e-2 to 5e-1 from fp, and the packages differ by 3e-7 where no code
    moved and by at most 0.41 of the effect where one did;
  * the packed W8A8 path against the simulated one at 2e-2 (the JAX
    package's bound for the same check, tests/test_packed_model.py)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import bloom as jbloom
from smoothquant_tpu.models import common as jcommon
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models.registry import quantize_model as j_quantize_model
from smoothquant_tpu.quant import calibrate as jcal
from smoothquant_tpu.quant.config import QuantConfig as JQuantConfig
from smoothquant_tpu_torch.models import bloom as tbloom
from smoothquant_tpu_torch.models import common as tcommon
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.models.registry import pack_model, quantize_model
from smoothquant_tpu_torch.quant.config import (
    W4A4_PER_CHANNEL,
    W8A8_SMOOTHQUANT,
    QuantConfig,
    w4a4_group,
)
from smoothquant_tpu_torch.utils.convert import params_from_numpy

jcore = importlib.import_module("smoothquant_tpu.quant.core")
tcore = importlib.import_module("smoothquant_tpu_torch.quant.core")

torch.set_num_threads(1)

SEQ = 12
ARCHES = {"llama": (jllama, tllama, "LlamaConfig", dict(hidden_size=128,
                                                       intermediate_size=256)),
          "opt": (jopt, topt, "OPTConfig", dict(hidden_size=128, ffn_dim=256)),
          "bloom": (jbloom, tbloom, "BloomConfig", dict(hidden_size=128))}
RECIPES = {
    "w8a8_smoothquant": W8A8_SMOOTHQUANT,
    "w4a4_per_channel": W4A4_PER_CHANNEL,
    "w4a4_g16_sorted": w4a4_group(16, 0.1),
    "w4a4_g16_unsorted": QuantConfig(weight_quant="per_group_unsorted",
                                     act_quant="per_group_unsorted", salient_prop=0.1,
                                     group_size=16),
}
W4A4 = [r for r in RECIPES if r.startswith("w4a4")]


def _jcfg(q: QuantConfig) -> JQuantConfig:
    return JQuantConfig(**dataclasses.asdict(q))


def _recipe(name: str, bmm: bool) -> QuantConfig:
    return dataclasses.replace(RECIPES[name], quantize_bmm_input=bmm)


def _randomize(params, rng):
    """Norm weights near 1 and small biases (the initializers make them 1
    and 0), so each one counts."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node is None:
            return None
        a = np.asarray(node)
        if name == "bias":
            return rng.normal(size=a.shape).astype(a.dtype) * 0.05
        if a.ndim == 1:
            return rng.uniform(0.8, 1.2, size=a.shape).astype(a.dtype)
        return a
    return walk(params)


@pytest.fixture(scope="module", params=list(ARCHES))
def model(request):
    arch = request.param
    jm, tm, cls, widths = ARCHES[arch]
    jcfg = dataclasses.replace(getattr(jm, cls).tiny(), **widths)
    tcfg = getattr(tm, cls)(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(getattr(tm, cls))})
    params = _randomize(jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg)),
                        np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, jcfg.vocab_size, size=(1, 16)) for _ in range(2)]
    feat = jcal.get_calib_feat(
        lambda p, ids, col: jm.forward(p, jnp.asarray(ids), jcfg, ctx=JCtx(taps=col)),
        jparams, batches)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, SEQ))
    fp = np.asarray(jax.jit(lambda p, i: jm.forward(p, i, jcfg)[0])(jparams, jnp.asarray(ids)))
    m = dict(arch=arch, jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg, params=params, jparams=jparams,
             feat=feat, ids=ids, fp=fp, sim={})
    return m


def _sim(m, name: str, bmm: bool):
    """(JAX's simulated tree, the port's) for a recipe; both packages'
    quantize_model on the same weights and importance vectors."""
    key = (name, bmm)
    if key not in m["sim"]:
        q = _recipe(name, bmm)
        m["sim"][key] = (
            j_quantize_model(m["arch"], m["jparams"], m["jcfg"], _jcfg(q), m["feat"]),
            quantize_model(m["arch"], params_from_numpy(m["params"], "cpu"), m["tcfg"], q,
                           m["feat"]))
    return m["sim"][key]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_quantize_model_leaves_bit_exact(model, recipe):
    """Every leaf of the port's quantize_model tree is JAX's, bit for bit;
    the salient permutations arrive int64 (JAX keeps int32)."""
    jsim, tsim = _sim(model, recipe, False)
    ref = dict(_leaves(jax.tree.map(np.asarray, jsim)))
    got = dict(_leaves(tsim))
    assert set(got) == set(ref)
    n_sal = 0
    for path, r in ref.items():
        g = got[path]
        if path[-1] in ("sal_perm", "sal_inv_perm", "salient_indices"):
            assert g.dtype == torch.int64
            n_sal += 1
        np.testing.assert_array_equal(g.numpy(), r, err_msg=str(path))
    assert (n_sal > 0) == (RECIPES[recipe].salient_prop > 0)


@pytest.mark.parametrize("bmm", [False, True], ids=["bmm_off", "bmm_on"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_simulated_forward_matches_jitted_jax(model, recipe, bmm):
    """Logits of forward(..., ctx=ForwardContext(quant=q)) against JAX's
    jitted forward, quantize_bmm_input on and off (the module docstring
    gives the bound and its reason)."""
    m = model
    q = _recipe(recipe, bmm)
    jsim, tsim = _sim(m, recipe, bmm)
    ref = np.asarray(jax.jit(lambda p, i: m["jm"].forward(p, i, m["jcfg"], ctx=JCtx(
        quant=_jcfg(q)))[0])(jsim, jnp.asarray(m["ids"])))
    with torch.no_grad():
        got = m["tm"].forward(tsim, torch.from_numpy(m["ids"]), m["tcfg"],
                              ctx=ForwardContext(quant=q))[0].numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    effect = np.linalg.norm(ref - m["fp"]) / np.linalg.norm(m["fp"])
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert effect > 1e-2
    assert rel <= max(1e-5, 0.5 * effect), (rel, effect)


def _layer_fns(m):
    """(JAX layer, port layer): (layer params, x, ctx) → the layer's output,
    over no cache, at positions 0..SEQ-1."""
    arch, jm, tm, jcfg, tcfg = m["arch"], m["jm"], m["tm"], m["jcfg"], m["tcfg"]
    if arch == "llama":
        pos = np.arange(SEQ)[None]
        jt = jcommon.rotary_cos_sin(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
        tt = tcommon.rotary_cos_sin(torch.from_numpy(pos), tcfg.head_dim, tcfg.rope_theta)
        return (lambda lp, x, ctx: jm._decoder_layer(lp, x, jcfg, "l", *jt, ctx, None, None)[0],
                lambda lp, x, ctx: tm._decoder_layer(lp, x, tcfg, "l", *tt, ctx, None, None)[0])
    if arch == "opt":
        return (lambda lp, x, ctx: jm._decoder_layer(lp, x, jcfg, "l", ctx, None, None)[0],
                lambda lp, x, ctx: tm._decoder_layer(lp, x, tcfg, "l", ctx, None, None)[0])
    slopes = jbloom.alibi_slopes(jcfg.num_attention_heads)
    js, ts = jnp.asarray(slopes), torch.as_tensor(slopes)
    return (lambda lp, x, ctx: jm._decoder_layer(lp, x, jcfg, "l", js, ctx, None, None)[0],
            lambda lp, x, ctx: tm._decoder_layer(lp, x, tcfg, "l", ts, ctx, None, None)[0])


class _Codes:
    """Records, in call order, each Q-DQ's integer codes (round(x / scale),
    the quantizer's own division) and each sorted group's permutation, by
    wrapping the core module's qdq and sorted_group_perm; codes() returns
    every call's codes in the ORIGINAL column order (a sorted call's codes
    cut to its width and un-permuted), so two columns that trade places
    inside one group move no code."""

    def __init__(self, mod, rnd, f32):
        self.mod, self.events = mod, []
        self.orig = (mod.qdq, mod.sorted_group_perm)

        def qdq(x, scale):
            self.events.append(("codes", rnd(f32(x) / scale)))
            return self.orig[0](x, scale)

        def perm(x2d, strategy="max"):
            p = self.orig[1](x2d, strategy)
            self.events.append(("perm", p))
            return p

        self.wrapped = (qdq, perm)

    def __enter__(self):
        self.events.clear()
        self.mod.qdq, self.mod.sorted_group_perm = self.wrapped
        return self

    def __exit__(self, *exc):
        self.mod.qdq, self.mod.sorted_group_perm = self.orig

    @staticmethod
    def codes(events, argsort):
        out, perm = [], None
        for kind, a in events:
            if kind == "perm":
                perm = np.asarray(a)
                continue
            a = np.asarray(a)
            if perm is not None:
                a = a.reshape(a.shape[0], -1)[:, :perm.shape[0]][:, argsort(perm)]
                perm = None
            out.append(a)
        return out


@pytest.mark.parametrize("bmm", [False, True], ids=["bmm_off", "bmm_on"])
@pytest.mark.parametrize("recipe", W4A4)
def test_w4a4_layers_fed_the_same_input(model, recipe, bmm):
    """Each layer of the W4A4 simulated model, both packages fed JAX's own
    input to it (a random hidden state for layer 0): the codes of every
    activation Q-DQ in the layer (the module docstring gives the bounds
    and the reasons a code moves), then the layer's output."""
    m = model
    q = _recipe(recipe, bmm)
    jsim, tsim = _sim(m, recipe, bmm)
    jlayer, tlayer = _layer_fns(m)
    jrec = _Codes(jcore, jnp.round, lambda a: a.astype(jnp.float32))
    trec = _Codes(tcore, torch.round, lambda a: a.float())

    kinds = []       # the JAX events' kinds, read while jrun traces

    @jax.jit
    def jrun(lp, x):
        with jrec:
            y = jlayer(lp, x, JCtx(quant=_jcfg(q)))
            kinds[:] = [k for k, _ in jrec.events]
            return y, [a for _, a in jrec.events]

    x = np.random.default_rng(4).normal(size=(2, SEQ, m["jcfg"].hidden_size)).astype(np.float32)
    n_first = 3 if m["arch"] != "bloom" else 1     # q / k / v, or Bloom's fused qkv
    # the Q-DQ calls of those linears' inputs (with bmm each input is
    # followed by its output's); they read the norm of the shared input
    first = set(range(0, 2 * n_first, 2) if bmm else range(n_first))
    for i in range(m["jcfg"].num_hidden_layers):
        y_j, arrays = jrun(jsim["layers"][str(i)], jnp.asarray(x))
        with trec, torch.no_grad():
            y_t = tlayer(tsim["layers"][str(i)], torch.from_numpy(x), ForwardContext(quant=q))
        assert [k for k, _ in trec.events] == kinds
        t_codes = _Codes.codes([(k, a.numpy()) for k, a in trec.events], np.argsort)
        j_codes = _Codes.codes(list(zip(kinds, arrays)), np.argsort)
        assert len(j_codes) == len(t_codes)
        moved = total = 0
        for n, (a, b) in enumerate(zip(j_codes, t_codes)):
            assert a.shape == b.shape
            if n in first:
                np.testing.assert_array_equal(b, a, err_msg=f"layer {i} call {n}")
            moved += int((a != b).sum())
            total += a.size
        assert moved <= 1e-3 * total, (i, moved, total)
        y_j = np.asarray(y_j)
        rel = np.linalg.norm(y_t.numpy() - y_j) / np.linalg.norm(y_j)
        assert rel <= (1e-5 if moved == 0 else 5e-2), (i, moved, rel)
        x = np.array(y_j)


@pytest.mark.parametrize("compute", ["dequant", "int"])
def test_packed_w8a8_close_to_simulated(compute):
    """The port's W8A8 per-channel / per-token pack (pack_model's defaults)
    against its simulated model on a tiny Llama, as the JAX package holds
    its own (tests/test_packed_model.py:34-49): the paths round in another
    order, so 2e-2."""
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    q = QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    sim = quantize_model("llama", params, cfg, q)
    packed = pack_model("llama", params, cfg, q, compute_dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, size=(1, 12)))
    with torch.no_grad():
        s, _ = tllama.forward(sim, ids, cfg, ctx=ForwardContext(quant=q))
        r, _ = tllama.forward(packed, ids, cfg, ctx=ForwardContext(quant=q, compute=compute))
    np.testing.assert_allclose(r.numpy(), s.numpy(), atol=2e-2, rtol=2e-2)

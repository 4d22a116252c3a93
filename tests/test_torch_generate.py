"""The Generator and the promoted prefill twin as a whole, the port vs the
JAX package on the same weights (hidden 512, 8 heads of 64 over 4 kv
heads, 2 layers, vocab 256, f32):

  * Generator: prefill on promote_model_int8 of a plain nibble pack, decode
    on the per-layer serving tree over head-major QuantKVCaches (K11) —
    greedy tokens identical; fp params over KVCaches, with and without an
    EOS — identical;
  * the no-cache forward on the promoted tree at 260 rows (K4's side of
    the switch) — logits within 3 % (relative norm), argmax agreeing at
    97 % of the positions;
  * ContinuousBatcher with the promoted prefill twin and the shared-basis
    stacked decode tree over the S-major pool — tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import QuantConfig as JQ
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu.serve import GenerationConfig as JGenConfig
from smoothquant_tpu.serve import Generator as JGenerator
from smoothquant_tpu.serve.batching import ContinuousBatcher as JBatcher
from smoothquant_tpu.serve.batching import Request as JRequest
from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.kernels import real_linear as treal
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator, sample_token
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 128


def to_numpy_tree(node):
    if isinstance(node, jpack.PackedLinear):
        d = {f: None if getattr(node, f) is None else np.asarray(getattr(node, f))
             for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")}
        d["meta"] = dataclasses.asdict(node.meta)
        return d
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    return None if node is None else np.asarray(node)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=4, num_hidden_layers=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    qcfg = jw4a4_group(group_size=16, salient_prop=0.05)
    head = JQ(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    common = dict(input_feat=feat, compute_dtype=jnp.float32, nibble=True, fuse=True,
                  lm_head_qcfg=head)
    serve = jpack_model("llama", params, jcfg, qcfg, align_k_groups=8, align_o=256,
                        fold_perms=True, shared_residual_basis=True,
                        identity_keys=("o_proj",), **common)
    plain = jpack_model("llama", params, jcfg, qcfg, **common)
    t_serve = params_from_numpy(to_numpy_tree(serve), "cpu")
    return dict(
        jcfg=jcfg, tcfg=tcfg, qcfg=qcfg, params=params,
        tparams=params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        serve=serve, stacked=jllama.stack_layers(serve, jcfg),
        promoted=jpack.promote_model_int8(plain),
        t_serve=t_serve, t_stacked=tllama.stack_layers(t_serve, tcfg),
        # the port promotes its own copy of the plain pack
        t_promoted=tpack.promote_model_int8(params_from_numpy(to_numpy_tree(plain), "cpu")))


def test_generator_promoted_prefill_quant_kv_identical(models):
    m = models
    prompt = np.random.default_rng(6).integers(0, m["jcfg"].vocab_size, size=(2, 12))
    jgen = JGenerator(jllama, m["serve"], m["jcfg"], quant=m["qcfg"], max_len=MAX_LEN,
                      quant_kv=True, compute="int", interpret=True,
                      prefill_params=m["promoted"])
    tgen = Generator(tllama, m["t_serve"], m["tcfg"], max_len=MAX_LEN, quant_kv=True,
                     prefill_params=m["t_promoted"], device="cpu")
    ref = jgen.generate(prompt, JGenConfig(max_new_tokens=6))
    got = tgen.generate(prompt, GenerationConfig(max_new_tokens=6))
    assert got.shape == (2, 18)
    np.testing.assert_array_equal(got, ref)


def test_generator_fp_kv_cache_identical_with_eos(models):
    m = models
    prompt = np.random.default_rng(8).integers(0, m["jcfg"].vocab_size, size=(2, 7))
    jgen = JGenerator(jllama, m["params"], m["jcfg"], max_len=MAX_LEN)
    tgen = Generator(tllama, m["tparams"], m["tcfg"], max_len=MAX_LEN, device="cpu")
    ref = jgen.generate(prompt, JGenConfig(max_new_tokens=5))
    got = tgen.generate(prompt, GenerationConfig(max_new_tokens=5))
    np.testing.assert_array_equal(got, ref)
    eos = int(ref[0, 8])               # row 0's second new token ends it
    ref = jgen.generate(prompt, JGenConfig(max_new_tokens=5, eos_token_id=eos))
    got = tgen.generate(prompt, GenerationConfig(max_new_tokens=5, eos_token_id=eos))
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 8:] == eos).all()


def test_promoted_no_cache_forward_matches_jax(models, monkeypatch):
    """One 260-token prompt through the promoted tree with no cache, logits
    for every position: the port's linears take K4 (plain here), JAX its
    kernel in interpret mode.  jitted XLA's cos and exp differ from torch's
    in the last bits; where that moves a per-token int8 code across a
    rounding edge (4 of 260 rows in the first layer here), the flip
    spreads to later positions through attention — so the logits agree to
    ~1.5 % of their norm (the W4A4 recipe itself is ~30 % from fp), not
    to the last bits."""
    m = models
    calls = []
    k4 = treal.int8_prefill_matmul
    monkeypatch.setattr(treal, "int8_prefill_matmul",
                        lambda *a, **kw: calls.append(1) or k4(*a, **kw))
    ids = np.random.default_rng(9).integers(0, m["jcfg"].vocab_size, size=(1, 260))
    ctx = JCtx(compute="int", interpret=True)
    ref = np.asarray(jax.jit(lambda p, i: jllama.forward(p, i, m["jcfg"], ctx=ctx)[0])(
        m["promoted"], jnp.asarray(ids)))
    got, _ = tllama.forward(m["t_promoted"], torch.from_numpy(ids), m["tcfg"])
    got = got.numpy()
    assert got.shape == (1, 260, m["jcfg"].vocab_size) and np.isfinite(got).all()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.03
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.97
    np.testing.assert_allclose(got[0, :16], ref[0, :16], rtol=1e-4, atol=1e-4)
    assert len(calls) == 4 * m["tcfg"].num_hidden_layers + 1     # + the lm_head


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=(n,)), max_new_tokens=4)
            for i, n in enumerate([40, 55, 61, 33, 9, 20])]


def test_batcher_promoted_prefill_tokens_identical(models):
    """Four 33-61-token prompts share one 4 × 64 = 256-row prefill on the
    promoted twin (the K4 side of the switch), two short ones a 32-token
    bucket; decode runs on the stacked shared-basis tree over the S-major
    pool (max_batch 4, chunk 2)."""
    m = models
    jb = JBatcher(jllama, m["stacked"], m["jcfg"], quant=m["qcfg"], max_batch=4,
                  max_len=MAX_LEN, quant_kv=True, compute="auto", interpret=True,
                  prefill_params=m["promoted"], smajor=True)
    tb = ContinuousBatcher(tllama, m["t_stacked"], m["tcfg"], max_batch=4,
                           max_len=MAX_LEN, quant_kv=True,
                           prefill_params=m["t_promoted"], smajor=True, device="cpu")
    outs = []
    for b, cls in ((jb, JRequest), (tb, Request)):
        reqs = _requests(cls, m["jcfg"].vocab_size)
        for r in reqs:
            b.submit(r)
        b.run_to_completion(chunk=2)
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(g) == 4 for g in outs[1])
    np.testing.assert_array_equal(tb.key_valid, jb.key_valid)


def test_generator_asks_for_the_card(models):
    """Without device="cpu" the Generator asks for the card: on a machine
    without CUDA it raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(tllama, models["t_serve"], models["tcfg"], max_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="per-layer"):
        Generator(tllama, models["t_stacked"], models["tcfg"], device="cpu")


def test_sample_token():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 0.5]])
    assert sample_token(logits, 0.0).tolist() == [1, 0]
    draws = [sample_token(logits, 1.0, torch.Generator().manual_seed(s)).tolist()
             for s in range(2)]
    again = [sample_token(logits, 1.0, torch.Generator().manual_seed(s)).tolist()
             for s in range(2)]
    assert draws == again and all(0 <= t < 3 for d in draws for t in d)

"""The serving slice as a whole: the port's ContinuousBatcher vs the JAX
batcher on the same converted weights (the bench recipe at a tiny size),
one stacked S-major decode step vs JAX's logits, and the no-fallback
contract of the entry points."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.common import SMajorQuantKVCache as JSMajor
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import QuantConfig as JQ
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu.serve.batching import ContinuousBatcher as JBatcher
from smoothquant_tpu.serve.batching import Request as JRequest
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.common import SMajorQuantKVCache
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 128


def to_numpy_tree(node):
    if isinstance(node, jpack.PackedLinear):
        d = {f: None if getattr(node, f) is None else np.asarray(getattr(node, f))
             for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm",
                       "ns_mask", "sal_select")}
        d["meta"] = dataclasses.asdict(node.meta)
        return d
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    return None if node is None else np.asarray(node)


@pytest.fixture(scope="module")
def models():
    """The bench recipe (W4A4 g16, 5 % salient, fused, folded, shared
    residual basis, identity o_proj, int8 lm_head) at hidden 512, 8 heads
    of 64, 2 layers, vocab 256, f32; packed by JAX and converted."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=8, num_hidden_layers=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    qcfg = jw4a4_group(group_size=16, salient_prop=0.05)
    packed = jpack_model(
        "llama", params, jcfg, qcfg, input_feat=feat, compute_dtype=jnp.float32,
        nibble=True, align_k_groups=8, align_o=256, fuse=True, fold_perms=True,
        shared_residual_basis=True, identity_keys=("o_proj",),
        lm_head_qcfg=JQ(weight_quant="per_channel", act_quant="per_token",
                        quant_bits=8))
    stacked = jllama.stack_layers(packed, jcfg)
    t_packed = params_from_numpy(to_numpy_tree(packed), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, qcfg=qcfg, packed=packed, stacked=stacked,
                t_packed=t_packed, t_stacked=tllama.stack_layers(t_packed, tcfg))


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=(n,)), max_new_tokens=4)
            for i, n in enumerate([5, 9, 3, 20])]


def test_batcher_tokens_identical_to_jax(models):
    """Ragged requests through bucketed batched prefill, scatter into the
    pool and chunked decode (max_batch 2, chunk 2): identical tokens."""
    m = models
    jb = JBatcher(jllama, m["stacked"], m["jcfg"], quant=m["qcfg"], max_batch=2,
                  max_len=MAX_LEN, quant_kv=True, compute="auto", interpret=True,
                  prefill_params=m["packed"], smajor=True)
    tb = ContinuousBatcher(tllama, m["t_stacked"], m["tcfg"], max_batch=2,
                           max_len=MAX_LEN, quant_kv=True,
                           prefill_params=m["t_packed"], smajor=True, device="cpu")
    outs = []
    for b, cls in ((jb, JRequest), (tb, Request)):
        reqs = _requests(cls, m["jcfg"].vocab_size)
        for r in reqs:
            b.submit(r)
        b.run_to_completion(chunk=2)
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(g) == 4 for g in outs[1])
    np.testing.assert_array_equal(tb.pool_pos, jb.pool_pos)
    np.testing.assert_array_equal(tb.key_valid, jb.key_valid)


def test_stacked_smajor_decode_step_matches_jax(models):
    """Per-layer prefill into S-major caches, then one decode token over the
    stacked tree with per-slot positions and a key mask: logits to 2e-4,
    the written cache rows bit-exact, positions advanced."""
    m = models
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, 6))
    ctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True)
    jcaches = [JSMajor.create(2, MAX_LEN, jcfg.num_key_value_heads,
                              jcfg.head_dim) for _ in range(jcfg.num_hidden_layers)]
    # jitted, as the JAX batcher runs it (eager JAX divides by constants
    # exactly; compiled, it multiplies by their reciprocals)
    fwd = jax.jit(lambda p, ids, c, pos, mask: jllama.forward(
        p, ids, jcfg, ctx=ctx, caches=c, positions=pos, attn_mask=mask))
    _, jcaches = fwd(m["packed"], jnp.asarray(prompt), jcaches, None, None)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jcaches)
    slot_pos = np.array([6, 4], np.int32)
    jst = jst._replace(pos=jnp.broadcast_to(jnp.asarray(slot_pos),
                                            (jcfg.num_hidden_layers, 2)))
    mask = np.zeros((2, MAX_LEN), bool)
    mask[0, :7] = True
    mask[1, :5] = True
    tok = np.array([[7], [9]])
    ref, ref_c = fwd(m["stacked"], jnp.asarray(tok), jst,
                     jnp.asarray(slot_pos)[:, None], jnp.asarray(mask))

    tst = SMajorQuantKVCache.create(2, MAX_LEN, tcfg.num_key_value_heads,
                                    tcfg.head_dim, "cpu",
                                    n_layers=tcfg.num_hidden_layers)
    tllama.forward_hidden(m["t_packed"], torch.from_numpy(prompt), tcfg,
                          caches=[tst.layer(i) for i in range(tcfg.num_hidden_layers)])
    for name in ("k_q", "v_q", "k_scale", "v_scale"):   # the prefill cache
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=1e-6, atol=0)
    tst.pos[:] = torch.from_numpy(slot_pos)
    got, got_c = tllama.forward(m["t_stacked"], torch.from_numpy(tok), tcfg,
                                caches=tst, positions=torch.from_numpy(slot_pos)[:, None],
                                attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    for b, p in enumerate(slot_pos):
        np.testing.assert_array_equal(got_c.k_q[:, b, p].numpy(),
                                      np.asarray(ref_c.k_q[:, b, p]))
    np.testing.assert_array_equal(got_c.pos.numpy(), np.asarray(ref_c.pos))


def test_entry_points_raise_without_cuda(models):
    """Without device="cpu" the entry points ask for the card: on a machine
    without CUDA they raise instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    m = models
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(tllama, m["t_stacked"], m["tcfg"], max_batch=2,
                          max_len=MAX_LEN, quant_kv=True, smajor=True,
                          prefill_params=m["t_packed"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.init_layer_params(torch.Generator(), m["tcfg"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.stacked_caches(m["tcfg"], 2, MAX_LEN, quant_kv=True, smajor=True)


def test_package_import_needs_no_gpu_toolchain():
    """Importing every module starts no build and needs neither triton nor
    nvcc; nothing of JAX is imported."""
    code = (
        "import sys\n"
        "import smoothquant_tpu_torch.serve.batching, "
        "smoothquant_tpu_torch.models.registry, "
        "smoothquant_tpu_torch.utils.convert, smoothquant_tpu_torch.utils.roofline\n"
        "from smoothquant_tpu_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'smoothquant_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

"""The aligned stacked head-major int8 decode as a whole: the port's
llama.forward against the JAX package's on the same converted serving
pack (the bench recipe at a tiny size: W4A4 g16, 5 % salient, fused,
folded, shared residual basis, identity o_proj, int8 lm_head; f32, head_dim
128, 2 layers), one MHA and one GQA model.  JAX prefills a prompt into
per-layer int8 head-major caches; both sides take the stacked copy with
aligned (L,) positions and decode 8 greedy tokens in each ForwardContext
composition: fuse_attn "auto" (K12's flat body for MHA, its stacked body
for GQA, then K10), "fused" (K12's write body), "off" (K10 + K11) and
"auto" with fuse_mlp (K14).

Held after every step: the tokens identical, the int8 cache codes and the
positions identical, the cache scales within 1e-6 relative (the new k / v
rows are the f32 output of the qkv linear, whose sums run in another
order, so a row's absmax can move by an ulp).  The logits: f32 sums in
another order (K12 folds the new position in last on both sides, but the
dots and tile sums round apart) can put a per-token int4 activation code
of a later linear on the other side of a rounding edge, which moves that
row's logits (one row of one step in 16, by 4 % of its norm, in the MHA
model).  So, as the 40-slot slice test holds them, at least 90 % of the
(step, row) logits match to 2e-4 (relative and absolute) and every row to
10 % of its norm."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.common import QuantKVCache as JQKV
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import QuantConfig as JQ
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.common import ForwardContext, QuantKVCache
from smoothquant_tpu_torch.utils.convert import params_from_numpy
from test_torch_llama_serve import to_numpy_tree

torch.set_num_threads(1)

MAX_LEN, PROMPT, STEPS = 128, 10, 8


@pytest.fixture(scope="module", params=[2, 1], ids=["mha", "gqa"])
def model(request):
    return build(request.param)


def build(n_kv):
    """The serving pack of a 2-head (head_dim 128) Llama over n_kv kv
    heads, its stacked twin in both packages, and JAX's prefill of a
    2-row prompt into stacked int8 head-major caches at aligned position
    PROMPT."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=2, num_key_value_heads=n_kv, num_hidden_layers=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(2)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    qcfg = jw4a4_group(group_size=16, salient_prop=0.05)
    packed = jpack_model(
        "llama", params, jcfg, qcfg, input_feat=feat, compute_dtype=jnp.float32,
        nibble=True, align_k_groups=8, align_o=256, fuse=True, fold_perms=True,
        shared_residual_basis=True, identity_keys=("o_proj",),
        lm_head_qcfg=JQ(weight_quant="per_channel", act_quant="per_token", quant_bits=8))
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, PROMPT))
    ctx = JCtx(quant=qcfg, compute="auto", interpret=True)
    caches = [JQKV.create(2, MAX_LEN, jcfg.num_key_value_heads, jcfg.head_dim)
              for _ in range(jcfg.num_hidden_layers)]
    logits, caches = jax.jit(lambda p, ids, c: jllama.forward(p, ids, jcfg, ctx=ctx, caches=c))(
        packed, jnp.asarray(prompt), caches)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    assert jst.pos.shape == (jcfg.num_hidden_layers,)
    t_packed = params_from_numpy(to_numpy_tree(packed), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, qcfg=qcfg, stacked=jllama.stack_layers(packed, jcfg),
                t_stacked=tllama.stack_layers(t_packed, tcfg), jst=jst,
                first=np.asarray(logits[:, -1]).argmax(-1)[:, None])


def _rows_close(got, ref):
    """Rows of (B, 1, V) logits within 2e-4; raises unless every row is
    within 10 % of its norm."""
    got, ref = got[:, -1], ref[:, -1]
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel.max() <= 0.1, rel
    return np.all(np.abs(got - ref) <= 2e-4 + 2e-4 * np.abs(ref), axis=-1)


def _same_cache(got, ref):
    for name in ("k_q", "v_q", "pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6, atol=0,
                                   err_msg=name)


def _port_cache(m):
    tst = tllama.stacked_caches(m["tcfg"], 2, MAX_LEN, quant_kv=True, smajor=False,
                                device="cpu")
    for name in ("k_q", "v_q", "k_scale", "v_scale", "pos"):
        getattr(tst, name).copy_(torch.from_numpy(np.array(getattr(m["jst"], name))))
    return tst


@pytest.mark.parametrize("fuse_attn,fuse_mlp", [("auto", False), ("fused", False),
                                                ("off", False), ("auto", True)])
def test_aligned_decode_matches_jax(model, fuse_attn, fuse_mlp):
    m = model
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True, fuse_attn=fuse_attn,
                fuse_mlp=fuse_mlp)
    fwd = jax.jit(lambda p, ids, c: jllama.forward(p, ids, jcfg, ctx=jctx, caches=c))
    tctx = ForwardContext(fuse_attn=fuse_attn, fuse_mlp=fuse_mlp)
    jst, tst = m["jst"], _port_cache(m)
    assert isinstance(tst, QuantKVCache)
    jtok = ttok = m["first"]
    close = []
    for _ in range(STEPS):
        ref, jst = fwd(m["stacked"], jnp.asarray(jtok), jst)
        got, tst = tllama.forward(m["t_stacked"], torch.from_numpy(ttok), tcfg, caches=tst,
                                  ctx=tctx)
        ref, got = np.asarray(ref), got.numpy()
        assert got.shape == ref.shape == (2, 1, jcfg.vocab_size)
        close.extend(_rows_close(got, ref))
        _same_cache(tst, jst)
        jtok, ttok = ref[:, -1].argmax(-1)[:, None], got[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(ttok, jtok)
    assert np.mean(close) >= 0.9
    assert int(tst.pos[0]) == PROMPT + STEPS


def test_compositions_agree(model):
    """One step in each composition from the same cache.  The three K12
    compositions share their arithmetic on the CPU (the write body writes
    K10's row; K14's plain version is the unfused chain in f32): logits and
    caches identical.  "off" folds the new position in inside its tile,
    which rounds apart: its layer-0 rows (written before any attention) and
    positions are identical."""
    m = model
    outs, caches = {}, {}
    for fa, fm in (("auto", False), ("fused", False), ("off", False), ("auto", True)):
        tst = _port_cache(m)
        outs[fa, fm], caches[fa, fm] = tllama.forward(
            m["t_stacked"], torch.from_numpy(m["first"]), m["tcfg"], caches=tst,
            ctx=ForwardContext(fuse_attn=fa, fuse_mlp=fm))
    base, base_c = outs["auto", False], caches["auto", False]
    for key in (("fused", False), ("auto", True)):
        assert torch.equal(outs[key], base)
        for name in ("k_q", "v_q", "k_scale", "v_scale", "pos"):
            assert torch.equal(getattr(caches[key], name), getattr(base_c, name))
    off = caches["off", False]
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        assert torch.equal(getattr(off, name)[0], getattr(base_c, name)[0])
    assert torch.equal(off.pos, base_c.pos)
    with pytest.raises(ValueError, match="fuse_attn"):
        ForwardContext(fuse_attn="on")


@pytest.mark.parametrize("kw", [{}, {"per_slot": True}, {"quant_kv": True},
                                {"quant_kv": True, "per_slot": True},
                                {"quant_kv": True, "smajor": True, "per_slot": True}],
                         ids=["default", "per_slot", "quant_kv", "quant_kv_per_slot", "smajor"])
def test_stacked_caches_layout_matches_jax(kw):
    """The same stacked_caches call builds the same cache in both packages:
    its type, every field's shape and dtype, the positions' shape (the
    defaults are the JAX ones: a head-major fp cache in `dtype`).  The
    port's S-major cache always carries (L, B) per-slot positions, so it is
    compared with per_slot."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), num_hidden_layers=3)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    j = jllama.stacked_caches(jcfg, 5, MAX_LEN, jnp.bfloat16, pos=7, **kw)
    t = tllama.stacked_caches(tcfg, 5, MAX_LEN, torch.bfloat16, pos=7, device="cpu", **kw)
    assert type(t).__name__ == type(j).__name__
    for name in j._fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), name
        assert (a.float().numpy() == b.astype(np.float32)).all(), name

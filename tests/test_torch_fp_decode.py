"""The bf16-baseline slice: K13 (fp_matmul_stacked) plain PyTorch version vs
the JAX Pallas kernel in interpret mode, and the pack_fp_decode stacked
decode (K13 linears, fp cache append, K11 attention) vs the JAX prefetch-
scan decode over a stacked head-major KVCache, aligned and per slot; the
no-cache forward of fp and weight_t trees.

f32 throughout: 1e-5 relative, plus 1e-5 of the largest magnitude (for
sums that cancel toward zero), from f32 sums taken in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.fp_matmul import fp_matmul_stacked as j_k13
from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu_torch.kernels import fp_matmul as k13
from smoothquant_tpu_torch.kernels import stream_gmm
from smoothquant_tpu_torch.models import common as tcommon
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

MAX_LEN = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n,kk,o,dt", [(5, 768, 384, "float32"), (3, 256, 1024, "float32"),
                                       (4, 512, 256, "bfloat16")])
def test_k13_plain_matches_jax(n, kk, o, dt):
    rng = np.random.default_rng(kk)
    x = rng.normal(size=(n, kk)).astype(np.float32)
    w = rng.normal(size=(3, kk, o)).astype(np.float32) * kk ** -0.5
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    for i in range(3):
        ref = np.asarray(j_k13(jnp.asarray([i], jnp.int32), jnp.asarray(x, jdt),
                               jnp.asarray(w, jdt), interpret=True), np.float32)
        got = k13.fp_matmul_stacked(i, _t(x).to(tdt), _t(w).to(tdt))
        assert got.dtype == tdt and got.shape == (n, o)
        if dt == "float32":
            _close(got, ref)
        else:   # a bf16 output may round one bf16 ulp apart
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7,
                                       atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def model():
    """f32 Llama, hidden 256, 4 heads of 64 over 2 kv heads, 2 layers; the
    JAX fp tree, its pack_fp_decode stack, and the port's twins."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams,
                jstacked=jllama.stack_layers(jllama.pack_fp_decode(params, jcfg), jcfg),
                tstacked=tllama.stack_layers(tllama.pack_fp_decode(tparams, tcfg), tcfg))


def _prefilled(m, prompt, per_slot=False):
    """Per-layer KVCaches prefilled by JAX, stacked; and the port's copy."""
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    caches = [JKVCache.create(prompt.shape[0], MAX_LEN, jcfg.num_key_value_heads,
                              jcfg.head_dim, jnp.float32)
              for _ in range(jcfg.num_hidden_layers)]
    _, caches = jax.jit(lambda p, ids, c: jllama.forward(p, ids, jcfg, caches=c))(
        m["params"], jnp.asarray(prompt), caches)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    tst = tllama.stacked_caches(tcfg, prompt.shape[0], MAX_LEN, torch.float32,
                                quant_kv=False, smajor=False, per_slot=per_slot,
                                device="cpu")
    tst.k.copy_(_t(jst.k))
    tst.v.copy_(_t(jst.v))
    return jst, tst


@pytest.mark.parametrize("per_slot", [False, True])
def test_fp_stacked_decode_matches_jax(model, per_slot):
    """One token through the stacked weight_t tree: the JAX scan runs K13 and
    K11 in interpret mode, the port their plain versions — logits and the
    written cache rows within tolerance, the advanced positions identical."""
    m = model
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, 6))
    jst, tst = _prefilled(m, prompt, per_slot)
    tok = np.array([[7], [9]])
    kw_j, kw_t = {}, {}
    if per_slot:
        slot_pos = np.array([6, 4], np.int32)
        mask = np.zeros((2, MAX_LEN), bool)
        mask[0, :7] = True
        mask[1, :5] = True
        mask[1, 2] = False                    # a key hole
        jst = jst._replace(pos=jnp.broadcast_to(jnp.asarray(slot_pos),
                                                (jcfg.num_hidden_layers, 2)))
        assert tst.pos.shape == (tcfg.num_hidden_layers, 2)
        tst.pos[:] = torch.from_numpy(slot_pos)
        kw_j = dict(positions=jnp.asarray(slot_pos)[:, None], attn_mask=jnp.asarray(mask))
        kw_t = dict(positions=torch.from_numpy(slot_pos)[:, None],
                    attn_mask=torch.from_numpy(mask))
    else:
        tst.pos[:] = _t(jst.pos)
    ctx = JCtx(interpret=True)
    assert jllama._prefetch_capable(m["jstacked"], jcfg, ctx, jst, 1)
    ref, ref_c = jax.jit(lambda p, t, c, **kw: jllama.forward(
        p, t, jcfg, ctx=ctx, caches=c, **kw))(m["jstacked"], jnp.asarray(tok), jst, **kw_j)
    assert tcommon.prefetch_tree_capable(m["tstacked"]["layers"]["stacked"], tst, 1)
    got, got_c = tllama.forward(m["tstacked"], torch.from_numpy(tok), tcfg, caches=tst,
                                **kw_t)
    _close(got, ref)
    np.testing.assert_array_equal(got_c.pos.numpy(), np.asarray(ref_c.pos))
    _close(got_c.k, ref_c.k)
    _close(got_c.v, ref_c.v)


def test_no_cache_forward_matches_jax(model):
    """The full-sequence forward with no cache: fp and unstacked weight_t
    trees (K13's flat branch is one matmul) against JAX."""
    m = model
    ids = np.random.default_rng(2).integers(0, m["jcfg"].vocab_size, size=(2, 9))
    ref = np.asarray(jax.jit(lambda p, i: jllama.forward(p, i, m["jcfg"])[0])(
        m["params"], jnp.asarray(ids)))
    for tree in (m["tparams"], tllama.pack_fp_decode(m["tparams"], m["tcfg"])):
        got, caches = tllama.forward(tree, torch.from_numpy(ids), m["tcfg"])
        assert caches is None
        _close(got, ref)


def test_stacked_gate(model):
    """A stacked tree takes the stacked decode for one token over a stacked
    cache whose projections tile (prefetch_tree_capable); otherwise it runs
    the per-layer body over its layers, as the JAX package's scan over
    _decoder_layer does (3 tokens into the stacked fp cache: logits, the
    written rows and the positions against JAX).  Over a head-major int8
    cache at aligned positions it decodes as the JAX package does."""
    m = model
    tst = tllama.stacked_caches(m["tcfg"], 2, MAX_LEN, torch.float32, quant_kv=False,
                                smajor=False, device="cpu")
    st = m["tstacked"]["layers"]["stacked"]
    assert tcommon.prefetch_tree_capable(st, tst, 1)
    assert not tcommon.prefetch_tree_capable(st, tst, 2)
    odd = dict(st, mlp=dict(st["mlp"], down_proj={
        "weight_t": st["mlp"]["down_proj"]["weight_t"][:, :, :100], "bias": None}))
    assert not tcommon.prefetch_tree_capable(odd, tst, 1)
    ids = np.random.default_rng(13).integers(0, m["jcfg"].vocab_size, size=(2, 3))
    jst = jllama.stacked_caches(m["jcfg"], 2, MAX_LEN, jnp.float32)
    ref, ref_c = jax.jit(lambda p, t, c: jllama.forward(p, t, m["jcfg"], caches=c))(
        m["jstacked"], jnp.asarray(ids), jst)
    got, got_c = tllama.forward(m["tstacked"], torch.from_numpy(ids), m["tcfg"], caches=tst)
    _close(got, ref)
    _close(got_c.k, ref_c.k)
    _close(got_c.v, ref_c.v)
    np.testing.assert_array_equal(got_c.pos.numpy(), np.asarray(ref_c.pos))
    # aligned positions over a head-major int8 cache: the virtual-tile
    # attention (K12's stacked body for this GQA model) then K10, as the JAX
    # package runs it; K12 rounds each probability to bf16 before PV, and a
    # score that rounds apart can flip one (one bf16 ulp of one position's
    # weight), so the logits are held to 2.5e-4 of their largest magnitude
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(12)
    shape = (jcfg.num_hidden_layers, 2, jcfg.num_key_value_heads, MAX_LEN, jcfg.head_dim)
    pool = dict(k_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                v_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                k_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32),
                v_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32))
    jq = jllama.stacked_caches(jcfg, 2, MAX_LEN, jnp.float32, pos=9, quant_kv=True)
    jq = jq._replace(**{k: jnp.asarray(v) for k, v in pool.items()})
    qst = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, smajor=False, pos=9,
                                device="cpu")
    for k, v in pool.items():
        getattr(qst, k).copy_(torch.from_numpy(v))
    tok = np.array([[3], [11]])
    ref, ref_c = jax.jit(lambda p, t, c: jllama.forward(p, t, jcfg, ctx=JCtx(interpret=True),
                                                        caches=c))(
        m["jstacked"], jnp.asarray(tok), jq)
    got, got_c = tllama.forward(m["tstacked"], torch.from_numpy(tok), tcfg, caches=qst)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.5e-4 * np.abs(ref).max())
    for k in ("k_q", "v_q", "pos"):
        np.testing.assert_array_equal(getattr(got_c, k).numpy(), np.asarray(getattr(ref_c, k)))
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(got_c, k).numpy(), np.asarray(getattr(ref_c, k)),
                                   rtol=1e-6, atol=0)


def test_fp_lm_head_logits_accumulate_in_f32():
    """A bf16 Llama with a dict lm_head: the logits are the bf16 products
    summed in f32, as the JAX einsum with preferred_element_type=f32 takes
    them (llama.py:596-598) — not a bf16 product rounded to bf16 and cast.
    No decoder layers, so both packages hand the lm_head the same bf16
    hidden states (embedding → RMSNorm)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), num_hidden_layers=0,
                               dtype="bfloat16")
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, 7))
    ref = np.asarray(jax.jit(lambda p, i: jllama.forward(p, i, jcfg)[0])(
        params, jnp.asarray(ids)))
    got, _ = tllama.forward(tparams, torch.from_numpy(ids), tcfg)
    assert got.dtype == torch.float32
    _close(got, ref)
    rounded = got.to(torch.bfloat16).float()
    assert (got != rounded).float().mean() > 0.5     # f32 logits, not bf16 ones


# ---------------------------------------------------------------- K13's stream body


@pytest.mark.parametrize("n, kk, o, dtype, body", [
    (4, 4096, 12288, torch.bfloat16, "stream"),   # Llama-2-7B's qkv at B = 4
    (4, 11008, 4096, torch.bfloat16, "stream"),   # down_proj
    (1, 72, 136, torch.bfloat16, "stream"),       # a ragged stage and column tile
    (8, 4096, 4096, torch.bfloat16, "stream"),    # the most rows one n8 tile holds
    (4, 4096, 12288, torch.float32, "ldg"),       # f32: the __ldg body
    (4, 12, 64, torch.bfloat16, "ldg"),           # K % 8 != 0: no 16-byte TMA rows
    (4, 4096, 12, torch.bfloat16, "ldg"),         # O % 8 != 0
])
def test_k13_body_rule(n, kk, o, dtype, body):
    """K13's body on a CUDA tensor follows from the shape alone: the stream
    body for every bf16 decode linear, the __ldg body for f32."""
    assert k13.fp_body(n, kk, o, dtype) == body


def test_k13_stream_stages_and_split():
    """K13's stages: 64 weight rows where the 128-column tiles alone about
    fill the card (Llama-2-7B's qkv, 96 tiles), 32 where a tile's K splits
    over ranks (o and down, 32 tiles: 4 ranks) or the tiles outnumber the
    SMs (gate_up, 172 tiles); the split over K as the stream body plans it."""
    assert stream_gmm.k13_stages(4096) == 64 and stream_gmm.k13_stages(11008, 32) == 344
    assert stream_gmm.k13_stages(72, 32) == 3
    for kk, o, kb, ranks in ((4096, 12288, 64, 1), (4096, 4096, 32, 4), (4096, 22016, 32, 1),
                             (11008, 4096, 32, 4)):
        assert stream_gmm.k13_kb(o, kk) == kb
        assert stream_gmm.split(o, stream_gmm.k13_stages(kk, kb)) == ranks


def _k13_stream_emulation(x, w, n_split, kb):
    """Torch emulation of K13's stream body (csrc/stream_gmm.cuh
    stream_bf16_kernel): rank r of n_split sums its stages (kb weight rows
    each, rows past K zero) one mma's k16 at a time into f32, and the ranks'
    partials are added in rank order; the f32 result, before the bf16
    rounding of the output."""
    kk = x.shape[1]
    stages = stream_gmm.k13_stages(kk, kb)
    lg = n_split.bit_length() - 1
    out = None
    for rank in range(n_split):
        acc = torch.zeros((x.shape[0], w.shape[1]))
        for t in range((rank * stages) >> lg, ((rank + 1) * stages) >> lg):
            for k0 in range(kb * t, min(kb * t + kb, kk), 16):
                acc = acc + x[:, k0:k0 + 16].float() @ w[k0:k0 + 16].float()
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("n, kk, o, n_split", [
    (4, 1024, 256, 1), (4, 1024, 256, 2), (4, 1024, 256, 4), (4, 1024, 256, 8),
    (1, 200, 256, 1), (1, 200, 256, 2), (1, 200, 256, 4),   # a ragged last stage
    (8, 576, 384, 1), (8, 576, 384, 2), (8, 576, 384, 4), (8, 576, 384, 8)])
def test_k13_stream_emulation_matches_jax(n, kk, o, n_split):
    """K13's stream body sums each rank's k16 steps in f32 and the ranks in
    rank order: emulated in torch over bf16 operands at the stage depth its
    rule picks, held to the JAX fp_matmul_stacked (interpret mode, f32 out)
    within f32 order (1e-5 relative and of the largest magnitude), and its
    bf16 rounding to the JAX bf16 output within one bf16 ulp."""
    kb = stream_gmm.k13_kb(o, kk)
    assert stream_gmm.k13_stages(kk, kb) >= n_split
    rng = np.random.default_rng(kk + n_split)
    x = _t(rng.normal(size=(n, kk)).astype(np.float32)).to(torch.bfloat16)
    w = _t(rng.normal(size=(2, kk, o)).astype(np.float32) * kk ** -0.5).to(torch.bfloat16)
    got = _k13_stream_emulation(x, w[1], n_split, kb)
    xj, wj = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w))
    ref = np.asarray(j_k13(jnp.asarray([1], jnp.int32), xj, wj, out_dtype=jnp.float32,
                           interpret=True), np.float32)
    _close(got, ref)
    ref16 = np.asarray(j_k13(jnp.asarray([1], jnp.int32), xj, wj, interpret=True), np.float32)
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), ref16, rtol=2.0 ** -7,
                               atol=1e-5 * np.abs(ref16).max())

"""The 64-slot serving slice against the JAX package on the CPU, at the
tiny bench recipe of test_torch_generate.py (hidden 512, 8 heads of 64 over
4 kv heads, 2 layers, f32; the shared-basis serving tree and the promoted
prefill twin): one stacked decode step over the head-major per-slot int8
pool at B = 40 (the linears take K7a + K5) and B = 16 (K7b / K7a + K5 on
K1's codes), the
ContinuousBatcher at its default head-major pool with 40 slots, and the
entry points that must raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.serve.batching import ContinuousBatcher as JBatcher
from smoothquant_tpu.serve.batching import Request as JRequest
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.common import KVCache, QuantKVCache
from smoothquant_tpu_torch.serve.batching import ContinuousBatcher, Request
from test_torch_generate import MAX_LEN, models  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("batch", [40, 16])
def test_head_major_decode_step_matches_jax(models, batch):  # noqa: F811
    """One decode token over the stacked tree and a random head-major int8
    pool (the same codes and scales on both sides), ragged per-slot
    positions and a key mask with holes.  The linears' f32 sums (K5's,
    the RMSNorm's) run in another order than XLA's, so a per-token int4 code
    on a rounding edge can land on the other side and move that row's
    logits (2 of 40 rows here, by up to 0.17): at least 90 % of the rows
    match to the file's 2e-4, every row to 10 % of its norm with the same
    argmax share; the cache is untouched outside the written rows, whose
    codes agree but for such a move, and every layer's positions advance."""
    m = models
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    n_l, n_kv, d = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    rng = np.random.default_rng(batch)
    shape = (n_l, batch, n_kv, MAX_LEN, d)
    pool = dict(k_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                v_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                k_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32),
                v_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32))
    slot_pos = rng.integers(2, 100, size=(batch,)).astype(np.int32)
    mask = (np.arange(MAX_LEN)[None, :] <= slot_pos[:, None]) & (
        rng.random((batch, MAX_LEN)) > 0.1)
    mask[np.arange(batch), slot_pos] = True
    tok = rng.integers(0, jcfg.vocab_size, size=(batch, 1))
    ctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True)
    jst = jllama.stacked_caches(jcfg, batch, MAX_LEN, jnp.float32, quant_kv=True,
                                per_slot=True)
    jst = jst._replace(pos=jnp.broadcast_to(jnp.asarray(slot_pos), (n_l, batch)),
                       **{k: jnp.asarray(v) for k, v in pool.items()})
    ref, ref_c = jax.jit(lambda p, ids, c, pos, msk: jllama.forward(
        p, ids, jcfg, ctx=ctx, caches=c, positions=pos, attn_mask=msk))(
        m["stacked"], jnp.asarray(tok), jst, jnp.asarray(slot_pos)[:, None],
        jnp.asarray(mask))

    tst = tllama.stacked_caches(tcfg, batch, MAX_LEN, quant_kv=True, smajor=False,
                                per_slot=True, device="cpu")
    for name, v in pool.items():
        getattr(tst, name).copy_(torch.from_numpy(v))
    tst.pos[:] = torch.from_numpy(slot_pos)
    got, got_c = tllama.forward(m["t_stacked"], torch.from_numpy(tok), tcfg, caches=tst,
                                positions=torch.from_numpy(slot_pos)[:, None],
                                attn_mask=torch.from_numpy(mask))
    got, ref = got.numpy()[:, 0], np.asarray(ref)[:, 0]
    assert got.shape == ref.shape == (batch, jcfg.vocab_size)
    close = np.all(np.abs(got - ref) <= 2e-4 + 2e-4 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.9
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel.max() <= 0.1
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9
    written = np.zeros((n_l, batch, MAX_LEN), bool)
    written[:, np.arange(batch), slot_pos] = True
    for name in pool:
        a, b = getattr(got_c, name).numpy(), np.asarray(getattr(ref_c, name))
        keep = np.broadcast_to(~written[:, :, None, :], a.shape[:4])
        np.testing.assert_array_equal(a[keep], b[keep])
        if name.endswith("_q"):
            assert (a[~keep] != b[~keep]).mean() < 1e-2
    np.testing.assert_array_equal(got_c.pos.numpy(), np.asarray(ref_c.pos))


def test_batcher_head_major_pool_tokens_identical_to_jax(models):  # noqa: F811
    """ContinuousBatcher(max_batch=40, quant_kv=True) at its default
    head-major pool, prefilling on the promoted twin, 48 requests so that
    slots are re-admitted: the same tokens as the JAX batcher, chunked
    decode at 33-40 live slots (K7a + K5), 5-32 (K7b / K7a + K5 on K1's
    codes) and fewer (K1).  A per-token
    code on a rounding edge (see the decode-step test) can move a token:
    for these requests none does; other request seeds move 1-4 of ~150."""
    m = models
    jb = JBatcher(jllama, m["stacked"], m["jcfg"], quant=m["qcfg"], max_batch=40,
                  max_len=MAX_LEN, quant_kv=True, compute="auto", interpret=True,
                  prefill_params=m["promoted"])
    tb = ContinuousBatcher(tllama, m["t_stacked"], m["tcfg"], max_batch=40,
                           max_len=MAX_LEN, quant_kv=True, prefill_params=m["t_promoted"],
                           device="cpu")
    assert isinstance(tb.caches, QuantKVCache) and tb.caches.pos.shape == (2, 40)
    outs = []
    for b, cls in ((jb, JRequest), (tb, Request)):
        rng = np.random.default_rng(14)
        reqs = [cls(uid=i, prompt=rng.integers(0, m["jcfg"].vocab_size,
                                               size=(int(rng.integers(3, 40)),)),
                    max_new_tokens=int(rng.integers(2, 5))) for i in range(48)]
        for r in reqs:
            b.submit(r)
        b.run_to_completion(chunk=2)
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(g) >= 2 for g in outs[1])
    np.testing.assert_array_equal(tb.pool_pos, jb.pool_pos)
    np.testing.assert_array_equal(tb.key_valid, jb.key_valid)


def test_aligned_head_major_decode_raises_naming_k12(models):  # noqa: F811
    """(L,) aligned positions and no mask over the head-major int8 pool take
    the virtual-tile attention (K12's stacked body for this GQA model, then
    K10) in the JAX package, and now in the port too: one decode step over
    a random pool at position 5 against the JAX package.  As in the
    per-slot test above, a per-token int4 code on a rounding edge may move
    a row, so every row is held to 10 % of its norm with the same greedy
    token, and the rows that did not move to 2e-4; the written codes and
    the positions are identical."""
    m = models
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    n_l, n_kv, d = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    rng = np.random.default_rng(55)
    shape = (n_l, 2, n_kv, MAX_LEN, d)
    pool = dict(k_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                v_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                k_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32),
                v_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32))
    tok = rng.integers(0, jcfg.vocab_size, size=(2, 1))
    jst = jllama.stacked_caches(jcfg, 2, MAX_LEN, jnp.float32, pos=5, quant_kv=True)
    jst = jst._replace(**{k: jnp.asarray(v) for k, v in pool.items()})
    ctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True)
    ref, ref_c = jax.jit(lambda p, ids, c: jllama.forward(p, ids, jcfg, ctx=ctx, caches=c))(
        m["stacked"], jnp.asarray(tok), jst)
    cache = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, smajor=False, pos=5,
                                  device="cpu")
    assert cache.pos.shape == (n_l,)
    for name, v in pool.items():
        getattr(cache, name).copy_(torch.from_numpy(v))
    got, got_c = tllama.forward(m["t_stacked"], torch.from_numpy(tok), tcfg, caches=cache)
    got, ref = got.numpy()[:, 0], np.asarray(ref)[:, 0]
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel.max() <= 0.1
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    assert np.all(np.abs(got - ref) <= 2e-4 + 2e-4 * np.abs(ref), axis=-1).any()
    for name in ("k_q", "v_q", "pos"):
        np.testing.assert_array_equal(getattr(got_c, name).numpy(),
                                      np.asarray(getattr(ref_c, name)))


def test_quant_cache_and_batcher_ask_for_the_card(models):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantKVCache.create(2, 16, 2, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(tllama, models["t_stacked"], models["tcfg"], max_batch=2,
                          max_len=MAX_LEN, quant_kv=True, prefill_params=models["t_promoted"])
    # the fp pool (quant_kv=False, the JAX default) is served now: a stacked
    # head-major KVCache with (L, B) positions
    fp = ContinuousBatcher(tllama, models["t_stacked"], models["tcfg"], max_batch=2,
                           max_len=MAX_LEN, prefill_params=models["t_promoted"], device="cpu")
    assert isinstance(fp.caches, KVCache) and fp.caches.pos.shape == (2, 2)

"""K3 and K12 at any GQA rep and at a caller's softmax scale: their plain
PyTorch versions against the JAX Pallas kernels (jitted, interpret mode)
on the same numpy inputs, and Llama's stacked-decode gate against the
kernels' plan.

On the card both kernels run a rep above 8 in groups of 8 query rows (grid
z), as K11 does; the plain versions hold the function those groups
compute.  JAX's K3 takes reps that are multiples of 8 above 8
(attn_smajor.supported); its K12 pads rep to a multiple of 8, so it takes
rep 12 too.  Tolerances are the existing tests' (test_torch_attn_smajor,
test_torch_attn_fused): K3 2e-4 relative and absolute; K12's f32
attention 2.5e-4 of its largest magnitude, bf16 one rounding, the write
body's row and scale bit for bit."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import attn_fused as jaf
from smoothquant_tpu.kernels.attn_smajor import decode_attention_smajor_stacked as j_attn
from smoothquant_tpu_torch.kernels import attn_fused as taf
from smoothquant_tpu_torch.kernels.attn_smajor import decode_attention_smajor_stacked
from smoothquant_tpu_torch.kernels.decode_attention import MAX_GROUP_REP, plan, rep_groups
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    KVCache,
    QuantKVCache,
    SMajorQuantKVCache,
    decode_bias,
)
from test_torch_attn_fused import L, _both, _check_attn, _inputs

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s", [128, 384])
@pytest.mark.parametrize("sm_scale", [None, 1.0])
def test_k3_rep16_and_scale_match_jax(sm_scale, s):
    """Rep 16 (32 query heads over 2 kv heads: two groups of 8 on the card),
    one and three softmax tiles, the default scale and 1.0, a fully masked
    row: the plain version against JAX's K3."""
    l_num, b, h, n_kv, d = 2, 3, 32, 2, 64
    rng = np.random.default_rng(s + (7 if sm_scale else 0))
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    v_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[2, :] = False
    bias = decode_bias(_t(np.array([40, s - 1, 9])), b, s, _t(mask))
    ref = j_attn(jnp.ones((1,), jnp.int32), jnp.asarray(q), jnp.asarray(k_sm),
                 jnp.asarray(v_sm), jnp.asarray(bias.numpy()), jnp.asarray(ks),
                 jnp.asarray(vs), sm_scale=sm_scale, interpret=True)
    got = decode_attention_smajor_stacked(1, _t(q), _t(k_sm), _t(v_sm), bias, _t(ks), _t(vs),
                                          sm_scale=sm_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    assert not got[2].any()
    if sm_scale is not None:   # the scale reaches the scores
        other = decode_attention_smajor_stacked(1, _t(q), _t(k_sm), _t(v_sm), bias, _t(ks),
                                                _t(vs))
        assert not torch.allclose(other, got, atol=1e-3)


@pytest.mark.parametrize("h,sm_scale,dt", [(32, None, "float32"), (24, None, "float32"),
                                           (32, 1.0, "float32"), (32, None, "bfloat16")],
                         ids=["rep16", "rep12", "rep16-scale1", "rep16-bf16"])
def test_k12_any_rep_and_scale_match_jax(h, sm_scale, dt):
    """Rep 16 and 12 over 2 kv heads (two groups on the card, the second of
    4 rows at rep 12) and sm_scale 1.0: the stacked body and the write body
    against JAX's (which pads rep to 16), the written row and scales bit for
    bit, every other row untouched."""
    n_kv, pos = 2, 57
    inp = _inputs(2, h, n_kv, seed=h + (3 if sm_scale else 0))
    j, t = _both(inp, dt)
    kw = {} if sm_scale is None else {"sm_scale": sm_scale}
    ref = jaf.fused_virtual_attn_stacked(1, pos, *j, interpret=True, **kw)
    got = taf.fused_virtual_attn_stacked(1, pos, *t, **kw)
    _check_attn(got, ref, dt)
    ref_w = jaf.fused_rope_write_attn_stacked(1, pos, *j, interpret=True, **kw)
    before = [x.clone() for x in t[5:]]
    got_w = taf.fused_rope_write_attn_stacked(1, pos, *t, **kw)
    _check_attn(got_w, ref_w[0], dt)
    for name, g, r, b0 in zip(("k_q", "v_q", "ks", "vs"), t[5:], ref_w[1:], before):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        changed = (g != b0).reshape(L, 2, n_kv, g.shape[3], -1).any(-1).any(1).any(1)
        assert not changed[0].any() and not changed[2].any()
        assert not changed[1][torch.arange(g.shape[3]) != pos].any()


# ---------------------------------------------------------------- Llama's gate


def _cache(layout, b, s, n_kv, d, dtype):
    """A stacked cache of the layout on the meta device (the gate reads
    shapes only): S-major int8, head-major int8 with (L,) aligned or (L, B)
    per-slot positions, head-major fp."""
    dev = torch.device("meta")
    if layout == "smajor":
        return SMajorQuantKVCache.create(b, s, n_kv, d, dev, n_layers=2)
    if layout == "fp":
        return KVCache.create(b, s, n_kv, d, dtype, dev, n_layers=2)
    return QuantKVCache.create(b, s, n_kv, d, device=dev, n_layers=2,
                               per_slot=layout == "int8_per_slot")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_llama_gate_admits_only_shapes_a_plan_takes(dtype, monkeypatch):
    """Every (S, H, H_kv, D) that llama._prefetch_capable admits, over each
    layout, gets a plan from the attention kernel that layout runs (K3 over
    the S-major cache, K12 over the aligned int8 head-major cache in "auto"
    / "fused", K11 otherwise): a gated step raises no ValueError on the
    card.  Rep 16 and 12 are admitted over every layout (K3 and K12 run
    groups of 8 rows); a head_dim outside 64 / 128 / 256 and a flash body
    past its shared memory (f32 queries over 32768 positions at rep 2 and
    above) are declined, as JAX's gate declines what its kernels refuse.
    The tree check (prefetch_tree_capable) is stubbed true: the gate's
    shape rule is under test."""
    monkeypatch.setattr(tllama, "prefetch_tree_capable", lambda *a: True)
    params = {"layers": {"stacked": {}},
              "embed_tokens": {"weight": torch.zeros((1, 1), dtype=dtype)}}
    b = 4
    admitted, declined = [], []
    shapes = itertools.product((128, 384, 512, 4096, 32768, 100),
                               ((32, 32), (32, 8), (32, 2), (24, 2), (71, 1), (12, 4)),
                               (64, 128, 192, 256))
    for s, (h, n_kv), d in shapes:
        cfg = tllama.LlamaConfig(hidden_size=h * d, num_attention_heads=h,
                                 num_key_value_heads=n_kv, num_hidden_layers=2)
        for layout, fuse in (("smajor", None), ("int8", "auto"), ("int8", "fused"),
                             ("int8", "off"), ("int8_per_slot", "auto"), ("fp", None)):
            cache = _cache(layout, b, s, n_kv, d, dtype)
            ctx = None if fuse is None else ForwardContext(fuse_attn=fuse)
            key = (s, h, n_kv, d, layout, fuse)
            if not tllama._prefetch_capable(params, cfg, ctx, cache, 1):
                declined.append(key)
                continue
            admitted.append(key)
            kernel = ("K3" if layout == "smajor" else
                      "K12" if layout == "int8" and fuse in ("auto", "fused") else "K11")
            body, ranks = plan(kernel, dtype, b * n_kv, s, d, h // n_kv)
            assert body in ("split", "flash") and (ranks > 0) == (body == "split"), key
    reps = {h // n_kv for s, h, n_kv, d, *_ in admitted}
    assert {16, 12, 71} <= reps and any(k[2:] == (2, 128, "smajor", None) for k in admitted)
    assert all(k[3] != 192 for k in admitted) and all(k[0] != 100 for k in admitted)
    if dtype == torch.float32:   # the flash body: a group's score rows of 32768 floats
        assert not any(k[0] == 32768 and k[1] // k[2] > 1 for k in admitted)
        assert any(k[0] == 32768 and k[1] == k[2] for k in admitted)
        assert any(k[0] == 32768 and k[1] // k[2] == 16 for k in declined)
    assert rep_groups(16) == 2 and rep_groups(12) == 2 and MAX_GROUP_REP == 8
    assert len(admitted) + len(declined) == 6 * 6 * 4 * 6

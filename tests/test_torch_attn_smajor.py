"""K2 (write_quant_cache_smajor) and K3 (decode_attention_smajor_stacked)
plain PyTorch versions vs the JAX Pallas kernels in interpret mode; K3's
split-S decomposition emulated in PyTorch and its shape rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.attn_smajor import (
    decode_attention_smajor_stacked as j_attn,
    write_quant_cache_smajor as j_write,
)
from smoothquant_tpu_torch.kernels.attn_smajor import (
    LAUNCH_KEYS,
    NEG_INF,
    decode_attention_smajor_stacked,
    write_quant_cache_smajor,
)
from smoothquant_tpu_torch.kernels.decode_attention import _pick_tile_s, plan
from smoothquant_tpu_torch.models.common import decode_bias

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rotary", [True, False])
def test_write_cache_plain_matches_jax(rotary):
    """Per-slot positions, one past S-1 (clamped to the last row): the int8
    rows are bit-exact, the scales match to rtol 1e-6, nothing else moves."""
    l_num, b, h, s, d = 2, 4, 8, 64, 64
    rng = np.random.default_rng(1)
    k_new = rng.normal(size=(b, h, d)).astype(np.float32)
    v_new = rng.normal(size=(b, h, d)).astype(np.float32)
    ang = rng.uniform(0, 6.3, size=(b, 1, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    k_sm = rng.integers(-127, 128, size=(l_num, b, s, h * d)).astype(np.int8)
    v_sm = rng.integers(-127, 128, size=(l_num, b, s, h * d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.02, size=(l_num, b, h, s)).astype(np.float32)
    vs = rng.uniform(0.01, 0.02, size=(l_num, b, h, s)).astype(np.float32)
    pos = np.array([5, 0, 63, 70], np.int32)

    ref = j_write(jnp.int32(1), jnp.asarray(pos), jnp.asarray(k_new),
                  jnp.asarray(v_new), jnp.asarray(cos), jnp.asarray(sin),
                  jnp.asarray(k_sm), jnp.asarray(v_sm), jnp.asarray(ks),
                  jnp.asarray(vs), rotary=rotary, interpret=True)
    got = [_t(a) for a in (k_sm, v_sm, ks, vs)]
    write_quant_cache_smajor(1, _t(pos), _t(k_new), _t(v_new), _t(cos), _t(sin),
                             *got, rotary=rotary)
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(ref[2:], got[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    # row 63 of slot 3 was written (pos 70 clamped to S-1); others untouched
    assert not np.array_equal(got[0][1, 3, 63].numpy(), k_sm[1, 3, 63])
    np.testing.assert_array_equal(got[0][0].numpy(), k_sm[0])
    np.testing.assert_array_equal(got[0][1, 0, 6].numpy(), k_sm[1, 0, 6])


@pytest.mark.parametrize("h,n_kv,s", [(8, 8, 128), (8, 2, 128), (8, 8, 384), (8, 2, 384),
                                       (8, 8, 1024), (8, 2, 1024)],
                         ids=["8-8", "8-2", "8-8-384", "8-2-384", "8-8-1024", "8-2-1024"])
def test_decode_attention_plain_matches_jax(h, n_kv, s):
    """One softmax tile (S = 128), three of 128 (S = 384) and two of 512
    (S = 1024): the TPU kernel forms p against the running max of each tile
    and rounds p·v_scale to bf16 there, so the plain version follows the
    tiles, not the row's exact max.  MHA and GQA, a fully masked row."""
    l_num, b, d = 2, 3, 64
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    v_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[2, :] = False            # a fully masked row outputs 0
    pos = np.array([40, s - 1, 9])
    bias = decode_bias(_t(pos), b, s, _t(mask))
    ref = j_attn(jnp.ones((1,), jnp.int32), jnp.asarray(q), jnp.asarray(k_sm),
                 jnp.asarray(v_sm), jnp.asarray(bias.numpy()), jnp.asarray(ks),
                 jnp.asarray(vs), interpret=True)
    got = decode_attention_smajor_stacked(1, _t(q), _t(k_sm), _t(v_sm), bias,
                                          _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    assert not got[2].any()


def test_decode_bias_matches_jax():
    from smoothquant_tpu.models.common import decode_bias as j_bias

    rng = np.random.default_rng(5)
    mask = rng.random((3, 32)) > 0.4
    pos = np.array([3, 31, 40], np.int32)
    ref = j_bias(jnp.asarray(pos), 3, 32, jnp.asarray(mask))
    np.testing.assert_array_equal(decode_bias(_t(pos), 3, 32, _t(mask)).numpy(),
                                  np.asarray(ref))


# ---------------------------------------------------------------- the split-S body


def split_emulation(qf, kl, vl, ks, vs, ranks, *, bias=None, pos=None, stage=32):
    """The split-S body of csrc/split_decode.cuh in PyTorch, over one layer
    viewed head-major: qf (B, H_kv, rep, D) f32, kl / vl (B, H_kv, S, D)
    int8, ks / vs (B, H_kv, S) f32; the mask from a (B, S) bias (K11, K3) or
    from the scalar pos (K12: columns < pos, no bias staged).  Rank j takes
    positions [j·chunk, (j + 1)·chunk): its unmasked range [lo, hi] — from
    the bias, or [0, pos − c0) at once — and the `stage`-position stages
    that cover it are all it reads (S-major: whole TMA boxes; the rows past
    [lo, hi] are read and not used); its scores (a masked position keeps the
    bias, or NEG_INF, as its score) and its maxima of each tile it touches;
    each tile's max over the ranks that hold it; the TPU kernel's running
    max, m_safe and α scanned from them, F_t = Π_{u>t} α_u; each rank's
    l = Σ F_t·p and partial Σ F_t·bf16(p·v_scale)·v over its live rows; l
    and the partials summed in rank order.  Returns (the running max after
    the last tile, l, acc) — K3 divides, K12 folds its new row in first."""
    b, g, rep, d = qf.shape
    s = kl.shape[2]
    ts = _pick_tile_s(s)
    n_tiles, chunk = s // ts, s // ranks
    if pos is not None:
        bias = torch.where(torch.arange(s) < pos, 0.0, NEG_INF).float()[None].expand(b, s)
    live = bias > -1e29
    sc = bias[:, None, None, :].expand(b, g, rep, s).clone()
    read = torch.zeros((b, s), dtype=torch.bool)
    tile_max = torch.full((ranks, b, g, rep, n_tiles), -np.inf)
    for j in range(ranks):
        c0 = j * chunk
        for bi in range(b):
            on = live[bi, c0:c0 + chunk].nonzero().flatten()
            if on.numel() == 0:
                continue
            lo, hi = c0 + int(on.min()), c0 + int(on.max())
            r0 = c0 + (lo - c0) // stage * stage
            r1 = min(c0 + ((hi - c0) // stage + 1) * stage, s)
            read[bi, r0:r1] = True
            sel = torch.arange(lo, hi + 1)
            sel = sel[live[bi, sel]]
            x = torch.einsum("grd,gsd->grs", qf[bi], kl[bi][:, sel].float()) * (1.0 / np.sqrt(d))
            sc[bi][..., sel] = x * ks[bi][:, None, sel] + bias[bi, sel]
        for t in range(n_tiles):
            lo_t, hi_t = max(t * ts, c0), min((t + 1) * ts, c0 + chunk)
            if lo_t < hi_t:
                tile_max[j, ..., t] = sc[..., lo_t:hi_t].amax(-1)
    assert bool(read[live].all()), "a live row outside the stages read"
    m_t = tile_max.amax(0)
    m_safe = torch.empty_like(m_t)
    alpha = torch.zeros_like(m_t)
    m_run = None
    for t in range(n_tiles):
        m_new = m_t[..., t] if t == 0 else torch.maximum(m_run, m_t[..., t])
        m_safe[..., t] = torch.clamp_min(m_new, NEG_INF / 2)
        if t:
            alpha[..., t] = torch.exp(m_run - m_safe[..., t])
        m_run = m_new
    f_t = torch.ones_like(m_t)
    for t in range(n_tiles - 2, -1, -1):
        f_t[..., t] = f_t[..., t + 1] * alpha[..., t + 1]
    tile_of = torch.arange(s) // ts
    l_sum = torch.zeros((b, g, rep, 1))
    acc = torch.zeros((b, g, rep, d))
    for j in range(ranks):
        p_j = torch.arange(j * chunk, (j + 1) * chunk)
        f = f_t[..., tile_of[p_j]]
        p = torch.exp(sc[..., p_j] - m_safe[..., tile_of[p_j]])
        l_sum = l_sum + (f * p).sum(-1, keepdim=True)
        w = f * (p * vs[:, :, None, p_j]).to(torch.bfloat16).float() * live[:, None, None, p_j]
        acc = acc + torch.einsum("bgrs,bgsd->bgrd", w, vl[:, :, p_j].float())
    return m_run[..., None], l_sum, acc


def _smajor_case(rng, b, h, n_kv, s, d):
    l_num = 2
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    q = _t(q).to(torch.bfloat16).float().numpy()          # the split body takes bf16 queries
    k_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    v_sm = rng.integers(-127, 128, size=(l_num, b, s, n_kv * d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(l_num, b, n_kv, s)).astype(np.float32)
    mask = rng.random((b, s)) > 0.2
    mask[3] = False                                      # a fully masked slot
    mask[2, : s - 40] = False                            # valid only in the last tile
    pos = np.array([s - 1, 5, s - 1, 0])                 # slot 1: inside the first tile
    bias = decode_bias(_t(pos), b, s, _t(mask))
    return q, k_sm, v_sm, ks, vs, bias


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("s", [512, 640])
@pytest.mark.parametrize("h,n_kv", [(8, 8), (8, 2)])
def test_split_emulation_matches_plain_and_jax(h, n_kv, s, ranks):
    """K3 on the split-S body over the S-major layout: the decomposition
    emulated in PyTorch (split_emulation: per-rank bias ranges and stages,
    tile maxima exchanged, F_t-weighted partials in rank order) against the
    plain version and the JAX kernel (interpret mode) at the K3 tolerance
    (2e-4), at ranks 1-8, over one 512-wide tile and five 128-wide ones:
    a slot over the whole cache with holes, one over positions 0-5, one
    over the last tile only, a fully masked one."""
    b, d = 4, 64
    rng = np.random.default_rng(200 + ranks + s + n_kv)
    q, k_sm, v_sm, ks, vs, bias = _smajor_case(rng, b, h, n_kv, s, d)
    qf = _t(q).reshape(b, n_kv, h // n_kv, d)
    hm = lambda a: _t(a[1]).reshape(b, s, n_kv, d).transpose(1, 2)
    _, l_sum, acc = split_emulation(qf, hm(k_sm), hm(v_sm), _t(ks[1]), _t(vs[1]), ranks,
                                    bias=bias)
    got = (acc / torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))).reshape(b, h, d)
    plain = decode_attention_smajor_stacked(1, _t(q), _t(k_sm), _t(v_sm), bias, _t(ks),
                                            _t(vs))
    ref = _jax_k3(q, k_sm, v_sm, bias, ks, vs)
    for other in (plain.numpy(), ref):
        np.testing.assert_allclose(got.numpy(), other, rtol=2e-4, atol=2e-4)
    assert not got[3].any()


_JAX_K3 = {}


def _jax_k3(q, k_sm, v_sm, bias, ks, vs):
    """The JAX kernel's output (interpret mode) at layer 1, computed once a case."""
    key = (q.tobytes(), k_sm.shape)
    if key not in _JAX_K3:
        _JAX_K3[key] = np.asarray(j_attn(
            jnp.ones((1,), jnp.int32), jnp.asarray(q), jnp.asarray(k_sm), jnp.asarray(v_sm),
            jnp.asarray(bias.numpy()), jnp.asarray(ks), jnp.asarray(vs), interpret=True))
    return _JAX_K3[key]


def test_body_rule_and_planner():
    """K3 takes K11's rules (decode_attention.plan): bf16 queries at D = 64 /
    128 the split body in split_ranks(B·H_kv, S) ranks — Llama B = 4 over
    512 in 4, B = 64 in 1, B = 4 over 1024 in 4, 8 kv heads at B = 4 in 8 —
    f32 queries and D = 256 the flash body; a forced body or split raises
    where it does not fit, as do S not tileable by 128 and D = 96; each
    body counts under its key."""
    bf, f32 = torch.bfloat16, torch.float32
    assert plan("K3", bf, 4 * 32, 512, 128, 1) == ("split", 4)
    assert plan("K3", bf, 64 * 32, 512, 128, 1) == ("split", 1)
    assert plan("K3", bf, 4 * 32, 1024, 128, 1) == ("split", 4)
    assert plan("K3", bf, 4 * 8, 512, 64, 4) == ("split", 8)
    assert plan("K3", f32, 4 * 32, 512, 128, 1) == ("flash", 0)
    assert plan("K3", bf, 4 * 32, 512, 256, 1) == ("flash", 0)
    assert plan("K3", bf, 4 * 32, 512, 128, 1, split=8) == ("split", 8)
    for kw in (dict(body="split", s=512, d=128, q=f32), dict(body="split", s=512, d=256, q=bf),
               dict(split=16, s=512, d=128, q=bf), dict(s=100, d=128, q=bf),
               dict(s=512, d=96, q=bf), dict(body="tiles", s=512, d=128, q=bf),
               dict(body="flash", s=65536, d=128, q=f32)):
        with pytest.raises(ValueError):
            plan("K3", kw["q"], 4 * 32, kw["s"], kw["d"], 1, kw.get("body"), kw.get("split"))
    assert LAUNCH_KEYS == {"split": "decode_attention_smajor_stacked",
                           "flash": "decode_attention_smajor_stacked_flash"}

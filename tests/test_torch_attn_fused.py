"""K12, the virtual-tile decode attention: the port's plain PyTorch version
of its three bodies against the JAX Pallas kernel (jitted, interpret mode)
on the same numpy inputs, as tests/test_attn_fused.py builds them.

The write body's cache bytes and scales are bit-exact (the same rotary fma
and reciprocal-multiply quantize as K10).  The attention folds the new
position in last on both sides; what is left is another f32 summation
order (the einsum's dots and tile sums against XLA's).  Each probability
is rounded to bf16 before PV, as the TPU kernel rounds it, and a last-bit
difference in a score can put one on the other side of a bf16 rounding
edge: one bf16 ulp of one position's weight, up to 1.3e-4 of the output's
largest magnitude in these cases.  So the f32 attention is held to 2.5e-4
of that magnitude, eight times inside the 2e-3 the JAX tests allow between
K12 and the unfused composition, and bf16 queries to one bf16 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import attn_fused as jaf
from smoothquant_tpu_torch.kernels import attn_fused as taf
from smoothquant_tpu_torch.kernels import cache_write as tcw
from smoothquant_tpu_torch.kernels.attn_smajor import _rot_half
from smoothquant_tpu_torch.kernels.decode_attention import plan
from smoothquant_tpu_torch.quant.core import fma_f32
from test_torch_attn_smajor import split_emulation

torch.set_num_threads(1)

L, S, D = 3, 128, 128
F32_TOL = 2.5e-4


def _inputs(b, h, n_kv, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.normal(size=(b, h, D)).astype(np.float32),
        k_new=rng.normal(size=(b, n_kv, D)).astype(np.float32),
        v_new=rng.normal(size=(b, n_kv, D)).astype(np.float32),
        cos=rng.uniform(-1, 1, size=(b, 1, D)).astype(np.float32),
        sin=rng.uniform(-1, 1, size=(b, 1, D)).astype(np.float32),
        k_q=rng.integers(-127, 128, size=(L, b, n_kv, S, D)).astype(np.int8),
        v_q=rng.integers(-127, 128, size=(L, b, n_kv, S, D)).astype(np.int8),
        ks=rng.uniform(0.005, 0.02, size=(L, b, n_kv, S)).astype(np.float32),
        vs=rng.uniform(0.005, 0.02, size=(L, b, n_kv, S)).astype(np.float32))


_JDT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(inp, dt):
    """(JAX args, port args) of the same values; q / k / v in dtype dt."""
    jdt, tdt = _JDT[dt]
    names = ("q", "k_new", "v_new", "cos", "sin", "k_q", "v_q", "ks", "vs")
    j = [jnp.asarray(inp[n]).astype(jdt) if n in ("q", "k_new", "v_new") else
         jnp.asarray(inp[n]) for n in names]
    t = [torch.from_numpy(inp[n].copy()).to(tdt) if n in ("q", "k_new", "v_new") else
         torch.from_numpy(inp[n].copy()) for n in names]
    return j, t


def _check_attn(got, ref, dt):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dt == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL * np.abs(ref).max())
    else:   # one bf16 rounding of the output apart at most
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotary", [True, False])
@pytest.mark.parametrize("pos", [0, 9, 127])
@pytest.mark.parametrize("h,n_kv", [(4, 4), (8, 2)])
def test_stacked_bodies_match_jax(h, n_kv, pos, rotary, dt):
    """The stacked body (no write) and the write body: attention within the
    stated tolerance, the written row and scale bit-exact, every other
    position and layer untouched."""
    assert taf.fused_attn_supported(S, h, n_kv, D) == jaf.fused_attn_supported(S, h, n_kv, D)
    inp = _inputs(2, h, n_kv, seed=pos + 7 * h)
    j, t = _both(inp, dt)
    ref = jaf.fused_virtual_attn_stacked(1, pos, *j, rotary=rotary, interpret=True)
    got = taf.fused_virtual_attn_stacked(1, pos, *t, rotary=rotary)
    _check_attn(got, ref, dt)
    assert got.dtype == _JDT[dt][1]

    ref_w = jaf.fused_rope_write_attn_stacked(1, pos, *j, rotary=rotary, interpret=True)
    before = [x.clone() for x in t[5:]]
    got_w = taf.fused_rope_write_attn_stacked(1, pos, *t, rotary=rotary)
    _check_attn(got_w, ref_w[0], dt)
    for name, g, r, b0 in zip(("k_q", "v_q", "ks", "vs"), t[5:], ref_w[1:], before):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        changed = (g != b0).reshape(L, 2, n_kv, S, -1).any(-1).any(1).any(1)   # (L, S)
        assert not changed[0].any() and not changed[2].any()          # layer isolation
        assert not changed[1][torch.arange(S) != pos].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotary", [True, False])
@pytest.mark.parametrize("pos", [0, 9, 127])
def test_flat_body_matches_jax(pos, rotary, dt):
    """The flat body (MHA): PRE-rotary flat q, the rotary in f32 rounded to
    q's dtype before the dot, flat output."""
    b, h = 2, 4
    inp = _inputs(b, h, h, seed=11 + pos)
    j, t = _both(inp, dt)
    j[0] = j[0].reshape(b, 1, h * D)
    t[0] = t[0].reshape(b, 1, h * D)
    ref = jaf.fused_virtual_attn_flat(2, pos, *j, rotary=rotary, interpret=True)
    got = taf.fused_virtual_attn_flat(2, pos, *t, rotary=rotary)
    assert got.shape == (b, 1, h * D)
    _check_attn(got, ref, dt)


def test_virtual_row_is_k10s_row():
    """The write body writes what K10 writes from the same k / v at the
    same position (one code, one scale per (slot, kv head))."""
    inp = _inputs(3, 8, 2, seed=5)
    _, t = _both(inp, "bfloat16")
    t10 = [x.clone() for x in t]
    taf.fused_rope_write_attn_stacked(0, 40, *t)
    tcw.write_quant_cache_stacked(0, torch.tensor(40, dtype=torch.int32), *t10[1:])
    for a, b in zip(t[5:], t10[5:]):
        assert torch.equal(a, b)


def test_layer_selection_and_options():
    """Each layer index reads its own layer; a caller's softmax scale is the
    JAX kernel's; the option the port leaves out raises."""
    inp = _inputs(2, 4, 4, seed=3)
    j, t = _both(inp, "float32")
    for i in range(L):
        ref = jaf.fused_virtual_attn_stacked(i, 50, *j, interpret=True)
        _check_attn(taf.fused_virtual_attn_stacked(i, 50, *t), ref, "float32")
    with pytest.raises(NotImplementedError, match="int8_dots"):
        taf.fused_virtual_attn_stacked(0, 5, *t, int8_dots=True)
    ref = jaf.fused_virtual_attn_stacked(0, 5, *j, sm_scale=0.5, interpret=True)
    _check_attn(taf.fused_virtual_attn_stacked(0, 5, *t, sm_scale=0.5), ref, "float32")
    assert not taf.fused_attn_supported(100, 4, 4, D)
    assert not taf.fused_attn_supported(S, 6, 4, D)


# ---------------------------------------------------------------- the split-S body


def _k12_emulation(layer, pos, q, k_new, v_new, cos, sin, k_q, v_q, ks, vs, *, flat, ranks,
                   write=False):
    """K12 on the split-S body in PyTorch: split_emulation over columns < pos
    (each rank's row range from the scalar), then the virtual step folded
    into each rank's slice of the (rep, D) outputs — s_v from the new row's
    codes (K10's rotary and quantize), m' = max(m, s_v), α = exp(m −
    m_safe'), p_v = exp(s_v − m_safe'), l' = l·α + p_v, acc' = acc·α +
    bf16(p_v·v_scale)·v — and, for the write body, the row written by the
    rank whose chunk holds min(pos, S − 1).  f32 queries, as the tests'."""
    _, b, n_kv, s, d = k_q.shape
    h = q.shape[-1] // d if flat else q.shape[1]
    rep = h // n_kv
    (k8, ksc), (v8, vsc) = taf.new_row_codes(k_new, v_new, cos, sin)
    qf = q.reshape(b, h, d).float()
    if flat:
        c, sn = taf._tables(cos, sin, b, d)
        qf = fma_f32(qf, c[:, None], _rot_half(qf) * sn[:, None]).to(q.dtype).float()
    qf = qf.reshape(b, n_kv, rep, d)
    m, l_sum, acc = split_emulation(qf, k_q[layer], v_q[layer], ks[layer], vs[layer], ranks,
                                    pos=pos)
    s_v = torch.einsum("bgrd,bgd->bgr", qf, k8.float())[..., None]
    s_v = s_v * (1.0 / np.sqrt(d)) * ksc[..., None, None]
    m_safe = torch.clamp_min(torch.maximum(m, s_v), taf.NEG_INF / 2)
    alpha, p_v = torch.exp(m - m_safe), torch.exp(s_v - m_safe)
    l2 = l_sum * alpha + p_v
    den = torch.where(l2 > 0, l2, torch.ones_like(l2))
    pw = (p_v * vsc[..., None, None]).to(torch.bfloat16).float()
    out = torch.empty((b, n_kv, rep * d))
    width = rep * d // ranks
    for j in range(ranks):                      # rank j's slice of the outputs
        e = torch.arange(j * width, (j + 1) * width)
        r, dd = e // d, e % d
        out[..., e] = ((acc.reshape(b, n_kv, rep * d)[..., e] * alpha[:, :, r, 0]
                        + pw[:, :, r, 0] * v8.float()[..., dd]) / den[:, :, r, 0])
    if write:
        row = min(max(pos, 0), s - 1)
        assert row // (s // ranks) in range(ranks)      # one rank's chunk holds it
        for buf, x in ((k_q, k8), (v_q, v8), (ks, ksc), (vs, vsc)):
            buf[layer][:, :, row] = x
    return out.reshape(q.shape).to(q.dtype)


_JAX_K12 = {}


def _k12_case(s, pos, body):
    """(port args, JAX output(s)) of one K12 split case over a two-layer
    cache of S positions, computed once a case."""
    if (s, pos, body) not in _JAX_K12:
        b, h, n_kv = (2, 4, 4) if body == "flat" else (2, 8, 2)
        rng = np.random.default_rng(s + pos + len(body))
        inp = dict(
            q=rng.normal(size=(b, h, D)).astype(np.float32),
            k_new=rng.normal(size=(b, n_kv, D)).astype(np.float32),
            v_new=rng.normal(size=(b, n_kv, D)).astype(np.float32),
            cos=rng.uniform(-1, 1, size=(b, 1, D)).astype(np.float32),
            sin=rng.uniform(-1, 1, size=(b, 1, D)).astype(np.float32),
            k_q=rng.integers(-127, 128, size=(2, b, n_kv, s, D)).astype(np.int8),
            v_q=rng.integers(-127, 128, size=(2, b, n_kv, s, D)).astype(np.int8),
            ks=rng.uniform(0.005, 0.02, size=(2, b, n_kv, s)).astype(np.float32),
            vs=rng.uniform(0.005, 0.02, size=(2, b, n_kv, s)).astype(np.float32))
        j, _ = _both(inp, "float32")
        if body == "flat":
            j[0] = j[0].reshape(b, 1, h * D)
            inp["q"] = inp["q"].reshape(b, 1, h * D)
        fn = {"flat": jaf.fused_virtual_attn_flat, "stacked": jaf.fused_virtual_attn_stacked,
              "write": jaf.fused_rope_write_attn_stacked}[body]
        _JAX_K12[s, pos, body] = inp, fn(1, pos, *j, interpret=True)
    inp, ref = _JAX_K12[s, pos, body]
    return _both(inp, "float32")[1], ref


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("s,pos", [(512, 0), (512, 9), (512, 511), (640, 0), (640, 9),
                                   (640, 639)])
@pytest.mark.parametrize("body", ["flat", "stacked", "write"])
def test_split_emulation_matches_plain_and_jax(body, s, pos, ranks):
    """K12's three bodies on the split-S body, emulated in PyTorch
    (_k12_emulation), against the plain version and the JAX kernel
    (interpret mode) at the f32 tolerance, at ranks 1-8, over one 512-wide
    softmax tile and five 128-wide ones, at pos 0 (only the new row), pos
    inside the first tile and pos = S − 1; the write body's row and scales
    identical to the plain version's and JAX's."""
    t, ref = _k12_case(s, pos, body)
    flat, write = body == "flat", body == "write"
    emu_c = [x.clone() for x in t[5:]]
    got = _k12_emulation(1, pos, *t[:5], *emu_c, flat=flat, ranks=ranks, write=write)
    plain = taf.fused_attn_plain(1, pos, *t, flat=flat, write_cache=write)
    _check_attn(got, ref[0] if write else ref, "float32")
    _check_attn(got, plain.numpy(), "float32")
    if write:
        for name, g, p, r in zip(("k_q", "v_q", "ks", "vs"), emu_c, t[5:], ref[1:]):
            assert torch.equal(g, p), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def test_split_body_rule_and_keys():
    """K12's design rule is K11's (decode_attention.plan): bf16 queries at D
    = 64 / 128 take the split body in split_ranks(B·H_kv, S) ranks (B = 4 at
    Llama's 32 heads over 512: 4; B = 64: 1; the GQA share, 8 kv heads: 8),
    f32 queries and D = 256 the flash body, each counted under its key."""
    bf, f32 = torch.bfloat16, torch.float32
    assert plan("K12", bf, 4 * 32, 512, 128, 1) == ("split", 4)
    assert plan("K12", bf, 64 * 32, 512, 128, 1) == ("split", 1)
    assert plan("K12", bf, 4 * 8, 512, 128, 4) == ("split", 8)
    assert plan("K12", f32, 4 * 32, 512, 128, 1) == ("flash", 0)
    assert plan("K12", bf, 4 * 32, 512, 256, 1) == ("flash", 0)
    with pytest.raises(ValueError, match="split body"):
        plan("K12", f32, 4 * 32, 512, 128, 1, body="split")
    assert taf.LAUNCH_KEYS == {"split": "fused_attn", "flash": "fused_attn_flash"}

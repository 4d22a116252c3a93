"""K11 (decode_attention_stacked / decode_attention) plain PyTorch version vs
the JAX Pallas kernel in interpret mode: fp and int8 head-major caches,
MHA and GQA, masked holes and fully masked rows, one and several S tiles;
the ALiBi body (Bloom's slopes) over fp and int8 caches.

Tolerance in f32: 1e-5 relative, plus 1e-5 of the output's largest
magnitude (sums of opposite-signed terms cancel toward zero), from f32
sums taken in another order; a bf16 output may round one bf16 ulp apart.
With ALiBi the scores carry slope·position (up to ~160 here, ~450 at
Bloom-7b1's head 0 over 640 positions), so a last-bit difference of the
q·k sum moves the rounded score by an ulp of that magnitude: 2e-4, the
JAX package's own bound for Bloom (tests/test_prefetch_scan_archs.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import decode_attention as jda
from smoothquant_tpu.models.bloom import alibi_slopes as j_alibi_slopes
from smoothquant_tpu_torch.kernels import decode_attention as k11
from smoothquant_tpu_torch.models.common import decode_bias

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _cache(rng, shape, kind):
    if kind == "int8":
        vals = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(0.005, 0.02, size=shape[:-1]).astype(np.float32)
                  for _ in range(2)]
        return vals, scales
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)], [None, None]


def _bias(rng, b, s, pos):
    mask = rng.random((b, s)) > 0.3
    mask[-1, :] = False                      # a fully masked row gives 0
    return decode_bias(_t(pos), b, s, _t(mask))


CASES = [  # (h, n_kv, s, cache kind, dtype)
    (4, 4, 128, "f32", "float32"),
    (8, 2, 384, "f32", "float32"),          # GQA, three 128-wide tiles
    (4, 4, 1024, "int8", "float32"),        # two 512-wide tiles
    (8, 2, 256, "int8", "float32"),
    (8, 4, 128, "bf16", "bfloat16"),
    (8, 4, 256, "int8", "bfloat16"),
]


@pytest.mark.parametrize("h,n_kv,s,kind,dt", CASES)
def test_decode_attention_stacked_plain_matches_jax(h, n_kv, s, kind, dt):
    l_num, b, d = 2, 3, 64
    rng = np.random.default_rng(s + h)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (l_num, b, n_kv, s, d), kind)
    bias = _bias(rng, b, s, np.array([s // 3, s - 1, 9]))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if kind == "bf16" else jnp.asarray
    cast_t = (lambda a: _t(a).to(torch.bfloat16)) if kind == "bf16" else _t
    sc_j = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    sc_t = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    ref = jda.decode_attention_stacked(
        jnp.ones((1,), jnp.int32), jnp.asarray(q, jdt), cast_j(k), cast_j(v),
        jnp.asarray(bias.numpy()), interpret=True, **sc_j)
    got = k11.decode_attention_stacked(1, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                       **sc_t)
    assert got.dtype == tdt and got.shape == (b, h, d)
    ref = np.asarray(ref, np.float32)
    rtol = 1e-5 if dt == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())
    assert not got[-1].any()


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_decode_attention_per_layer_matches_jax(kind):
    """The per-layer wrapper (a one-layer stack)."""
    b, h, n_kv, s, d = 2, 8, 4, 256, 64
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (b, n_kv, s, d), kind)
    bias = _bias(rng, b, s, np.array([200, 17]))
    sc = [] if ks is None else [ks, vs]
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias.numpy()), *map(jnp.asarray, sc),
                               interpret=True)
    got = k11.decode_attention(_t(q), _t(k), _t(v), bias, *map(_t, sc))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


ALIBI_CASES = [  # (h, s, cache kind, dtype, layer): positions near the end
    (4, 640, "f32", "float32", 1),            # five 128-wide tiles, as Bloom's 640
    (8, 1024, "int8", "float32", 0),          # two 512-wide tiles
    (4, 256, "bf16", "bfloat16", 1),
    (4, 512, "int8", "bfloat16", 1),
]


@pytest.mark.parametrize("h,s,kind,dt,layer", ALIBI_CASES)
def test_decode_attention_alibi_matches_jax(h, s, kind, dt, layer):
    """The ALiBi body: score += slope_h · key position, over the fp and the
    int8 bodies, stacked (layer `layer` of 2) against the JAX kernel."""
    b, d = 3, 64
    rng = np.random.default_rng(s + h + 5)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (2, b, h, s, d), kind)
    bias = _bias(rng, b, s, np.array([s - 1, s - 40, 3]))
    slopes = j_alibi_slopes(h)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if kind == "bf16" else jnp.asarray
    cast_t = (lambda a: _t(a).to(torch.bfloat16)) if kind == "bf16" else _t
    sc_j = [None, None] if ks is None else [jnp.asarray(ks), jnp.asarray(vs)]
    sc_t = [None, None] if ks is None else [_t(ks), _t(vs)]
    ref = jda.decode_attention_stacked(
        jnp.full((1,), layer, jnp.int32), jnp.asarray(q, jdt), cast_j(k), cast_j(v),
        jnp.asarray(bias.numpy()), *sc_j, jnp.asarray(slopes), interpret=True)
    got = k11.decode_attention_stacked(layer, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                       *sc_t, _t(slopes))
    ref = np.asarray(ref, np.float32)
    rtol = 2e-4 if dt == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), ref, rtol=rtol, atol=2e-4 * np.abs(ref).max())
    assert not got[-1].any()
    # the slopes move the output: without them it differs
    plain = k11.decode_attention_stacked(layer, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                         *sc_t)
    assert (got.float() - plain.float()).abs().max() > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_decode_attention_alibi_per_layer_matches_jax(kind):
    """The per-layer wrapper with slopes (Bloom's per-layer decode)."""
    b, h, s, d = 2, 8, 384, 128
    rng = np.random.default_rng(23)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (b, h, s, d), kind)
    bias = _bias(rng, b, s, np.array([300, 17]))
    sc = [None, None] if ks is None else [ks, vs]
    slopes = j_alibi_slopes(h)
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias.numpy()),
                               *[None if a is None else jnp.asarray(a) for a in sc],
                               jnp.asarray(slopes), interpret=True)
    got = k11.decode_attention(_t(q), _t(k), _t(v), bias,
                               *[None if a is None else _t(a) for a in sc], _t(slopes))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())


def test_decode_attention_options_and_support():
    """int8_dots is not ported and raises on any device; ALiBi slopes take
    MHA only (the JAX kernel asserts rep == 1), one per query head; the
    support gate is the JAX one."""
    q = torch.zeros((1, 4, 64))
    k = torch.zeros((1, 1, 4, 128, 64))
    bias = torch.zeros((1, 128))
    with pytest.raises(NotImplementedError, match="int8_dots"):
        k11.decode_attention_stacked(0, q, k, k, bias, int8_dots=True)
    gqa = torch.zeros((1, 1, 2, 128, 64))
    with pytest.raises(ValueError, match="MHA only"):
        k11.decode_attention_stacked(0, q, gqa, gqa, bias, alibi_slopes=torch.ones(4))
    with pytest.raises(ValueError, match="ALiBi slopes"):
        k11.decode_attention_stacked(0, q, k, k, bias, alibi_slopes=torch.ones(2))
    out = k11.decode_attention_stacked(0, q, k, k, bias, alibi_slopes=torch.ones(4))
    assert out.shape == q.shape
    for args in ((128, 32, 32, 128), (384, 8, 2, 64), (100, 8, 8, 64), (128, 8, 8, 80),
                 (512, 6, 4, 64)):
        assert k11.supported(*args) == jda.supported(*args)
    assert k11._pick_tile_s(768) == jda._pick_tile_s(768) == 256


def test_split_body_shape_rules():
    """K11's body rule (bf16 queries at D = 64 / 128 take the split body,
    f32 queries and D = 256 the flash body) and the split planner's ranks at
    the paths' shapes: B = 4 over 512 (128 heads) takes 4 ranks a head,
    B = 64 (2048 heads) one; a rank holds at least 64 positions, at most
    SPLIT_MAX_CHUNK."""
    bf, f32 = torch.bfloat16, torch.float32
    assert k11.attn_body(bf, 128, 512, 1) == "split"
    assert k11.attn_body(bf, 64, 1024, 4) == "split"
    assert k11.attn_body(bf, 128, 640, 8) == "split"
    assert k11.attn_body(f32, 128, 512, 1) == "flash"
    assert k11.attn_body(bf, 256, 512, 1) == "flash"
    assert k11.attn_body(bf, 128, 100, 1) == "flash"            # not tileable
    assert k11.attn_body(bf, 128, 32768, 1) == "flash"          # 8 ranks of 4096 positions
    table = {  # (B·H_kv, S): ranks
        (4 * 32, 512): 4, (4 * 32, 640): 4, (64 * 32, 512): 1, (32 * 32, 512): 1,
        (16 * 32, 512): 1, (8 * 32, 512): 2, (4 * 32, 1024): 4, (4, 128): 2, (1, 128): 2,
        (1, 16384): 8, (2048, 4096): 2, (2048, 8192): 4}
    for (heads, s), ranks in table.items():
        assert k11.split_ranks(heads, s) == ranks, (heads, s)
    for c in k11.SPLITS:
        assert k11._split_fits(640, c) == (c <= 8)
    assert not k11._split_fits(384, 16)
    assert k11._split_fits(384, 8)                              # 48 positions a rank
    with pytest.raises(ValueError):
        k11.split_ranks(4, 100)


def _split_emulation(layer, q, k, v, bias, k_scale, v_scale, slopes, ranks):
    """K11's split body written in PyTorch: the positions cut into `ranks`
    contiguous chunks; each rank's scores and its per-tile maxima; the tile
    maxima combined over the ranks that hold the tile; the TPU kernel's
    running max, m_safe and rescales α scanned from them, and F_t = Π_{u>t}
    α_u; each rank's p = exp(score − m_safe of its tile), l = Σ F_t·p and
    p·v partial Σ F_t·bf16(p [·v_scale])·v over its unmasked positions; the
    partials summed in rank order over their l summed in rank order."""
    b, h, d = q.shape
    kl, vl = k[layer], v[layer]
    n_kv, s = kl.shape[1], kl.shape[2]
    rep = h // n_kv
    ts = k11._pick_tile_s(s)
    n_tiles, chunk = s // ts, s // ranks
    quant = k_scale is not None
    v_dt = torch.bfloat16 if quant else vl.dtype
    qf = q.float().reshape(b, n_kv, rep, d)
    sc = torch.einsum("bgrd,bgsd->bgrs", qf, kl.float()) * (1.0 / np.sqrt(d))
    if quant:
        sc = sc * k_scale[layer][:, :, None, :]
    if slopes is not None:
        sc = sc + slopes.float()[None, :, None, None] * torch.arange(s).float()
    sc = sc + bias[:, None, None, :]
    tile_of = torch.arange(s) // ts
    rank_of = torch.arange(s) // chunk
    m_t = torch.full((b, n_kv, rep, n_tiles), -np.inf)
    for j in range(ranks):                      # each rank publishes its tiles' maxima
        for t in range(n_tiles):
            sel = (rank_of == j) & (tile_of == t)
            if sel.any():
                m_t[..., t] = torch.maximum(m_t[..., t], sc[..., sel].amax(-1))
    m_safe = torch.empty_like(m_t)
    alpha = torch.zeros_like(m_t)
    m_run = None
    for t in range(n_tiles):
        m_new = m_t[..., t] if t == 0 else torch.maximum(m_run, m_t[..., t])
        m_safe[..., t] = torch.clamp_min(m_new, k11.NEG_INF / 2)
        if t:
            alpha[..., t] = torch.exp(m_run - m_safe[..., t])
        m_run = m_new
    f_t = torch.ones_like(m_t)
    for t in range(n_tiles - 2, -1, -1):
        f_t[..., t] = f_t[..., t + 1] * alpha[..., t + 1]
    live = bias > -1e29
    acc = torch.zeros((b, n_kv, rep, d))
    l_sum = torch.zeros((b, n_kv, rep, 1))
    for j in range(ranks):                      # each rank's partials, added in rank order
        pos = torch.arange(j * chunk, (j + 1) * chunk)
        f = f_t[..., tile_of[pos]]
        p = torch.exp(sc[..., pos] - m_safe[..., tile_of[pos]])
        l_sum = l_sum + (f * p).sum(-1, keepdim=True)
        pv = p * v_scale[layer][:, :, None, pos] if quant else p
        w = f * pv.to(v_dt).float() * live[:, None, None, pos]
        acc = acc + torch.einsum("bgrs,bgsd->bgrd", w, vl[:, :, pos].float())
    den = torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))
    return (acc / den).reshape(b, h, d).to(q.dtype)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("s,alibi,kind", [(512, False, "bf16"), (512, False, "int8"),
                                          (640, True, "int8"), (640, True, "bf16"),
                                          (640, False, "int8")])
def test_split_decomposition_matches_plain(ranks, s, alibi, kind):
    """The split body's decomposition (per-rank chunks, tile maxima
    exchanged into the prefix max, F_t-weighted partials combined in rank
    order) against the plain version at chip_smoke's kernel tolerance (1e-2
    of the largest bf16 output), over one 512-wide tile and five 128-wide
    ones, with and without ALiBi: slots over the whole cache, over a few
    positions, over the last tile only, and fully masked."""
    rng = np.random.default_rng(100 + ranks)
    b, d = 4, 128
    h = n_kv = 8 if alibi else 4
    if not alibi:
        h = 8                                   # GQA rep 2
    (k, v), (ks, vs) = _cache(rng, (2, b, n_kv, s, d), kind if kind == "int8" else "f32")
    k, v = _t(k), _t(v)
    if kind == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    ks = None if ks is None else _t(ks)
    vs = None if vs is None else _t(vs)
    q = _t(rng.normal(size=(b, h, d)).astype(np.float32)).to(torch.bfloat16)
    bias = decode_bias(torch.tensor([s - 1, 3, s - 1, s - 1]), b, s, None)
    bias[2, : s - 40] = -1e30                   # only the last tile's positions
    bias[3] = -1e30                             # a fully masked slot
    slopes = _t(j_alibi_slopes(h)) if alibi else None
    ref = k11.decode_attention_stacked_plain(1, q, k, v, bias, ks, vs, slopes)
    got = _split_emulation(1, q, k, v, bias, ks, vs, slopes, ranks)
    assert torch.isfinite(got).all()
    assert got[3].abs().max() == 0
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item() + 1e-6


REP_CASES = [  # (rep, n_kv, s, cache kind, dtype, sm_scale)
    (1, 4, 256, "int8", "bfloat16", 1.0),   # OPT: q scaled at projection
    (4, 2, 256, "f32", "float32", None),
    (8, 1, 384, "int8", "float32", 1.0),
    (9, 2, 256, "bf16", "bfloat16", None),  # two groups of query rows a kv head
    (71, 1, 512, "int8", "bfloat16", None),  # Falcon-7B: 71 heads over one kv head
    (71, 1, 256, "f32", "float32", 1.0),
]


@pytest.mark.parametrize("rep,n_kv,s,kind,dt,scale", REP_CASES)
def test_decode_attention_any_rep_and_scale_matches_jax(rep, n_kv, s, kind, dt, scale):
    """K11 at any rep the JAX kernel takes (H % H_kv == 0, rows padded to 8
    there, in groups of 8 on the card) and at a caller's sm_scale, stacked
    (layer 1 of 2), against the JAX kernel; sm_scale changes the output."""
    b, d = 3, 64
    h = rep * n_kv
    rng = np.random.default_rng(rep + s)
    q = (rng.normal(size=(b, h, d)) * 0.2).astype(np.float32)
    (k, v), (ks, vs) = _cache(rng, (2, b, n_kv, s, d), kind)
    bias = _bias(rng, b, s, np.array([s - 1, s // 2, 5]))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if kind == "bf16" else jnp.asarray
    cast_t = (lambda a: _t(a).to(torch.bfloat16)) if kind == "bf16" else _t
    sc_j = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    sc_t = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    ref = jda.decode_attention_stacked(
        jnp.ones((1,), jnp.int32), jnp.asarray(q, jdt), cast_j(k), cast_j(v),
        jnp.asarray(bias.numpy()), sm_scale=scale, interpret=True, **sc_j)
    got = k11.decode_attention_stacked(1, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                       sm_scale=scale, **sc_t)
    assert got.dtype == tdt and got.shape == (b, h, d)
    ref = np.asarray(ref, np.float32)
    rtol = 1e-5 if dt == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), ref, rtol=rtol, atol=1e-5 * np.abs(ref).max())
    assert not got[-1].any()
    other = k11.decode_attention_stacked(1, _t(q).to(tdt), cast_t(k), cast_t(v), bias,
                                         sm_scale=0.5 if scale is None else None, **sc_t)
    assert (other.float() - got.float()).abs().max() > 1e-3 * np.abs(ref).max()


def test_any_rep_plan():
    """K11's plan at rep above 8: the split body for bf16 queries at D = 64,
    its ranks planned over B·H_kv·⌈rep / 8⌉ clusters (Falcon-7B at B = 4
    over 512: 36 clusters of 8 ranks; at B = 64: 576 of one); the flash
    body's shared memory that of rep 8 whatever the rep; K3 and K12 plan
    the same groups (a Llama of 32 query heads over 2 kv heads, rep 16, at
    B = 4: 16 clusters of 8 ranks)."""
    bf = torch.bfloat16
    assert k11.rep_groups(71) == 9 and k11.rep_groups(8) == 1 and k11.rep_groups(9) == 2
    assert k11.plan("K11", bf, 4, 512, 64, 71) == ("split", 8)
    assert k11.plan("K11", bf, 64, 512, 64, 71) == ("split", 1)
    assert k11.plan("K11", bf, 4, 512, 64, 71) == \
        ("split", k11.split_ranks(4 * 9, 512))
    assert k11.plan("K11", torch.float32, 4, 512, 256, 71) == ("flash", 0)
    with pytest.raises(ValueError, match="shared"):
        k11.plan("K11", torch.float32, 4, 4096, 256, 71)
    for kernel in ("K3", "K12"):
        assert k11.plan(kernel, bf, 4 * 2, 512, 128, 16) == ("split", 8)
        assert k11.plan(kernel, bf, 4, 512, 64, 9) == k11.plan("K11", bf, 4, 512, 64, 9)
        assert k11.plan(kernel, torch.float32, 4, 512, 256, 71) == ("flash", 0)

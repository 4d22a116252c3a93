"""The KV cache writers' row body on the CPU: the fused entry points
(rope_q_write_cache_smajor, K2, and rope_q_write_cache_stacked, K10) in
their plain versions against the JAX package — JAX's apply_rotary on q
(jitted), then its write_quant_cache_smajor / write_quant_cache_stacked
(Pallas, interpret=True, jitted) — on q / k / v sliced from one numpy qkv
array, as Llama's fused qkv row and Bloom's interleaved (nh, 3, D) row lay
them; the port reads them as strided views.  Then Llama's stacked decode
through the fused writer, and the stacked decode with the salient block
stored in another dtype than the rows.

Held: q's bits and every int8 code and scale of the cache identical to
JAX's, with one exception named where it applies: K2's rotary in JAX's
interpret mode on the CPU, where XLA contracts the Pallas body's
x·cos + rot(x)·sin into an fma, which the TPU kernel and the port keep
apart (two rounded products and a rounded sum).  There k's codes and
scales are held bit for bit to a numpy oracle of the body's own rounding,
and to JAX's within one ulp (scales) and one step in under 1e-4 of the
codes (a value at a rounding edge)."""

import dataclasses
import inspect
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels.attn_smajor import write_quant_cache_smajor as j_write_sm
from smoothquant_tpu.kernels.cache_write import write_quant_cache_stacked as j_write_hm
from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.common import apply_rotary as j_apply_rotary
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import QuantConfig as JQ
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.kernels import kv_write
from smoothquant_tpu_torch.kernels.attn_smajor import (
    rope_q_write_cache_smajor,
    write_quant_cache_smajor,
)
from smoothquant_tpu_torch.kernels.cache_write import (
    rope_q_write_cache_stacked,
    write_quant_cache_stacked,
)
from smoothquant_tpu_torch.models import common as tcommon
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.utils.convert import params_from_numpy
from test_torch_llama_serve import to_numpy_tree

torch.set_num_threads(1)

L, B, S = 2, 5, 32
# q heads and kv heads of each qkv layout: Llama MHA, Llama GQA (4 q heads a
# kv head), Bloom's interleaved MHA
LAYOUTS = {"llama_mha": (4, 4), "llama_gqa": (8, 2), "bloom": (4, 4)}
DTYPES = {"float32": (torch.float32, jnp.float32, 64),
          # bf16 at the serving head_dim: at 64, XLA's CPU code for K10's bf16
          # body contracts the rotary's second half the other way round
          # (tests/test_torch_cache_write.py)
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 128)}
POSITIONS = {"slots": np.array([3, 0, S - 1, S + 6, 17], np.int32),
             "aligned_first": np.int32(0), "aligned_last": np.int32(S - 1),
             "aligned_past": np.int32(S + 4)}


def _qkv_rows(layout, n_q, n_kv, d, t_dt, seed):
    """(torch rows (B, F) in t_dt, q / k / v views into them, their values as
    contiguous f32 numpy arrays)."""
    rng = np.random.default_rng(seed)
    n_heads = n_q + 2 * n_kv
    heads = (rng.normal(size=(B, n_heads, d))
             * rng.uniform(0.1, 8.0, size=(B, n_heads, 1))).astype(np.float32)
    if layout == "bloom":   # (nh, 3, D): head h's q, k, v side by side
        rows = np.stack([heads[:, :n_q], heads[:, n_q:n_q + n_kv], heads[:, n_q + n_kv:]],
                        axis=2).reshape(B, -1)
    else:                   # [q heads | k heads | v heads]
        rows = heads.reshape(B, -1)
    t_rows = torch.from_numpy(rows).to(t_dt)
    if layout == "bloom":
        r = t_rows.view(B, n_q, 3, d)
        q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    else:
        q = t_rows[:, :n_q * d].view(B, n_q, d)
        k = t_rows[:, n_q * d:(n_q + n_kv) * d].view(B, n_kv, d)
        v = t_rows[:, (n_q + n_kv) * d:].view(B, n_kv, d)
    vals = [t.float().contiguous().numpy() for t in (q, k, v)]
    return t_rows, (q, k, v), vals


def _cache(smajor, n_kv, d, seed):
    rng = np.random.default_rng(seed)
    shape = (L, B, S, n_kv * d) if smajor else (L, B, n_kv, S, d)
    vals = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.01, 0.02, size=(L, B, n_kv, S)).astype(np.float32)
              for _ in range(2)]
    return vals + scales


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _k2_oracle(k, cos, sin):
    """K2's k rotary and quantize in float32 numpy, every product and sum
    rounded apart: (codes (B, H, D) int8, scales (B, H))."""
    d = k.shape[-1]
    rot = np.concatenate([-k[..., d // 2:], k[..., :d // 2]], axis=-1)
    kr = k * cos + rot * sin
    scale = np.maximum(np.abs(kr).max(-1), np.float32(1e-8)) * np.float32(1.0 / 127.0)
    return np.round(kr / scale[..., None]).astype(np.int8), scale.astype(np.float32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rotary", [True, False], ids=["rotary", "no_rotary"])
@pytest.mark.parametrize("pos_kind", list(POSITIONS))
@pytest.mark.parametrize("smajor", [True, False], ids=["smajor", "head_major"])
def test_fused_write_matches_jax(smajor, pos_kind, rotary, dt, layout):
    """q, k and v as views into one qkv row array; per-slot (B,) positions
    at 0, S − 1 and past S (clamped to S − 1), or one aligned position;
    per-slot (B, 1, D) tables, or one shared (1, 1, D) row.  With rotary
    off (Bloom) no q is rotated and no table passed."""
    n_q, n_kv = LAYOUTS[layout]
    t_dt, j_dt, d = DTYPES[dt]
    seed = zlib.crc32(f"{smajor} {pos_kind} {rotary} {dt} {layout}".encode())
    t_rows, (q, k, v), (qn, kn, vn) = _qkv_rows(layout, n_q, n_kv, d, t_dt, seed)
    if B > 1:
        assert not (k.is_contiguous() or v.is_contiguous())
    pos = POSITIONS[pos_kind]
    rng = np.random.default_rng(seed + 1)
    ang = rng.uniform(0, 300, size=(B if pos.ndim else 1, 1, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    cache = _cache(smajor, n_kv, d, seed + 2)

    j_write = j_write_sm if smajor else j_write_hm
    jt = lambda a: jnp.asarray(a).astype(j_dt)
    tabs_b = [jnp.asarray(np.broadcast_to(t, (B, 1, d))) if rotary
              else jnp.zeros((B, 1, d), jnp.float32) for t in (cos, sin)]
    ref = j_write(jnp.int32(1), jnp.asarray(pos), jt(kn), jt(vn), *tabs_b,
                  *(jnp.asarray(c) for c in cache), rotary=rotary, interpret=True)
    got = [torch.from_numpy(c.copy()) for c in cache]
    write = rope_q_write_cache_smajor if smajor else rope_q_write_cache_stacked
    t_tabs = (torch.from_numpy(cos), torch.from_numpy(sin)) if rotary else (None, None)
    q_rot = write(1, torch.as_tensor(pos), q if rotary else None, k, v, *t_tabs, *got,
                  rotary=rotary)

    if rotary:
        ref_q = jax.jit(j_apply_rotary)(jt(qn)[:, None], jnp.asarray(cos), jnp.asarray(sin))
        assert q_rot.dtype == t_dt and q_rot.shape == (B, n_q, d)
        np.testing.assert_array_equal(_bits(q_rot.float()), _bits(ref_q[:, 0]))
    else:
        assert q_rot is None
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]), err_msg="v codes")
    np.testing.assert_array_equal(_bits(got[3]), _bits(ref[3]), err_msg="v scales")
    if smajor and rotary:
        # XLA contracts JAX's K2 rotary on the CPU into an fma; the body keeps
        # the products apart: bit for bit against the numpy oracle of that
        # rounding, and against JAX scales within one ulp, codes within one
        # step at under 1e-4 of the elements (a value at a rounding edge)
        codes, scales = _k2_oracle(kn, np.broadcast_to(cos, (B, 1, d)),
                                   np.broadcast_to(sin, (B, 1, d)))
        rows = np.minimum(np.broadcast_to(pos, (B,)), S - 1)
        for b in range(B):
            np.testing.assert_array_equal(got[0][1, b, rows[b]].numpy(), codes[b].reshape(-1))
            np.testing.assert_array_equal(_bits(got[2][1, b, :, rows[b]]), _bits(scales[b]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1.2e-7, atol=0)
        diff = np.abs(got[0].numpy().astype(np.int32) - np.asarray(ref[0]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), err_msg="k codes")
        np.testing.assert_array_equal(_bits(got[2]), _bits(ref[2]), err_msg="k scales")
    # the other layer and the unwritten rows keep their bytes
    np.testing.assert_array_equal(got[0][0].numpy(), cache[0][0])
    np.testing.assert_array_equal(got[3][0].numpy(), cache[3][0])


@pytest.mark.parametrize("smajor", [True, False], ids=["smajor", "head_major"])
@pytest.mark.parametrize("layout", ["llama_gqa", "bloom"])
def test_strided_and_contiguous_views_write_the_same(smajor, layout):
    """The writers on k / v as strided views into the qkv rows and on their
    contiguous copies: identical caches and q, through the fused entry
    and through the JAX-signature one."""
    n_q, n_kv = LAYOUTS[layout]
    d = 64
    _, (q, k, v), _ = _qkv_rows(layout, n_q, n_kv, d, torch.float32, 5)
    rng = np.random.default_rng(6)
    cos, sin = (torch.from_numpy(f(rng.uniform(0, 9, size=(B, 1, d))).astype(np.float32))
                for f in (np.cos, np.sin))
    pos = torch.tensor([1, 0, S - 1, S + 3, 9], dtype=torch.int32)
    cache = _cache(smajor, n_kv, d, 7)
    fused = rope_q_write_cache_smajor if smajor else rope_q_write_cache_stacked
    plain = write_quant_cache_smajor if smajor else write_quant_cache_stacked
    outs = []
    for parts in ((q, k, v), tuple(t.contiguous() for t in (q, k, v))):
        a = [torch.from_numpy(c.copy()) for c in cache]
        b = [torch.from_numpy(c.copy()) for c in cache]
        q_rot = fused(0, pos, parts[0], parts[1], parts[2], cos, sin, *a)
        plain(0, pos, parts[1], parts[2], cos, sin, *b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        outs.append((q_rot, a))
    assert torch.equal(outs[0][0], outs[1][0])
    for x, y in zip(outs[0][1], outs[1][1]):
        assert torch.equal(x, y)


def test_write_body_rule():
    """The row body takes head_dim 16-256 (a power of two), 16-byte aligned
    rows in its vector form, others in its scalar form; the first design
    ("warps") takes the other head_dims and no q; a forced body raises on a
    call it does not take."""
    assert kv_write.write_body(128, True) == "rows"
    assert kv_write.write_body(128, False) == "scalar"
    assert kv_write.write_body(96, True) == "warps"
    assert kv_write.write_body(64, True, "scalar") == "scalar"
    assert kv_write.write_body(64, False, "warps") == "warps"
    for args, match in (((96, True, "rows"), "head_dim"), ((64, False, "rows"), "aligned"),
                        ((64, True, "tiles"), "one of"), ((8, True, "scalar"), "head_dim")):
        with pytest.raises(ValueError, match=match):
            kv_write.write_body(*args)
    with pytest.raises(ValueError, match="no q"):
        kv_write.write_body(64, True, "warps", q=torch.zeros(1))
    assert kv_write.launch_key("write_quant_cache_smajor", "rows") == "write_quant_cache_smajor"
    assert kv_write.launch_key("write_quant_cache_stacked", "warps") == \
        "write_quant_cache_stacked_warps"


@pytest.mark.parametrize("entry", [rope_q_write_cache_smajor, rope_q_write_cache_stacked,
                                   write_quant_cache_smajor, write_quant_cache_stacked])
def test_writer_entries_take_no_block_size(entry):
    """The block size of the row body is kv_write.ROW_THREADS on every
    path: no public writer takes it (launch_rows does, for measurements)."""
    assert "threads" not in inspect.signature(entry).parameters
    assert inspect.signature(kv_write.launch_rows).parameters["threads"].default == \
        kv_write.ROW_THREADS


def test_fused_entries_off_the_cpu_launch_or_raise():
    """On a tensor off the CPU the fused entries launch the row body or
    raise: a q with rotary off and a head_dim the row body does not take
    (the warps body rotates no q) raise before any launch."""
    meta = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device="meta")
    args = (meta(2, 4, 96), meta(2, 4, 96), meta(2, 4, 96), meta(2, 1, 96), meta(2, 1, 96),
            meta(1, 2, 4, 8, 96, dt=torch.int8), meta(1, 2, 4, 8, 96, dt=torch.int8),
            meta(1, 2, 4, 8), meta(1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="no kernel"):
        rope_q_write_cache_stacked(0, meta(2, dt=torch.int32), *args)
    with pytest.raises(ValueError, match="rotary"):
        kv_write.launch_rows(False, 0, None, args[0], args[1], args[2], None, None,
                             *args[5:], rotary=False, body=None)


# ---------------------------------------------------------------- Llama's stacked decode

MAX_LEN, PROMPT, STEPS = 128, 6, 3


@pytest.fixture(scope="module")
def llama_model():
    """A 2-layer Llama (8 heads of 64 over 4 kv heads, f32: JAX's S-major
    attention kernel takes query heads in eights) with the serving recipe
    (W4A4 g16, 5 % salient, fused, folded, shared residual basis, identity
    o_proj, int8 lm_head) in both packages, and JAX's prefill of a 2-row
    prompt into per-layer head-major int8 caches."""
    from smoothquant_tpu.models.common import QuantKVCache as JQKV

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=512,
                               intermediate_size=512, num_attention_heads=8,
                               num_key_value_heads=4, num_hidden_layers=2)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(3)
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
    logits, caches = jax.jit(lambda p, ids, c: jllama.forward(p, ids, jcfg, ctx=ctx,
                                                              caches=c))(
        packed, jnp.asarray(prompt), caches)
    t_packed = params_from_numpy(to_numpy_tree(packed), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, qcfg=qcfg, stacked=jllama.stack_layers(packed, jcfg),
                t_stacked=tllama.stack_layers(t_packed, tcfg),
                jst=jax.tree.map(lambda *xs: jnp.stack(xs), *caches),
                first=np.asarray(logits[:, -1]).argmax(-1)[:, None])


def _counting(monkeypatch, module, name, calls, check=None):
    fn = getattr(module, name)

    def counted(*args, **kw):
        if check is not None:
            check(*args, **kw)
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("mode", ["smajor", "off"])
def test_llama_stacked_decode_through_the_fused_writer(llama_model, mode, monkeypatch):
    """STEPS greedy tokens over the stacked tree from JAX's prefill, with
    ragged per-slot positions: "smajor" over the S-major pool (K2 + K3),
    "off" over the head-major one (K10 + K11).  The tokens and every int8
    code of the cache are identical to JAX's step after every step (the
    scales within 1e-6 relative: the new rows are the f32 output of the qkv
    linear, whose sums run in another order), and the positions advance.
    The layer loop runs no apply_rotary: the writer takes q with k and v
    (one call a layer, q handed in), where the "fused" composition still
    rotates q in the loop."""
    m = llama_model
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    n_l, n_kv, d = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    slot_pos = np.array([PROMPT, PROMPT - 2], np.int32)
    jst = m["jst"]
    if mode == "smajor":
        from smoothquant_tpu.models.common import SMajorQuantKVCache as JSMajor

        to_sm = lambda t: jnp.transpose(t, (0, 1, 3, 2, 4)).reshape(n_l, 2, MAX_LEN, n_kv * d)
        jst = JSMajor(k_q=to_sm(jst.k_q), v_q=to_sm(jst.v_q), k_scale=jst.k_scale,
                      v_scale=jst.v_scale, pos=jst.pos)
    jst = jst._replace(pos=jnp.broadcast_to(jnp.asarray(slot_pos), (n_l, 2)))
    tst = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, smajor=mode == "smajor",
                                per_slot=True, device="cpu")
    for name in ("k_q", "v_q", "k_scale", "v_scale", "pos"):
        getattr(tst, name).copy_(torch.from_numpy(np.array(getattr(jst, name))))
    calls = {}

    def q_handed_in(i, pos, q, *rest, **kw):
        assert q is not None and q.shape == (2, jcfg.num_attention_heads, d)

    writer = "rope_q_write_cache_smajor" if mode == "smajor" else "rope_q_write_cache_stacked"
    _counting(monkeypatch, tllama, "apply_rotary", calls)
    _counting(monkeypatch, tcommon, writer, calls, q_handed_in)
    ctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True)
    fwd = jax.jit(lambda p, ids, c, pos, msk: jllama.forward(
        p, ids, jcfg, ctx=ctx, caches=c, positions=pos, attn_mask=msk))
    jtok = ttok = m["first"]
    for step in range(STEPS):
        pos_col = (slot_pos + step)[:, None]
        msk = np.arange(MAX_LEN)[None, :] <= pos_col
        ref, jst = fwd(m["stacked"], jnp.asarray(jtok), jst, jnp.asarray(pos_col),
                       jnp.asarray(msk))
        got, tst = tllama.forward(m["t_stacked"], torch.from_numpy(ttok), tcfg, caches=tst,
                                  positions=torch.from_numpy(pos_col),
                                  attn_mask=torch.from_numpy(msk),
                                  ctx=ForwardContext(fuse_attn="auto"))
        jtok = np.asarray(ref)[:, -1].argmax(-1)[:, None]
        ttok = got.numpy()[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(ttok, jtok)
        for name in ("k_q", "v_q", "pos"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), err_msg=name)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)), rtol=1e-6, atol=0)
    assert calls.get("apply_rotary", 0) == 0
    assert calls[writer] == n_l * STEPS
    # the control: the "fused" composition rotates q in the loop, once a layer
    aligned = tllama.stacked_caches(tcfg, 2, MAX_LEN, quant_kv=True, smajor=False,
                                    pos=PROMPT, device="cpu")
    tllama.forward(m["t_stacked"], torch.from_numpy(m["first"]), tcfg, caches=aligned,
                   ctx=ForwardContext(fuse_attn="fused"))
    assert calls["apply_rotary"] == n_l


# ---------------------------------------------------------------- the salient block's dtype


@pytest.fixture(scope="module", params=["float32-rows-bf16-pack", "bf16-rows-f32-pack"])
def mixed_model(request):
    """A 2-layer Llama (hidden 256, 2 heads of 128) whose rows are in one
    dtype and whose pack holds its salient blocks in the other
    (pack_model's compute_dtype), stacked in both packages; for bf16 rows
    also the twin packed in bf16 (the same weights, the same salient block
    once rounded to bf16)."""
    rows_dt, pack_dt = (("float32", jnp.bfloat16) if request.param.startswith("float32")
                        else ("bfloat16", jnp.float32))
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=256,
                               intermediate_size=256, num_attention_heads=2,
                               num_key_value_heads=2, num_hidden_layers=2, dtype=rows_dt)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})
    params = jllama.init_params(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(8)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        jcfg.intermediate_size if "down_proj" in key else jcfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(jcfg)}
    qcfg = jw4a4_group(group_size=16, salient_prop=0.05)

    def stacks(compute_dtype):
        packed = jpack_model(
            "llama", params, jcfg, qcfg, input_feat=feat, compute_dtype=compute_dtype,
            nibble=True, align_k_groups=8, align_o=256, fuse=True, fold_perms=True,
            shared_residual_basis=True, identity_keys=("o_proj",),
            lm_head_qcfg=JQ(weight_quant="per_channel", act_quant="per_token", quant_bits=8))
        t_packed = params_from_numpy(to_numpy_tree(packed), device="cpu")
        return jllama.stack_layers(packed, jcfg), tllama.stack_layers(t_packed, tcfg)

    out = dict(jcfg=jcfg, tcfg=tcfg, qcfg=qcfg, rows=tcfg.torch_dtype,
               mixed=stacks(pack_dt))
    if rows_dt == "bfloat16":
        out["twin"] = stacks(jnp.bfloat16)
    return out


def _decode_step(m, stacks, batch):
    """One decode token of `batch` rows over a random head-major per-slot
    int8 pool (seeded by batch): (JAX's logits, the port's), (B, V) f32."""
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    n_l, n_kv, d = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    rng = np.random.default_rng(batch)
    shape = (n_l, batch, n_kv, MAX_LEN, d)
    pool = dict(k_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                v_q=rng.integers(-127, 128, size=shape).astype(np.int8),
                k_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32),
                v_scale=rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32))
    slot_pos = rng.integers(2, MAX_LEN - 8, size=(batch,)).astype(np.int32)
    mask = np.arange(MAX_LEN)[None, :] <= slot_pos[:, None]
    tok = rng.integers(0, jcfg.vocab_size, size=(batch, 1))
    ctx = JCtx(quant=m["qcfg"], compute="auto", interpret=True)
    jst = jllama.stacked_caches(jcfg, batch, MAX_LEN, jnp.float32, quant_kv=True,
                                per_slot=True)
    jst = jst._replace(pos=jnp.broadcast_to(jnp.asarray(slot_pos), (n_l, batch)),
                       **{k: jnp.asarray(v) for k, v in pool.items()})
    ref, _ = jax.jit(lambda p, ids, c, pos, msk: jllama.forward(
        p, ids, jcfg, ctx=ctx, caches=c, positions=pos, attn_mask=msk))(
        stacks[0], jnp.asarray(tok), jst, jnp.asarray(slot_pos)[:, None], jnp.asarray(mask))
    tst = tllama.stacked_caches(tcfg, batch, MAX_LEN, quant_kv=True, smajor=False,
                                per_slot=True, device="cpu")
    for name, v in pool.items():
        getattr(tst, name).copy_(torch.from_numpy(v))
    tst.pos[:] = torch.from_numpy(slot_pos)
    got, _ = tllama.forward(stacks[1], torch.from_numpy(tok), tcfg, caches=tst,
                            positions=torch.from_numpy(slot_pos)[:, None],
                            attn_mask=torch.from_numpy(mask))
    return np.asarray(ref, dtype=np.float32)[:, 0], got.float().numpy()[:, 0]


@pytest.mark.parametrize("batch", [8, 40])
def test_stacked_decode_with_the_salient_block_in_another_dtype(mixed_model, batch):
    """One decode token at more than K1's 4 rows (8: K7b + K5 on K1's
    codes; 40: K7b / K7a + K5) with the salient blocks stored in the other
    dtype than the rows: the port takes each block in the rows' dtype, cast
    once a pack, where JAX casts it every call.  f32 rows over a bf16 pack
    match JAX as the 40-slot slice test holds its step
    (tests/test_torch_large_batch.py: at least 90 % of the rows to 2e-4,
    every row within 10 % of its norm; under another f32 sum order a
    per-token int4 code at a rounding edge lands on the other side).  bf16
    rows over an f32 pack give the logits of bf16 rows over the bf16 twin
    bit for bit, in the port and in JAX, so they stand against JAX as the
    same-dtype pack does (this model's bf16 logits differ from JAX's by up
    to 3e-1 of a row's norm whatever the pack's dtype: bf16 rounds at
    other places in the two frameworks)."""
    m = mixed_model
    lin = m["mixed"][1]["layers"]["stacked"]["self_attn"]["qkv_proj"]
    assert lin.w_sal_t.dtype != m["rows"]
    ref, got = _decode_step(m, m["mixed"], batch)
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    if m["rows"] == torch.float32:
        close = np.all(np.abs(got - ref) <= 2e-4 + 2e-4 * np.abs(ref), axis=-1)
        assert close.mean() >= 0.9
        assert rel.max() <= 0.1
    else:
        twin_ref, twin_got = _decode_step(m, m["twin"], batch)
        np.testing.assert_array_equal(got, twin_got)
        np.testing.assert_array_equal(ref, twin_ref)
        assert rel.max() <= 0.3
    # each block was cast once, and is the one the next step takes
    block = lin.salient_block(m["rows"])
    assert block.dtype == m["rows"] and lin.salient_block(m["rows"]) is block
    assert torch.equal(block, lin.w_sal_t.to(m["rows"]))

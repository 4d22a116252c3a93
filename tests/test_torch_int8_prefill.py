"""The promoted-int8 prefill in the port vs the JAX package: promote_int8
(codes and scales bit-exact on the packs the JAX promotion handles, a
refusal on the ones it gets wrong), K4's plain version against
int8_prefill_matmul in interpret mode, and the identity-int8 forward on
both sides of its row switch.

Tolerances: the int32 sums are exact on both sides, so in f32 the outputs
differ only by the order of the salient dot's f32 sums: 1e-5 relative,
plus 1e-5 of the output's largest magnitude where a sum cancels to near
zero; a bf16 output may then round one bf16 ulp (2^-7 relative) apart."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.kernels.int8_prefill import int8_prefill_matmul as j_k4
from smoothquant_tpu.kernels.real_linear import real_quant_linear as j_rql
from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.quant.config import w4a4_group as jw4a4_group
from smoothquant_tpu_torch.kernels import int8_prefill as k4
from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.kernels import real_linear as treal
from smoothquant_tpu_torch.quant.config import w4a4_group
from smoothquant_tpu_torch.utils.convert import packed_from_numpy, params_from_numpy

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -7


def _t(a):
    """A JAX or numpy array as an f32 tensor (bf16 values are exact in f32)."""
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.array(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _to_numpy(jp):
    d = {f: None if getattr(jp, f) is None else np.asarray(getattr(jp, f))
         for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")}
    d["meta"] = dataclasses.asdict(jp.meta)
    return d


def to_numpy_tree(node):
    if isinstance(node, jpack.PackedLinear):
        return _to_numpy(node)
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    return None if node is None else np.asarray(node)


def _lin(rng, o, c):
    w = rng.normal(size=(o, c)).astype(np.float32) * c ** -0.5
    w[:, 3] *= 20.0   # an outlier channel
    return w, rng.normal(size=(o,)).astype(np.float32)


# ---------------------------------------------------------------- promote


@pytest.mark.parametrize("nibble,salient", [(True, 0.1), (False, 0.1), (True, 0.0)])
def test_promote_int8_bit_exact(nibble, salient):
    """A plain permuted pack promoted by both packages: int8 codes, column
    scales, ns_mask and meta identical; the port's weight stored K-major;
    its own pack of the same weight promotes to the same codes."""
    rng = np.random.default_rng(0)
    o, c = 40, 160
    w, b = _lin(rng, o, c)
    imp = rng.uniform(0.1, 1.0, size=(c,))
    jp = jpack.pack_linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                           jw4a4_group(group_size=16, salient_prop=salient),
                           importance=imp, nibble=nibble, compute_dtype=jnp.float32)
    ref = jpack.promote_int8(jp)
    got = tpack.promote_int8(packed_from_numpy(_to_numpy(jp), "cpu"))
    own = tpack.promote_int8(tpack.pack_linear(
        {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
        w4a4_group(group_size=16, salient_prop=salient), importance=imp,
        nibble=nibble, compute_dtype=torch.float32))
    jm = dataclasses.asdict(ref.meta)
    jm.pop("tp_reduce")
    for t in (got, own):
        assert dataclasses.asdict(t.meta) == jm
        np.testing.assert_array_equal(t.w_qt.numpy(), np.asarray(ref.w_qt))
        np.testing.assert_array_equal(t.w_scales_t.numpy(), np.asarray(ref.w_scales_t))
        np.testing.assert_array_equal(t.perm.numpy(), np.asarray(ref.perm))
        np.testing.assert_array_equal(_np(t.w_sal_t), _np(ref.w_sal_t))
        assert t.w_qt.t().is_contiguous()
        if salient:
            np.testing.assert_array_equal(t.ns_mask.numpy(), np.asarray(ref.ns_mask))
        else:
            assert t.ns_mask is None and ref.ns_mask is None


def _tiny_packs(kind):
    """JAX fp params, cfg and the nibble pack of `kind` (W4A4 g16, 10 %
    salient): plain fused, identity o_proj, folded down_proj input, shared
    residual basis."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(4), cfg)
    rng = np.random.default_rng(2)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}
    opts = {"plain": {}, "identity": dict(identity_keys=("o_proj",)),
            "folded": dict(fold_perms=True),
            "shared_basis": dict(shared_residual_basis=True)}[kind]
    qcfg = jw4a4_group(group_size=16, salient_prop=0.1)
    p4 = jpack_model("llama", params, cfg, qcfg, input_feat=feat,
                     compute_dtype=jnp.float32, nibble=True, fuse=True, **opts)
    return cfg, params, qcfg, p4


@pytest.mark.parametrize("kind", ["identity", "folded", "shared_basis"])
def test_jax_promotion_wrong_where_port_refuses(kind):
    """On identity, folded and shared-basis packs the JAX promotion scatters
    rows into the wrong channel order: its logits miss the fp model's by
    more than their norm (1.1-1.5) where the W4 tree misses by ~0.4.  The
    port raises on the same packs instead of reproducing that."""
    cfg, params, qcfg, p4 = _tiny_packs(kind)
    p8 = jpack.promote_model_int8(p4)
    ids = jnp.asarray(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, 8)))
    ctx = JCtx(quant=qcfg, compute="int", interpret=True)
    fwd = jax.jit(lambda p: jllama.forward(p, ids, cfg, ctx=ctx)[0])
    lf = np.asarray(jllama.forward(params, ids, cfg)[0])
    rel = lambda a: np.linalg.norm(np.asarray(a) - lf) / np.linalg.norm(lf)
    r4, r8 = rel(fwd(p4)), rel(fwd(p8))
    assert r4 < 0.5 and r8 > 1.0 and r8 > 2 * r4, (r4, r8)
    with pytest.raises(NotImplementedError, match="promote_int8"):
        tpack.promote_model_int8(params_from_numpy(to_numpy_tree(p4), "cpu"))


def test_promote_model_plain_tree_close_to_fp():
    """The plain fused pack promotes on both sides to identical packs, and
    the promoted model stays as close to the fp model as the W4 tree."""
    cfg, params, qcfg, p4 = _tiny_packs("plain")
    got = tpack.promote_model_int8(params_from_numpy(to_numpy_tree(p4), "cpu"))
    ref = jpack.promote_model_int8(p4)
    for i in range(cfg.num_hidden_layers):
        for grp, name in (("self_attn", "qkv_proj"), ("self_attn", "o_proj"),
                          ("mlp", "gate_up_proj"), ("mlp", "down_proj")):
            g, r = got["layers"][str(i)][grp][name], ref["layers"][str(i)][grp][name]
            np.testing.assert_array_equal(g.w_qt.numpy(), np.asarray(r.w_qt))
            np.testing.assert_array_equal(g.w_scales_t.numpy(), np.asarray(r.w_scales_t))


def test_promote_rejects_stacks():
    rng = np.random.default_rng(5)
    w, _ = _lin(rng, 16, 64)
    p = tpack.pack_linear({"weight": torch.from_numpy(w), "bias": None},
                          w4a4_group(group_size=16), nibble=True,
                          compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="stacks"):
        tpack.promote_int8(tpack.stack_packed([p, p]))


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("n,kk,o,k_s,sal_dt,out_dt", [
    (37, 160, 48, 0, "float32", "float32"),       # N % 8, K % 256, no salient
    (100, 200, 136, 128, "float32", "float32"),   # salient, odd K
    (64, 512, 256, 128, "bfloat16", "float32"),   # bf16 salient, f32 out
    (29, 96, 72, 128, "bfloat16", "bfloat16"),    # bf16 out
    (16, 1024, 128, 0, "float32", "bfloat16"),
])
def test_k4_plain_matches_jax(n, kk, o, k_s, sal_dt, out_dt):
    rng = np.random.default_rng(n + kk)
    x_q = rng.integers(-127, 128, size=(n, kk)).astype(np.int8)
    sx = rng.uniform(0.001, 0.02, size=(n, 1)).astype(np.float32)
    w = rng.integers(-127, 128, size=(kk, o)).astype(np.int8)
    sw = rng.uniform(0.001, 0.02, size=(1, o)).astype(np.float32)
    x_sal = rng.normal(size=(n, k_s)).astype(np.float32)
    w_sal = rng.normal(size=(k_s, o)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    ref = j_k4(jnp.asarray(x_q), jnp.asarray(sx), jnp.asarray(w), jnp.asarray(sw),
               jnp.asarray(x_sal, jdt[sal_dt]), jnp.asarray(w_sal, jdt[sal_dt]),
               out_dtype=jdt[out_dt], interpret=True)
    got = k4.int8_prefill_matmul(
        torch.from_numpy(x_q), torch.from_numpy(sx), tpack.k_major(torch.from_numpy(w)),
        torch.from_numpy(sw), torch.from_numpy(x_sal).to(tdt[sal_dt]),
        torch.from_numpy(w_sal).to(tdt[sal_dt]), out_dtype=tdt[out_dt])
    assert got.dtype == tdt[out_dt] and got.shape == (n, o)
    acc = np.asarray(x_q, np.int64) @ np.asarray(w, np.int64)
    np.testing.assert_array_equal(k4.int_mm(torch.from_numpy(x_q),
                                            torch.from_numpy(w)).numpy(), acc)
    rtol = 1e-5 if out_dt == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol,
                               atol=1e-5 * np.abs(_np(ref)).max())


@pytest.mark.parametrize("n,kk,o,k_s,tile_k,dt", [
    (100, 512, 300, 128, 0, "float32"),     # tests/test_int8_prefill.py's cases
    (64, 1024, 256, 0, 256, "float32"),     # several K steps in JAX
    (37, 200, 72, 16, 0, "bfloat16"),       # ragged N, K % 16, bf16 raw x
])
def test_k4_raw_x_mode_matches_jax(n, kk, o, k_s, tile_k, dt):
    """The raw-x mode (ns_mask given: the masked per-token quantize inside
    the kernel) against JAX's: its int8 codes bit for bit, the f32 output
    bit for bit, the bf16 one at f32 rounding (XLA's bf16 salient dot sums
    in another order than the f32 product of the upcast operands); and
    against the pre-quantized mode on the codes quantize_raw_x gives: bit
    for bit."""
    rng = np.random.default_rng(7 + n)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dt]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    x = jnp.asarray(rng.normal(size=(n, kk)), jdt)
    mask = (rng.random(kk) > 0.1).astype(np.float32)
    x_main = x.astype(jnp.float32) * jnp.asarray(mask)[None, :]
    sx = jnp.maximum(jnp.max(jnp.abs(x_main), axis=-1, keepdims=True), 1e-5) / 127.0
    w = rng.integers(-127, 128, size=(kk, o)).astype(np.int8)
    sw = rng.uniform(0.001, 0.02, size=(1, o)).astype(np.float32)
    x_sal = jnp.asarray(rng.normal(size=(n, k_s)), jdt)
    w_sal = jnp.asarray(rng.normal(size=(k_s, o)), jdt)
    ref = j_k4(x, sx, jnp.asarray(w), jnp.asarray(sw), x_sal, w_sal,
               jnp.asarray(mask).reshape(1, -1), out_dtype=jnp.float32, interpret=True,
               tile_k=tile_k)
    tx, tsx, tmask = _t(x).to(tdt), _t(sx), torch.from_numpy(mask).reshape(1, -1)
    args = (tsx, tpack.k_major(torch.from_numpy(w)), torch.from_numpy(sw),
            _t(x_sal).to(tdt), _t(w_sal).to(tdt))
    got = k4.int8_prefill_matmul(tx, *args, tmask, out_dtype=torch.float32)
    assert got.shape == (n, o)
    ref = np.asarray(ref)
    if dt == "float32":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    codes = k4.quantize_raw_x(tx, tmask, tsx)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jnp.round(x_main / sx).astype(jnp.int8)))
    pre = k4.int8_prefill_matmul(codes, *args, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), pre.numpy())


def test_k4_raw_x_mode_raises():
    """What the raw-x mode still refuses, on any device (the JAX wrapper
    asserts the first two): int8 codes with a mask, raw fp activations
    without one, and a mask that is not (1, K)."""
    z = torch.zeros((4, 16), dtype=torch.int8)
    rest = (torch.ones(4, 1), tpack.k_major(torch.zeros(16, 8, dtype=torch.int8)),
            torch.ones(1, 8), torch.zeros(4, 0), torch.zeros(0, 8))
    with pytest.raises(TypeError, match="raw fp activations"):
        k4.int8_prefill_matmul(z, *rest, torch.ones(1, 16))
    with pytest.raises(TypeError, match="raw fp activations"):
        k4.int8_prefill_matmul(z.float(), *rest)
    with pytest.raises(ValueError, match="ns_mask"):
        k4.int8_prefill_matmul(z.float(), *rest, torch.ones(1, 8))


@pytest.mark.parametrize("n", [2, 40, 260])
def test_identity_int8_forward_matches_jax(n, monkeypatch):
    """real_quant_linear on a promoted pack with salient channels, below
    and above the port's switch (PREFILL_KERNEL_MIN_TOKENS: K4 from it, the
    torch._int_mm product below it) and JAX's at 256 rows (its kernel, and
    its XLA dots below)."""
    calls = []
    plain = k4.int8_prefill_matmul
    monkeypatch.setattr(treal, "int8_prefill_matmul",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    rng = np.random.default_rng(n)
    o, c = 48, 160
    w, b = _lin(rng, o, c)
    jp = jpack.promote_int8(jpack.pack_linear(
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        jw4a4_group(group_size=16, salient_prop=0.05),
        importance=rng.uniform(0.1, 1.0, size=(c,)), nibble=True,
        compute_dtype=jnp.float32))
    x = rng.normal(size=(n, c)).astype(np.float32)
    ref = jax.jit(lambda p, xx: j_rql(p, xx, compute="int", interpret=True))(
        jp, jnp.asarray(x))
    got = treal.real_quant_linear(packed_from_numpy(_to_numpy(jp), "cpu"),
                                  torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert len(calls) == (n >= treal.PREFILL_KERNEL_MIN_TOKENS)

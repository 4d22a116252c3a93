"""The port's checkpoints (smoothquant_tpu_torch.utils.checkpoint) against
the JAX package's (smoothquant_tpu/utils/checkpoint.py), file by file.

Files the JAX package writes — fp, packed (per-layer int8 containers; the
fused nibble serving recipe with its identity o_proj and identity-int8
lm_head; stacked), Llama / OPT / Bloom, f32 and bf16 compute, simulated
and int8 OPT — load in the port bit for bit as utils/convert carries the
same trees across, and the port's forward matches JAX's (jitted, Pallas in
interpret mode) within the tolerances of test_torch_llama_serve (2e-4) and
test_torch_opt_int8 (1e-5 of the norm).  For f32 trees the port's own
file holds JAX's keys, dtypes and bytes and the same metas JSON, and JAX
loads it to the same logits.  A bf16 JAX pack loads in the port bit for
bit; the JAX loader refuses that same file ("|V2" leaves) — the
divergence of the reference this pins.  block_decode_tree packs and a
tp_reduce no reduce has are refused (tensor-parallel packs load:
test_torch_sharded_checkpoint).  Act-scales files cross both ways."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.models import ForwardContext as JCtx
from smoothquant_tpu.models import bloom as jbloom
from smoothquant_tpu.models import llama as jllama
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models import opt_int8 as jint8
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import quantize_model as jquantize_model
from smoothquant_tpu.quant import config as jconfig
from smoothquant_tpu.utils import checkpoint as jck
from smoothquant_tpu_torch.models import bloom as tbloom
from smoothquant_tpu_torch.models import llama as tllama
from smoothquant_tpu_torch.models import opt as topt
from smoothquant_tpu_torch.models import opt_int8 as tint8
from smoothquant_tpu_torch.models.common import ForwardContext
from smoothquant_tpu_torch.utils import checkpoint as tck
from smoothquant_tpu_torch.utils.convert import (
    config_from,
    int8_opt_from_numpy,
    params_from_numpy,
)
from test_torch_llama_serve import to_numpy_tree
from test_torch_opt_int8 import REL_NORM, _rel_norm, exported  # noqa: F401
from torch_io_helpers import assert_trees_bit_equal

torch.set_num_threads(1)

FAMILIES = {"llama": (jllama, tllama), "opt": (jopt, topt), "bloom": (jbloom, tbloom)}
CONFIGS = {"llama": (jllama.LlamaConfig, tllama.LlamaConfig),
           "opt": (jopt.OPTConfig, topt.OPTConfig),
           "bloom": (jbloom.BloomConfig, tbloom.BloomConfig)}
HEAD = dict(weight_quant="per_channel", act_quant="per_token", quant_bits=8)


def _fp(family, dtype="float32"):
    """(JAX config, JAX params) of the family's tiny model, port config."""
    jcls, tcls = CONFIGS[family]
    cfg = dataclasses.replace(jcls.tiny(), dtype=dtype)
    params = FAMILIES[family][0].init_params(jax.random.PRNGKey(3), cfg)
    return cfg, params, config_from(tcls, cfg)


def _feat(jmod, cfg, params, seed):
    """Salience vectors of every quantizable linear, keyed as calibration
    keys them."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, key, _ in jmod.quantizable_linears(cfg):
        node = params
        for p in path:
            node = node[p]
        out[key] = rng.uniform(0.1, 1.0, size=(np.asarray(node["weight"]).shape[1],))
    return out


# name: (family, compute dtype, pack_model options)
PACKS = {
    "llama_int8": ("llama", "float32", {}),
    "llama_serving": ("llama", "float32", dict(
        nibble=True, fuse=True, fold_perms=True, shared_residual_basis=True,
        identity_keys=("o_proj",), lm_head_qcfg=jconfig.QuantConfig(**HEAD))),
    "opt_nibble": ("opt", "float32", dict(nibble=True, fold_perms=True)),
    "bloom_int8": ("bloom", "float32", {}),
    "llama_bf16": ("llama", "bfloat16", dict(
        nibble=True, fuse=True, identity_keys=("o_proj",),
        lm_head_qcfg=jconfig.QuantConfig(**HEAD))),
}


def _jax_pack(name):
    family, compute, opts = PACKS[name]
    jmod, _ = FAMILIES[family]
    cfg, params, tcfg = _fp(family)
    qcfg = jconfig.w4a4_group(group_size=16, salient_prop=0.1)
    if compute == "bfloat16":
        qcfg = dataclasses.replace(qcfg, scale_dtype="bfloat16")
    packed = jpack_model(family, params, cfg, qcfg, input_feat=_feat(jmod, cfg, params, 5),
                         compute_dtype=jnp.dtype(compute), **opts)
    return cfg, tcfg, qcfg, packed


@pytest.fixture(scope="module")
def packs():
    return {name: _jax_pack(name) for name in PACKS}


def _ids(cfg, seed=4, shape=(1, 8)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def _jax_logits(jmod, tree, cfg, qcfg, ids):
    fwd = jax.jit(lambda p, x: jmod.forward(p, x, cfg, ctx=JCtx(quant=qcfg, interpret=True)))
    return np.asarray(fwd(tree, jnp.asarray(ids))[0])


def _port_logits(tmod, tree, cfg, ids):
    with torch.no_grad():
        return tmod.forward(tree, torch.from_numpy(ids), cfg, ctx=ForwardContext())[0].numpy()


@pytest.mark.parametrize("name", [n for n in PACKS if PACKS[n][1] == "float32"])
def test_jax_packed_file_loads_in_port(packs, tmp_path, name):
    """A JAX-written per-layer pack: the port's tree is the convert path's
    bit for bit, and its logits JAX's within 2e-4."""
    family = PACKS[name][0]
    jmod, tmod = FAMILIES[family]
    cfg, tcfg, qcfg, packed = packs[name]
    path = str(tmp_path / "j.npz")
    jck.save_packed_model(packed, path)
    got = tck.load_packed_model(path, device="cpu")
    assert_trees_bit_equal(got, params_from_numpy(to_numpy_tree(packed), "cpu"))
    ids = _ids(cfg)
    np.testing.assert_allclose(_port_logits(tmod, got, tcfg, ids),
                               _jax_logits(jmod, packed, cfg, qcfg, ids),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", [n for n in PACKS if PACKS[n][1] == "float32"])
def test_port_packed_file_is_jax_file(packs, tmp_path, name):
    """The port's file of the same (f32) pack holds JAX's keys, dtypes and
    bytes and the same metas; JAX loads it to the same logits."""
    family = PACKS[name][0]
    jmod, _ = FAMILIES[family]
    cfg, _, qcfg, packed = packs[name]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_packed_model(packed, jpath)
    tck.save_packed_model(tck.load_packed_model(jpath, device="cpu"), tpath)
    _assert_same_file(tpath, jpath)
    back = jck.load_packed_model(tpath)
    ids = _ids(cfg)
    np.testing.assert_array_equal(_jax_logits(jmod, back, cfg, qcfg, ids),
                                  _jax_logits(jmod, packed, cfg, qcfg, ids))


def _assert_same_file(got_path, ref_path):
    with np.load(got_path) as g, np.load(ref_path) as r:
        assert sorted(g.files) == sorted(r.files), sorted(set(g.files) ^ set(r.files))
        for k in r.files:
            a, b = g[k], r[k]
            assert a.dtype.str == b.dtype.str and a.shape == b.shape, (k, a.dtype, b.dtype)
            if k.startswith("__"):
                assert json.loads(bytes(a)) == json.loads(bytes(b)), k
            else:
                assert a.tobytes() == b.tobytes(), k


def test_stacked_pack_file_both_ways(packs, tmp_path):
    """The stacked serving tree (JAX stack_layers) round-trips: the port
    loads JAX's file as the convert path's tree, its decode step on it is
    the one on the converted tree, and its own file is JAX's."""
    cfg, tcfg, _, packed = packs["llama_serving"]
    stacked = jllama.stack_layers(packed, cfg)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_packed_model(stacked, jpath)
    got = tck.load_packed_model(jpath, device="cpu")
    ref = params_from_numpy(to_numpy_tree(stacked), "cpu")
    assert_trees_bit_equal(got, ref)
    tck.save_packed_model(got, tpath)
    _assert_same_file(tpath, jpath)
    outs = []
    for tree in (got, ref):
        cache = tllama.stacked_caches(tcfg, 2, 16, pos=5, quant_kv=True, smajor=True,
                                      device="cpu")
        with torch.no_grad():
            outs.append(tllama.forward(tree, torch.tensor([[3], [7]]), tcfg,
                                       caches=cache)[0])
    assert torch.equal(outs[0], outs[1])


def test_bf16_jax_pack_loads_bit_for_bit_and_jax_refuses(packs, tmp_path):
    """bf16 scales and salient blocks go out as "|V2": the port reads them
    as bf16 bit for bit and writes the same bytes back; the JAX loader
    refuses the file (jnp.asarray of "|V2")."""
    cfg, tcfg, qcfg, packed = packs["llama_bf16"]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_packed_model(packed, jpath)
    with np.load(jpath) as z:
        assert z["layers/0/mlp/gate_up_proj/w_scales_t"].dtype.str == "|V2"
    got = tck.load_packed_model(jpath, device="cpu")
    lin = got["layers"]["0"]["mlp"]["gate_up_proj"]
    assert lin.w_scales_t.dtype == lin.w_sal_t.dtype == torch.bfloat16
    assert_trees_bit_equal(got, params_from_numpy(to_numpy_tree(packed), "cpu"))
    tck.save_packed_model(got, tpath)
    _assert_same_file(tpath, jpath)
    with pytest.raises(TypeError, match="V2"):
        jck.load_packed_model(jpath)
    ids = _ids(cfg)
    np.testing.assert_allclose(_port_logits(tllama, got, tcfg, ids),
                               _jax_logits(jllama, packed, cfg, qcfg, ids),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("field", ["sal_select", "tp_reduce"])
def test_tpu_only_and_tensor_parallel_packs_raise(packs, tmp_path, field):
    packed = packs["llama_int8"][3]
    lin = packed["layers"]["0"]["mlp"]["down_proj"]
    if field == "sal_select":
        lin = dataclasses.replace(lin, sal_select=jnp.zeros((lin.meta.in_features, 8)))
    else:   # no tensor-parallel reduce of that name
        lin = dataclasses.replace(lin, meta=dataclasses.replace(lin.meta, tp_reduce="scatter"))
    tree = {**packed, "layers": {**packed["layers"], "0": {
        **packed["layers"]["0"], "mlp": {**packed["layers"]["0"]["mlp"], "down_proj": lin}}}}
    path = str(tmp_path / "bad.npz")
    jck.save_packed_model(tree, path)
    with pytest.raises(NotImplementedError if field == "sal_select" else ValueError):
        tck.load_packed_model(path, device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp_params_file_both_ways(tmp_path, family, dtype):
    """fp trees: the port loads JAX's file bit for bit (bf16 too, which the
    JAX loader refuses) and its logits are JAX's; its own file is JAX's, and
    JAX loads the f32 one to the same logits."""
    jmod, tmod = FAMILIES[family]
    cfg, params, tcfg = _fp(family, dtype)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_params(params, jpath)
    got = tck.load_params(jpath, device="cpu")
    assert_trees_bit_equal(got, params_from_numpy(to_numpy_tree(params), "cpu"))
    tck.save_params(got, tpath)
    _assert_same_file(tpath, jpath)
    ids = _ids(cfg)
    if dtype == "bfloat16":
        with pytest.raises(TypeError, match="V2"):
            jck.load_params(tpath)
        return
    ref = _jax_logits(jmod, params, cfg, None, ids)
    np.testing.assert_allclose(_port_logits(tmod, got, tcfg, ids), ref, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(_jax_logits(jmod, jck.load_params(tpath), cfg, None, ids),
                                  ref)


def test_load_params_casts_float_leaves(tmp_path):
    params = _fp("llama")[1]
    path = str(tmp_path / "j.npz")
    jck.save_params(params, path)
    got = tck.load_params(path, dtype="bfloat16", device="cpu")
    w = got["layers"]["0"]["mlp"]["down_proj"]["weight"]
    assert w.dtype == torch.bfloat16
    ref = torch.tensor(np.asarray(params["layers"]["0"]["mlp"]["down_proj"]["weight"]))
    assert torch.equal(w, ref.to(torch.bfloat16))


def test_simulated_tree_file_both_ways(tmp_path):
    """quantize_model's simulated tree: its int32 index leaves come back
    int64 and go out int32, JAX's file byte for byte."""
    cfg, params, _ = _fp("llama")
    qcfg = jconfig.w4a4_group(group_size=16, salient_prop=0.1)
    sim = jquantize_model("llama", params, cfg, qcfg,
                          input_feat=_feat(jllama, cfg, params, 6))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_params(sim, jpath)
    got = tck.load_params(jpath, device="cpu")
    assert_trees_bit_equal(got, params_from_numpy(to_numpy_tree(sim), "cpu"))
    idx = [v for k, v in _flat(got).items() if k.endswith("sal_perm")]
    assert idx and all(t.dtype == torch.int64 for t in idx)
    tck.save_params(got, tpath)
    _assert_same_file(tpath, jpath)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def test_int8_opt_file_both_ways(exported, tmp_path):  # noqa: F811
    """The JAX export's int8 OPT file loads in the port as int8_opt_from_numpy
    carries it, its logits JAX's within 1e-5 of the norm; the port's file
    is JAX's, and JAX loads it to the same logits."""
    e = exported
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_int8_opt(e["int8"], e["jcfg"], jpath)
    cfg, got = tck.load_int8_opt(jpath, device="cpu")
    assert cfg == e["tcfg"]
    ref = int8_opt_from_numpy(jax.tree.map(np.asarray, e["int8"]), "cpu")
    assert_trees_bit_equal(got, ref)
    for gl, rl in zip(got["int8_layers"], ref["int8_layers"]):
        assert gl.scales == rl.scales
        assert [gl.q_proj.alpha, gl.fc2.alpha] == [rl.q_proj.alpha, rl.fc2.alpha]
    tck.save_int8_opt(got, cfg, tpath)
    _assert_same_file(tpath, jpath)
    ids = np.concatenate(e["batches"][:2])
    want = np.asarray(jint8.forward(e["int8"], jnp.asarray(ids), e["jcfg"], interpret=True)[0])
    logits, _ = tint8.forward(got, torch.from_numpy(ids), cfg)
    assert _rel_norm(logits.numpy(), want) <= REL_NORM
    j_cfg, j_back = jck.load_int8_opt(tpath)
    assert j_cfg == e["jcfg"]
    np.testing.assert_array_equal(
        np.asarray(jint8.forward(j_back, jnp.asarray(ids), j_cfg, interpret=True)[0]), want)


def test_act_scales_files_cross_packages(tmp_path):
    """.pt and .npz act-scales written by either package read the same in
    the other."""
    from smoothquant_tpu.utils import hf_import as j
    from smoothquant_tpu_torch.utils import hf_import as thf

    scales = {f"model.layers.{i}.mlp.down_proj": np.random.default_rng(i).uniform(
        0.1, 2.0, size=(64,)).astype(np.float32) for i in range(2)}
    for ext in ("pt", "npz"):
        for writer, reader in ((thf, j), (j, thf)):
            path = str(tmp_path / f"{writer.__name__.split('.')[0]}.{ext}")
            writer.save_act_scales(scales, path)
            got = reader.load_act_scales(path)
            assert sorted(got) == sorted(scales)
            for k in scales:
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], scales[k])


def test_load_flat_maps_large_stored_members(tmp_path):
    """Members of 1 MiB or more come back as memory maps of the file, the
    rest read through zipfile; every one equals np.load's, and a large bf16
    ("|V2") leaf loads bit for bit."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 16, size=(1024, 640), dtype=np.uint16)
    arrays = {"big/int8": rng.integers(-128, 128, size=(2048, 1024)).astype(np.int8),
              "big/f32": rng.normal(size=(512, 600)).astype(np.float32),
              "big/bf16": bits.view(np.dtype("V2")), "small": np.arange(7),
              "name": np.asarray("per_token"), "flag": np.asarray(True)}
    path = str(tmp_path / "f.npz")
    np.savez(path, **arrays)
    flat = tck.load_flat(path)
    with np.load(path) as z:
        assert sorted(flat) == sorted(z.files)
        for k in z.files:
            assert flat[k].dtype == z[k].dtype and flat[k].shape == z[k].shape, k
            assert np.asarray(flat[k]).tobytes() == z[k].tobytes(), k
    assert all(isinstance(flat[k], np.memmap) for k in ("big/int8", "big/f32", "big/bf16"))
    assert not isinstance(flat["small"], np.memmap)
    np.savez(str(tmp_path / "p.npz"), **{"big/bf16": arrays["big/bf16"]})
    got = tck.load_params(str(tmp_path / "p.npz"), device="cpu")["big"]["bf16"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), bits)

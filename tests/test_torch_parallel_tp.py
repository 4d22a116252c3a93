"""Tensor parallelism of the port (parallel.tp_packed, parallel.sharding,
the row-sharded pack, the Generator's forward_fn) against the JAX
package's.

The JAX references run here on conftest's 8-device CPU mesh as JAX's own
tests run them (shard_map, Pallas in interpret mode, jitted); the port
runs as 2 gloo ranks on the CPU (4 for the dp = 2 × tp = 2 case), spawned
by parallel.mesh.launch with a timeout, which import no JAX and get their
inputs as numpy trees (tests/torch_parallel_ranks.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothquant_tpu.kernels import pack as jpack
from smoothquant_tpu.models import ForwardContext as JCtx, llama as jllama, opt as jopt
from smoothquant_tpu.models.common import KVCache as JKVCache
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import quantize_model as jquantize_model
from smoothquant_tpu.parallel import make_mesh as jmake_mesh
from smoothquant_tpu.parallel.tp_packed import make_tp_forward_v2 as jmake_tp_forward_v2
from smoothquant_tpu.parallel.tp_packed import pack_model_tp as jpack_model_tp
from smoothquant_tpu.quant import QuantConfig as JQuantConfig, w4a4_group as jw4a4_group
from smoothquant_tpu.serve import GenerationConfig as JGenCfg, Generator as JGenerator

from smoothquant_tpu_torch.kernels import pack as tpack
from smoothquant_tpu_torch.parallel import mesh as tmesh
from smoothquant_tpu_torch.parallel import sharding as tsharding
from smoothquant_tpu_torch.parallel import tp_packed as ttp
from smoothquant_tpu_torch.quant import config as tconfig

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

UNSORTED = ranks.UNSORTED
TIMEOUT = 60


def np_tree(node):
    """A JAX tree as numpy (PackedLinear leaves as dicts with their meta)."""
    if isinstance(node, jpack.PackedLinear):
        d = {f: None if getattr(node, f) is None else np.asarray(getattr(node, f))
             for f in ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")}
        d["meta"] = dataclasses.asdict(node.meta)
        return d
    if isinstance(node, dict):
        return {k: np_tree(v) for k, v in node.items()}
    return None if node is None else np.asarray(node)


def cfg_dict(cfg):
    return dataclasses.asdict(cfg)


def feat_for(cfg, seed):
    return {key: np.random.default_rng(seed).uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


@pytest.fixture(scope="module")
def inputs():
    cfg = jllama.LlamaConfig.tiny()
    init = lambda k: jllama.init_params(jax.random.PRNGKey(k), cfg)
    rng = np.random.default_rng(12)
    return {
        "cfg": cfg_dict(cfg), "fp_v1": np_tree(init(0)), "fp5": np_tree(init(5)),
        "fp7": np_tree(init(7)), "fp11": np_tree(init(11)), "fp13": np_tree(init(13)),
        "feat7": feat_for(cfg, 8),
        "ids_v1": _ids(0, (2, 10)), "ids_v2": _ids(6, (2, 9)), "ids_flag": _ids(9, (2, 8)),
        "ids_long": _ids(6, (2, 32)), "ids_3": _ids(6, (2, 3)),
        "ids_count": np.zeros((1, 8), np.int64),
        "prompt": rng.integers(0, 256, size=(2, 6)), "tok": rng.integers(0, 256, size=(2, 1)),
        "gen_prompt": np.random.default_rng(14).integers(0, 256, size=(1, 5)),
    }


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results of every TP case (both ranks return the same
    replicated logits; rank 1's are checked equal to rank 0's)."""
    res = tmesh.launch(ranks.tp_scenarios, 2, device="cpu", args=(inputs,),
                       timeout_s=TIMEOUT)
    for k, v in res[0].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, res[1][k], err_msg=k)
    return res[0]


@pytest.fixture(scope="module")
def mesh2():
    return jmake_mesh(tp=2, dp=4)


def test_v1_matches_jax_single_device(port, inputs):
    """v1 (O-shards all-gathered) against JAX's single-device packed
    forward, at JAX's own TP tolerance."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    qcfg = jw4a4_group(group_size=32)
    packed = jpack_model("llama", params, cfg, qcfg, compute_dtype=jnp.float32)
    ref, _ = jllama.forward(packed, jnp.asarray(inputs["ids_v1"]), cfg,
                            ctx=JCtx(quant=qcfg, interpret=True))
    np.testing.assert_allclose(port["v1"], np.asarray(ref), atol=2e-3, rtol=2e-3)


def _jax_v2(mesh2, key, ids, qcfg=None, feat=None, chunks=0):
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(key), cfg)
    qcfg = qcfg or JQuantConfig(**UNSORTED)
    tp = jpack_model_tp("llama", params, cfg, qcfg, tp=2, input_feat=feat,
                        compute_dtype=jnp.float32)
    fwd = jmake_tp_forward_v2(jllama, cfg, mesh2, interpret=True,
                              overlap_chunks=chunks)(tp)
    return np.asarray(fwd(tp, jnp.asarray(ids)))


def test_v2_matches_jax_v2(port, inputs, mesh2):
    """v2 (Megatron: local heads, two all-reduces a layer) against JAX's
    v2 over shard_map: f32 accumulation order only."""
    np.testing.assert_allclose(port["v2_exact"], _jax_v2(mesh2, 5, inputs["ids_v2"]),
                               atol=1e-4, rtol=1e-4)


def test_flagship_recipe_tracks_v1(port, inputs):
    """Sorted groups with 5 % salient are packed per K-shard, another
    layout than the whole layer's: v2 must track the fp model as well as
    v1 does, and v1 closely (JAX's test_flagship_recipe_tracks_v1)."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(7), cfg)
    qcfg = jw4a4_group(group_size=16, salient_prop=0.1)
    ids = jnp.asarray(inputs["ids_flag"])
    v1 = jpack_model("llama", params, cfg, qcfg, input_feat=inputs["feat7"],
                     compute_dtype=jnp.float32)
    ref = np.asarray(jllama.forward(v1, ids, cfg, ctx=JCtx(quant=qcfg, interpret=True))[0])
    fp = np.asarray(jllama.forward(params, ids, cfg)[0])
    got = port["flagship"]
    assert np.all(np.isfinite(got))
    r = lambda a, b: np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert r(got, fp) > r(ref, fp) - 0.02, (r(got, fp), r(ref, fp))
    assert r(got, ref) > 0.95, r(got, ref)


def test_decode_over_head_sharded_cache(port, inputs):
    """A cached decode step over each rank's heads of the KV cache (its
    1 of 2 kv heads) against JAX's single-device packed decode, as JAX's
    test_tp_decode_with_sharded_kv_cache holds its TP step."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(11), cfg)
    qcfg = JQuantConfig(**UNSORTED)
    single = jpack_model("llama", params, cfg, qcfg, compute_dtype=jnp.float32)
    ctx = JCtx(quant=qcfg, interpret=True)
    caches = [JKVCache.create(2, 16, cfg.num_key_value_heads, cfg.head_dim, jnp.float32)
              for _ in range(cfg.num_hidden_layers)]
    _, caches = jllama.forward(single, jnp.asarray(inputs["prompt"]), cfg, ctx=ctx,
                               caches=caches)
    ref, _ = jllama.forward(single, jnp.asarray(inputs["tok"]), cfg, ctx=ctx, caches=caches)
    assert port["decode_cache_heads"] == cfg.num_key_value_heads // 2
    np.testing.assert_allclose(port["decode"], np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_generator_over_tp_step_gives_jaxs_tokens(port, inputs):
    """Generator(forward_fn=make_tp_decode_v2's step) over caches of the
    rank's heads: greedy tokens equal to JAX's single-device Generator."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(13), cfg)
    qcfg = JQuantConfig(**UNSORTED)
    single = jpack_model("llama", params, cfg, qcfg, compute_dtype=jnp.float32)
    gen = JGenerator(jllama, single, cfg, quant=qcfg, max_len=16, interpret=True,
                     kv_dtype=jnp.float32)
    ref = gen.generate(inputs["gen_prompt"], JGenCfg(max_new_tokens=4))
    np.testing.assert_array_equal(port["generator"], ref)


@pytest.mark.parametrize("tokens", ["long", "3"])
def test_overlap_chunks_bitwise_the_synchronous_psum(port, tokens):
    """overlap_chunks=4 (each chunk's all-reduce in flight while the next
    chunk computes) gives the synchronous psum's logits bit for bit; 32
    tokens split into 4 reduces a row-parallel linear, 3 tokens decline
    the split (JAX common.py:168-169)."""
    sync, over = port[f"overlap_sync{'' if tokens == 'long' else '_3'}"], \
        port[f"overlap_4{'' if tokens == 'long' else '_3'}"]
    np.testing.assert_array_equal(sync, over)
    n_l = jllama.LlamaConfig.tiny().num_hidden_layers
    counts = port[f"overlap_4{'' if tokens == 'long' else '_3'}_counts"]
    assert counts["all_reduce"] == (4 if tokens == "long" else 1) * 2 * n_l, counts


def test_collective_counts_per_layer(port):
    """v2 issues at most two all-reduces a layer plus two and no
    all-gather; v1 one all-gather a linear, at least seven a layer (JAX
    test_tp_packed.py:135-164 counts them in the HLO)."""
    n_l = jllama.LlamaConfig.tiny().num_hidden_layers
    v1, v2 = port["v1_counts_tree_counts"], port["v2_counts_tree_counts"]
    assert v2.get("all_reduce", 0) <= 2 * n_l + 2, v2
    assert v2.get("all_gather", 0) < v1.get("all_gather", 0)
    assert v1["all_gather"] >= 7 * n_l, v1


def _row_case(recipe, nibble, bias):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 128)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32) if bias else None
    imp = rng.uniform(0.1, 1.0, 128)
    absmax = rng.uniform(0.1, 2.0, 128)
    kw = dict(group_size=16)
    j = {"unsorted": JQuantConfig(**UNSORTED),
         "flagship": jw4a4_group(salient_prop=0.1, **kw),
         "w4a8": dataclasses.replace(jw4a4_group(salient_prop=0.05, **kw), act_bits=8)}[recipe]
    t = tconfig.QuantConfig(**dataclasses.asdict(j))
    return w, b, imp, absmax, j, t


@pytest.mark.parametrize("recipe", ["unsorted", "flagship", "w4a8"])
@pytest.mark.parametrize("nibble", [False, True])
def test_pack_linear_row_sharded_bit_exact(recipe, nibble):
    """pack_linear_row_sharded against JAX's: codes, scales, salient block,
    perms and bias / tp bit for bit, the same meta (tp_reduce "psum",
    one shard's dimensions); local_shard hands each rank its shard's
    pack, which is pack_linear of that K-slice."""
    w, b, imp, absmax, jq, tq = _row_case(recipe, nibble, bias=True)
    jp = jpack.pack_linear_row_sharded({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jq,
                                       2, importance=imp, act_absmax=absmax,
                                       compute_dtype=jnp.float32, nibble=nibble)
    tp = tpack.pack_linear_row_sharded({"weight": torch.from_numpy(w),
                                        "bias": torch.from_numpy(b)}, tq, 2, importance=imp,
                                       act_absmax=absmax, compute_dtype=torch.float32,
                                       nibble=nibble)
    assert dataclasses.asdict(tp.meta) == dataclasses.asdict(jp.meta)
    assert tp.meta.tp_reduce == "psum"
    for f in ("w_qt", "w_scales_t", "w_sal_t", "bias"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm).astype(np.int64))
    for r in range(2):
        loc = ttp.local_shard({"l": tp}, r, 2)["l"]
        own = tpack.pack_linear({"weight": torch.from_numpy(w[:, r * 64:(r + 1) * 64]),
                                 "bias": None}, tq, importance=imp[r * 64:(r + 1) * 64],
                                act_absmax=absmax[r * 64:(r + 1) * 64],
                                compute_dtype=torch.float32, nibble=nibble)
        for f in ("w_qt", "w_scales_t", "w_sal_t", "perm"):
            torch.testing.assert_close(getattr(loc, f), getattr(own, f), rtol=0, atol=0)


def test_guards():
    """The divisibility guards raise as JAX's do."""
    cfg = tconfig.QuantConfig(**UNSORTED)
    with pytest.raises(ValueError, match="not divisible"):
        tpack.pack_linear_row_sharded({"weight": torch.zeros(8, 30), "bias": None}, cfg, 4)
    lin = tpack.pack_linear({"weight": torch.randn(30, 32), "bias": None}, cfg,
                            compute_dtype=torch.float32)
    lin = dataclasses.replace(lin, meta=dataclasses.replace(lin.meta, tp_reduce="none"))
    with pytest.raises(ValueError, match="not divisible"):
        ttp.assert_tp_divisible({"x": lin}, 7)
    tsharding.assert_group_shardable(4096, 4, 128)
    with pytest.raises(ValueError):
        tsharding.assert_group_shardable(4096, 4, 768)
    with pytest.raises(ValueError):
        tsharding.assert_group_shardable(100, 8, 4)


# ---------------------------------------------------------------- plain / simulated


@pytest.fixture(scope="module")
def sharded_case():
    """The plain Llama and OPT trees and the simulated Llama tree of JAX's
    tests/test_parallel.py, with JAX's single-device logits (jitted)."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    fwd = jax.jit(lambda p, i: jllama.forward(p, i, cfg)[0])
    params1 = jllama.init_params(jax.random.PRNGKey(1), cfg)
    qcfg = JQuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8,
                        quantize_bmm_input=True, salient_prop=0.05)
    feat = {f"model.layers.{i}.{g}.{p}": np.random.default_rng(i).uniform(
        0.1, 1.0, size=(cfg.intermediate_size if p == "down_proj" else cfg.hidden_size,))
        for i in range(cfg.num_hidden_layers)
        for g, ps in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                      ("mlp", ("gate_proj", "up_proj", "down_proj"))) for p in ps}
    qparams = jquantize_model("llama", params1, cfg, qcfg, input_feat=feat)
    ids_q = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 8))
    ctx = JCtx(quant=qcfg)
    sim = jax.jit(lambda p, i: jllama.forward(p, i, cfg, ctx=ctx)[0])
    ocfg = jopt.OPTConfig.tiny()
    oparams = jopt.init_params(jax.random.PRNGKey(3), ocfg)
    ids_o = np.random.default_rng(3).integers(0, ocfg.vocab_size, size=(2, 12))
    ofwd = jax.jit(lambda p, i: jopt.forward(p, i, ocfg)[0])
    inp = {"llama_fp": {"cfg": cfg_dict(cfg), "params": np_tree(params), "ids": ids},
           "llama_sim": {"cfg": cfg_dict(cfg), "params": np_tree(qparams), "ids": ids_q,
                         "qcfg": dataclasses.asdict(qcfg)},
           "opt_fp": {"cfg": cfg_dict(ocfg), "params": np_tree(oparams), "ids": ids_o}}
    refs = {"llama_fp": np.asarray(fwd(params, jnp.asarray(ids))),
            "llama_sim": np.asarray(sim(qparams, jnp.asarray(ids_q))),
            "opt_fp": np.asarray(ofwd(oparams, jnp.asarray(ids_o)))}
    return inp, refs


@pytest.mark.parametrize("world,tp", [(2, 2), (4, 2)])
def test_sharded_forward_matches_single_device(sharded_case, world, tp):
    """The fp and simulated-quantized (W8A8 per-token, 5 % salient, the
    q / k / v outputs quantized) forwards over shard_params trees against
    JAX's single-device forward at JAX's 2e-4 / 2e-3 (tests/
    test_parallel.py:30-78): column-parallel outputs gathered, the
    row-parallel activation quantizer over the whole row; at world 4 as
    (dp, tp) = (2, 2), each dp replica on its rows of the batch."""
    inp, refs = sharded_case
    inp = {"tp": tp, **(inp if world == 2 else {"llama_sim": inp["llama_sim"]})}
    res = tmesh.launch(ranks.sharded_scenarios, world, device="cpu", args=(inp,),
                       timeout_s=TIMEOUT)
    for name in [k for k in refs if k in inp]:
        for r in res:
            np.testing.assert_allclose(r[name], refs[name], atol=2e-4, rtol=2e-3,
                                       err_msg=name)
        assert res[0][name + "_types"] == ["ShardedLinear"]
        assert res[0][name + "_counts"]["all_reduce"] >= 2 * 2   # two row layers a layer

"""Expert, context and pipeline parallelism of the port (parallel.ep,
parallel.cp, parallel.pp) and its multi-rank dry run, against the JAX
package's.

The JAX references run here on conftest's 8-device CPU mesh (shard_map,
jitted; Pallas in interpret mode); the port runs as 2 gloo ranks on the
CPU (4 for the dry run), spawned by parallel.mesh.launch with a timeout,
which import no JAX and get their inputs as numpy trees made from a seed
(tests/torch_parallel_ranks.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from smoothquant_tpu.models import ForwardContext as JCtx, llama as jllama, mixtral as jmix
from smoothquant_tpu.models import opt as jopt
from smoothquant_tpu.models.common import attention as jattention
from smoothquant_tpu.models.registry import pack_model as jpack_model
from smoothquant_tpu.models.registry import quantize_model as jquantize_model
from smoothquant_tpu.parallel.cp import CP_AXIS, make_cp_mesh, ring_attention
from smoothquant_tpu.parallel.ep import make_ep_forward, make_ep_mesh
from smoothquant_tpu.quant import w4a4_group as jw4a4_group

from smoothquant_tpu_torch.parallel import dryrun
from smoothquant_tpu_torch.parallel import mesh as tmesh

import torch_parallel_ranks as ranks
from test_torch_parallel_tp import cfg_dict, np_tree

torch.set_num_threads(1)

WORLD = 2
TIMEOUT = 60
RING_CASES = [(4, 4, False), (4, 4, True), (8, 2, False), (8, 2, True)]


def _llama_cfg(layers=2):
    return dataclasses.replace(jllama.LlamaConfig.tiny(), num_hidden_layers=layers)


def _ring_case(h, n_kv, masked):
    b, s, d = 2, 32, 16
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n_kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, n_kv, s, d)).astype(np.float32)
    # position 0 always valid: a row with no valid key diverges by design
    mask = None
    if masked:
        mask = (rng.random((b, s)) > 0.2).astype(np.int32)
        mask[:, 0] = 1
    return {"q": q, "k": k, "v": v, "mask": mask}


@pytest.fixture(scope="module")
def case():
    """Every input (numpy, from seeds) and JAX's reference for it."""
    jit = lambda f: jax.jit(f)
    mcfg = jmix.MixtralConfig.tiny()
    mparams = jmix.init_params(jax.random.PRNGKey(0), mcfg)
    ids_ep = np.random.default_rng(6).integers(0, mcfg.vocab_size, size=(2, 6))
    ids_ep_p = np.random.default_rng(7).integers(0, mcfg.vocab_size, size=(2, 6))
    qcfg = jw4a4_group(group_size=32)
    packed = jpack_model("mixtral", mparams, mcfg, qcfg, compute_dtype=jnp.float32)
    sparse = JCtx(moe_dispatch="sparse", moe_capacity_factor=4.0)
    refs = {"ep_fp": np.asarray(jit(lambda p, i: jmix.forward(p, i, mcfg, ctx=sparse)[0])(
        mparams, jnp.asarray(ids_ep)))}
    pctx = JCtx(quant=qcfg, interpret=True, moe_dispatch="sparse", moe_capacity_factor=4.0)
    refs["ep_packed"] = np.asarray(jmix.forward(packed, jnp.asarray(ids_ep_p), mcfg,
                                                ctx=pctx)[0])
    jstacked = jmix.stack_experts(mparams, mcfg)
    refs["ep_jax_ep"] = np.asarray(make_ep_forward(jmix, mcfg, make_ep_mesh(ep=2),
                                                   capacity_factor=4.0)(jstacked)(
        jstacked, jnp.asarray(ids_ep)))

    rings = [_ring_case(*c) for c in RING_CASES]
    mesh = make_cp_mesh(WORLD)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(None, CP_AXIS, None, None), P(None, None, CP_AXIS, None),
                                 P(None, None, CP_AXIS, None), P(None, CP_AXIS)),
                       out_specs=P(None, CP_AXIS, None, None), check_vma=False)
    def jring(q, k, v, m):
        return ring_attention(q, k, v, CP_AXIS, attn_mask=m)

    ones = lambda c: np.ones(c["q"].shape[:2], np.int32)
    refs["ring_jax"] = [np.asarray(jring(c["q"], c["k"], c["v"],
                                         c["mask"] if c["mask"] is not None else ones(c)))
                        for c in rings]
    refs["ring_single"] = [np.asarray(jattention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        attn_mask=None if c["mask"] is None else jnp.asarray(c["mask"]))) for c in rings]

    lcfg = _llama_cfg()
    lparams = jllama.init_params(jax.random.PRNGKey(0), lcfg)
    ids_cp = np.random.default_rng(1).integers(0, lcfg.vocab_size, size=(2, 32))
    ocfg = jopt.OPTConfig.tiny()
    oparams = jopt.init_params(jax.random.PRNGKey(2), ocfg)
    ids_cpo = np.random.default_rng(3).integers(0, ocfg.vocab_size, size=(2, 32))
    lfwd = lambda c: jax.jit(lambda p, i: jllama.forward(p, i, c)[0])
    refs["cp_llama"] = np.asarray(lfwd(lcfg)(lparams, jnp.asarray(ids_cp)))
    refs["cp_opt"] = np.asarray(jax.jit(lambda p, i: jopt.forward(p, i, ocfg)[0])(
        oparams, jnp.asarray(ids_cpo)))

    pcfg = _llama_cfg(4)
    pparams = jllama.init_params(jax.random.PRNGKey(4), pcfg)
    ids_pp = np.random.default_rng(5).integers(0, pcfg.vocab_size, size=(4, 16))
    refs["pp"] = np.asarray(lfwd(pcfg)(pparams, jnp.asarray(ids_pp)))
    sparams = jllama.init_params(jax.random.PRNGKey(6), lcfg)
    sq = dataclasses.replace(jw4a4_group(group_size=16, salient_prop=0.0), act_quant="per_token")
    qparams = jquantize_model("llama", sparams, lcfg, sq)
    ids_sim = np.random.default_rng(7).integers(0, lcfg.vocab_size, size=(2, 16))
    sctx = JCtx(quant=sq)
    refs["pp_sim"] = np.asarray(jax.jit(lambda p, i: jllama.forward(p, i, lcfg, ctx=sctx)[0])(
        qparams, jnp.asarray(ids_sim)))
    dparams = jllama.init_params(jax.random.PRNGKey(8), pcfg)
    tokens = np.random.default_rng(9).integers(0, pcfg.vocab_size, size=(2, 9))
    refs["pp_decode"] = np.asarray(lfwd(pcfg)(dparams, jnp.asarray(tokens)))

    inp = {
        "ep": {"cfg": cfg_dict(mcfg), "params": np_tree(mparams), "ids": ids_ep,
               "packed": np_tree(packed), "ids_packed": ids_ep_p},
        "ring": rings,
        "cp": {"cp_llama": {"cfg": cfg_dict(lcfg), "params": np_tree(lparams), "ids": ids_cp},
               "cp_opt": {"cfg": cfg_dict(ocfg), "params": np_tree(oparams), "ids": ids_cpo}},
        "pp": {"cfg": cfg_dict(pcfg), "params": np_tree(pparams), "ids": ids_pp},
        "pp_sim": {"cfg": cfg_dict(lcfg), "params": np_tree(qparams), "ids": ids_sim,
                   "qcfg": dataclasses.asdict(sq)},
        "pp_decode": {"cfg": cfg_dict(pcfg), "params": np_tree(dparams), "tokens": tokens},
    }
    return inp, refs


@pytest.fixture(scope="module")
def port(case):
    res = tmesh.launch(ranks.modes_scenarios, WORLD, device="cpu", args=(case[0],),
                       timeout_s=TIMEOUT)
    return res


def test_ep_matches_single_device_sparse(port, case):
    """EP over 2 ranks (2 of the 4 experts each, one all-reduce a MoE
    block) against JAX's single-device sparse dispatch (fp at JAX's 1e-5,
    the W4A4 pack at 1e-4) and JAX's own EP forward."""
    refs = case[1]
    n_l = jmix.MixtralConfig.tiny().num_hidden_layers
    for r in port:
        np.testing.assert_allclose(r["ep_fp"], refs["ep_fp"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["ep_fp"], refs["ep_jax_ep"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["ep_packed"], refs["ep_packed"], atol=1e-4, rtol=1e-4)
        assert r["ep_local_experts"] == 2
        assert r["ep_fp_counts"] == {"all_reduce": n_l}, r["ep_fp_counts"]


def test_ep_divisibility_guard(port):
    assert "not divisible by ep=2" in port[0]["ep_guard"]


@pytest.mark.parametrize("i", range(len(RING_CASES)), ids=[
    f"h{h}_kv{k}_{'mask' if m else 'nomask'}" for h, k, m in RING_CASES])
def test_ring_attention_matches_jax(port, case, i):
    """ring_attention over 2 ranks (with and without a key mask, MHA and
    GQA) against JAX's ring over a 2-device cp mesh and its single-device
    attention, at JAX's 2e-5; a hop of k, v (and the mask) a step, n steps
    as JAX's loop."""
    refs = case[1]
    sl = case[0]["ring"][i]["q"].shape[1] // WORLD
    got = np.concatenate([r["ring"][i][0] for r in port], axis=1)
    np.testing.assert_allclose(got, refs["ring_jax"][i], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, refs["ring_single"][i], rtol=2e-5, atol=2e-5)
    assert got.shape[1] == 2 * sl
    assert port[0]["ring"][i][1] == {"ring_hop": WORLD * (3 if RING_CASES[i][2] else 2)}


@pytest.mark.parametrize("name", ["cp_llama", "cp_opt"])
def test_cp_prefill_matches_single_device(port, case, name):
    """The sequence-split prefill (positions offset by rank, ring attention
    in every layer) against JAX's single-device forward at JAX's 2e-4."""
    for r in port:
        np.testing.assert_allclose(r[name], case[1][name], rtol=2e-4, atol=2e-4)
    assert port[0][name + "_counts"]["ring_hop"] == 2 * 2 * WORLD   # k, v; 2 layers


@pytest.mark.parametrize("name", ["pp_v1_mb2", "pp_v1_mb4", "pp_v2"])
def test_pp_forward_matches_single_device(port, case, name):
    """GPipe over 2 stages (v1 whole edges at 2 and 4 microbatches, v2
    vocabulary-split edges) against JAX's single-device forward at 2e-4;
    one ring hop a tick, M + pp − 1 ticks."""
    for r in port:
        np.testing.assert_allclose(r[name], case[1]["pp"], rtol=2e-4, atol=2e-4)
    mb = {"pp_v1_mb2": 2, "pp_v1_mb4": 4, "pp_v2": 2}[name]
    assert port[0][name + "_counts"]["ring_hop"] == mb + WORLD - 1


def test_pp_simulated_stages(port, case):
    for r in port:
        np.testing.assert_allclose(r["pp_sim"], case[1]["pp_sim"], rtol=2e-4, atol=2e-4)


def test_pp_decode_matches_single_device(port, case):
    """The pipelined cached decode, fed 9 tokens one at a time: each step's
    logits are JAX's single-device forward's at that position (2e-4), the
    caches of each rank's layers at position 9."""
    ref = case[1]["pp_decode"]
    for r in port:
        np.testing.assert_allclose(r["pp_decode"], ref, rtol=2e-4, atol=2e-4)
        assert r["pp_decode_pos"] == 9


def test_dryrun_multichip_four_ranks():
    """dryrun_multichip over 4 ranks ((dp, tp) = (2, 2), ep = cp = pp = 4):
    every mode's logits finite."""
    lines = dryrun.dryrun_multichip(4, device="cpu", timeout_s=TIMEOUT)
    assert len(lines) == 7 and "mesh=(dp=2, tp=2)" in lines[0], lines


def test_chip_smoke_parallel_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's parallel phases (shard_kernels, nccl_world1 over a
    world-1 gloo group, ranks2 over 2 gloo ranks) on the CPU at hidden 512:
    their control flow and checks, with timing and the launch checks
    stubbed (plain versions launch nothing)."""
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n, reps=5: (fn(0), 0.0)[1])
    monkeypatch.setattr(cs, "_launched", lambda key, fn: fn())
    cfg = dataclasses.replace(cs.parallel_config(), hidden_size=512, intermediate_size=1024,
                              num_attention_heads=4, num_key_value_heads=4, vocab_size=512)
    mcfg = dataclasses.replace(cs.mixtral_ep_config(), hidden_size=128, intermediate_size=256,
                               num_attention_heads=4, num_key_value_heads=2, vocab_size=512)
    dev = torch.device("cpu")
    rows = cs.check_shard_kernels(
        dev, torch.Generator().manual_seed(0), heads=2, head_dim=64, vocab=512, c_model=256,
        sites=(("q", 256, 256, False), ("o_proj", 256, 256, True),
               ("gate", 512, 256, False), ("down", 256, 512, True)))
    assert len(rows) == 14 and all(r["max_err"] == 0.0 for r in rows)
    world1 = cs.nccl_world1(dev, "cpu", cfg, mcfg, backend="gloo")
    assert world1["tp_v2"]["max_rel_err"] == world1["ep"]["max_rel_err"] == 0.0
    cs.ranks2("cpu", device="cpu", cfg=cfg, mcfg=mcfg, expect_launches=False)

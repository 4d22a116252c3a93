"""The ranks' side of the port's parallel tests: functions that
parallel.mesh.launch runs in spawned processes joined by gloo on the CPU.

They import torch, numpy and the port only (no JAX: a spawned rank
imports this module afresh), take their inputs as numpy trees made by
the test from a seed, and return numpy results and collective counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from smoothquant_tpu_torch.models import llama, mixtral, opt
from smoothquant_tpu_torch.models.common import ForwardContext, KVCache
from smoothquant_tpu_torch.models.registry import pack_model
from smoothquant_tpu_torch.parallel import comm, cp, ep, mesh, pp, sharding, tp_packed
from smoothquant_tpu_torch.quant.config import QuantConfig, w4a4_group
from smoothquant_tpu_torch.serve.generate import GenerationConfig, Generator
from smoothquant_tpu_torch.utils.convert import config_from, params_from_numpy

UNSORTED = dict(weight_quant="per_group_unsorted", act_quant="per_group_unsorted",
                quant_bits=4, group_size=16)
F32 = torch.float32


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _counted(fn):
    """(fn's result, the collectives it issued)."""
    comm.reset_counts()
    out = fn()
    return out, dict(comm.COUNTS)


def tp_scenarios(rank, world, dev, inp):
    """Every tensor-parallel case of test_torch_parallel_tp on this rank."""
    cfg = config_from(llama.LlamaConfig, inp["cfg"])
    group = mesh.axis_group(mesh.make_mesh(tp=world), "tp")
    out = {}

    def v1(name, fp, qcfg, ids, feat=None):
        packed = pack_model("llama", fp, cfg, qcfg, input_feat=feat, compute_dtype=F32)
        local = tp_packed.local_shard(packed, rank, world)
        fwd = tp_packed.make_tp_forward(llama, cfg, qcfg, group)(local)
        out[name], out[name + "_counts"] = _counted(lambda: _np(fwd(local, ids)))

    def v2(name, fp, qcfg, ids, feat=None, chunks=0):
        tree = tp_packed.pack_model_tp("llama", fp, cfg, qcfg, world, input_feat=feat,
                                       compute_dtype=F32)
        local = tp_packed.local_shard(tree, rank, world)
        fwd = tp_packed.make_tp_forward_v2(llama, cfg, group, overlap_chunks=chunks)(local)
        out[name], out[name + "_counts"] = _counted(lambda: _np(fwd(local, ids)))

    t = lambda a: torch.as_tensor(a, device=dev)
    fp_v1 = params_from_numpy(inp["fp_v1"], dev)
    v1("v1", fp_v1, w4a4_group(32), t(inp["ids_v1"]))
    fp5 = params_from_numpy(inp["fp5"], dev)
    v2("v2_exact", fp5, QuantConfig(**UNSORTED), t(inp["ids_v2"]))
    v2("overlap_sync", fp5, QuantConfig(**UNSORTED), t(inp["ids_long"]))
    v2("overlap_4", fp5, QuantConfig(**UNSORTED), t(inp["ids_long"]), chunks=4)
    v2("overlap_sync_3", fp5, QuantConfig(**UNSORTED), t(inp["ids_3"]))
    v2("overlap_4_3", fp5, QuantConfig(**UNSORTED), t(inp["ids_3"]), chunks=4)
    v1("v1_counts_tree", fp5, QuantConfig(**UNSORTED), t(inp["ids_count"]))
    v2("v2_counts_tree", fp5, QuantConfig(**UNSORTED), t(inp["ids_count"]))
    fp7 = params_from_numpy(inp["fp7"], dev)
    feat = {k: np.asarray(v) for k, v in inp["feat7"].items()}
    v2("flagship", fp7, w4a4_group(16, 0.1), t(inp["ids_flag"]), feat=feat)

    # the decode step over a head-sharded cache, and the Generator over it
    fp11 = params_from_numpy(inp["fp11"], dev)
    tree = tp_packed.pack_model_tp("llama", fp11, cfg, QuantConfig(**UNSORTED), world,
                                   compute_dtype=F32)
    local = tp_packed.local_shard(tree, rank, world)
    step = tp_packed.make_tp_decode_v2(llama, cfg, group)(local)
    whole = [KVCache.create(2, 16, cfg.num_key_value_heads, cfg.head_dim, F32, dev)
             for _ in range(cfg.num_hidden_layers)]
    caches = tp_packed.local_caches(whole, rank, world)
    _, caches = step(local, t(inp["prompt"]), caches)
    out["decode"] = _np(step(local, t(inp["tok"]), caches)[0])
    out["decode_cache_heads"] = int(caches[0].k.shape[1])

    fp13 = params_from_numpy(inp["fp13"], dev)
    tree = tp_packed.pack_model_tp("llama", fp13, cfg, QuantConfig(**UNSORTED), world,
                                   compute_dtype=F32)
    local = tp_packed.local_shard(tree, rank, world)
    step = tp_packed.make_tp_decode_v2(llama, cfg, group)(local)
    gen = Generator(llama, local, cfg, max_len=16, kv_dtype=F32, device=dev,
                    forward_fn=step)
    out["generator"] = gen.generate(inp["gen_prompt"], GenerationConfig(max_new_tokens=4))
    return out


def sharded_scenarios(rank, world, dev, inp):
    """The plain and simulated forwards over shard_params trees, (dp, tp)
    = (world // tp, tp): each dp replica takes its rows of the batch and
    the logits are all-gathered over dp."""
    tp = inp["tp"]
    m = mesh.make_mesh(tp=tp)
    dp_group = mesh.axis_group(m, mesh.DP_AXIS)
    d = dist.get_rank(dp_group)
    out = {}
    for name, arch, mod, cls in (("llama_fp", "llama", llama, llama.LlamaConfig),
                                 ("llama_sim", "llama", llama, llama.LlamaConfig),
                                 ("opt_fp", "opt", opt, opt.OPTConfig)):
        if name not in inp:
            continue
        case = inp[name]
        cfg = config_from(cls, case["cfg"])
        params = params_from_numpy(case["params"], dev)
        ctx = None
        if "qcfg" in case:
            ctx = ForwardContext(quant=QuantConfig(**case["qcfg"]))
        local = sharding.shard_params(params, sharding.param_specs(arch, params), m)
        ids = torch.as_tensor(case["ids"], device=dev)
        rows = ids.shape[0] // dist.get_world_size(dp_group)
        mine = ids[d * rows:(d + 1) * rows]
        logits, counts = _counted(lambda: comm.all_gather(
            sharding.sharded_forward(mod, local, mine, cfg, m, ctx), dp_group, 0))
        out[name], out[name + "_counts"] = _np(logits), counts
        out[name + "_types"] = sorted({type(v).__name__ for v in
                                       local["layers"]["0"]["self_attn"].values()})
    return out


def modes_scenarios(rank, world, dev, inp):
    """EP, CP and PP on this rank."""
    out = {}
    t = lambda a: torch.as_tensor(a, device=dev)
    if "ep" in inp:
        case = inp["ep"]
        cfg = config_from(mixtral.MixtralConfig, case["cfg"])
        params = params_from_numpy(case["params"], dev)
        m = ep.make_ep_mesh()
        packed = params_from_numpy(case["packed"], dev)
        for name, tree, ids in (("ep_fp", params, case["ids"]),
                                ("ep_packed", packed, case["ids_packed"])):
            local = ep.ep_local(mixtral.stack_experts(tree, cfg), m)
            fwd = ep.make_ep_forward(mixtral, cfg, m, capacity_factor=4.0)(local)
            out[name], out[name + "_counts"] = _counted(lambda: _np(fwd(local, t(ids))))
        w1 = local["layers"]["0"]["block_sparse_moe"]["experts"]["stacked"]["w1"]
        out["ep_local_experts"] = int(w1.w_qt.shape[0])
        bad = dataclasses.replace(cfg, num_local_experts=3)
        try:
            ep.make_ep_forward(mixtral, bad, m)
            out["ep_guard"] = "no error"
        except ValueError as e:
            out["ep_guard"] = str(e)
    if "ring" in inp:
        m = cp.make_cp_mesh()
        g = mesh.axis_group(m, cp.CP_AXIS)
        res = []
        for case in inp["ring"]:
            sl = case["q"].shape[1] // world
            sel = lambda a, ax: torch.as_tensor(np.take(a, range(rank * sl, (rank + 1) * sl),
                                                        axis=ax), device=dev)
            mask = None if case["mask"] is None else sel(case["mask"], 1)
            o, c = _counted(lambda: cp.ring_attention(sel(case["q"], 1), sel(case["k"], 2),
                                                      sel(case["v"], 2), g, attn_mask=mask))
            res.append((_np(o), c))
        out["ring"] = res
    if "cp" in inp:
        m = cp.make_cp_mesh()
        for name, mod, cls in (("cp_llama", llama, llama.LlamaConfig),
                               ("cp_opt", opt, opt.OPTConfig)):
            case = inp["cp"][name]
            cfg = config_from(cls, case["cfg"])
            params = params_from_numpy(case["params"], dev)
            fwd = cp.make_cp_prefill(mod, cfg, m)(params)
            out[name], out[name + "_counts"] = _counted(lambda: _np(fwd(params,
                                                                       t(case["ids"]))))
    if "pp" in inp:
        case = inp["pp"]
        cfg = config_from(llama.LlamaConfig, case["cfg"])
        params = params_from_numpy(case["params"], dev)
        m = pp.make_pp_mesh()
        for name, stack, mb in (("pp_v1_mb2", pp.stack_pp_stages, 2),
                                ("pp_v1_mb4", pp.stack_pp_stages, 4),
                                ("pp_v2", pp.stack_pp_stages_v2, 0)):
            local = pp.pp_local(stack(params, cfg, world), m)
            fwd = pp.make_pp_forward(llama, cfg, m, microbatches=mb)(local)
            out[name], out[name + "_counts"] = _counted(lambda: _np(fwd(local,
                                                                       t(case["ids"]))))
        scase = inp["pp_sim"]
        scfg = config_from(llama.LlamaConfig, scase["cfg"])
        qparams = params_from_numpy(scase["params"], dev)
        local = pp.pp_local(pp.stack_pp_stages(qparams, scfg, world), m)
        fwd = pp.make_pp_forward(llama, scfg, m, quant=QuantConfig(**scase["qcfg"]))(local)
        out["pp_sim"] = _np(fwd(local, t(scase["ids"])))
        dcase = inp["pp_decode"]
        dcfg = config_from(llama.LlamaConfig, dcase["cfg"])
        dparams = params_from_numpy(dcase["params"], dev)
        local = pp.pp_local(pp.stack_pp_stages(dparams, dcfg, world), m)
        init_caches, step = pp.make_pp_decode(llama, dcfg, m)(local)
        caches = init_caches(dcase["tokens"].shape[0], 32, F32)
        logits = []
        for j in range(dcase["tokens"].shape[1]):
            lg, caches = step(local, caches, t(dcase["tokens"][:, j]))
            logits.append(_np(lg))
        out["pp_decode"] = np.stack(logits, 1)
        out["pp_decode_pos"] = int(caches[0].pos)
    return out


def sharded_checkpoint_forward(rank, world, dev, path, cfg, ids):
    """This rank's shard of a sharded checkpoint, through
    make_tp_forward_v2: the logits."""
    from smoothquant_tpu_torch.utils.checkpoint import load_packed_model_sharded

    local = load_packed_model_sharded(path, shard=rank, device=dev)
    cfg = config_from(llama.LlamaConfig, cfg)
    group = mesh.axis_group(mesh.make_mesh(tp=world), "tp")
    fwd = tp_packed.make_tp_forward_v2(llama, cfg, group)(local)
    return _np(fwd(local, torch.as_tensor(ids, device=dev)))

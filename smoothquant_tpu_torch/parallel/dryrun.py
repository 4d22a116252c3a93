"""A dry run of every parallel mode over n ranks (the counterpart of
__graft_entry__.dryrun_multichip):

    python -m smoothquant_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

spawns n ranks joined by gloo (parallel.mesh.launch) and runs on each, at a
small width: the simulated W4A4 forward over shard_params trees on a (dp,
tp) mesh (dp = 2 where n is even and above 2), packed TP v1 and v2, expert
parallelism (Mixtral, ep = n), ring-attention context parallelism (cp = n),
the GPipe forward (2 microbatches) and the pipelined decode (3 cached
steps), pp = n with two layers a stage.  Each mode's logits must be
finite; rank 0's lines are printed.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def _modes(rank: int, world: int, dev) -> list:
    from smoothquant_tpu_torch.models import llama, mixtral
    from smoothquant_tpu_torch.models.common import ForwardContext
    from smoothquant_tpu_torch.models.registry import pack_model, quantize_model
    from smoothquant_tpu_torch.parallel import comm, cp, ep, mesh, pp, sharding, tp_packed
    from smoothquant_tpu_torch.quant.config import w4a4_group

    lines = []
    dp = 2 if world % 2 == 0 and world > 2 else 1
    tp = world // dp
    m = mesh.make_mesh(tp=tp, dp=dp)
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=32 * tp, intermediate_size=64 * tp,
                            num_hidden_layers=2, num_attention_heads=tp,
                            num_key_value_heads=tp, max_position_embeddings=64,
                            dtype="float32")
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    qcfg = w4a4_group(group_size=32, salient_prop=0.05)
    rng = np.random.default_rng(0)
    feat = {key: rng.uniform(0.1, 1.0, size=(cfg.intermediate_size if "down_proj" in key
                                              else cfg.hidden_size,))
            for _, key, _ in llama.quantizable_linears(cfg)}

    def check(name, logits):
        assert torch.isfinite(logits).all(), name
        lines.append(f"dryrun_multichip OK ({name}): logits {tuple(logits.shape)}")

    qparams = quantize_model("llama", params, cfg, qcfg, input_feat=feat)
    local = sharding.shard_params(qparams, sharding.param_specs("llama", qparams), m)
    dp_group = mesh.axis_group(m, mesh.DP_AXIS)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(dp * 2, 16)), device=dev)
    mine = ids.chunk(dp)[dist.get_rank(dp_group)]
    logits = sharding.sharded_forward(llama, local, mine, cfg, m, ForwardContext(quant=qcfg))
    check(f"sim/sharded: mesh=(dp={dp}, tp={tp})",
          comm.all_gather(logits, dp_group, 0))

    tp_group = mesh.axis_group(m, mesh.TP_AXIS)
    r, n = dist.get_rank(tp_group), tp
    ids2 = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 8)), device=dev)
    packed = pack_model("llama", params, cfg, qcfg, input_feat=feat, compute_dtype=torch.float32)
    loc = tp_packed.local_shard(packed, r, n)
    check("packed TP v1, all-gather",
          tp_packed.make_tp_forward(llama, cfg, qcfg, m)(loc)(loc, ids2))
    v2 = tp_packed.pack_model_tp("llama", params, cfg, qcfg, n, input_feat=feat,
                                 compute_dtype=torch.float32)
    loc = tp_packed.local_shard(v2, r, n)
    check("Megatron TP v2, all-reduce", tp_packed.make_tp_forward_v2(llama, cfg, m)(loc)(loc, ids2))

    mcfg = mixtral.MixtralConfig.tiny(vocab_size=512)
    mparams = mixtral.stack_experts(
        mixtral.init_params(torch.Generator(device=dev).manual_seed(1), mcfg, dev), mcfg)
    emesh = ep.make_ep_mesh()
    eloc = ep.ep_local(mparams, emesh)
    check(f"MoE expert parallel, ep={world}",
          ep.make_ep_forward(mixtral, mcfg, emesh, capacity_factor=4.0)(eloc)(eloc, ids2))

    cmesh = cp.make_cp_mesh()
    ids_cp = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 4 * world)), device=dev)
    check(f"ring-attention context parallel, cp={world}",
          cp.make_cp_prefill(llama, cfg, cmesh)(params)(params, ids_cp))

    pmesh = pp.make_pp_mesh()
    pcfg = dataclasses.replace(cfg, num_hidden_layers=2 * world)
    pparams = llama.init_params(torch.Generator(device=dev).manual_seed(2), pcfg, dev)
    ploc = pp.pp_local(pp.stack_pp_stages(pparams, pcfg, world), pmesh)
    ids_pp = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 16)), device=dev)
    check(f"GPipe pipeline parallel, pp={world}, 2 microbatches",
          pp.make_pp_forward(llama, pcfg, pmesh, microbatches=2)(ploc)(ploc, ids_pp))
    init_caches, step = pp.make_pp_decode(llama, pcfg, pmesh)(ploc)
    caches = init_caches(2, 32, torch.float32)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2,)), device=dev)
    for _ in range(3):
        lg, caches = step(ploc, caches, tok)
        tok = lg.argmax(-1)
    assert caches[0].pos == 3
    check(f"PP decode, per-stage KV caches, pp={world}: 3 cached steps", lg)
    return lines


def dryrun_multichip(n_ranks: int, device="cuda", timeout_s: float = 120.0) -> list:
    """Every parallel mode on n_ranks gloo ranks on `device`; returns the
    lines (rank 0's), each mode's logits checked finite."""
    from smoothquant_tpu_torch.parallel.mesh import launch

    return launch(_modes, n_ranks, device=device, timeout_s=timeout_s)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for line in dryrun_multichip(args.ranks, args.device):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

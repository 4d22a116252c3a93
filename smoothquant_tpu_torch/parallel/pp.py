"""Pipeline parallelism: GPipe microbatched stages over the "pp" ranks
(port of smoothquant_tpu/parallel/pp.py).

The layer stack splits into pp contiguous stages (stack_pp_stages: every
per-layer leaf stacked to (pp, L/pp, ...), a rank holding its stage's
slice), the batch into M microbatches, and M + pp − 1 ticks move the
activations stage to stage, one ring hop a tick: at tick t stage s works on
microbatch t − s when 0 <= t − s < M and idles otherwise (the JAX package
computes and masks there; here the idle tick skips the work, as its
result is never read).  The bubble is (pp − 1) / (M + pp − 1) of the
ticks.  Embeddings, the final norm and the lm_head are whole on every
rank (v1), or split over the vocabulary (v2, stack_pp_stages_v2: the
lookup a masked local take and one all-reduce, the lm_head each rank's
vocabulary slice of the logits, all-gathered).

make_pp_decode threads per-stage KV caches through the ticks: each rank
holds the caches of its own layers; one token's activation crosses the
stages over pp ticks (microbatch 1), and a stage updates its caches on
its own tick only.  Stage weights may be packed (each stage's
PackedLinears stacked with one layout).  Llama-family models.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from smoothquant_tpu_torch.models.common import (
    ForwardContext,
    KVCache,
    QuantKVCache,
    layer_tree,
    rms_norm,
    rotary_cos_sin,
    stack_trees,
    unembed,
)
from smoothquant_tpu_torch.parallel import comm
from smoothquant_tpu_torch.parallel.mesh import axis_group, shard_tree

PP_AXIS = "pp"
_FIELDS = ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm", "ns_mask")


def make_pp_mesh(pp: Optional[int] = None):
    """A 1-D ("pp",) DeviceMesh over the default group's ranks
    (pp.py:48-61); pp, if given, must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if pp is not None and pp != n:
        raise ValueError(f"pp={pp}: a pp mesh spans the {n} ranks")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu", torch.arange(n),
                      mesh_dim_names=(PP_AXIS,))


def stack_pp_stages(params: dict, cfg, pp: int) -> dict:
    """{"embed_tokens", "norm", "lm_head", "stages"} with every stage leaf
    (pp, L/pp, ...) (pp.py:64-87); packed layers stack when they share one
    layout."""
    n_layers = cfg.num_hidden_layers
    if n_layers % pp:
        raise ValueError(f"num_hidden_layers {n_layers} % pp {pp} != 0")
    per = n_layers // pp
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = stack_trees([stack_trees([params["layers"][str(s * per + j)]
                                              for j in range(per)]) for s in range(pp)])
    return out


def stack_pp_stages_v2(params: dict, cfg, pp: int) -> dict:
    """stack_pp_stages with the embedding and an fp lm_head split over the
    vocabulary, (pp, V/pp, H) each (pp.py:90-127); a packed lm_head keeps
    v1 (stack_pp_stages)."""
    out = stack_pp_stages(params, cfg, pp)
    lm = out.get("lm_head")
    if lm is not None and not isinstance(lm, dict) and not cfg.tie_word_embeddings:
        raise ValueError("stack_pp_stages_v2 supports dict (fp/simulated-quant) lm_heads "
                         "only; use stack_pp_stages (v1) for PackedLinear lm_heads")
    v, h = out["embed_tokens"]["weight"].shape
    if v % pp:
        raise ValueError(f"vocab_size {v} % pp {pp} != 0")
    out["embed_tokens"] = {"weight": out["embed_tokens"]["weight"].reshape(pp, v // pp, h)}
    if isinstance(lm, dict):
        out["lm_head"] = {"weight": lm["weight"].reshape(pp, v // pp, h),
                          "bias": None if lm.get("bias") is None
                          else lm["bias"].reshape(pp, v // pp)}
    return out


def pp_specs(staged: dict) -> dict:
    """The spec tree of a staged tree: the stages (and v2's vocabulary-split
    edges) on their leading axis, the rest whole."""
    v2 = staged["embed_tokens"]["weight"].ndim == 3

    def lead(node):
        from smoothquant_tpu_torch.kernels.pack import PackedLinear

        if isinstance(node, PackedLinear):
            return dict.fromkeys(_FIELDS, 0)
        if isinstance(node, dict):
            return {k: lead(v) for k, v in node.items()}
        return None if node is None else 0

    return {k: lead(v) if k == "stages" or (v2 and k in ("embed_tokens", "lm_head"))
            else None for k, v in staged.items()}


def pp_local(staged: dict, mesh) -> dict:
    """This rank's slice of a staged tree: its stage (1, L/pp, ...)."""
    group = axis_group(mesh, PP_AXIS)
    return shard_tree(staged, pp_specs(staged), dist.get_rank(group),
                      dist.get_world_size(group))


def _run_stage(mod, local, x, cfg, per, cos, sin, ctx, caches=None):
    """The rank's stage (its `per` layers) on x; with caches (a list a
    layer), each layer over its cache, the list updated."""
    stage = layer_tree(local["stages"], 0)
    for j in range(per):
        x, c = mod._decoder_layer(layer_tree(stage, j), x, cfg, "model.layers.pp", cos, sin,
                                  ctx, None if caches is None else caches[j], None)
        if caches is not None:
            caches[j] = c
    return x


def _last_stage(x, s_idx, pp):
    """x on stage pp − 1, zeros elsewhere, in f32: the all-reduce of it
    hands stage pp − 1's tensor to every rank."""
    return x.float() if s_idx == pp - 1 else torch.zeros_like(x, dtype=torch.float32)


def make_pp_forward(mod, cfg, mesh, *, microbatches: int = 0, compute: str = "auto",
                    quant=None):
    """GPipe prefill (pp.py:130-257): build(staged) → fwd(staged, ids) →
    f32 logits (B, S, V) on every rank, staged the rank's pp_local tree.
    The batch splits into `microbatches` (default pp) equal microbatches."""
    group = axis_group(mesh, PP_AXIS)
    pp, s_idx = dist.get_world_size(group), dist.get_rank(group)
    n_mb = microbatches or pp
    per = cfg.num_hidden_layers // pp

    def build(staged):
        v2 = staged["embed_tokens"]["weight"].ndim == 3
        ctx = ForwardContext(quant=quant, compute=compute)

        @torch.no_grad()
        def fwd(local, ids):
            b, s = ids.shape
            if b % n_mb:
                raise ValueError(f"batch {b} % microbatches {n_mb} != 0")
            bm = b // n_mb
            if v2:
                # vocabulary-parallel lookup: a masked local take, one all-reduce
                tab = local["embed_tokens"]["weight"][0]
                vloc = tab.shape[0]
                loc = ids - s_idx * vloc
                ok = (loc >= 0) & (loc < vloc)
                emb = tab[loc.clamp(0, vloc - 1)]
                emb = comm.all_reduce(torch.where(ok[..., None], emb, 0).float(),
                                      group).to(tab.dtype)
            else:
                emb = local["embed_tokens"]["weight"][ids]
            h = emb.shape[-1]
            emb_mb = emb.reshape(n_mb, bm, s, h)
            positions = torch.arange(s, device=ids.device).expand(bm, s)
            cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
            out = torch.zeros((n_mb, bm, s, h), dtype=emb.dtype, device=emb.device)
            x_prev = emb_mb[0]
            for t in range(n_mb + pp - 1):
                # the activation stage s − 1 computed last tick
                x_in = comm.ring_hop(x_prev, group)
                x = emb_mb[min(t, n_mb - 1)] if s_idx == 0 else x_in
                mb = t - s_idx
                if 0 <= mb < n_mb:
                    x = _run_stage(mod, local, x, cfg, per, cos, sin, ctx)
                    if s_idx == pp - 1:
                        out[mb] = x
                x_prev = x
            hs = out.reshape(b, s, h)
            if v2:
                # stage pp − 1's hidden states to every rank, then each rank's
                # vocabulary slice of the logits
                hs = comm.all_reduce(_last_stage(hs, s_idx, pp), group).to(emb.dtype)
                hs = rms_norm(local["norm"], hs, cfg.rms_norm_eps)
                lm = local.get("lm_head")
                w = (local["embed_tokens"]["weight"][0]
                     if cfg.tie_word_embeddings or lm is None else lm["weight"][0])
                logits = unembed(hs, w)
                if isinstance(lm, dict) and lm.get("bias") is not None:
                    logits = logits + lm["bias"][0].float()
                return comm.all_gather(logits, group, axis=-1)
            # only stage pp − 1 holds the hidden states; the others add zeros
            if s_idx == pp - 1:
                hs = rms_norm(local["norm"], hs, cfg.rms_norm_eps)
                logits = mod.lm_head_logits(local, hs, cfg, ctx).float()
            else:
                logits = torch.zeros((b, s, cfg.vocab_size), dtype=torch.float32,
                                     device=emb.device)
            return comm.all_reduce(logits, group)

        return fwd

    return build


def make_pp_decode(mod, cfg, mesh, *, compute: str = "auto", quant=None,
                   quant_kv: bool = False):
    """Cached single-token decode over the stages (pp.py:260-395, v1
    edges): build(staged) → (init_caches, step), staged the rank's pp_local
    tree;
      init_caches(batch, max_len, dtype=None) → the per-layer caches of the
        rank's layers (KVCache, or QuantKVCache with quant_kv);
      step(staged, caches, tok) → (f32 logits (B, V), caches): tok (B,)
        the incoming token of every sequence; the activation crosses the
        stages over pp ticks, each stage running (and writing its caches)
        on its own tick.
    Prime the caches by feeding the prompt one token a step."""
    group = axis_group(mesh, PP_AXIS)
    pp, s_idx = dist.get_world_size(group), dist.get_rank(group)
    per = cfg.num_hidden_layers // pp
    n_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    cache_cls = QuantKVCache if quant_kv else KVCache

    def build(staged):
        if staged["embed_tokens"]["weight"].ndim == 3:
            raise ValueError("make_pp_decode supports v1 (replicated-edge) staging only; "
                             "use stack_pp_stages")
        ctx = ForwardContext(quant=quant, compute=compute)
        dev = staged["embed_tokens"]["weight"].device

        def init_caches(batch: int, max_len: int, dtype=None):
            return [cache_cls.create(batch, max_len, n_kv, cfg.head_dim,
                                     dtype or cfg.torch_dtype, dev) for _ in range(per)]

        @torch.no_grad()
        def step(local, caches, tok):
            b = tok.shape[0]
            pos = caches[0].pos
            x0 = local["embed_tokens"]["weight"][tok[:, None]]
            positions = torch.full((b, 1), int(pos), dtype=torch.int64, device=dev)
            cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
            caches = list(caches)
            x_prev = x0
            for h in range(pp):
                x_in = comm.ring_hop(x_prev, group)
                x = x0 if (s_idx == 0 and h == 0) else x_in
                x_prev = (_run_stage(mod, local, x, cfg, per, cos, sin, ctx, caches)
                          if s_idx == h else x_in)
            # stage pp − 1's hidden state to every rank (v1: edges whole)
            hs = comm.all_reduce(_last_stage(x_prev, s_idx, pp), group).to(x0.dtype)
            hs = rms_norm(local["norm"], hs, cfg.rms_norm_eps)
            logits = mod.lm_head_logits(local, hs, cfg, ctx).float()
            return logits[:, 0], caches

        return init_caches, step

    return build

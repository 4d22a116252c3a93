"""Parallel modes over torch.distributed (port of smoothquant_tpu/parallel):
tensor parallelism of plain / simulated trees (sharding) and of packed
trees (tp_packed: v1 all-gathers, v2 Megatron with a head-sharded cache),
expert parallelism (ep), ring-attention context parallelism (cp), GPipe
pipeline parallelism (pp), over process groups where the JAX package uses
shard_map mesh axes; comm holds the collectives, mesh the groups and the
rank launcher, dryrun the multi-rank dry run."""

from smoothquant_tpu_torch.parallel.cp import (
    CP_AXIS,
    make_cp_mesh,
    make_cp_prefill,
    ring_attention,
)
from smoothquant_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, make_mesh
from smoothquant_tpu_torch.parallel.pp import (
    PP_AXIS,
    make_pp_forward,
    make_pp_mesh,
    stack_pp_stages,
)
from smoothquant_tpu_torch.parallel.sharding import (
    assert_group_shardable,
    param_specs,
    shard_params,
)

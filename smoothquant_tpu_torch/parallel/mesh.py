"""Process groups and the ranks behind them (port of
smoothquant_tpu/parallel/mesh.py).

The JAX package builds a (dp, tp) jax.sharding.Mesh and runs shard_map
over its axes; here every rank is a process, and make_mesh builds the
2-D torch.distributed DeviceMesh with dims ("dp", "tp") over the ranks of
the default process group: axis_group(mesh, "tp") is the group the
tensor-parallel collectives run over.  Every make_* function of parallel/
takes a DeviceMesh (and the name of its axis) or a ProcessGroup.

launch runs a function on n spawned ranks joined by one backend through a
file store, each collective under a timeout, so a hang fails instead of
waiting; init_rank joins the calling process (world size 1 in
chip_smoke's NCCL phase).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from smoothquant_tpu_torch._device import resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"


def make_mesh(tp: Optional[int] = None, dp: Optional[int] = None):
    """A (dp, tp) DeviceMesh over the default group's ranks (mesh.py:22-46):
    tp defaults to every rank, dp to 1; dp · tp must be the world size.
    Rank r sits at (r // tp, r % tp), so a tp group is tp consecutive
    ranks.  Its device type follows the backend (NCCL: "cuda"; gloo:
    "cpu", the host buffers its collectives run on)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if tp is None:
        tp = n // (dp or 1)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=(DP_AXIS, TP_AXIS))


def axis_group(mesh, axis: str):
    """The ProcessGroup of `axis` of a DeviceMesh; a ProcessGroup as it is."""
    from torch.distributed.device_mesh import DeviceMesh

    return mesh.get_group(axis) if isinstance(mesh, DeviceMesh) else mesh


def _take(t: torch.Tensor, axis: int, rank: int, world: int, what: str) -> torch.Tensor:
    n = t.shape[axis]
    if n % world:
        raise ValueError(f"{what}: axis {axis} of size {n} not divisible by {world}")
    return t.narrow(axis, rank * (n // world), n // world)


def shard_tree(tree, specs, rank: int, world: int, what: str = ""):
    """Rank `rank` of `world`'s slice of every leaf (what shard_map's
    in_specs hands a device): `specs` mirrors `tree`, each leaf's entry the
    axis it is split along or None (the leaf whole, not copied); a
    PackedLinear's entry is a dict of its fields' axes.  Slices are
    contiguous copies, so the whole tree can be dropped after; an
    identity-int8 pack's weights stay K-major."""
    from smoothquant_tpu_torch.kernels.pack import PackedLinear, k_major

    if tree is None or specs is None:
        return tree
    if isinstance(tree, PackedLinear):
        kw = {}
        for f, ax in specs.items():
            t = getattr(tree, f)
            if t is not None and ax is not None:
                t = _take(t, ax, rank, world, f"{what}/{f}").contiguous()
                if f == "w_qt" and tree.meta.layout == "identity" and not tree.meta.nibble:
                    t = k_major(t)
            kw[f] = t
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs.get(k), rank, world, f"{what}/{k}")
                for k, v in tree.items()}
    if isinstance(specs, int):
        return _take(tree, specs, rank, world, what).contiguous()
    return tree


def init_rank(rank: int, world: int, backend: str, store_path: str,
              timeout_s: float = 60.0) -> None:
    """Join the default process group as `rank` of `world` through a
    FileStore at store_path; every collective gives up after timeout_s."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(fn, rank, world, backend, device, store_dir, timeout_s, args):
    torch.set_num_threads(1)
    out_path = os.path.join(store_dir, f"result-{rank}.pkl")
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        init_rank(rank, world, backend, os.path.join(store_dir, "store"), timeout_s)
        try:
            result = ("ok", fn(rank, world, dev, *args))
        finally:
            dist.destroy_process_group()
    except Exception:
        result = ("error", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)
    if result[0] != "ok":
        os._exit(1)


def launch(fn: Callable, world: int, *, backend: str = "gloo", device="cuda", args=(),
           timeout_s: float = 60.0, collective_timeout_s: Optional[float] = None) -> list:
    """fn(rank, world, device, *args) on `world` spawned processes joined by
    `backend` (each process its own torch thread; device "cuda" puts every
    rank on the current card, as two ranks share the one card over gloo);
    returns the ranks' results in rank order (they must pickle).  A rank
    that raises fails the launch with its traceback; one that has not
    finished after timeout_s is killed with the others and the launch
    raises TimeoutError.  Each collective gives up after
    collective_timeout_s (default timeout_s).  fn must be importable by
    name in a fresh interpreter (spawn)."""
    resolve_device(device)
    store_dir = tempfile.mkdtemp(prefix="sq_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, str(device), store_dir,
                               collective_timeout_s or timeout_s, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        results = []
        for r in range(world):
            path = os.path.join(store_dir, f"result-{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results.append(pickle.load(f))
            else:
                results.append(None)
        errors = [f"rank {r}:\n{res[1]}" for r, res in enumerate(results)
                  if res is not None and res[0] != "ok"]
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        died = [f"rank {r}: exit code {p.exitcode}" for r, (p, res) in
                enumerate(zip(procs, results)) if res is None and p.exitcode not in (None, 0)]
        if died:
            raise RuntimeError("a rank died: " + "; ".join(died))
        if any(res is None for res in results):
            raise TimeoutError(f"{sum(res is None for res in results)} of {world} ranks did "
                               f"not finish within {timeout_s} s")
        return [res[1] for res in results]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)

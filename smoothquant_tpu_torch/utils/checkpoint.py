"""Checkpoints in the JAX package's .npz layout (port of
smoothquant_tpu/utils/checkpoint.py:18-146 and :289-331).

A checkpoint is a flat np.savez archive keyed by tree paths ("layers/0/
mlp/down_proj/w_qt"), with JSON entries "__packed_metas__" (a packed
model's PackedMeta per packed linear) and "__config__" (an int8 OPT's
config).  The port writes the keys, dtypes and bytes the JAX package writes
for the same tree, and reads what it writes:

  * bfloat16 leaves go out as the raw "|V2" bytes np.savez writes for a
    JAX bf16 array, and "|V2" comes back as torch.bfloat16 (fp16 is saved
    as "<f2", so in these trees "|V2" is bf16).  The JAX loader refuses
    such a leaf (jnp.asarray of "|V2"), so a JAX bf16 pack loads in the
    port but not in the JAX package;
  * a PackedLinear goes out in JAX's layout: its fields, then its meta
    field by field (as _flatten walks the JAX dataclass), the
    identity-int8 weight row-major (K, O) where the port holds it K-major,
    perm int32; it comes back through convert.packed_from_numpy, which
    takes every tp_reduce and refuses block_decode_tree ("sal_select")
    packs;
  * index leaves of the simulated trees (sal_perm, sal_inv_perm,
    salient_indices) go out int32, JAX's dtype, and come back int64;
  * an int8 OPT's alpha goes out float32 (JAX's 0-d leaf), its scales as
    float64 scalars (np.asarray of a Python float), and comes back
    through convert.int8_opt_from_numpy.

The per-host sharded pair (save_packed_model_sharded /
load_packed_model_sharded, :149-285) writes and reads JAX's directory:
manifest.json and one shard-XXXXX-of-XXXXX.npz a rank, each PackedLinear
leaf split along the axis parallel.tp_packed.packed_model_specs names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zipfile
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device
from smoothquant_tpu_torch.kernels.pack import PackedLinear, PackedMeta
from smoothquant_tpu_torch.models.opt import OPTConfig
from smoothquant_tpu_torch.models.opt_int8 import Int8Linear, Int8OPTLayerParams
from smoothquant_tpu_torch.utils.convert import (
    config_from,
    int8_opt_from_numpy,
    packed_from_numpy,
    tensor_from_numpy,
)

_INDEX_LEAVES = ("sal_perm", "sal_inv_perm", "salient_indices", "perm")
_PACKED_FIELDS = ("w_qt", "w_scales_t", "w_sal_t", "bias", "perm")


def to_numpy(t, key: str = "") -> np.ndarray:
    """A leaf as the array the JAX package's _flatten saves: bf16 as its
    "|V2" bytes, an index leaf (key's last part) as int32."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    if t.dtype == torch.int64 and key.rsplit("/", 1)[-1] in _INDEX_LEAVES:
        t = t.to(torch.int32)
    return t.numpy()


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if tree is None:
        return out
    if isinstance(tree, PackedLinear):
        for f in _PACKED_FIELDS:
            _flatten(getattr(tree, f), f"{prefix}{f}/", out)
        _flatten(dataclasses.asdict(tree.meta), f"{prefix}meta/", out)
        _flatten(tree.ns_mask, f"{prefix}ns_mask/", out)
    elif isinstance(tree, Int8Linear):
        out[f"{prefix}w_q"] = to_numpy(tree.w_q)
        out[f"{prefix}bias"] = to_numpy(tree.bias)
        out[f"{prefix}alpha"] = np.asarray(tree.alpha, np.float32)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), f"{prefix}{f.name}/", out)
    else:
        out[prefix[:-1]] = to_numpy(tree, prefix[:-1])
    return out


def save_pytree(tree, path: str) -> None:
    np.savez(path, **_flatten(tree))


def load_flat(path: str) -> dict:
    """{key: array} of an .npz.  A stored (uncompressed) member, as np.savez
    writes them, is a copy-on-write memory map of its bytes in the file,
    read when it is used (no CRC pass, no copy); others go through np.load."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            out[key] = _member(zf, f, info, path)
    return out


_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


def _member(zf, f, info, path):
    """One member: memory-mapped where it is stored, 1 MiB or more, and its
    .npy header of version 1.0 or 2.0; else read through zipfile."""
    if info.compress_type == zipfile.ZIP_STORED and info.file_size >= (1 << 20):
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        read_header = _HEADER_READERS.get(np.lib.format.read_magic(f))
        if read_header is not None:
            shape, fortran, dtype = read_header(f)
            if not dtype.hasobject:
                return np.memmap(path, dtype=dtype, mode="c", offset=f.tell(), shape=shape,
                                 order="F" if fortran else "C")
    with zf.open(info) as m:
        return np.lib.format.read_array(m, allow_pickle=False)


def unflatten(flat: dict) -> dict:
    """Rebuild a nested dict (lists come back as dicts keyed by index str)."""
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _json_entry(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _tensors(node, dev, dtype=None):
    """numpy leaves → tensors on dev (index leaves int64; float leaves cast
    to dtype when it is given)."""
    if isinstance(node, dict):
        return {k: (_tensors(v, dev, dtype) if isinstance(v, dict) else
                    _leaf(v, k, dev, dtype)) for k, v in node.items()}
    return _leaf(node, "", dev, dtype)


def _leaf(a, key, dev, dtype):
    t = tensor_from_numpy(a, dev)
    if key in _INDEX_LEAVES:
        t = t.to(torch.int64)
    if dtype is not None and t.dtype in (torch.float32, torch.float16, torch.bfloat16):
        t = t.to(dtype)
    return t


def save_params(params: dict, path: str) -> None:
    """Save a model params tree (fp or simulated-quantized)."""
    save_pytree(params, path)


def load_params(path: str, dtype=None, device="cuda") -> dict:
    """A save_params checkpoint (either package's) on `device`, float
    leaves cast to `dtype` ("float32", "bfloat16", "float16" or a torch
    dtype) when it is given."""
    from smoothquant_tpu_torch.models.common import as_torch_dtype

    dev = resolve_device(device)
    return _tensors(unflatten(load_flat(path)), dev,
                    None if dtype is None else as_torch_dtype(dtype))


# ---------------------------------------------------------------------------
# Packed-model checkpoints
# ---------------------------------------------------------------------------


def save_packed_model(params: dict, path: str) -> None:
    """Save a pack_model() tree (per-layer or stacked): each PackedLinear's
    meta also goes into the "__packed_metas__" JSON entry, which the
    loaders rebuild it from."""
    metas: dict = {}

    def walk(node, prefix=""):
        if isinstance(node, PackedLinear):
            metas[prefix[:-1]] = dataclasses.asdict(node.meta)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")

    walk(params)
    flat = _flatten(params)
    flat["__packed_metas__"] = _json_entry(metas)
    np.savez(path, **flat)


def load_packed_model(path: str, device="cuda") -> dict:
    """A save_packed_model checkpoint (either package's) on `device`."""
    dev = resolve_device(device)
    flat = load_flat(path)
    metas = json.loads(bytes(flat.pop("__packed_metas__")).decode())
    nested = unflatten(flat)

    def rebuild(node, prefix=""):
        key = prefix[:-1]
        if key in metas:
            d = {k: v for k, v in node.items() if k != "meta"}
            return packed_from_numpy({**d, "meta": metas[key]}, dev)
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        return _leaf(node, prefix[:-1].rsplit("/", 1)[-1], dev, None)

    return rebuild(nested)


# ---------------------------------------------------------------------------
# Sharded packed checkpoints (checkpoint.py:149-285): one file a rank
# ---------------------------------------------------------------------------


def _shard_file(dir_path: str, i: int, n: int) -> str:
    return os.path.join(dir_path, f"shard-{i:05d}-of-{n:05d}.npz")


def save_packed_model_sharded(params: dict, dir_path: str, n_shards: int) -> None:
    """A pack_model / pack_model_tp tree as JAX's sharded directory:
    manifest.json ({"n_shards", "metas", "axes"}) and n_shards
    shard-XXXXX-of-XXXXX.npz files.  Each PackedLinear leaf is split along
    the axis parallel.tp_packed.packed_model_specs gives it (a column
    pack's O axis, a row pack's K-concatenated leading axis, so n_shards
    must be the tp it was packed for); every leaf kept whole (norms,
    embeddings, a row pack's bias, a column pack's perm, the metas' own
    entries) goes into shard 0 alone, which every rank reads."""
    from smoothquant_tpu_torch.parallel.tp_packed import packed_model_specs

    os.makedirs(dir_path, exist_ok=True)
    flat_p = _flatten(params)
    flat_s: dict = {}
    metas: dict = {}

    def walk(node, spec, prefix=""):
        if isinstance(node, PackedLinear):
            metas[prefix[:-1]] = dataclasses.asdict(node.meta)
            for f, ax in spec.items():
                flat_s[f"{prefix}{f}"] = ax
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{prefix}{k}/")

    walk(params, packed_model_specs(params))
    shards: list = [{} for _ in range(n_shards)]
    axes: dict = {}
    for key, arr in flat_p.items():
        ax = flat_s.get(key)
        if ax is None:
            shards[0][key] = arr
            continue
        if arr.shape[ax] % n_shards:
            raise ValueError(f"{key}: axis {ax} size {arr.shape[ax]} not divisible by "
                             f"n_shards={n_shards}")
        axes[key] = ax
        step = arr.shape[ax] // n_shards
        for i in range(n_shards):
            shards[i][key] = np.take(arr, np.arange(i * step, (i + 1) * step), axis=ax)
    with open(os.path.join(dir_path, "manifest.json"), "w") as f:
        json.dump({"n_shards": n_shards, "metas": metas, "axes": axes}, f)
    for i, flat in enumerate(shards):
        np.savez(_shard_file(dir_path, i, n_shards), **flat)


def load_packed_model_sharded(dir_path: str, shard: Optional[int] = None,
                              device="cuda") -> dict:
    """A sharded checkpoint (either package's) on `device`: shard=i → rank
    i's local params (its slice of each split leaf, the metas global as
    under shard_map: parallel.tp_packed.local_shard of the whole tree, bit
    for bit); shard=None → the whole tree, the shards concatenated."""
    dev = resolve_device(device)
    with open(os.path.join(dir_path, "manifest.json")) as f:
        manifest = json.load(f)
    n, axes, metas = manifest["n_shards"], manifest["axes"], manifest["metas"]
    if shard is not None:
        flat = load_flat(_shard_file(dir_path, 0, n))
        if shard != 0:
            flat = {k: v for k, v in flat.items() if k not in axes}
            flat.update(load_flat(_shard_file(dir_path, shard, n)))
    else:
        parts = [load_flat(_shard_file(dir_path, i, n)) for i in range(n)]
        flat = dict(parts[0])
        for key, ax in axes.items():
            flat[key] = np.concatenate([p[key] for p in parts], axis=ax)

    def rebuild(node, prefix=""):
        key = prefix[:-1]
        if key in metas:
            d = {k: v for k, v in node.items() if k != "meta"}
            return packed_from_numpy({**d, "meta": metas[key]}, dev)
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        return _leaf(node, prefix[:-1].rsplit("/", 1)[-1], dev, None)

    return rebuild(unflatten(flat))


# ---------------------------------------------------------------------------
# INT8 OPT artifact (export_int8_model CLI)
# ---------------------------------------------------------------------------


def save_int8_opt(int8_params: dict, cfg, path: str) -> None:
    flat = _flatten(int8_params)
    flat["__config__"] = _json_entry(dataclasses.asdict(cfg))
    np.savez(path, **flat)


def load_int8_opt(path: str, device="cuda"):
    """Returns (cfg, int8_params) ready for models.opt_int8.forward."""
    dev = resolve_device(device)
    flat = load_flat(path)
    cfg = config_from(OPTConfig, json.loads(bytes(flat.pop("__config__")).decode()))
    nested = unflatten(flat)
    raw = nested.pop("int8_layers")
    layers = [raw[str(i)] for i in range(len(raw))]
    fields = {f.name for f in dataclasses.fields(Int8OPTLayerParams)}
    if any(set(lp) != fields for lp in layers):
        raise ValueError(f"{path}: an int8 layer's fields are not {sorted(fields)}")
    return cfg, int8_opt_from_numpy({**nested, "int8_layers": layers}, dev)

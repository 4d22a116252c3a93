"""HF checkpoint import (port of smoothquant_tpu/utils/hf_import.py): a
local directory (config.json + safetensors shards or pytorch_model*.bin)
→ the port's (arch, config, params) on the card, fully offline.

The JAX package reads the config with transformers.AutoConfig and the
shards with safetensors.numpy; the port needs neither:

  * config.json is read with json and completed per model_type from
    _HF_DEFAULTS, the defaults AutoConfig supplies for the keys each
    family's config_from_hf reads (transformers 4.57's LlamaConfig,
    MistralConfig, OPTConfig and BloomConfig: Mistral's sliding_window is
    4096 when the key is absent and None when it is null; Llama's and
    Mistral's num_key_value_heads falls back to the head count when null;
    OPT's word_embed_proj_dim to hidden_size; Bloom's aliases n_layer /
    n_head / n_embed), returned as a namespace that config_from_hf reads
    as it reads an HF config;
  * a safetensors shard is its 8-byte little-endian header length, the
    JSON header (its "__metadata__" skipped) and the raw bytes; each tensor
    is a view over a copy-on-write memory map of the shard, so a state
    dict of many GB is never copied whole on the host, and the importers
    move it to the card one tensor at a time.

Act-scales artifacts: the reference's torch.save .pt format, or .npz.
"""

from __future__ import annotations

import json
import os
import struct
import types
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch._device import resolve_device

ARCH_MAP = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "mistral",
    "OPTForCausalLM": "opt",
    "MixtralForCausalLM": "mixtral",
    "FalconForCausalLM": "falcon",
    "BloomForCausalLM": "bloom",
}

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64}

# The defaults transformers.AutoConfig fills in (transformers 4.57) for the
# keys the port's config_from_hf reads, per model_type.
_HF_DEFAULTS = {
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                  max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=10000.0,
                  tie_word_embeddings=False, attention_bias=False, mlp_bias=False),
    "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=4096 * 32, rms_norm_eps=1e-6,
                    rope_theta=10000.0, tie_word_embeddings=False, sliding_window=4096),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12, ffn_dim=3072,
                max_position_embeddings=2048, do_layer_norm_before=True,
                word_embed_proj_dim=None, num_attention_heads=12),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5),
}
# BloomConfig.attribute_map (a key set through its alias wins) and the
# n_embed keyword it pops into hidden_size
_HF_ALIASES = {"bloom": {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head"}}


def _read_config_json(model_path: str) -> dict:
    with open(os.path.join(model_path, "config.json")) as f:
        return json.load(f)


def detect_arch(model_path: str) -> str:
    cfg = _read_config_json(model_path)
    archs = cfg.get("architectures") or []
    for a in archs:
        if a in ARCH_MAP:
            return ARCH_MAP[a]
    mt = cfg.get("model_type", "")
    if mt in ("llama", "mistral", "opt", "mixtral", "falcon", "bloom"):
        return mt
    raise ValueError(f"cannot detect architecture from {model_path}: {archs or mt}")


def read_hf_config(model_path: str, arch: Optional[str] = None) -> types.SimpleNamespace:
    """config.json as the attributes AutoConfig.from_pretrained would give
    the port's config_from_hf: the file's keys over the family's defaults,
    with its aliases and derived values applied."""
    raw = _read_config_json(model_path)
    arch = arch or detect_arch(model_path)
    kind = raw.get("model_type", arch)
    if kind not in _HF_DEFAULTS:
        kind = arch
    if kind not in _HF_DEFAULTS:
        raise NotImplementedError(f"no config defaults for model_type {kind!r}")
    aliases = _HF_ALIASES.get(kind, {})
    vals = dict(_HF_DEFAULTS[kind])
    vals.update({k: v for k, v in raw.items() if k not in aliases and k != "n_embed"})
    vals.update({aliases[k]: v for k, v in raw.items() if k in aliases})
    if kind == "bloom" and raw.get("n_embed") is not None:
        vals["hidden_size"] = raw["n_embed"]
    if kind in ("llama", "mistral") and vals["num_key_value_heads"] is None:
        vals["num_key_value_heads"] = vals["num_attention_heads"]
    if kind == "opt" and vals["word_embed_proj_dim"] is None:
        vals["word_embed_proj_dim"] = vals["hidden_size"]
    for alias, name in aliases.items():
        vals[alias] = vals[name]
    return types.SimpleNamespace(**vals)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def read_safetensors(path: str) -> dict:
    """{name: tensor} of one safetensors file, each a CPU view over a
    copy-on-write memory map of the file (nothing read until it is used);
    "__metadata__" skipped.  Raises on a dtype outside _ST_DTYPES."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return {}
    buf = torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        dt = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        raw = buf[base + lo:base + hi]
        if (base + lo) % dt.itemsize:          # a misaligned view cannot change dtype
            raw = raw.clone()
        out[name] = raw.view(dt).reshape(info["shape"])
    return out


def write_safetensors(tensors: dict, path: str, metadata: Optional[dict] = None) -> int:
    """Write {name: tensor} as one safetensors file (the header padded with
    spaces to 8 bytes, tensors in the dict's order); returns the bytes
    written.  Each tensor is brought to the host one at a time."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, off = {}, 0
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(head) + off


def load_state_dict(model_path: str) -> dict:
    """All weights of a directory: its safetensors shards in sorted order
    (preferred), else its pytorch_model*.bin files through
    torch.load(weights_only=True).  Tensors stay on the host."""
    state: dict = {}
    st_files = sorted(f for f in os.listdir(model_path) if f.endswith(".safetensors"))
    if st_files:
        for f in st_files:
            state.update(read_safetensors(os.path.join(model_path, f)))
        return state
    bin_files = sorted(f for f in os.listdir(model_path)
                       if f.endswith(".bin") and f.startswith("pytorch_model"))
    if bin_files:
        for f in bin_files:
            state.update(torch.load(os.path.join(model_path, f), map_location="cpu",
                                    weights_only=True))
        return state
    raise FileNotFoundError(f"no safetensors or pytorch_model*.bin in {model_path}")


def load_model(model_path: str, dtype: Optional[str] = None, device="cuda"):
    """Returns (arch, cfg, params) for a local HF checkpoint directory, the
    params on `device` in `dtype` (default: the config's, bfloat16)."""
    from smoothquant_tpu_torch.models.registry import get_arch

    dev = resolve_device(device)
    arch = detect_arch(model_path)
    mod = get_arch(arch)
    cfg = mod.config_from_hf(read_hf_config(model_path, arch))
    params = mod.params_from_hf_state_dict(load_state_dict(model_path), cfg, dtype=dtype,
                                           device=dev)
    return arch, cfg, params


# ---------------------------------------------------------------------------
# activation scales
# ---------------------------------------------------------------------------


def load_act_scales(path: str) -> dict:
    """An activation-scales artifact: the reference's torch.save format
    (act_scales/<model>.pt) or .npz.  Returns {hf_module_name: float32 (C,)
    numpy array}."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in obj.items()}


def save_act_scales(scales: dict, path: str) -> None:
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v, np.float32) for k, v in scales.items()})
    else:
        torch.save({k: torch.tensor(np.asarray(v)) for k, v in scales.items()}, path)

"""Architecture dispatch (port of smoothquant_tpu/models/registry.py):
register_arch and get_arch (:19-38; llama, mistral (llama-like), opt,
bloom), quantize_model (the simulated path's weight quantization, :41-48),
smooth_lm (:51-55) and pack_model (:57-197, host_pack included) — the
default per-layer tree (fuse=False: every projection its own pack, the
README quick start's path and Bloom's) or, for Llama, the fused qkv /
gate_up tree; the shared residual basis (Llama, fused or not), folded
permutations (Llama fused or not, OPT) and identity layouts of the
serving pack.  An architecture
without residual_consumers / perm_fold_pairs / fuse_projections refuses
the option that needs it, as the JAX package does."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothquant_tpu_torch.kernels.pack import fold_input_perm, pack_linear
from smoothquant_tpu_torch.models import bloom, llama, opt
from smoothquant_tpu_torch.quant.config import QuantConfig
from smoothquant_tpu_torch.quant.smooth import _get_path, _set_path, smooth_model

_ARCHES = {}


def register_arch(name: str, module) -> None:
    """Make `module` (quantize_params, smoothing_map, quantizable_linears,
    ...) the architecture `name`."""
    _ARCHES[name] = module


register_arch("llama", llama)
register_arch("mistral", llama)   # llama-like (registry.py:24)
register_arch("opt", opt)
register_arch("bloom", bloom)


def get_arch(name: str):
    try:
        return _ARCHES[name]
    except KeyError:
        raise NotImplementedError(
            f"architecture {name!r} is not ported (ported: {sorted(_ARCHES)})"
        ) from None


def quantize_model(arch: str, params: dict, cfg, qcfg: QuantConfig,
                   input_feat: Optional[dict] = None) -> dict:
    """Offline weight quantization of the simulated path for any registered
    architecture: a tree that forward runs under ForwardContext(quant=qcfg)."""
    return get_arch(arch).quantize_params(params, cfg, qcfg, input_feat)


def smooth_lm(arch: str, params: dict, cfg, act_scales: dict,
              alpha: float = 0.5) -> dict:
    """SmoothQuant smoothing for any registered architecture."""
    return smooth_model(params, get_arch(arch).smoothing_map(cfg), act_scales, alpha)


def pack_model(
    arch: str,
    params: dict,
    cfg,
    qcfg: QuantConfig,
    input_feat: Optional[dict] = None,
    act_scales: Optional[dict] = None,
    compute_dtype=None,
    nibble: bool = False,
    lm_head_qcfg: Optional[QuantConfig] = None,
    host_pack: bool = False,
    align_k_groups: int = 1,
    align_o: int = 1,
    fuse: bool = False,
    fold_perms: bool = False,
    shared_residual_basis: bool = False,
    identity_keys: tuple = (),
) -> dict:
    """Replace every quantizable linear with a PackedLinear.

    input_feat: salience importance vectors; act_scales: per-channel
    absmax (the static sort key).  Both keyed by HF module names.  The
    options mean what they mean in the JAX package's pack_model (its
    defaults: per-layer int8-container packs, which real_quant_linear runs
    on K8 or K9); packing runs on the device the weights live on, or with
    host_pack=True on the host's native library, each packed linear then
    moved to the weights' device (bit for bit the device pack; raises where
    the library cannot be built).
    """
    mod = get_arch(arch)
    compute_dtype = compute_dtype or cfg.torch_dtype
    if fuse:
        if not hasattr(mod, "fuse_projections"):
            raise NotImplementedError(f"{arch} has no fused-projection support")
        params = mod.fuse_projections(params, cfg)
        listing = mod.quantizable_linears_fused(cfg)
    else:
        listing = mod.quantizable_linears(cfg)
    rs_paths: dict = {}
    shared_imp = shared_absmax = None
    if shared_residual_basis:
        if not hasattr(mod, "residual_consumers"):
            raise NotImplementedError(f"{arch} has no shared-residual-basis support")
        rs_paths = {tuple(p): key for p, key in mod.residual_consumers(cfg, fuse)}
        keys = set(rs_paths.values())
        if input_feat is not None:
            shared_imp = np.sum([np.asarray(input_feat[k]) for k in keys], axis=0)
        if act_scales is not None:
            shared_absmax = np.max([np.asarray(act_scales[k]) for k in keys], axis=0)
        elif shared_imp is not None:
            shared_absmax = shared_imp
        else:
            raise ValueError("shared_residual_basis needs input_feat or "
                             "act_scales to define the shared layout")
    fold_map = {}
    if fold_perms:
        if not hasattr(mod, "perm_fold_pairs"):
            raise NotImplementedError(f"{arch} has no perm-fold support")
        fold_map = {tuple(c): prods for c, prods in mod.perm_fold_pairs(cfg, fuse)}
        listing = sorted(listing, key=lambda t: 0 if tuple(t[0]) in fold_map else 1)

    shared_perm = None
    for path, key, _qo in listing:
        lin = _get_path(params, path)
        imp = None if input_feat is None else np.asarray(input_feat[key])
        absmax = None if act_scales is None else np.asarray(act_scales[key])
        if tuple(path) in rs_paths:
            imp = shared_imp if shared_imp is not None else imp
            absmax = shared_absmax
        identity = nibble and any(sub in key for sub in identity_keys)
        packed = pack_linear(lin, qcfg, importance=imp, act_absmax=absmax,
                             compute_dtype=compute_dtype, nibble=nibble,
                             host_pack=host_pack, identity=identity,
                             align_k_groups=align_k_groups,
                             align_o=align_o)
        if tuple(path) in rs_paths:
            packed = dataclasses.replace(
                packed, meta=dataclasses.replace(packed.meta, pre_permuted=True))
            perm = packed.perm.cpu().numpy()
            if shared_perm is None:
                shared_perm = perm
            elif not np.array_equal(shared_perm, perm):
                raise RuntimeError("shared-basis consumers diverged in layout")
        for prod_path, n_splits in fold_map.get(tuple(path), ()):
            packed, prod_lin = fold_input_perm(packed, _get_path(params, prod_path),
                                               n_splits)
            params = _set_path(params, prod_path, prod_lin)
        params = _set_path(params, path, packed)
    if lm_head_qcfg is not None and isinstance(params.get("lm_head"), dict):
        params = dict(params)
        lm = params["lm_head"]
        if shared_perm is not None:
            take = torch.as_tensor(shared_perm, device=lm["weight"].device)
            lm = {"weight": lm["weight"].index_select(1, take),
                  "bias": lm.get("bias")}
        params["lm_head"] = pack_linear(lm, lm_head_qcfg, compute_dtype=compute_dtype,
                                        host_pack=host_pack)
    if shared_perm is not None:
        params = mod.apply_shared_residual_basis(params, cfg, shared_perm)
    return params

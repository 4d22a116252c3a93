"""Salient-channel selection (port of smoothquant_tpu/quant/saliency.py).

Saliency is resolved at quantize time, on the host, into a static channel
permutation that puts the non-salient channels first and the salient ones
last, each in ascending index order: the compaction the reference does
with a boolean mask on every call, as a layout fixed at load time.  These
functions are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def select_salient_indices(importance: np.ndarray, num_salient: int) -> np.ndarray:
    """Top-k channels by descending importance, as int32 indices in
    descending-importance order.  Stable sort: ties go to the lower index."""
    imp = np.asarray(importance, dtype=np.float64)
    order = np.argsort(-imp, kind="stable")
    return order[:num_salient].astype(np.int32)


def weight_magnitude_importance(weight) -> np.ndarray:
    """Per-input-channel mean |w| over the output rows, float64
    (saliency.py:34-43): an importance vector from the weight alone, for
    when no calibration data is at hand.  `weight` is an (out, in) array
    or tensor (bfloat16 tensors are read as float32)."""
    if isinstance(weight, torch.Tensor):
        weight = weight.detach().float().cpu().numpy()
    return np.abs(np.asarray(weight, np.float32)).mean(axis=0).astype(np.float64)


def salient_partition_perm(in_features: int, salient_indices: np.ndarray):
    """(perm, inv_perm), int32 (in_features,) (saliency.py:46-59):
    x[:, perm] holds the non-salient columns first and the salient ones
    last, each in ascending index order; y[:, inv_perm] undoes it."""
    sal = np.zeros(in_features, dtype=bool)
    sal[np.asarray(salient_indices, dtype=np.int64)] = True
    perm = np.concatenate([np.nonzero(~sal)[0], np.nonzero(sal)[0]]).astype(np.int32)
    inv_perm = np.argsort(perm).astype(np.int32)
    return perm, inv_perm

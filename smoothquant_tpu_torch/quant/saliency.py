"""Salient-channel selection (port of smoothquant_tpu/quant/saliency.py:21-31)."""

from __future__ import annotations

import numpy as np


def select_salient_indices(importance: np.ndarray, num_salient: int) -> np.ndarray:
    """Top-k channels by descending importance, as int32 indices in
    descending-importance order.  Stable sort: ties go to the lower index."""
    imp = np.asarray(importance, dtype=np.float64)
    order = np.argsort(-imp, kind="stable")
    return order[:num_salient].astype(np.int32)

"""Analytic model-size accounting (port of smoothquant_tpu/eval/
model_size.py; the reference's model_size.py:5-16):

size_bits = numel × [(1-p)·(w + 20/g) + p·(16 + 20/g)]

w the data width in bits, p the salient proportion, g the group size (20/g
is a 16-bit scale and 4 bits of metadata a group; left out when g == -1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GiB = 2 ** 30
MiB = 2 ** 20


def count_params(params) -> int:
    """Elements of every tensor or array leaf of a params tree (dicts,
    lists, tuples and dataclasses such as PackedLinear walked through),
    as the JAX package counts its pytree's array leaves."""
    if isinstance(params, (torch.Tensor, np.ndarray)):
        return int(params.numel() if isinstance(params, torch.Tensor) else params.size)
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    if dataclasses.is_dataclass(params) and not isinstance(params, type):
        return sum(count_params(getattr(params, f.name)) for f in dataclasses.fields(params))
    return 0


def get_model_size_bits(num_elements: int, data_width: int = 16,
                        salient_prop: float = 0.0, group_size: int = -1) -> float:
    w_ns = float(data_width)
    w_s = 16.0
    if group_size != -1:
        overhead = (16 + 4) / group_size
        w_ns += overhead
        w_s += overhead
    return num_elements * (w_ns * (1 - salient_prop) + w_s * salient_prop)


def get_model_size(params, data_width: int = 16, salient_prop: float = 0.0,
                   group_size: int = -1) -> float:
    """Size in bits of a params tree (every array leaf counted)."""
    return get_model_size_bits(count_params(params), data_width, salient_prop, group_size)


def bits_to_mib(bits: float) -> float:
    return bits / 8 / MiB

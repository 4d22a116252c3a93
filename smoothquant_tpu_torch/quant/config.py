"""Quantization configuration (port of smoothquant_tpu/quant/config.py).

A frozen, hashable dataclass carrying the recipe, its named presets
(W8A8_SMOOTHQUANT, W4A4_PER_CHANNEL) and recipe functions (w4a4_group, w4a8_group);
the packed layers record the activation part of it in their meta so
recipes can mix per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

WEIGHT_QUANT_CHOICES = ("per_channel", "per_tensor", "per_group", "per_group_unsorted")
ACT_QUANT_CHOICES = ("per_token", "per_tensor", "per_group", "per_group_unsorted")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Full quantization recipe for a model.

    weight_quant / act_quant: granularity ("per_group" is the sorted
      variant); salient_prop: fraction of input channels kept in high
      precision; quant_bits: weight width (q_max = 2**(b-1)-1); act_bits:
      activation width (None → quant_bits); group_size: channels per group;
      scale_dtype: STORAGE dtype of packed group scales (math stays f32).
    """

    weight_quant: str = "per_channel"
    act_quant: str = "per_token"
    quantize_bmm_input: bool = False
    salient_prop: float = 0.0
    quant_bits: int = 4
    act_bits: Optional[int] = None
    group_size: int = 128
    alpha: float = 0.5
    static_sort: bool = False
    sort_strategy: str = "max"
    scale_dtype: str = "float32"

    def __post_init__(self):
        if self.sort_strategy not in ("max", "mean_std", "argmax"):
            raise ValueError(
                "sort_strategy must be one of ('max', 'mean_std', 'argmax')")
        if self.scale_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "scale_dtype must be one of ('float32', 'bfloat16')")
        if self.weight_quant not in WEIGHT_QUANT_CHOICES:
            raise ValueError(f"weight_quant must be one of {WEIGHT_QUANT_CHOICES}")
        if self.act_quant not in ACT_QUANT_CHOICES:
            raise ValueError(f"act_quant must be one of {ACT_QUANT_CHOICES}")
        if not 0.0 <= self.salient_prop < 1.0:
            raise ValueError("salient_prop must be in [0, 1)")
        if self.quant_bits < 2:
            raise ValueError("quant_bits must be >= 2")
        if self.group_size < 1:
            raise ValueError("group_size must be >= 1")

    @property
    def q_max(self) -> int:
        return 2 ** (self.quant_bits - 1) - 1

    @property
    def effective_act_bits(self) -> int:
        return self.act_bits if self.act_bits is not None else self.quant_bits

    def num_salient(self, in_features: int) -> int:
        """max(1, int(p*C)) when p > 0, else 0."""
        if self.salient_prop <= 0:
            return 0
        return max(1, int(self.salient_prop * in_features))


# Named presets of the reference's experiments (config.py:113-121).
W8A8_SMOOTHQUANT = QuantConfig(
    weight_quant="per_channel", act_quant="per_token",
    quantize_bmm_input=True, quant_bits=8, alpha=0.5,
)
W4A4_PER_CHANNEL = QuantConfig(
    weight_quant="per_channel", act_quant="per_token",
    quantize_bmm_input=True, quant_bits=4,
)


def w4a4_group(group_size: int = 128, salient_prop: float = 0.0,
               quantize_bmm_input: bool = False) -> QuantConfig:
    """W4A4 per-group weights and activations (the bench recipe's base)."""
    return QuantConfig(
        weight_quant="per_group", act_quant="per_group",
        quantize_bmm_input=quantize_bmm_input,
        salient_prop=salient_prop, quant_bits=4, group_size=group_size,
    )


def w4a8_group(group_size: int = 128, salient_prop: float = 0.0,
               quantize_bmm_input: bool = False) -> QuantConfig:
    """W4A8: 4-bit group weights, 8-bit activations (config.py:101-108)."""
    return QuantConfig(
        weight_quant="per_group", act_quant="per_group",
        quantize_bmm_input=quantize_bmm_input,
        salient_prop=salient_prop, quant_bits=4, act_bits=8, group_size=group_size,
    )

from smoothquant_tpu_torch.quant.config import (
    W4A4_PER_CHANNEL,
    W8A8_SMOOTHQUANT,
    QuantConfig,
    w4a4_group,
    w4a8_group,
)
from smoothquant_tpu_torch.quant.core import (
    quantize_activation_per_group_absmax,
    quantize_activation_per_group_absmax_sort,
    quantize_activation_per_tensor_absmax,
    quantize_activation_per_token_absmax,
    quantize_weight_per_channel_absmax,
    quantize_weight_per_group_absmax,
    quantize_weight_per_group_absmax_sort,
    quantize_weight_per_tensor_absmax,
)
from smoothquant_tpu_torch.quant.linear import linear, quant_linear, quantize_linear_params
from smoothquant_tpu_torch.quant.smooth import (
    compute_smoothing_scales,
    smooth_model,
    smooth_norm_linears,
)

__all__ = [
    "QuantConfig", "W4A4_PER_CHANNEL", "W8A8_SMOOTHQUANT", "w4a4_group", "w4a8_group",
    "quantize_activation_per_group_absmax", "quantize_activation_per_group_absmax_sort",
    "quantize_activation_per_tensor_absmax", "quantize_activation_per_token_absmax",
    "quantize_weight_per_channel_absmax", "quantize_weight_per_group_absmax",
    "quantize_weight_per_group_absmax_sort", "quantize_weight_per_tensor_absmax",
    "linear", "quant_linear", "quantize_linear_params",
    "compute_smoothing_scales", "smooth_model", "smooth_norm_linears",
]

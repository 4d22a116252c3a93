"""Perplexity evaluation and model-size accounting (port of
smoothquant_tpu/eval)."""

from smoothquant_tpu_torch.eval.model_size import (
    bits_to_mib,
    count_params,
    get_model_size,
    get_model_size_bits,
)
from smoothquant_tpu_torch.eval.ppl import Evaluator, window_nll

__all__ = ["Evaluator", "window_nll", "bits_to_mib", "count_params", "get_model_size",
           "get_model_size_bits"]

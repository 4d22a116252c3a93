"""smoothquant_tpu_torch — the PyTorch/CUDA port of smoothquant_tpu.

The JAX package (`smoothquant_tpu`) stays the reference; this package
mirrors its module names so each piece has an obvious counterpart:

  quant/      QuantConfig, the int quantize primitives, salient selection
  kernels/    packing, the hand-written Hopper kernels (csrc/*.cu) with
              their plain PyTorch versions, and the real-quant dispatch
  models/     Llama forward (per-layer prefill, stacked S-major decode)
  serve/      ContinuousBatcher over a stacked S-major int8 KV pool
  utils/      JAX→port parameter conversion, H100 roofline accounting

Nothing here imports jax or smoothquant_tpu.  Entry points take a
`device` argument that defaults to "cuda" and raise when CUDA is missing;
they never fall back to the CPU unless the caller passes device="cpu".
"""

from smoothquant_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]

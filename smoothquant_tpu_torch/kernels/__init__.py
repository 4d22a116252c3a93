"""Packing, the hand-written Hopper kernels (csrc/*.cu, built at first use
by _build) with their plain PyTorch versions, and the real-quant dispatch."""

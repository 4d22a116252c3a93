"""Continuous-batching serving demo over a quantized model (port of
examples/serving_demo.py).

Mixed-length requests flow through a slot-based batcher with a W8A8
simulated-quantized tiny random Llama and greedy decoding:

  python -m smoothquant_tpu_torch.examples.serving_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> list:
    """Runs the demo; returns the finished requests by uid."""
    import torch

    from smoothquant_tpu_torch._device import resolve_device
    from smoothquant_tpu_torch.cli.common import add_device_arg
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.registry import quantize_model
    from smoothquant_tpu_torch.quant import QuantConfig
    from smoothquant_tpu_torch.serve import ContinuousBatcher, Request

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    dev = resolve_device(p.parse_args(argv).device)

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    qcfg = QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    qparams = quantize_model("llama", params, cfg, qcfg)

    batcher = ContinuousBatcher(llama, qparams, cfg, quant=qcfg, max_batch=2, max_len=128,
                                device=dev)
    rng = np.random.default_rng(0)
    for uid, n in enumerate([5, 11, 3, 8]):
        batcher.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, size=(n,)),
                               max_new_tokens=6))
    print(f"4 requests queued over 2 slots on {dev}; running to completion...")
    done = sorted(batcher.run_to_completion(), key=lambda r: r.uid)
    for r in done:
        print(f"request {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")
    return done


if __name__ == "__main__":
    main()

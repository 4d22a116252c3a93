"""Multi-host serving tier demo: request distribution over batcher replicas
(port of examples/cluster_demo.py).

The ClusterFrontend (serve/cluster.py) over two host replicas of a
quantized tiny Llama: mixed-length requests, least-outstanding-work
routing, the per-host and cluster throughput metrics.  Both replicas step
in one process (on a real deployment each runs on its own host), which
shows the scheduling, its determinism and the metrics:

  python -m smoothquant_tpu_torch.examples.cluster_demo [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    """Runs the demo; returns {"requests": finished requests by uid,
    "stats": ClusterFrontend.stats()}."""
    import torch

    from smoothquant_tpu_torch._device import resolve_device
    from smoothquant_tpu_torch.cli.common import add_device_arg
    from smoothquant_tpu_torch.models import llama
    from smoothquant_tpu_torch.models.registry import quantize_model
    from smoothquant_tpu_torch.quant import QuantConfig
    from smoothquant_tpu_torch.serve import ClusterFrontend, ContinuousBatcher, Request

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(p)
    dev = resolve_device(p.parse_args(argv).device)

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    qcfg = QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8)
    qparams = quantize_model("llama", params, cfg, qcfg)

    def make_batcher(host_id: int) -> ContinuousBatcher:
        return ContinuousBatcher(llama, qparams, cfg, quant=qcfg, max_batch=2, max_len=64,
                                 device=dev)

    cluster = ClusterFrontend(make_batcher, n_hosts=2)
    rng = np.random.default_rng(0)
    for uid, n in enumerate(rng.integers(3, 14, size=8)):
        cluster.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                             size=(int(n),)),
                               max_new_tokens=6))

    done = sorted(cluster.run_to_completion(), key=lambda r: r.uid)
    for req in done:
        print(f"req {req.uid}: prompt {len(req.prompt):2d} tokens → {req.generated}")
    stats = cluster.stats()
    print(json.dumps({"device": str(dev), **stats}, indent=1, default=float))
    return {"requests": done, "stats": stats}


if __name__ == "__main__":
    main()

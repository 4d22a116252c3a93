"""Rates of the machine with the card that the I/O phases of chip_smoke.py
lean on: free disk space, the host pack of one Llama-2-7B gate_up linear
(22016 × 4096, the serving recipe) on the host and on the card, a 2 GB
safetensors file written and read back to the card, the same bytes saved
and loaded as .npz.  One JSON line a measurement.

    python3 scripts/io_probe.py            # on the machine with the card
"""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> int:
    import numpy as np
    import torch

    from smoothquant_tpu_torch.kernels.pack import pack_linear
    from smoothquant_tpu_torch.quant.config import w4a4_group
    from smoothquant_tpu_torch.utils import checkpoint, hf_import, native

    if not torch.cuda.is_available():
        print("io_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    emit(probe="env", torch=torch.__version__, threads=torch.get_num_threads(),
         cpus=os.cpu_count(), disk_free_gb=shutil.disk_usage(tempfile.gettempdir()).free / 1e9)
    t0 = time.perf_counter()
    native.lib()
    emit(probe="packlib_build", seconds=time.perf_counter() - t0)
    q = dataclasses.replace(w4a4_group(64, 0.05), scale_dtype="bfloat16")
    imp = np.random.default_rng(0).uniform(0.1, 1, size=4096)
    w = {"weight": torch.randn(22016, 4096, device=dev).bfloat16(), "bias": None}
    for host in (True, True, False, False):          # the second of each timed warm
        s, _ = timed(lambda: pack_linear(w, q, importance=imp, act_absmax=imp, nibble=True,
                                         host_pack=host, align_k_groups=8, align_o=2048))
        emit(probe="pack_linear_gate_up", host=host, seconds=s)
    root = tempfile.mkdtemp(prefix="io_probe_")
    try:
        ts = {f"t{i}": torch.randn(11008, 4096, device=dev).bfloat16() for i in range(22)}
        path = os.path.join(root, "a.safetensors")
        s, n = timed(lambda: hf_import.write_safetensors(ts, path))
        emit(probe="safetensors_write", gb=n / 1e9, seconds=s)
        s, out = timed(lambda: {k: v.to(dev, copy=True)
                                for k, v in hf_import.read_safetensors(path).items()})
        emit(probe="safetensors_read_to_card", seconds=s, warm=True,
             equal=all(torch.equal(out[k], ts[k]) for k in ts))
        del out
        npz = os.path.join(root, "b.npz")
        s, _ = timed(lambda: np.savez(npz, **{k: v.cpu().view(torch.int16).numpy()
                                               for k, v in ts.items()}))
        emit(probe="npz_save", seconds=s)
        s, flat = timed(lambda: {k: torch.from_numpy(np.asarray(v)).to(dev)
                                 for k, v in checkpoint.load_flat(npz).items()})
        emit(probe="npz_load_to_card", seconds=s, warm=True)
    finally:
        shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())

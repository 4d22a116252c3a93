"""A short first call on one card for the stream body's K13 and K1 kinds
(csrc/stream_gmm.cuh): build, the SASS phase, K1 at 4, 16 and 32 rows and
K13 at 4 rows on a 4-layer Llama-2-7B of chip_smoke's build (each against
its plain version, the old body timed beside), the k13_edges and k1_edges
phases, the no-fallback cases and k1_vs_k5 — chip_smoke.py's own check
functions, without its model paths.

    python3 scripts/stream_kinds_check.py      # from the repo root, one card, ~3 minutes

Prints one JSON line per phase ({"phase", "ok", "seconds", "out"} or the
error), each kernel row as chip_smoke prints it, the card line first.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.models import llama

    if not torch.cuda.is_available():
        print("stream_kinds_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    failed = []

    def phase(name, fn):
        t = time.perf_counter()
        try:
            out = fn()
        except Exception as e:   # report every phase, then fail
            failed.append(name)
            cs.emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"[:3000],
                     "traceback": traceback.format_exc()[-3000:]})
            return None
        cs.emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t, "out": out})
        return out

    print(cs.card_line(), flush=True)
    phase("build", lambda: (_build.lib(), [ln.strip() for ln in _build.build_log.splitlines()
                                            if "registers" in ln or "spill" in ln])[1])
    phase("sass", lambda: {k: v for k, v in cs.sass_check()["stream_sass"].items()
                           if k.startswith(("K1 ", "K13"))})
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_hidden_layers=4)
    fp, _, stacked = cs.build_model(cfg, dev, cs.SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    for n in (cs.MAX_BATCH, 16, cs.MID_BATCH):
        phase(f"rawx@{n}", lambda: cs.check_rawx(stacked, dev, gen, n))
    bf16 = cs.build_bf16(fp, cfg)
    del fp
    phase("fp_matmul", lambda: cs.check_fp_matmul(bf16, dev, gen))
    del bf16
    phase("k13_edges", lambda: cs.check_k13_edges(dev))
    phase("k1_edges", lambda: cs.check_k1_edges(dev))
    phase("no_fallback", lambda: cs.check_no_fallback(dev))
    phase("k1_vs_k5", lambda: cs.k1_vs_k5(stacked, dev, gen))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Count how often K5's first call reads its salient activations before the
activation prep has written them, on one H100.

On the stacked path K5's stream kind (csrc/stream_gmm.cuh) is a
programmatic dependent of K7's row body, which lets it start once its loads
are out (up to 32 rows).  With f32 rows K5's consumer warps take the f32
salient dot straight from global memory, x_sal included, which the prep
writes.  This script runs the stacked qkv site of a 2-layer Llama-2-7B
(RMSNorm fused) on f32 rows, each trial on fresh rows and a fresh copy of
the pack, and holds each call bit for bit to the same two launches with a
synchronize between them (the prep, then K5: nothing to race).  It does so
for two libraries built side by side from the committed csrc/:

  base              as committed: the consumers run griddepcontrol.wait
                    before the f32 salient dot
  no_consumer_wait  that wait taken out (K5 as it was before)

and for three ways of holding the salient block: stored in f32 (no cast
anywhere), stored in bf16 and cast once on the first call
(PackedLinear.salient_block), and stored in bf16, cast once and then
synchronized before the call (a cast that cannot still be running).  Each
call is made on an idle card ("idle": the prep has ended before the host
launches K5) and queued behind about a millisecond of other work
("queued": torch.cuda._sleep first, so K5 is launched while the prep
waits, as behind a long kernel such as a cast of a 32-layer block).

    python3 scripts/k5_pdl_race.py [--trials N]   # from the repo root, one card

Prints the card line, then one JSON line per (library, card, rows,
block): the trials, how many differed from the synchronized pair, and the
largest difference.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = "stream_gmm.cuh"
WAIT = ("    if (a.pdl) griddep_wait();\n"
        "    sg_salient_f32<NT>(acc, a, o0, l);\n")
VARIANTS = {"base": None,
            "no_consumer_wait": [(WAIT, "    sg_salient_f32<NT>(acc, a, o0, l);\n")]}
ROWS = (8, 32, 64)
BLOCKS = ("f32_stored", "bf16_cast_once", "bf16_cast_synced")
CARD = {"idle": 0, "queued": 2_000_000}   # cycles of torch.cuda._sleep before a call


def apply_edits(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def dirs(name):
    """(csrc, build dir) of a library: the committed ones for base, else
    the committed csrc/ with the variant's edits, under the build dir."""
    from smoothquant_tpu_torch.kernels import _build

    base = (os.path.join(ROOT, "smoothquant_tpu_torch", "kernels", "csrc"), _build.BUILD_DIR)
    if VARIANTS[name] is None:
        return base
    work = os.path.join(base[1], "variants", name)
    csrc = os.path.join(work, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(base[0], csrc)
    path = os.path.join(csrc, HEADER)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(apply_edits(text, VARIANTS[name]))
    return csrc, os.path.join(work, "build")


def prebuild():
    """Build every library at once, one process each (each runs one nvcc a
    source); returns each one's (csrc, build dir), and raises with the
    output of a build that failed."""
    procs, built = [], {}
    for name in VARIANTS:
        csrc, bdir = built[name] = dirs(name)
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
                "from smoothquant_tpu_torch.kernels import _build; "
                f"_build.CSRC, _build.BUILD_DIR = {csrc!r}, {bdir!r}; _build.build()")
        procs.append((name, subprocess.Popen([sys.executable, "-c", code],
                                             stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{out[-4000:]}")
    return built


def use(name, built):
    """Load a library in place of the one the wrappers call."""
    from smoothquant_tpu_torch.kernels import _build

    _build.CSRC, _build.BUILD_DIR = built[name]
    _build._lib = None
    _build.lib()


def trials(lin, n, block, sleep, count, gen, dev):
    """(differing calls, largest |difference|) of `count` first calls of
    real_quant_linear on fresh f32 rows and a fresh copy of the pack, each
    behind `sleep` cycles of torch.cuda._sleep."""
    import torch

    from smoothquant_tpu_torch.kernels.int4_group_matmul import (
        RAWX_MAX_N, int4_group_matmul_stacked)
    from smoothquant_tpu_torch.kernels.real_linear import (
        k1_rows_operands, many_rows_operands, real_quant_linear)

    m, c = lin.meta, lin.meta.in_features
    norm_row = (torch.rand((lin.w_qt.shape[0], c), generator=gen, device=dev) + 0.5)
    norm = (norm_row.to(torch.bfloat16).float(), 1e-5, "rms")
    prep = k1_rows_operands if n <= RAWX_MAX_N else many_rows_operands
    stored = torch.float32 if block == "f32_stored" else torch.bfloat16
    bad, worst = 0, 0.0
    for _ in range(count):
        p = dataclasses.replace(lin, w_sal_t=lin.w_sal_t.to(stored))
        x = torch.randn((n, c), generator=gen, device=dev) * 3
        if block == "bf16_cast_synced":
            p.salient_block(torch.float32)
        torch.cuda.synchronize()
        if sleep:
            torch.cuda._sleep(sleep)
        got = real_quant_linear(p, x, layer_idx=1, norm=norm)
        torch.cuda.synchronize()
        x_q, x_s, x_sal, pre_laid = prep(p, x, 1, norm)
        torch.cuda.synchronize()
        ref = int4_group_matmul_stacked(1, x_q, x_s, p.w_qt, p.w_scales_t, x_sal,
                                        p.salient_block(torch.float32),
                                        group_size=m.group_size, out_dtype=got.dtype,
                                        pre_laid=pre_laid)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            bad += 1
            worst = max(worst, float((got - ref).abs().max()))
    return bad, worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from smoothquant_tpu_torch.models import llama

    print(cs.card_line(), flush=True)
    built = prebuild()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_hidden_layers=2)
    _, _, stacked = cs.build_model(cfg, dev, cs.SEED)
    lin = stacked["layers"]["stacked"]["self_attn"]["qkv_proj"]
    for name in VARIANTS:
        use(name, built)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        for card, sleep in CARD.items():
            for n in ROWS:
                for block in BLOCKS:
                    bad, worst = trials(lin, n, block, sleep, args.trials, gen, dev)
                    print(json.dumps({"library": name, "card": card, "rows": n,
                                      "block": block, "trials": args.trials, "differ": bad,
                                      "max_abs_diff": worst}), flush=True)


if __name__ == "__main__":
    main()

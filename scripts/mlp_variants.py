"""Time the pieces and the designs not taken of K14's stream body
(csrc/mlp_fused.cu: gate_up on stream_gmm.cuh's stream_swiglu_kernel, down on
K5's stream kind) and of K16's row body (csrc/norm_quant.cu) against the
committed ones, on one H100.  Each source variant is the committed csrc/ with
a few edits, and only mlp_fused.cu and norm_quant.cu (the two sources that
hold the entries) are built, all variants' nvcc processes at once, into a
library of their own that the wrappers are pointed at while it is timed (the
other entry points stay the committed build's).  Host variants time the
committed build with another launch option or host rule.

    python3 scripts/mlp_variants.py [--checks] [names ...]   # from the repo root, one card

--checks first runs chip_smoke's SASS phase and the k14_edges / k16_edges
phases (a new kernel's short first call).

Ablations ("abl_*") take a piece of the work out, so their outputs are
wrong by design and not checked: their readings say what that piece costs.
K14's cases (Llama-2-7B's serving pack: gate_up 4096 → 2 × 11008, down
11008 → 4096, W4A4 g64, 5 % salient, bf16 scales and x, the RMSNorm fused;
4 and 8 rows, each call on the next of 4 layers of random weights, cold in
L2):
  abl_loads_only    both launches' rings alone: no quantize, no products,
                    no salient pre-pass, no epilogue
  abl_no_epilogue   gate_up's epilogue (SwiGLU, down's group quantize, the
                    codes' stores) taken out
  abl_no_quantize   gate_up's quantizer warps report each stage without
                    making its codes
  gate_up_only      launch 1 alone (sq_mlp_stream's down launch taken out)
  down_only         launch 2 alone, not chained (its gate_up launch taken
                    out: down reads codes no launch wrote)
  unchained         down launched after gate_up ends (pdl = 0)
  k14_split2, k14_split4  gate_up's tiles split over 2 / 4 cluster ranks
                    (host: mlp_fused.gate_up_split; its rule gives one, the
                    172 tiles outnumbering the SMs)
beside them each reading has the cooperative body (coop) and the unfused
route (K1 gate_up, SiLU·up in torch, K1 down; unfused).  K16's cases
(OPT-1.3B's LayerNorm, C = 2048, f32 x, bf16 γ and β, 4 × 512 and 4 rows):
  k16_r1, k16_r2    one and two rows a block (host: norm_quant.k16_plan)
  k16_w8            eight warps a row, one row a block
  k16_wmin          the least warps a row at every row count, γ and β
                    loaded after the sums (the plan before its few-row rule)
  k16_no_prefetch   the plan's warps and rows, γ and β loaded after the sums
  k16_block         the one-block-a-row body (body="block")
beside F.layer_norm (no quantize).  Each reading is the device ms of one
call (chip_smoke.device_ms), taken base, variants, variants reversed, base.
Prints one JSON line per variant and case, the card line first.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SG = "stream_gmm.cuh"
MF = "mlp_fused.cu"
SOURCES = (MF, "norm_quant.cu")
# sq_mlp_stream's two launches, and the down launch's programmatic dependence
LAUNCH_1 = ("  {  // launch 1: gate_up, SiLU·up and down's codes\n",
            "  if (0) {  // launch 1: gate_up, SiLU·up and down's codes\n")
LAUNCH_2 = ("  {  // launch 2: down over the codes, behind launch 1\n",
            "  if (0) {  // launch 2: down over the codes, behind launch 1\n")
UNCHAIN = ("s_bf16, 1, /*pdl=*/1};", "s_bf16, 1, /*pdl=*/0};")

VARIANTS = {
    "abl_loads_only": [
        # gate_up: no salient tiles, no codes, no products, no epilogue
        (SG, "  sr_prepass<GS, 1>(a, smem, t0, t1, tid);\n  const SgLane l = sg_lane_halves",
         "  const SgLane l = sg_lane_halves"),
        (SG, "    if (t >= a.n_sal) sr_quantize_stage<GS, NT>",
         "    if (t < 0) sr_quantize_stage<GS, NT>"),
        (SG, "    if (t < a.n_sal) {\n      sg_salient_bf16<NT, 32>(acc, s, smem_u32(smem + "
             "Geo::OFF_SAL",
         "    if (t >= 0) {\n    } else if (t < a.n_sal) {\n      sg_salient_bf16<NT, 32>(acc, s, "
         "smem_u32(smem + Geo::OFF_SAL"),
        (SG, "  sw_epilogue<GS>(part, a, w, tile, rank, lg, cs, tid);\n", ""),
        # down: the consumers wait for each stage and free it
        (SG, "    if (t < a.n_sal) {\n      sg_salient_bf16<NT, Geo::KSAL>",
         "    if (t >= 0) {\n    } else if (t < a.n_sal) {\n      sg_salient_bf16<NT, Geo::KSAL>")],
    "abl_no_epilogue": [(SG, "  sw_epilogue<GS>(part, a, w, tile, rank, lg, cs, tid);\n", "")],
    "abl_no_quantize": [(SG, "    if (t >= a.n_sal) sr_quantize_stage<GS, NT>",
                         "    if (t < 0) sr_quantize_stage<GS, NT>")],
    "gate_up_only": [(MF, *LAUNCH_2)],
    "down_only": [(MF, *LAUNCH_1), (MF, *UNCHAIN)],
    "unchained": [(MF, *UNCHAIN)],
}
# variants that change a launch option or a host rule on the committed build
def _wmin(n, c, plan):
    w = 1
    while 32 * w * 4 * 8 < c:
        w *= 2
    return w, max(1, min(8 // w, n // 264)), False


# K16's plan variants: (n, c, the committed plan) → (warps a row, rows a block, prefetch)
HOST = {"k14_split2": {"k14_split": 2}, "k14_split4": {"k14_split": 4},
        "k16_r1": {"k16": lambda n, c, p: (p[0], 1, p[2])},
        "k16_r2": {"k16": lambda n, c, p: (p[0], min(2, 8 // p[0]), p[2])},
        "k16_w8": {"k16": lambda n, c, p: (8, 1, p[2])},
        "k16_wmin": {"k16": _wmin},
        "k16_no_prefetch": {"k16": lambda n, c, p: (p[0], p[1], False)},
        "k16_block": {"body": "block"}}
K16_VARIANTS = {"k16_r1", "k16_r2", "k16_w8", "k16_wmin", "k16_no_prefetch", "k16_block"}
ABLATIONS = {"abl_loads_only", "abl_no_epilogue", "abl_no_quantize", "gate_up_only",
             "down_only"}


def apply_edits(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variant_sources(name, csrc):
    """{file: edited text} of a source variant, from the sources in csrc."""
    out = {}
    for f, old, new in VARIANTS[name]:
        if f not in out:
            with open(os.path.join(csrc, f)) as fh:
                out[f] = fh.read()
        out[f] = apply_edits(out[f], [(old, new)])
    return out


class _Lib:
    """One variant's build: its own K14 and K16 entry points with their
    ctypes signatures, every other entry point the committed build's."""

    def __init__(self, path, base):
        from smoothquant_tpu_torch.kernels import _build

        self._base = base
        handle = ctypes.CDLL(path)
        for fn in ("sq_mlp_stream", "sq_mlp_fused", "sq_mlp_fused_grid_blocks",
                   "sq_mlp_fused_workspace_bytes", "sq_norm_quant", "sq_norm_quant_rows"):
            f = getattr(handle, fn)
            f.argtypes, f.restype = _build._SIGNATURES[fn]
            setattr(self, fn, f)

    def __getattr__(self, name):
        return getattr(self._base, name)


def build_all(names, base):
    """Build every source variant's two entry sources at once; {name: (_Lib
    or None, error)}."""
    from smoothquant_tpu_torch.kernels import _build

    root = os.path.join(_build.BUILD_DIR, "mlp_variants")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        csrc = os.path.join(root, name, "csrc")
        shutil.copytree(_build.CSRC, csrc)
        for f, text in variant_sources(name, _build.CSRC).items():
            with open(os.path.join(csrc, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(root, name, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
               *(os.path.join(csrc, f) for f in SOURCES), "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        out[name] = (_Lib(lib, base), None) if p.returncode == 0 else (None, log[-2000:])
    return out


def k14_cases(dev):
    """(case, fn(options), plain output): K14 at the serving pack's gate_up
    and down, 4 and 8 rows, and its yardsticks."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k1
    from smoothquant_tpu_torch.kernels import mlp_fused as k14
    from smoothquant_tpu_torch.models.llama import LlamaConfig
    from smoothquant_tpu_torch.utils import roofline

    cfg = LlamaConfig.llama2_7b()
    shapes = roofline.llama_pack_shapes(cfg)
    c, o1, kk1, k_s1 = shapes["gate_up"]
    inter, o2, kk2, k_s2 = shapes["down"]
    n_sal1, n_sal2 = int(0.05 * c), int(0.05 * inter)
    gs, n_l = 64, 4
    gen = torch.Generator(device=dev).manual_seed(0)
    pack = lambda kk, k_s, o: (
        torch.randint(-128, 128, (n_l, kk // 2, o), generator=gen, device=dev,
                      dtype=torch.int8),
        (torch.rand((n_l, kk // gs, o), generator=gen, device=dev) * 0.02 + 0.001
         ).to(torch.bfloat16),
        (torch.rand((n_l, k_s, o), generator=gen, device=dev) * 0.2 - 0.1).to(torch.bfloat16))
    gu, dn = pack(kk1, k_s1, o1), pack(kk2, k_s2, o2)
    norm = (torch.rand((n_l, c), generator=gen, device=dev) + 0.5).to(torch.bfloat16).float()
    kw = dict(group_size=gs, act_bits=4, n_sal1=n_sal1, n_sal2=n_sal2, gu_out_true=2 * inter,
              dn_out_true=o2, eps=1e-5)
    out = []
    for n in (4, 8):
        x = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
        args = lambda i, x=x: (i % n_l, x, norm[i % n_l], *gu, *dn)

        def fused(i, opts, args=args):
            return k14.mlp_swiglu_fused_stacked(*args(i), **kw, **opts)

        def unfused(i, opts, x=x):
            y = k1.int4_group_matmul_stacked_rawx(
                i % n_l, x, norm, *gu, eps=1e-5, num_salient=n_sal1, norm_kind="rms",
                group_size=gs, act_bits=4)
            h = torch.nn.functional.silu(y[:, :inter]) * y[:, inter:2 * inter]
            return k1.int4_group_matmul_stacked_rawx(
                i % n_l, h, None, *dn, num_salient=n_sal2, norm_kind=None, group_size=gs,
                act_bits=4)

        ref = k14.mlp_swiglu_fused_stacked_plain(*args(1), **kw)
        out += [(f"mlp@{n}", fused, ref),
                (f"coop@{n}", lambda i, opts, f=fused: f(i, {"body": "coop"}), None),
                (f"unfused@{n}", unfused, None)]
    return out


def k16_cases(dev):
    """(case, fn(options), plain output): K16 at the int8 OPT's LayerNorm
    (C = 2048, f32 x) over 4 × 512 and 4 rows, and F.layer_norm."""
    import torch
    import torch.nn.functional as F

    from smoothquant_tpu_torch.kernels import norm_quant as k16

    gen = torch.Generator(device=dev).manual_seed(1)
    c, out = 2048, []
    # the int8 OPT's LayerNorm rows are bf16 (its weights'); F.layer_norm takes f32 copies
    gamma = [(torch.rand(c, generator=gen, device=dev) + 0.5).to(torch.bfloat16)
             for _ in range(4)]
    beta = [(torch.randn(c, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
            for _ in range(4)]
    g32, b32 = [g.float() for g in gamma], [b.float() for b in beta]
    for n in (2048, 4):
        xs = [torch.randn((n, c), generator=gen, device=dev) * 2 + 0.3 for _ in range(4)]

        def call(i, opts, xs=xs):
            return k16.norm_quant(xs[i % 4], gamma[i % 4], beta[i % 4], 4.0 / 127, eps=1e-5,
                                  **opts)

        out += [(f"ln@{n}", call, k16.norm_quant_plain(xs[1], gamma[1], beta[1], 4.0 / 127,
                                                       eps=1e-5)),
                (f"layer_norm@{n}", lambda i, opts, xs=xs: F.layer_norm(
                    xs[i % 4], (c,), g32[i % 4], b32[i % 4], 1e-5), None)]
    return out


def _held(got, ref, case):
    """The kernel's output against the plain version: K14 within 1e-2 of the
    largest magnitude, K16's codes identical or one off."""
    if case.startswith("ln@"):
        return int((got.int() - ref.int()).abs().max()) <= 1
    return bool((got.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max())


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.kernels import mlp_fused as k14
    from smoothquant_tpu_torch.kernels import norm_quant as k16

    if not torch.cuda.is_available():
        print("mlp_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    checks = "--checks" in argv
    names = [a for a in argv if a != "--checks"] or list(VARIANTS) + list(HOST)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    if checks:   # the SASS phase reads ptxas' notes of a build made in this process
        cached = _build.build()
        if not _build.build_log:
            os.remove(cached)
            _build.build()
    base = _build.lib()
    if checks:
        print(json.dumps({"phase": "sass", **cs.sass_check()}), flush=True)
        print(json.dumps({"phase": "k14_edges", **cs.check_k14_edges(dev)}), flush=True)
        print(json.dumps({"phase": "k16_edges", **cs.check_k16_edges(dev)}), flush=True)
    built = build_all([n for n in names if n in VARIANTS], base)
    for name, (lib, err) in built.items():
        print(json.dumps({"variant": name, "built": lib is not None,
                          **({"error": err} if err else {})}), flush=True)
    built.update({n: (base, None) for n in names if n in HOST})
    cases = k14_cases(dev) + k16_cases(dev)
    ok = [n for n in names if built[n][0] is not None]
    readings = {}
    plan, split = k16.k16_plan, k14.gate_up_split
    try:
        for name in ["base"] + ok + ok[::-1] + ["base"]:
            _build._lib = base if name == "base" else built[name][0]
            opts = dict(HOST.get(name, {}))
            rule = opts.pop("k16", None)
            if rule is not None:
                k16.k16_plan = lambda n, c, rule=rule: rule(n, c, plan(n, c))
            ranks = opts.pop("k14_split", None)
            if ranks is not None:
                k14.gate_up_split = lambda *args, ranks=ranks: ranks
            for case, fn, ref in cases:
                is_k16 = case.startswith(("ln@", "layer_norm@"))
                if name != "base" and (is_k16 != (name in K16_VARIANTS)
                                       or not case.startswith(("mlp@", "ln@"))):
                    continue
                r = readings.setdefault((name, case), {"ms": []})
                try:
                    if ref is not None and name not in ABLATIONS and "held" not in r:
                        got = fn(1, opts)
                        torch.cuda.synchronize()
                        r["held"] = _held(got, ref, case)
                    r["ms"].append(cs.device_ms(lambda i: fn(i, opts), 8)
                                   if r.get("held", True) else None)
                except (RuntimeError, ValueError) as e:
                    r["error"] = str(e)[:200]
            k16.k16_plan = plan
            k14.gate_up_split = split
    finally:
        _build._lib = base
        k16.k16_plan = plan
        k14.gate_up_split = split
    for (name, case), r in readings.items():
        print(json.dumps({"variant": name, "case": case, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

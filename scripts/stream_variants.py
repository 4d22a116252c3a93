"""Time variants of the weight-streaming body K8 and K5 share
(csrc/stream_gmm.cuh) against the committed one, on one H100: each variant
is the committed csrc/ with a few edits to stream_gmm.cuh, built into its
own library beside the committed one (as scripts/wg_variants.py does for
K6 and K9).

    python3 scripts/stream_variants.py [names ...]   # from the repo root, one card
    python3 scripts/stream_variants.py --splits      # the committed body at each split

Variants are of two kinds.  Ablations ("abl_*") take a piece of the work
out, so the output is wrong by design and is not checked: their readings
say what that piece costs at each shape.  Designs are held against the
plain version at chip_smoke's tolerance (1e-2 of the largest output in
bf16) and timed only where they hold.

Variants of K8's and K5's kind (timed on their cases): abl_no_scale,
abl_no_mma, abl_no_transpose (a piece of the consumers' math replaced by one
cheap operation), abl_stream_only (the consumers wait for each stage and
free it), abl_compute_only (nothing loaded or waited for); stages6 (a
6-slot ring); l2_128 / l2_none (the weight's L2 fills); rank_major,
rank_major_l2_128 (grid (tiles, ranks), a cluster along y).  (The
two-consumer-warpgroup designs, measured and not taken, edited the
epilogue every kind now shares; commit ecb0c81 holds them.)

Variants of K13's bf16 kind (k13_*, timed on K13's cases): k13_loads_only
(the consumers wait for each stage and free it), k13_math_only (nothing
loaded or waited for), k13_stages6 / k13_stages8 (deeper rings),
k13_l2_128 (the weight's L2 fills of 128 bytes).  (32-row stages, once a
variant here, are the rule's pick at three of the four sites:
stream_gmm.k13_kb.)  Of K1's raw-x kind (k1_*, on K1's cases): k1_loads_only
(no activations made, no math), k1_math_only (the activations and the
math, nothing loaded or waited for), k1_no_prepass (no salient tiles
before the first stage), k1_no_quantize (the quantizer warps wait and
report, quantizing nothing: the products on codes left as they lie),
k1_no_math (the activations made, no products), k1_no_div / k1_no_salient
(a piece of the activations taken out or cheapened), k1_fast_code (the
codes from y·(1/scale) with no tie check: a design, held to the plain
version like any).  Every K1 ablation keeps its waits paired: the
consumers wait for each stage's codes wherever the quantizer warps run (a
consumer that ran ahead lets a slot be refilled under its quantizer, which
then waits on a past phase and hangs).  K1's cases also time its pre-pass
as a separate launch (the K5 route: K7b / K7a + K5's stream body on the
same codes) beside the in-kernel one.

Each reading is the device ms of one call (chip_smoke.device_ms), each call
on the next of 8 weights (cold in L2, as a decode step finds them), taken
base, variants, variants reversed, base.  Prints one JSON line per variant
and shape, the card line first; with SASS_DIR set, also writes the SASS of
the base build's stream kernels there (cuobjdump).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = "stream_gmm.cuh"

_SCALE = """        const float v = __fsub_rn(__int_as_float(p[mt][nt][e]), WG_MAGIC);
        acc[mt][nt][e] = __fmaf_rn(__fmul_rn(v, (e & 1) ? s1 : s0), w[2 * mt + (e >> 1)],
                                   acc[mt][nt][e]);"""
_MMA32 = """  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]),
        "r"(c[2]), "r"(c[3]));"""
_QUAD = """  c[0] = __byte_perm(t0, t2, l.sel0);
  c[1] = __byte_perm(t0, t2, l.sel1);
  c[2] = __byte_perm(t1, t3, l.sel0);
  c[3] = __byte_perm(t1, t3, l.sel1);"""

_RANK_MAJOR = [
    ("  rank = blockIdx.x & ((1 << lg) - 1);\n  o0 = (blockIdx.x >> lg) * SG_BO;",
     "  rank = blockIdx.y;\n  o0 = blockIdx.x * SG_BO;"),
    ("  cfg.gridDim = dim3((O + SG_BO - 1) / SG_BO * n_split);",
     "  cfg.gridDim = dim3((O + SG_BO - 1) / SG_BO, n_split);"),
    ("  attr[0].val.clusterDim.x = n_split;\n  attr[0].val.clusterDim.y = 1;",
     "  attr[0].val.clusterDim.x = 1;\n  attr[0].val.clusterDim.y = n_split;")]

_K13_MATH = ("#pragma unroll\n    for (int ks = 0; ks < KB / 16; ++ks) {\n"
             "      int a0[4], a1[4], b[1][2];")
_K1_MATH = ("    if (t < a.n_sal) {\n      sg_salient_bf16<NT, 32>(acc, s, smem_u32(smem + Geo::OFF_SAL")
_K1_PREPASS = "  sr_prepass<GS, NT>(a, smem, t0, t1, tid);\n"
_K1_READY = "    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (2 * STAGES + slot)), (i / STAGES) & 1);\n"
_K1_QUANTIZE = ("    if (t >= a.n_sal) sr_quantize_stage<GS, NT>(a, smem + slot * Geo::SLOT, "
                "t - a.n_sal, rr, lane);\n")
_K1_QUANTIZER_LOOP = ("  for (int t = t0 + qw; t < t1; t += 3) {\n    const int i = t - t0, slot = i % STAGES;\n"
                      "    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / STAGES) & 1);\n"
                      "    if (t >= a.n_sal) sr_quantize_stage")

VARIANTS = {
    # what the per-group scaling costs: one add in its place
    "abl_no_scale": [(_SCALE, "        acc[mt][nt][e] += __int_as_float(p[mt][nt][e]);")],
    # what the int8 mma costs: an integer add of its operands in its place
    "abl_no_mma": [(_MMA32, "#pragma unroll\n  for (int e = 0; e < 4; ++e) d[e] = c[e] + (a[e] ^ b0) + b1;")],
    # what the byte transpose costs: the row words as they are
    "abl_no_transpose": [(_QUAD, "  c[0] = v[0] ^ l.sel0;\n  c[1] = v[1];\n  c[2] = v[2];\n  c[3] = v[3];")],
    # the ring alone: the consumers wait for each stage and free it, no math
    "abl_stream_only": [("    if (t < a.n_sal) {\n      sg_salient_bf16<NT, Geo::KSAL>",
                         "    if (t >= 0) {\n    } else if (t < a.n_sal) {\n"
                         "      sg_salient_bf16<NT, Geo::KSAL>")],
    # the math alone: nothing is loaded and nothing waited for
    "abl_compute_only": [
        ("    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SG_STAGES) & 1);\n"
         "    const float* sx", "    const float* sx"),
        ("    if (warp == 4) sg_produce<NIB, GS, NT, S>(a, m, smem, t0, t1, o0, tid & 31);\n",
         "")],
    # a deeper ring: six slots
    "stages6": [("constexpr int SG_STAGES = 4;", "constexpr int SG_STAGES = 6;")],
    # the weight's L2 fills: 128 bytes (the box's row) or none, not 256
    "l2_128": [("SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                "SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
    "l2_none": [("SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                 "SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    # grid (tiles, ranks), a cluster along y: the blocks of one K range
    # launch side by side
    "rank_major": _RANK_MAJOR,
    # K13: the ring alone (no ldmatrix, no mma); the math alone
    "k13_loads_only": [(_K13_MATH, _K13_MATH.replace("ks < KB / 16", "ks < 0"))],
    "k13_math_only": [
        ("    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SB_STAGES) & 1);\n", ""),
        ("    if (warp == 4 && lane == 0) {\n      tma_prefetch(m.w);\n      tma_prefetch(m.x);\n"
         "      for (int t = t0; t < t1; ++t) {\n        const int i = t - t0, slot = i % SB_STAGES;",
         "    if (warp == 99) {\n      tma_prefetch(m.w);\n      tma_prefetch(m.x);\n"
         "      for (int t = t0; t < t1; ++t) {\n        const int i = t - t0, slot = i % SB_STAGES;")],
    "k13_stages6": [("constexpr int SB_STAGES = 4;", "constexpr int SB_STAGES = 6;")],
    "k13_stages8": [("constexpr int SB_STAGES = 4;", "constexpr int SB_STAGES = 8;")],
    # the weight's L2 fills for K13 (its map shares SG_W_PROMO)
    "k13_l2_128": [("SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                    "SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
    # K1: the ring alone; the activations and math alone; the pieces of the activations
    # (the quantizer warps stop at once and the consumers wait for no codes:
    # every ablation keeps the consumers waiting for each stage's codes
    # wherever the quantizers run, or the quantizers' waits could fall two
    # phases behind a slot's barrier)
    "k1_loads_only": [(_K1_PREPASS, ""), (_K1_QUANTIZER_LOOP, _K1_QUANTIZER_LOOP.replace(
                          "t < t1; t += 3", "t < t0; t += 3")),
                      (_K1_READY + "    if (t < a.n_sal) {\n      sg_salient_bf16<NT, 32>(acc, s, "
                                   "smem_u32(smem + Geo::OFF_SAL",
                       "    if (t >= 0) {\n    } else if (t < a.n_sal) {\n"
                       "      sg_salient_bf16<NT, 32>(acc, s, smem_u32(smem + Geo::OFF_SAL")],
    # the code byte straight from y·(1/scale): no tie check, no division
    "k1_fast_code": [("  if (fabsf(fabsf(frac) - 0.5f) <= fmaxf(fabsf(d), 1.0f) * 9.5367431640625e-7f)\n"
                      "    return __float_as_uint(__fadd_rn(__fdiv_rn(y, scale), WG_MAGIC)) & 0xFFu;\n",
                      "")],
    "k1_math_only": [   # no barrier waited for anywhere: the warps run free over garbage
        ("    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / STAGES) & 1);\n"
         "    // every stage's", "    // every stage's"),
        ("    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (2 * STAGES + slot)), (i / STAGES) & 1);\n"
         "    if (t < a.n_sal) {", "    if (t < a.n_sal) {"),
        ("    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / STAGES) & 1);\n"
         "    if (t >= a.n_sal) sr_quantize_stage", "    if (t >= a.n_sal) sr_quantize_stage"),
        ("    if (lane == 0) sg_arrive(smem_u32(smem + Geo::OFF_BAR + 8 * (2 * STAGES + slot)));\n  }\n}",
         "  }\n}"),
        ("    else if (lane == 0) sr_produce<GS, NT, S, false>",
         "    else if (lane == 99) sr_produce<GS, NT, S, false>")],
    "k1_no_prepass": [(_K1_PREPASS, "")],
    "k1_no_quantize": [(_K1_QUANTIZE, "")],
    "k1_no_math": [("        sg_group_mma<true, GS, NT, GS, WROW>(p, s, 0, h, smem_u32(s + Geo::OFF_Q + h "
                    "* Geo::CT),\n                                             xo, l);\n        "
                    "sg_scale<NT, S>(acc, p, sx + h * Geo::N_BOX, sw + h * SG_BO, 0.0625f, l);", "")],
    "k1_no_div": [("__fdiv_rn(y, scale)", "__fmul_rn(y, scale)")],
    "k1_no_salient": [("  const int ns = (t1 < a.n_sal ? t1 : a.n_sal) - t0;",
                       "  const int ns = 0;")],
    "rank_major_l2_128": _RANK_MAJOR + [("SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                                         "SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
}


def apply_edits(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


# variants whose output is wrong by design: timed, not held to the plain version
ABLATIONS = {"k13_loads_only", "k13_math_only", "k1_loads_only", "k1_math_only",
             "k1_no_prepass", "k1_no_quantize", "k1_no_math", "k1_no_div", "k1_no_salient"}


def variant_dirs(name, edits):
    """The variant's sources (the committed csrc/ with its edits to
    stream_gmm.cuh) and build directory, under the build directory."""
    from smoothquant_tpu_torch.kernels import _build

    work = os.path.join(_build.BUILD_DIR, "variants", name)
    csrc = os.path.join(work, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    path = os.path.join(csrc, HEADER)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(apply_edits(text, edits))
    return csrc, os.path.join(work, "build")


def prebuild(names, at_once=4):
    """Build the variants' libraries, `at_once` processes at a time (each
    runs one nvcc a source), so build() only loads them."""
    for i in range(0, len(names), at_once):
        procs = []
        for name in names[i:i + at_once]:
            csrc, bdir = variant_dirs(name, VARIANTS[name])
            code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
                    "from smoothquant_tpu_torch.kernels import _build; "
                    f"_build.CSRC, _build.BUILD_DIR = {csrc!r}, {bdir!r}; _build.build()")
            procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for p in procs:
            p.communicate()


def build(name):
    """The library of one variant (prebuild's); returns (handle, error text or None)."""
    from smoothquant_tpu_torch.kernels import _build

    base_csrc, base_dir = _build.CSRC, _build.BUILD_DIR
    if name != "base":
        work = os.path.join(base_dir, "variants", name)
        _build.CSRC, _build.BUILD_DIR = os.path.join(work, "csrc"), os.path.join(work, "build")
    _build._lib = None
    try:
        return _build.lib(), None
    except RuntimeError as e:
        return None, str(e)[-2000:]
    finally:
        _build.CSRC, _build.BUILD_DIR = base_csrc, base_dir


def kind_of(variant: str) -> str:
    """The cases a variant is timed on: K13's, K1's, or K5's and K8's."""
    return "k13" if variant.startswith("k13_") else "k1" if variant.startswith("k1_") else "k5k8"


def cases(dev):
    """(name, kind, fn(i), plain output of fn(0)) at the main paths' widths:
    K5 at Llama-2-7B's qkv and gate_up at 64 rows (K7a's layout, bf16
    scales), K8 at the quick start's gate_proj at 4 and 64 rows (f32
    scales); K13 at the bf16 tree's four sites and K1 at the serving pack's
    four sites (each in its mode) at 4 rows, on an 8-layer Llama-2-7B of
    chip_smoke's build, and beside each K1 site the K5 route on the same
    codes (real_linear.k1_rows_operands, then K5's stream body: the pre-pass
    as a launch of its own)."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import fp_matmul as k13
    from smoothquant_tpu_torch.kernels import int4_group_matmul as k5
    from smoothquant_tpu_torch.kernels import int_group_matmul as k8
    from smoothquant_tpu_torch.kernels.act_prep import quantize_acts_grouped_t
    from smoothquant_tpu_torch.kernels.real_linear import _salient_gather, k1_rows_operands
    from smoothquant_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=gen, device=dev) * (hi - lo) + lo

    def codes(*s, q=7):
        return torch.randint(-q, q + 1, s, generator=gen, device=dev, dtype=torch.int8)

    out = []
    for name, kk, ks, o in (("k5_qkv@64", 3840, 256, 12288), ("k5_gate_up@64", 3840, 256, 22016)):
        wp = torch.randint(-128, 128, (8, kk // 2, o), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = rnd(8, kk // 64, o, lo=0.01, hi=0.2).to(torch.bfloat16)
        wsal = rnd(8, ks, o).to(torch.bfloat16)
        xq, xs = quantize_acts_grouped_t(rnd(64, kk), group_size=64, act_bits=4)
        xsal = rnd(64, ks).to(torch.bfloat16)
        kw = dict(group_size=64, out_dtype=torch.bfloat16, pre_laid=64)
        fn = (lambda i, a=(xq, xs, wp, ws, xsal, wsal), kw=kw:
              k5.int4_group_matmul_stacked(i % 8, *a, **kw))
        out.append((name, "k5k8", fn, k5.int4_group_matmul_stacked_plain(
            0, xq, xs, wp, ws, xsal, wsal, **kw)))
    kk, ks, o = 3904, 256, 11008
    ws_ = [(codes(kk, o), rnd(kk // 64, o, lo=0.01, hi=0.2), rnd(ks, o).to(torch.bfloat16))
           for _ in range(8)]
    for n in (4, 64):
        xq, xs, xsal = codes(n, kk), rnd(n, kk // 64, lo=0.01, hi=0.2), rnd(n, ks).to(
            torch.bfloat16)
        kw = dict(group_size=64, out_dtype=torch.bfloat16)
        fn = (lambda i, x=(xq, xs, xsal), kw=kw:
              k8.int_group_matmul(x[0], x[1], ws_[i % 8][0], ws_[i % 8][1], x[2],
                                  ws_[i % 8][2], **kw))
        out.append((f"k8_gate@{n}", "k5k8", fn, k8.int_group_matmul_plain(
            xq, xs, ws_[0][0], ws_[0][1], xsal, ws_[0][2], **kw)))
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), num_hidden_layers=8)
    fp, _, stacked = cs.build_model(cfg, dev, cs.SEED)
    bf16 = cs.build_bf16(fp, cfg)
    del fp
    st = bf16["layers"]["stacked"]
    for site, w in (("qkv", st["self_attn"]["qkv_proj"]["weight_t"]),
                    ("o", st["self_attn"]["o_proj"]["weight_t"]),
                    ("gate_up", st["mlp"]["gate_up_proj"]["weight_t"]),
                    ("down", st["mlp"]["down_proj"]["weight_t"])):
        x = rnd(4, w.shape[1]).to(torch.bfloat16)
        out.append((f"k13_{site}@4", "k13", lambda i, x=x, w=w: k13.fp_matmul_stacked(i % 8, x, w),
                    k13.fp_matmul_stacked_plain(0, x, w)))
    for site, lin, mode in cs._sites(stacked["layers"]["stacked"]):
        m = lin.meta
        x = rnd(4, m.in_features).to(torch.bfloat16)
        norm = None
        if mode == "rms":
            norm = (rnd(8, m.in_features, lo=0.5, hi=1.5).to(torch.bfloat16).float(), 1e-5, "rms")
        w_sal = lin.w_sal_t.to(torch.bfloat16)
        kw = dict(group_size=m.group_size, act_bits=m.act_bits, num_salient=m.num_salient,
                  out_dtype=torch.bfloat16)

        x_sal = [_salient_gather(lin, x, lin.perm[li]) for li in range(8)]   # as the path's

        def k1_call(i, lin=lin, x=x, norm=norm, mode=mode, w_sal=w_sal, kw=kw, x_sal=x_sal):
            li = i % 8
            if mode == "mask":
                return k5.int4_group_matmul_stacked_rawx(
                    li, x, lin.ns_mask, lin.w_qt, lin.w_scales_t, w_sal, x_sal[li],
                    norm_kind="mask", **kw)
            return k5.int4_group_matmul_stacked_rawx(
                li, x, norm[0] if norm else None, lin.w_qt, lin.w_scales_t, w_sal, eps=1e-5,
                norm_kind="rms" if norm else None, **kw)

        def route(i, lin=lin, x=x, norm=norm, w_sal=w_sal):
            x_q, x_s, x_sal, pre = k1_rows_operands(lin, x, i % 8, norm)
            return k5.int4_group_matmul_stacked(
                i % 8, x_q, x_s, lin.w_qt, lin.w_scales_t, x_sal, w_sal,
                group_size=lin.meta.group_size, out_dtype=torch.bfloat16, pre_laid=pre)

        ref = route(0)
        out.append((f"k1_{site}@4", "k1", k1_call, ref))
        out.append((f"k1route_{site}@4", "k1", route, ref))
    return out


def dump_sass(lib_path, out_dir):
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    os.makedirs(out_dir, exist_ok=True)
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        m = re.search(r"stream_gmm_kernelILb(\d)ELi(\d+)ELi(\d+)", name)
        if m:
            with open(os.path.join(out_dir, f"stream_{'k5' if m.group(1) == '1' else 'k8'}"
                                            f"_gs{m.group(2)}_nt{m.group(3)}.sass"), "w") as f:
                f.write(fn)
        m = re.search(r"stream_rawx_kernelILi64ELi1E13__nv_bfloat16", name)
        if m or re.search(r"stream_bf16_kernelILi(32|64)E", name):
            tag = "k1_gs64_nt1_bf16" if m else "k13_kb" + re.search(r"ILi(\d+)E", name).group(1)
            with open(os.path.join(out_dir, f"stream_{tag}.sass"), "w") as f:
                f.write(fn)


def splits(dev) -> None:
    """The committed bodies at every cluster split of SPLITS for each case
    (stream_gmm.split patched to return it; K1's k1_split takes it from
    there), beside the split it plans."""
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import stream_gmm

    planned = stream_gmm.split
    for case, kind, fn, _ in cases(dev):
        if case.startswith("k1route_"):
            continue
        out = {}
        for c in stream_gmm.SPLITS:
            stream_gmm.split = lambda o, stages, c=c: c
            try:
                out[c] = cs.device_ms(fn, 16)
            except (RuntimeError, ValueError) as e:
                out[c] = str(e)[:80]
        stream_gmm.split = planned
        seen = []
        stream_gmm.split = lambda o, stages: seen.append(planned(o, stages)) or seen[-1]
        fn(0)
        stream_gmm.split = planned
        print(json.dumps({"case": case, "planned": seen[-1], "ms_by_split": out}), flush=True)


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("stream_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    if argv == ["--splits"]:
        splits(dev)
        return 0
    chosen = [n for n in VARIANTS if not argv or n in argv]
    prebuild(chosen)
    libs = {}
    for name in ["base"] + chosen:
        lib, err = build(name)
        libs[name] = lib
        print(json.dumps({"variant": name, "built": lib is not None,
                          **({"error": err} if err else {})}), flush=True)
    if os.environ.get("SASS_DIR"):
        dump_sass(_build.build(), os.environ["SASS_DIR"])
    all_cases = cases(dev)
    names = [n for n in chosen if libs[n] is not None]
    kinds = {kind_of(n) for n in names} or {"k5k8", "k13", "k1"}
    readings = {}
    for name in ["base"] + names + names[::-1] + ["base"]:
        _build._lib = libs[name]
        for case, kind, fn, ref in all_cases:
            if kind not in kinds or (name != "base" and kind != kind_of(name)):
                continue
            r = readings.setdefault((name, case), {"rel_err": None, "ms": []})
            try:
                got = fn(0)
                torch.cuda.synchronize()
                r["rel_err"] = ((got.float() - ref.float()).abs().max()
                                / ref.float().abs().max()).item()
                held = (name.startswith("abl_") or name in ABLATIONS
                        or r["rel_err"] <= 1e-2)
                r["ms"].append(cs.device_ms(fn, 16) if held else None)
            except RuntimeError as e:
                r["error"] = str(e)[:200]
    _build._lib = libs["base"]
    for (name, case), r in readings.items():
        print(json.dumps({"variant": name, "case": case, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

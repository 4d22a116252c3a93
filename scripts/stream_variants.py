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

Variants: abl_no_scale, abl_no_mma, abl_no_transpose (a piece of the
consumers' math replaced by one cheap operation), abl_stream_only (the
consumers wait for each stage and free it), abl_compute_only (nothing
loaded or waited for); two_consumer_wg (two consumer warpgroups at 8 n8
tiles, 32 tokens each, one block an SM) and two_consumer_wg_stages8 (with
an 8-slot ring); stages6 (a 6-slot ring); l2_128 / l2_none (the weight's
L2 fills); rank_major, rank_major_l2_128 (grid (tiles, ranks), a cluster
along y).

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
    ("  const int rank = blockIdx.x & (cs - 1), o0 = (blockIdx.x >> lg) * SG_BO;",
     "  const int rank = blockIdx.y, o0 = blockIdx.x * SG_BO;"),
    ("  cfg.gridDim = dim3((a.O + SG_BO - 1) / SG_BO * a.n_split);",
     "  cfg.gridDim = dim3((a.O + SG_BO - 1) / SG_BO, a.n_split);"),
    ("  attr[0].val.clusterDim.x = a.n_split;\n  attr[0].val.clusterDim.y = 1;",
     "  attr[0].val.clusterDim.x = 1;\n  attr[0].val.clusterDim.y = a.n_split;")]

VARIANTS = {
    # what the per-group scaling costs: one add in its place
    "abl_no_scale": [(_SCALE, "        acc[mt][nt][e] += __int_as_float(p[mt][nt][e]);")],
    # what the int8 mma costs: an integer add of its operands in its place
    "abl_no_mma": [(_MMA32, "#pragma unroll\n  for (int e = 0; e < 4; ++e) d[e] = c[e] + (a[e] ^ b0) + b1;")],
    # what the byte transpose costs: the row words as they are
    "abl_no_transpose": [(_QUAD, "  c[0] = v[0] ^ l.sel0;\n  c[1] = v[1];\n  c[2] = v[2];\n  c[3] = v[3];")],
    # the ring alone: the consumers wait for each stage and free it, no math
    "abl_stream_only": [("    if (t < a.n_sal) {\n      sg_salient_bf16",
                         "    if (t >= 0) {\n    } else if (t < a.n_sal) {\n      sg_salient_bf16")],
    # the math alone: nothing is loaded and nothing waited for
    "abl_compute_only": [
        ("    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SG_STAGES) & 1);\n"
         "    const float* sx", "    const float* sx"),
        ("    if (warp == 4) sg_produce<NIB, GS, NT, S>(a, m, smem, t0, t1, o0, tid & 31);\n",
         "")],
    # two consumer warpgroups at NT = 8, each taking 32 of the 64 tokens (one
    # block an SM, no setmaxnreg): twice the warps share a stage's latencies
    "two_consumer_wg": [
        ("constexpr int SG_THREADS = 256;     // a consumer warpgroup, then a producer one\n"
         "constexpr int SG_CONSUMER_REGS = 200, SG_PRODUCER_REGS = 56;\n", ""),
        ("  static constexpr int N_BOX = 8 * NT;                 // token rows a tile holds\n",
         "  static constexpr int N_BOX = 8 * NT;                 // token rows a tile holds\n"
         "  static constexpr int WN = NT == 8 ? 2 : 1;\n"
         "  static constexpr int NTW = NT / WN;\n"
         "  static constexpr int THREADS = 128 * (WN + 1);\n"
         "  static constexpr int BLOCKS = WN == 2 ? 1 : 2;\n"),
        ("  int lane, w, gid, tig, quad_b;\n", "  int lane, w, gid, tig, quad_b, tok0;\n"),
        ("__device__ __forceinline__ SgLane sg_lane(int tid) {\n  SgLane l;\n  l.lane = tid & 31;\n"
         "  l.w = tid >> 5;\n",
         "__device__ __forceinline__ SgLane sg_lane(int tid, int ntw) {\n  SgLane l;\n"
         "  l.lane = tid & 31;\n  l.w = (tid >> 5) & 3;\n  l.tok0 = 8 * ntw * (tid >> 7);\n"),
        ("__device__ __forceinline__ SgXOff<ROW, KSTEP> sg_xoff(int lane) {",
         "__device__ __forceinline__ SgXOff<ROW, KSTEP> sg_xoff(int lane, int tok0) {"),
        ("    const int base = (8 * (m >> 1) + r) * ROW, h = (m & 1) ^ f;",
         "    const int base = (tok0 + 8 * (m >> 1) + r) * ROW, h = (m & 1) ^ f;"),
        ("    const int base = (8 * m + r) * ROW;", "    const int base = (tok0 + 8 * m + r) * ROW;"),
        ("        const int n = 8 * nt + 2 * l.tig + j;\n        x[j] = n < a.N",
         "        const int n = l.tok0 + 8 * nt + 2 * l.tig + j;\n        x[j] = n < a.N"),
        ("__device__ __forceinline__ void sg_consume(float (&acc)[2][NT][4], const SgArgs& a, char* smem,\n"
         "                                           int t0, int t1, int o0, const SgLane& l) {\n"
         "  using Geo = SgGeo<NIB, GS, NT>;\n",
         "__device__ __forceinline__ void sg_consume(float (&acc)[2][SgGeo<NIB, GS, NT>::NTW][4],\n"
         "    const SgArgs& a, char* smem, int t0, int t1, int o0, const SgLane& l) {\n"
         "  using Geo = SgGeo<NIB, GS, NT>;\n  constexpr int NTW = Geo::NTW;\n"),
        ("    for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;\n"
         "  if (!a.t_bf16 && t0 == 0 && a.k_s > 0) sg_salient_f32<NT>(acc, a, o0, l);\n"
         "  const SgXOff<Geo::XROW, KSTEP> xo = sg_xoff<Geo::XROW, KSTEP>(l.lane);\n"
         "  const SgXOff<Geo::SALROW, 32> xso = sg_xoff<Geo::SALROW, 32>(l.lane);",
         "    for (int nt = 0; nt < NTW; ++nt)\n#pragma unroll\n      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;\n"
         "  if (!a.t_bf16 && t0 == 0 && a.k_s > 0) sg_salient_f32<NTW>(acc, a, o0, l);\n"
         "  const SgXOff<Geo::XROW, KSTEP> xo = sg_xoff<Geo::XROW, KSTEP>(l.lane, l.tok0);\n"
         "  const SgXOff<Geo::SALROW, 32> xso = sg_xoff<Geo::SALROW, 32>(l.lane, l.tok0);"),
        ("    const float* sx = reinterpret_cast<const float*>(s + Geo::OFF_SX);",
         "    const float* sx = reinterpret_cast<const float*>(s + Geo::OFF_SX) + l.tok0;"),
        ("      sg_salient_bf16<NT, Geo::KSAL>(", "      sg_salient_bf16<NTW, Geo::KSAL>("),
        ("        int p[2][NT][4];\n        sg_group_mma<true, GS, NT, GS>(",
         "        int p[2][NTW][4];\n        sg_group_mma<true, GS, NTW, GS>("),
        ("        sg_scale<NT, S>(acc, p, sx + h * Geo::N_BOX", "        sg_scale<NTW, S>(acc, p, sx + h * Geo::N_BOX"),
        ("          int p[2][NT][4];\n          sg_group_mma<false, GS, NT, 128>(",
         "          int p[2][NTW][4];\n          sg_group_mma<false, GS, NTW, 128>("),
        ("          sg_scale<NT, S>(acc, p, sx + gi * Geo::N_BOX", "          sg_scale<NTW, S>(acc, p, sx + gi * Geo::N_BOX"),
        ("__global__ void __launch_bounds__(SG_THREADS, 2)\nstream_gmm_kernel(const SgArgs a, const __grid_constant__ SgMaps m) {\n"
         "  using Geo = SgGeo<NIB, GS, NT>;\n",
         "__global__ void __launch_bounds__(SgGeo<NIB, GS, NT>::THREADS, SgGeo<NIB, GS, NT>::BLOCKS)\n"
         "stream_gmm_kernel(const SgArgs a, const __grid_constant__ SgMaps m) {\n"
         "  using Geo = SgGeo<NIB, GS, NT>;\n  constexpr int CONSUMERS = 128 * Geo::WN;\n"),
        ("(SG_STAGES + s)), 4);", "(SG_STAGES + s)), 4 * Geo::WN);"),
        ("  if (warp >= 4) {\n    regs_dec<SG_PRODUCER_REGS>();\n    if (warp == 4) sg_produce",
         "  if (tid >= CONSUMERS) {\n    if (tid < CONSUMERS + 32) sg_produce"),
        ("    named_sync<SG_THREADS>(SG_BAR_DRAINED);\n    if (cs > 1) {",
         "    named_sync<Geo::THREADS>(SG_BAR_DRAINED);\n    if (cs > 1) {"),
        ("  regs_inc<SG_CONSUMER_REGS>();\n  const SgLane l = sg_lane(tid);\n  float acc[2][NT][4];\n",
         "  const SgLane l = sg_lane(tid, Geo::NTW);\n  float acc[2][Geo::NTW][4];\n"),
        ("  named_sync<SG_THREADS>(SG_BAR_DRAINED);   // the ring is free: it takes the partial tile\n"
         "#pragma unroll\n  for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n    for (int j = 0; j < 2; ++j)\n"
         "      *reinterpret_cast<float4*>(part + (8 * nt + 2 * l.tig + j) * SG_PART_LD + l.quad_b) =",
         "  named_sync<Geo::THREADS>(SG_BAR_DRAINED);\n"
         "#pragma unroll\n  for (int nt = 0; nt < Geo::NTW; ++nt)\n#pragma unroll\n    for (int j = 0; j < 2; ++j)\n"
         "      *reinterpret_cast<float4*>(part + (l.tok0 + 8 * nt + 2 * l.tig + j) * SG_PART_LD + l.quad_b) ="),
        ("q < q_end; q += 128) {", "q < q_end; q += CONSUMERS) {"),
        ("  static const cudaError_t ready =\n      wg_kernel_ready(stream_gmm_kernel<NIB, GS, NT, S>, Geo::SMEM, 65536 / (2 * SG_THREADS));",
         "  static const cudaError_t ready = cudaFuncSetAttribute(\n      stream_gmm_kernel<NIB, GS, NT, S>, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);"),
        ("  cfg.blockDim = dim3(SG_THREADS);", "  cfg.blockDim = dim3(Geo::THREADS);")],
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
    "rank_major_l2_128": _RANK_MAJOR + [("SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                                         "SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
}


# the two warpgroups with an eight-slot ring (one block an SM keeps eight
# stages in flight, as two blocks of four do)
VARIANTS["two_consumer_wg_stages8"] = VARIANTS["two_consumer_wg"] + [
    ("constexpr int SG_STAGES = 4;", "constexpr int SG_STAGES = 8;")]


def apply_edits(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name, edits):
    """The library of one variant; returns (handle, error text or None)."""
    from smoothquant_tpu_torch.kernels import _build

    base_csrc, base_dir = _build.CSRC, _build.BUILD_DIR
    if name != "base":
        work = os.path.join(base_dir, "variants", name)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(base_csrc, os.path.join(work, "csrc"))
        path = os.path.join(work, "csrc", HEADER)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(apply_edits(text, edits))
        _build.CSRC, _build.BUILD_DIR = os.path.join(work, "csrc"), os.path.join(work, "build")
    _build._lib = None
    try:
        return _build.lib(), None
    except RuntimeError as e:
        return None, str(e)[-2000:]
    finally:
        _build.CSRC, _build.BUILD_DIR = base_csrc, base_dir


def cases(dev):
    """(name, fn(i), plain output of fn(0)) at the main paths' widths: K5 at
    Llama-2-7B's qkv and gate_up at 64 rows (K7a's layout, bf16 scales),
    K8 at the quick start's gate_proj at 4 and 64 rows (f32 scales)."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k5
    from smoothquant_tpu_torch.kernels import int_group_matmul as k8
    from smoothquant_tpu_torch.kernels.act_prep import quantize_acts_grouped_t

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
        out.append((name, fn, k5.int4_group_matmul_stacked_plain(0, xq, xs, wp, ws, xsal,
                                                                 wsal, **kw)))
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
        out.append((f"k8_gate@{n}", fn, k8.int_group_matmul_plain(
            xq, xs, ws_[0][0], ws_[0][1], xsal, ws_[0][2], **kw)))
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


def splits(dev) -> None:
    """The committed body at every cluster split of SPLITS for each case
    (stream_gmm.split patched to return it), beside the split it plans."""
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import stream_gmm

    planned = stream_gmm.split
    for case, fn, _ in cases(dev):
        out = {}
        for c in stream_gmm.SPLITS:
            stream_gmm.split = lambda o, stages, c=c: c
            try:
                out[c] = cs.device_ms(fn, 16)
            except RuntimeError as e:
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
    libs = {}
    for name in ["base"] + chosen:
        lib, err = build(name, VARIANTS.get(name, []))
        libs[name] = lib
        print(json.dumps({"variant": name, "built": lib is not None,
                          **({"error": err} if err else {})}), flush=True)
    if os.environ.get("SASS_DIR"):
        dump_sass(_build.build(), os.environ["SASS_DIR"])
    all_cases = cases(dev)
    names = [n for n in chosen if libs[n] is not None]
    readings = {}
    for name in ["base"] + names + names[::-1] + ["base"]:
        _build._lib = libs[name]
        for case, fn, ref in all_cases:
            r = readings.setdefault((name, case), {"rel_err": None, "ms": []})
            try:
                got = fn(0)
                torch.cuda.synchronize()
                r["rel_err"] = ((got.float() - ref.float()).abs().max()
                                / ref.float().abs().max()).item()
                held = name.startswith("abl_") or r["rel_err"] <= 1e-2
                r["ms"].append(cs.device_ms(fn, 16) if held else None)
            except RuntimeError as e:
                r["error"] = str(e)[:200]
    _build._lib = libs["base"]
    for (name, case), r in readings.items():
        print(json.dumps({"variant": name, "case": case, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

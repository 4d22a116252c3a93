"""Time the pieces and the designs not taken of K4's and K15a's bodies in
csrc/int8_wg.cu — the warp-specialized s8 wgmma body (wg_s8_gemm.cuh) and
the stream body's (O, K) int8 kind (stream_gmm.cuh stream_s8_kernel) —
against the committed ones, on one H100.  Each variant is the committed
csrc/ with a few edits, and only int8_wg.cu (the one source that includes
them) is built, all variants' nvcc processes at once, into a library of its
own that the wrappers are pointed at while it is timed.

    python3 scripts/s8_variants.py [names ...]   # from the repo root, one card

Ablations ("abl_*") take a piece of the work out, so their outputs are
wrong by design and not checked: their readings say what that piece costs.
Designs are held to the plain version (K4: 1e-2 of the largest bf16
output; K15a: bit for bit) and timed only where they hold.

The wgmma body, on K4's five Llama-2-7B sites (N = 1024) and K15a's OPT-1.3B
sites at 2048 rows:
  abl_loads_only   the consumers wait for each stage and free it: the ring
  abl_math_only    the producer loads the ring once, then hands the slots
                   over with no copy: the wgmma on resident stages
  abl_no_epilogue  nothing stored: the ring and the wgmma alone
  bn128            128 × 128 tiles (five slots) where no salient accumulator
                   takes registers: K15a and K4's lm_head
  wide_stages2     the 128 × 256 tiles over two slots in place of three
  stages4          four slots of the 128 × 128 ring in place of five
  one_tile         one block a tile (no persistent walk)
  inflight1        each consumer keeps one wgmma group in flight, a slot
                   released once the next stage's group is issued
  multicast2       clusters of two CTAs on neighbouring row tiles, each
                   loading half of the shared weight tile and multicasting
                   it to both (a quarter to a third fewer bytes from L2)
  multicast2_inflight1  both
The stream kind, on K15a's sites at 4 rows:
  abl_sk_ring_only  the consumers wait for each stage and free it
  abl_sk_math_only  nothing loaded or waited for after the ring's first fill
  sk_stages8        eight slots
  sk_blocks264      the split planned for two blocks an SM (a host rule:
                    stream_gmm.MAX_BLOCKS 264 while it runs)

Each reading is the device ms of one call (chip_smoke.device_ms), each call
on the next of 4 weights (cold in L2), taken base, variants, variants
reversed, base.  Prints one JSON line per variant and case, the card line
first; the build lines give ptxas' serialized-wgmma notes of each build.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WG = "wg_s8_gemm.cuh"
ENTRY = "int8_wg.cu"
SG = "stream_gmm.cuh"

_INT8_LOOP = """    for (int s = 0; s < a.n_s8; ++s, ++g) {
      const int slot = g % STAGES;
      const uint32_t su = smem_u32(smem + slot * G::SLOT);
      mbar_wait(smem_u32(smem + G::BAR + 8 * slot), (g / STAGES) & 1);
      s8_mma<BN>(acc, su + wg * 64 * 128, su + G::A);
      if (leader) s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + slot)));
    }"""
_INFLIGHT = """    for (int s = 0; s < a.n_s8; ++s, ++g) {
      const int slot = g % STAGES;
      const uint32_t su = smem_u32(smem + slot * G::SLOT);
      mbar_wait(smem_u32(smem + G::BAR + 8 * slot), (g / STAGES) & 1);
      s8_issue<BN>(acc, su + wg * 64 * 128, su + G::A);
      wg_wait<1>();
      if (s > 0 && leader)
        s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + (g - 1) % STAGES)));
    }
    wg_wait<0>();
    wg_fence_regs(acc);
    if (a.n_s8 > 0 && leader) s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + (g - 1) % STAGES)));"""
_PRODUCE = """      mbar_expect_tx(full, G::SLOT);
      if (s < a.n_sal) {"""
# the same loop in the multicast design, where a slot is freed on both CTAs
_MC = lambda text: text.replace("s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + slot)))",
                                "s8_free(smem_u32(smem + G::BAR + 8 * (STAGES + slot)), rank)") \
    .replace("s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + (g - 1) % STAGES)))",
             "s8_free(smem_u32(smem + G::BAR + 8 * (STAGES + (g - 1) % STAGES)), rank)")
_SK_CONSUME = """    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SK_STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {"""

MULTICAST2 = [  # the 2-CTA multicast design, as edits of wg_s8_gemm.cuh
    ('#include "wg_gemm.cuh"\n',
     '#include "cluster.cuh"\n#include "wg_gemm.cuh"\n'),
    ('enum { S8_K4 = 0, S8_LINEAR = 1 };',
     '// CTAs a cluster: neighbouring row tiles that share each weight tile, each\n// CTA loading its share of the tile and multicasting it to the others\nconstexpr int S8_CLUSTER = 2;\nenum { S8_K4 = 0, S8_LINEAR = 1 };'),
    ('  int tiles_m, tiles;       // row tiles, tiles in all',
     '  int tiles_m, tiles;       // row-tile groups (S8_CLUSTER row tiles each), groups in all'),
    ('__device__ __forceinline__ void s8_release(uint32_t bar) {\n  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");\n}\n',
     '__device__ __forceinline__ void s8_release(uint32_t bar) {\n  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");\n}\n// the same arrival on the mbarrier at the same offset in cluster rank `rank`\n__device__ __forceinline__ void s8_release_rank(uint32_t bar, uint32_t rank) {\n  uint32_t remote;\n  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n" : "=r"(remote) : "r"(bar), "r"(rank));\n  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n" ::"r"(remote)\n               : "memory");\n}\n// TMA\'s box into the same offset of every CTA in `mask`, each CTA\'s bytes\n// counted on its own mbarrier at bar\'s offset\n__device__ __forceinline__ void tma_2d_mc(uint32_t dst, const CUtensorMap& map, uint32_t bar,\n                                          int x, int y, uint16_t mask) {\n  asm volatile(\n      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"\n      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\\n" ::"r"(dst),\n      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(x), "r"(y), "h"(mask)\n      : "memory");\n}\n\n'),
    ("// tile t's first row and column: row tile t % tiles_m, column tile t / tiles_m\ntemplate <int BN>\n__device__ __forceinline__ void s8_tile(const S8Args& a, int t, int& n0, int& o0) {\n  const int tn = a.tiles_m == 1 ? t : (int)__umulhi((uint32_t)t, a.mag_m);\n  n0 = (t - tn * a.tiles_m) * S8_BM;",
     "// group t's row tile for cluster rank `rank` and its first column: row\n// group t % tiles_m, column tile t / tiles_m\ntemplate <int BN>\n__device__ __forceinline__ void s8_tile(const S8Args& a, int t, int rank, int& n0, int& o0) {\n  const int tn = a.tiles_m == 1 ? t : (int)__umulhi((uint32_t)t, a.mag_m);\n  n0 = ((t - tn * a.tiles_m) * S8_CLUSTER + rank) * S8_BM;"),
    ('__device__ __forceinline__ void s8_produce(const S8Args& a, const S8Maps& m, char* smem) {\n  using G = S8Geo<BN, STAGES>;',
     '__device__ __forceinline__ void s8_produce(const S8Args& a, const S8Maps& m, char* smem,\n                                           int rank) {\n  using G = S8Geo<BN, STAGES>;\n  constexpr uint16_t all = (1u << S8_CLUSTER) - 1;'),
    ('  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {\n    int n0, o0;\n    s8_tile<BN>(a, t, n0, o0);',
     '  for (int t = blockIdx.x / S8_CLUSTER; t < a.tiles; t += gridDim.x / S8_CLUSTER) {\n    int n0, o0;\n    s8_tile<BN>(a, t, rank, n0, o0);'),
    ('      if (s < a.n_sal) {\n        tma_2d(su, m.xsal, full, s * S8_SAL_K, n0);\n#pragma unroll\n        for (int h = 0; h < BN / 64; ++h)\n          tma_2d(su + G::A + h * 8192, m.wsal, full, o0 + 64 * h, s * S8_SAL_K);\n      } else {\n        const int k0 = (s - a.n_sal) * S8_KB;\n        tma_2d(su, m.x, full, k0, n0);\n        tma_2d(su + G::A, m.w, full, k0, o0);\n      }\n',
     "      // the weight (or w_sal) tile in S8_CLUSTER shares, this CTA's\n      // multicast to the cluster (each CTA's full barrier counts every share)\n      if (s < a.n_sal) {\n        tma_2d(su, m.xsal, full, s * S8_SAL_K, n0);\n#pragma unroll\n        for (int h = rank; h < BN / 64; h += S8_CLUSTER) {\n          if constexpr (S8_CLUSTER > 1)\n            tma_2d_mc(su + G::A + h * 8192, m.wsal, full, o0 + 64 * h, s * S8_SAL_K, all);\n          else\n            tma_2d(su + G::A + h * 8192, m.wsal, full, o0 + 64 * h, s * S8_SAL_K);\n        }\n      } else {\n        const int k0 = (s - a.n_sal) * S8_KB, r0 = rank * (BN / S8_CLUSTER);\n        tma_2d(su, m.x, full, k0, n0);\n        if constexpr (S8_CLUSTER > 1)\n          tma_2d_mc(su + G::A + r0 * 128, m.w, full, k0, o0 + r0, all);\n        else\n          tma_2d(su + G::A, m.w, full, k0, o0);\n      }\n"),
    ('template <int BN, int STAGES, bool SAL, int KIND, typename TO>\n__device__ __forceinline__ void s8_consume(const S8Args& a, char* smem, int tid) {',
     "// a slot freed: this CTA's empty mbarrier, and each other cluster rank's\n// (whose producer multicasts into this slot too)\n__device__ __forceinline__ void s8_free(uint32_t bar, int rank) {\n  s8_release(bar);\n#pragma unroll\n  for (int r = 1; r < S8_CLUSTER; ++r) s8_release_rank(bar, (rank + r) % S8_CLUSTER);\n}\n\ntemplate <int BN, int STAGES, bool SAL, int KIND, typename TO>\n__device__ __forceinline__ void s8_consume(const S8Args& a, char* smem, int tid, int rank) {"),
    ('  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++it) {\n    int n0, o0;\n    s8_tile<BN>(a, t, n0, o0);',
     '  for (int t = blockIdx.x / S8_CLUSTER; t < a.tiles; t += gridDim.x / S8_CLUSTER, ++it) {\n    int n0, o0;\n    s8_tile<BN>(a, t, rank, n0, o0);'),
    ('        if (leader) s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + slot)));\n      }',
     '        if (leader) s8_free(smem_u32(smem + G::BAR + 8 * (STAGES + slot)), rank);\n      }'),
    ('      if (leader) s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + slot)));\n    }',
     '      if (leader) s8_free(smem_u32(smem + G::BAR + 8 * (STAGES + slot)), rank);\n    }'),
    ('  const int tid = threadIdx.x;\n  if (tid == 0) {\n    for (int s = 0; s < STAGES; ++s) {\n      mbar_init(smem_u32(smem + G::BAR + 8 * s), 1);\n      mbar_init(smem_u32(smem + G::BAR + 8 * (STAGES + s)), 2);\n    }\n    mbar_init_fence();\n  }\n  __syncthreads();\n  if (tid >= 256) {\n    regs_dec<S8_PRODUCER_REGS>();\n    if (tid == 256) s8_produce<BN, STAGES>(a, m, smem);\n    return;\n  }\n  regs_inc<S8_CONSUMER_REGS>();\n  s8_consume<BN, STAGES, SAL, KIND, TO>(a, smem, tid);\n}\n',
     "  const int tid = threadIdx.x, rank = blockIdx.x % S8_CLUSTER;\n  if (tid == 0) {\n    for (int s = 0; s < STAGES; ++s) {\n      mbar_init(smem_u32(smem + G::BAR + 8 * s), 1);\n      mbar_init(smem_u32(smem + G::BAR + 8 * (STAGES + s)), 2 * S8_CLUSTER);\n    }\n    mbar_init_fence();\n  }\n  // every rank's barriers initialized before any multicast or remote arrival\n  if constexpr (S8_CLUSTER > 1) sg_cluster_sync();\n  else __syncthreads();\n  if (tid >= 256) {\n    regs_dec<S8_PRODUCER_REGS>();\n    if (tid == 256) s8_produce<BN, STAGES>(a, m, smem, rank);\n  } else {\n    regs_inc<S8_CONSUMER_REGS>();\n    s8_consume<BN, STAGES, SAL, KIND, TO>(a, smem, tid, rank);\n  }\n  // no rank leaves while another may still arrive on its barriers\n  if constexpr (S8_CLUSTER > 1) {\n    __syncwarp();\n    sg_cluster_sync();\n  }\n}\n"),
    ('  a.tiles_m = (N + S8_BM - 1) / S8_BM;',
     '  a.tiles_m = ((N + S8_BM - 1) / S8_BM + S8_CLUSTER - 1) / S8_CLUSTER;'),
    ('         wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, O, K, S8_KB, BN,\n                CU_TENSOR_MAP_SWIZZLE_128B);',
     '         wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, O, K, S8_KB, BN / S8_CLUSTER,\n                CU_TENSOR_MAP_SWIZZLE_128B);'),
    ('  const int grid = blocks < a.tiles ? blocks : a.tiles;\n  kern<<<grid, S8_THREADS, G::SMEM, st>>>(a, m);\n',
     '  const int groups = blocks / S8_CLUSTER < a.tiles ? blocks / S8_CLUSTER : a.tiles;\n  if constexpr (S8_CLUSTER == 1) {\n    kern<<<groups, S8_THREADS, G::SMEM, st>>>(a, m);\n  } else {\n    cudaLaunchConfig_t cfg = {};\n    cfg.gridDim = dim3(groups * S8_CLUSTER);\n    cfg.blockDim = dim3(S8_THREADS);\n    cfg.dynamicSmemBytes = G::SMEM;\n    cfg.stream = st;\n    cudaLaunchAttribute attr[1];\n    attr[0].id = cudaLaunchAttributeClusterDimension;\n    attr[0].val.clusterDim.x = S8_CLUSTER;\n    attr[0].val.clusterDim.y = 1;\n    attr[0].val.clusterDim.z = 1;\n    cfg.attrs = attr;\n    cfg.numAttrs = 1;\n    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, m);\n    if (e != cudaSuccess) return (int)e;\n  }\n'),
]

VARIANTS = {
    "abl_loads_only": [
        (WG, "      s8_mma<BN>(acc, su + wg * 64 * 128, su + G::A);\n", ""),
        (WG, "        s8_mma_sal(sal, su + wg * 64 * 128, su + G::A);\n", "")],
    "abl_math_only": [
        (WG, _PRODUCE, """      if (g >= STAGES) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(full) : "memory");
        continue;
      }
""" + _PRODUCE)],
    "abl_no_epilogue": [(WG, "    s8_epilogue<BN, SAL, KIND, TO>(a, acc, sal, col, sxv, stg, n0, o0, tid);\n",
                         "")],
    "bn128": [(ENTRY, "constexpr int WIDE_BN = 256, WIDE_STAGES = 3;",
               "constexpr int WIDE_BN = 128, WIDE_STAGES = S8_STAGES;")],
    "wide_stages2": [(ENTRY, "constexpr int WIDE_BN = 256, WIDE_STAGES = 3;",
                      "constexpr int WIDE_BN = 256, WIDE_STAGES = 2;")],
    "stages4": [(WG, "constexpr int S8_STAGES = 5; ", "constexpr int S8_STAGES = 4; ")],
    "one_tile": [(WG, "  const int grid = blocks < a.tiles ? blocks : a.tiles;",
                  "  const int grid = a.tiles;")],
    "multicast2": [(WG, old, new) for old, new in MULTICAST2],
    "multicast2_inflight1": [],   # both edits (filled below)
    "inflight1": [(WG, _INT8_LOOP, _INFLIGHT)],
    "abl_sk_ring_only": [(SG, _SK_CONSUME, _SK_CONSUME.replace(
        "    for (int ks = 0; ks < 4; ++ks) {", "    for (int ks = 0; ks < 0; ++ks) {"))],
    "abl_sk_math_only": [
        (SG, "        mbar_expect_tx(full, Geo::W_BYTES + Geo::X_BYTES);\n        tma_2d(su, m.w, full, t * 128, o0);",
         "        if (i >= SK_STAGES) { sg_arrive(full); continue; }\n"
         "        mbar_expect_tx(full, Geo::W_BYTES + Geo::X_BYTES);\n        tma_2d(su, m.w, full, t * 128, o0);")],
    "sk_stages8": [(SG, "constexpr int SK_STAGES = 4; ", "constexpr int SK_STAGES = 8; ")],
}
VARIANTS["multicast2_inflight1"] = VARIANTS["multicast2"] + [(WG, _MC(_INT8_LOOP), _MC(_INFLIGHT))]
# which cases a variant is timed on
STREAM_VARIANTS = {"abl_sk_ring_only", "abl_sk_math_only", "sk_stages8", "sk_blocks264"}
# variants that change a host rule, not a source: the committed build, the
# rule's module constant set while they run
HOST_RULES = {"sk_blocks264": ("smoothquant_tpu_torch.kernels.stream_gmm", "MAX_BLOCKS", 264)}

_FUNCS = {"sq_int8_prefill_wg", "sq_int8_linear_wg", "sq_int8_linear_stream"}


def apply_edits(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variant_sources(name, csrc):
    """{file: edited text} of a variant, from the sources in csrc."""
    out = {}
    for f, old, new in VARIANTS[name]:
        if f not in out:
            with open(os.path.join(csrc, f)) as fh:
                out[f] = fh.read()
        out[f] = apply_edits(out[f], [(old, new)])
    return out


class _Lib:
    """The three entry points of one int8_wg.cu build, with their ctypes
    signatures: what _build.lib() hands the wrappers while a variant runs."""

    def __init__(self, path):
        from smoothquant_tpu_torch.kernels import _build

        handle = ctypes.CDLL(path)
        for fn in _FUNCS:
            f = getattr(handle, fn)
            f.argtypes, f.restype = _build._SIGNATURES[fn]
            setattr(self, fn, f)


def build_all(names):
    """Build every variant's int8_wg.cu at once; {name: (_Lib or None,
    serialized notes, error)}."""
    from smoothquant_tpu_torch.kernels import _build

    base = os.path.join(_build.BUILD_DIR, "s8_variants")
    shutil.rmtree(base, ignore_errors=True)
    procs = {}
    for name in names:
        csrc = os.path.join(base, name, "csrc")
        shutil.copytree(_build.CSRC, csrc)
        for f, text in variant_sources(name, _build.CSRC).items():
            with open(os.path.join(csrc, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(base, name, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", os.path.join(csrc, ENTRY),
               "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        notes = sum(1 for ln in log.splitlines() if "serialized" in ln)
        out[name] = ((_Lib(lib), notes, None) if p.returncode == 0
                     else (None, None, log[-2000:]))
    return out


def cases(dev):
    """(kind, name, fn(variant lib), plain output or None): K4's five sites,
    K15a's four kinds of site at 2048 rows (wgmma body) and at 4 (stream)."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15
    from smoothquant_tpu_torch.kernels import int8_prefill as k4
    from smoothquant_tpu_torch.kernels.pack import k_major

    gen = torch.Generator(device=dev).manual_seed(0)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev, dtype=torch.int8)
    out = []
    for site, kk, o, ks in (("qkv", 4096, 12288, 256), ("o", 4096, 4096, 256),
                            ("gate_up", 4096, 22016, 256), ("down", 11008, 4096, 640),
                            ("lm_head", 4096, 32000, 0)):
        x, ws = i8(1024, kk), [k_major(i8(kk, o)) for _ in range(4)]
        sx = torch.rand((1024, 1), generator=gen, device=dev) * 0.01
        sw = torch.rand((1, o), generator=gen, device=dev) * 0.01
        xs = torch.randn((1024, ks), generator=gen, device=dev).to(torch.bfloat16)
        wsal = torch.randn((ks, o), generator=gen, device=dev).to(torch.bfloat16)
        args = lambda i, x=x, ws=ws, sx=sx, sw=sw, xs=xs, wsal=wsal: (
            x, sx, ws[i % 4], sw, xs, wsal)
        out.append(("k4", site, lambda i, args=args: k4.int8_prefill_matmul(*args(i)),
                    k4.int8_prefill_matmul_plain(*args(0))))
    for n in (2048, 4):
        for site, kk, o, to_i8 in (("q", 2048, 2048, True), ("out", 2048, 2048, False),
                                   ("fc1", 2048, 8192, True), ("fc2", 8192, 2048, False)):
            x, ws = (i8(n, kk) // 4), [i8(o, kk) for _ in range(4)]
            b = torch.randn(o, generator=gen, device=dev)
            kw = dict(relu=site == "fc1", out_dtype=torch.int8 if to_i8 else torch.float32)
            out.append(("stream" if n == 4 else "linear", f"{site}@{n}",
                        lambda i, x=x, ws=ws, b=b, kw=kw: k15.int8_linear(x, ws[i % 4], 1e-4, b,
                                                                        **kw),
                        k15.int8_linear_plain(x, ws[0], 1e-4, b, **kw)))
    return out


def _applies(name, kind):
    if name == "base":
        return True
    if name in STREAM_VARIANTS:
        return kind == "stream"
    return kind in ("k4", "linear")


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("s8_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    names = argv or list(VARIANTS) + list(HOST_RULES)
    base_lib = _build.lib()
    built = build_all([n for n in names if n in VARIANTS])
    built.update({n: (base_lib, 0, None) for n in names if n in HOST_RULES})
    for name, (lib, notes, err) in built.items():
        print(json.dumps({"variant": name, "built": lib is not None, "serialized_notes": notes,
                          **({"error": err} if err else {})}), flush=True)
    all_cases = cases(dev)
    ok = [n for n in names if built[n][0] is not None]
    readings = {}
    try:
        for name in ["base"] + ok + ok[::-1] + ["base"]:
            _build._lib = base_lib if name == "base" else built[name][0]
            rule = HOST_RULES.get(name)
            if rule:
                module = importlib.import_module(rule[0])
                saved = getattr(module, rule[1])
                setattr(module, rule[1], rule[2])
            for kind, case, fn, ref in all_cases:
                if not _applies(name, kind):
                    continue
                r = readings.setdefault((name, case), {"ms": []})
                try:
                    if not name.startswith("abl_") and "held" not in r:
                        got = fn(0)
                        torch.cuda.synchronize()
                        r["held"] = (torch.equal(got, ref) if kind != "k4" else
                                     ((got.float() - ref.float()).abs().max()
                                      <= 1e-2 * ref.float().abs().max()).item())
                    r["ms"].append(cs.device_ms(fn, 8) if r.get("held", True) else None)
                except RuntimeError as e:
                    r["error"] = str(e)[:200]
            if rule:
                setattr(module, rule[1], saved)
    finally:
        _build._lib = base_lib
    for (name, case), r in readings.items():
        print(json.dumps({"variant": name, "case": case, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Time the designs K6's and K9's wgmma bodies did not take against the
bodies they did, on one H100: each variant is the committed csrc/ with a
few edits (or, for K9's all-threads body, a spliced section), built into
its own library beside the committed one.

    python3 scripts/wg_variants.py        # from the repo root, one card

Variants:
  k6_pingpong        one producer warpgroup (40 registers) and two
                     consumers (232) with two s32 accumulators: group
                     u + 1's wgmma in flight while group u is scaled
  k6_no_turns        the committed body with the consumers issuing their
                     wgmma without taking turns
  k9_all_threads     K9's earlier body: four warpgroups, each issuing its
                     wgmma and dequantizing the next stage, one barrier a
                     stage (scripts/wg_variants/k9_all_threads.cuh)
  k9_four_consumers  the committed body with four consumer warpgroups

Each reading is the device ms of one call (chip_smoke.device_ms), taken
base, variants, variants reversed, base, with the output held against the
plain version at chip_smoke's tolerance (1e-2 of the largest output), and
ptxas' count of serialized-wgmma notes for the variant's build.  Prints one
JSON line per variant and shape, the card line first.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K6_SRC = "int4_group_matmul.cu"
K9_SRC = "quant_matmul.cu"

# ---------------------------------------------------------------- the edits

_TURN_FIRST = "  if (wg == 1 && T > n_sal) named_arrive<256>(W6_TURN);   // consumer 0 issues first\n"
_TURN_LAST = "  if (wg == 0 && T > n_sal) named_sync<256>(W6_TURN);   // consumer 1's last hand-over\n"
_K6_LOOP = """#pragma unroll
    for (int h = 0; h < 2; ++h) {
      named_sync<256>(W6_TURN + wg);
      w6_mma_group<GS>(p, a_u + h * WG_BM * GS, b_u + h * WG_BM * GS);
      named_arrive<256>(W6_TURN + (wg ^ 1));
      wg_wait<0>();
      wg_fence_regs(p);
      w6_scale(acc, p, slot, h, row, lane);
    }"""

K6_PINGPONG = [
    ("constexpr int W6_THREADS = 4 * 128, W6_PRODUCER = 256;",
     "constexpr int W6_THREADS = 3 * 128, W6_PRODUCER = 256;"),
    ("constexpr int W6_CONSUMER_REGS = 160, W6_PRODUCER_REGS = 96;",
     "constexpr int W6_CONSUMER_REGS = 232, W6_PRODUCER_REGS = 40;"),
    # the row scales of a stage: 256 copies over the producer's 128 threads
    ("""    const int g = t - n_sal, h = pt >> 7, n = n0 + (pt & 127);
    const bool ok = n < a.N;
    cp4(s + W6_SX + pt * 4, ok ? a.xs + (size_t)n * G + g + h * (G / 2) : a.xs, ok);""",
     """    for (int q = pt; q < 256; q += W6_THREADS - W6_PRODUCER) {
      const int g = t - n_sal, h = q >> 7, n = n0 + (q & 127);
      const bool ok = n < a.N;
      cp4(s + W6_SX + q * 4, ok ? a.xs + (size_t)n * G + g + h * (G / 2) : a.xs, ok);
    }"""),
    # the transform: the two producer warpgroups' shares, one after the other
    ("  const WgLane l = wg_lane(pt);\n  if (pt == 0) {\n    tma_prefetch(m.xq);",
     "  if (pt == 0) {\n    tma_prefetch(m.xq);"),
    ("""    w6_transform<S, GS>(smem + W6_BT + (t & 1) * WG_BT_BYTES, smem + (t % WG_STAGES) * W6_SLOT,
                        t, n_sal, l, pt);""",
     """    for (int q = pt; q < 256; q += W6_THREADS - W6_PRODUCER)
      w6_transform<S, GS>(smem + W6_BT + (t & 1) * WG_BT_BYTES,
                          smem + (t % WG_STAGES) * W6_SLOT, t, n_sal, wg_lane(q), q);"""),
    # every stage is released (no branch between a wgmma and its wait); the
    # producer takes the last two releases after its loop
    ("""    fence_async_smem();
    named_arrive<W6_THREADS>(W6_FULL + (t & 1));
  }
}""", """    fence_async_smem();
    named_arrive<W6_THREADS>(W6_FULL + (t & 1));
  }
  for (int s = T - 2 > 0 ? T - 2 : 0; s < T; ++s) named_sync<W6_THREADS>(W6_EMPTY + (s & 1));
}"""),
    ("    if (t <= T - 3) named_arrive<W6_THREADS>(W6_EMPTY + (t & 1));\n  }\n" + _TURN_FIRST,
     "    named_arrive<W6_THREADS>(W6_EMPTY + (t & 1));\n  }\n"),
    (_TURN_LAST, ""),
    ("  int p[64];", "  int p0[64], p1[64];"),
    (_K6_LOOP + """
    if (t <= T - 3) named_arrive<W6_THREADS>(W6_EMPTY + (t & 1));
  }""", """    w6_mma_group<GS>(p0, a_u, b_u);                 // lo(t)
    wg_wait<1>();                                   // hi(t - 1) is done
    wg_fence_regs(p1);
    if (t > n_sal) {
      w6_scale(acc, p1, smem + ((t - 1) % WG_STAGES) * W6_SLOT, 1, row, lane);
      named_arrive<W6_THREADS>(W6_EMPTY + ((t - 1) & 1));
    }
    w6_mma_group<GS>(p1, a_u + WG_BM * GS, b_u + WG_BM * GS);   // hi(t)
    wg_wait<1>();                                   // lo(t) is done
    wg_fence_regs(p0);
    w6_scale(acc, p0, slot, 0, row, lane);
  }
  wg_wait<0>();
  wg_fence_regs(p1);
  if (T > n_sal) {
    w6_scale(acc, p1, smem + ((T - 1) % WG_STAGES) * W6_SLOT, 1, row, lane);
    named_arrive<W6_THREADS>(W6_EMPTY + ((T - 1) & 1));
  }"""),
    ("mbar_init(smem_u32(smem + W6_BAR + 8 * s), 1 + 256);",
     "mbar_init(smem_u32(smem + W6_BAR + 8 * s), 1 + W6_THREADS - W6_PRODUCER);"),
    ("wg_kernel_ready(wg_gmm_kernel<S, GS>, W6_SMEM, 65536 / W6_THREADS)",
     "wg_kernel_ready(wg_gmm_kernel<S, GS>, W6_SMEM, 168)"),
]

K6_NO_TURNS = [
    (_TURN_FIRST, ""),
    (_TURN_LAST, ""),
    (_K6_LOOP, """#pragma unroll
    for (int h = 0; h < 2; ++h) {
      w6_mma_group<GS>(p, a_u + h * WG_BM * GS, b_u + h * WG_BM * GS);
      wg_wait<0>();
      wg_fence_regs(p);
      w6_scale(acc, p, slot, h, row, lane);
    }"""),
]

K9_ALL_THREADS = [
    ("SPLICE", "// ------------------------------------------------------------ bf16 body",
     "// The bf16 body: its maps", "k9_all_threads.cuh"),
    ("grouped ? DqShape<3>::BM : DqShape<2>::BM", "grouped ? DqShape<4>::BM : DqShape<2>::BM"),
    ("launch_dual_path_wg<3, S, true, true>", "launch_dual_path_wg<4, S, true, true>"),
    ("launch_dual_path_wg<3, S, true, false>", "launch_dual_path_wg<4, S, true, false>"),
]

K9_FOUR_CONSUMERS = [
    ("static constexpr int PRODUCER_REGS = 96;",
     "static constexpr int PRODUCER_REGS = CWG == 4 ? 48 : 96;"),
    ("grouped ? DqShape<3>::BM : DqShape<2>::BM", "grouped ? DqShape<4>::BM : DqShape<2>::BM"),
    ("launch_dual_path_wg<3, S, true, true>", "launch_dual_path_wg<4, S, true, true>"),
    ("launch_dual_path_wg<3, S, true, false>", "launch_dual_path_wg<4, S, true, false>"),
]

VARIANTS = {
    "k6_pingpong": (K6_SRC, K6_PINGPONG),
    "k6_no_turns": (K6_SRC, K6_NO_TURNS),
    "k9_all_threads": (K9_SRC, K9_ALL_THREADS),
    "k9_four_consumers": (K9_SRC, K9_FOUR_CONSUMERS),
}


def apply_edits(text, edits):
    for e in edits:
        if e[0] == "SPLICE":   # a section replaced by a file of scripts/wg_variants/
            _, start, end, name = e
            with open(os.path.join(ROOT, "scripts", "wg_variants", name)) as f:
                body = f.read()
            i, j = text.index(start), text.index(end)
            text = text[:i] + body.rstrip("\n") + "\n\n" + text[j:]
            continue
        old, new = e
        if text.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name, src, edits):
    """The library of one variant (None for the committed sources); returns
    (handle, ptxas' serialized-wgmma notes, error text or None)."""
    from smoothquant_tpu_torch.kernels import _build

    base_csrc, base_dir = _build.CSRC, _build.BUILD_DIR
    if name != "base":
        work = os.path.join(base_dir, "variants", name)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(base_csrc, os.path.join(work, "csrc"))
        path = os.path.join(work, "csrc", src)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(apply_edits(text, edits))
        _build.CSRC, _build.BUILD_DIR = os.path.join(work, "csrc"), os.path.join(work, "build")
    _build._lib = None
    try:
        lib = _build.lib()
        notes = sum(1 for ln in _build.build_log.splitlines() if "serialized" in ln)
        return lib, notes, None
    except RuntimeError as e:
        return None, None, str(e)[-2000:]
    finally:
        _build.CSRC, _build.BUILD_DIR = base_csrc, base_dir


def cases(dev):
    """(kernel, name, fn(), plain output) at the main paths' shapes: K6 at
    Llama-2-7B's four prefill linears (1024 rows, bf16 scales) and a
    BLOOM-7b1 4h_to_h at 2048 and 4 rows (f32 scales); K9 at the quick
    start's gate_proj at 2048 rows, grouped and one group."""
    import torch

    from smoothquant_tpu_torch.kernels import int4_group_matmul as k6
    from smoothquant_tpu_torch.kernels import quant_matmul as k9

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s, lo=-1.0, hi=1.0):
        return torch.rand(s, generator=gen, device=dev) * (hi - lo) + lo

    def codes(*s, q=7):
        return torch.randint(-q, q + 1, s, generator=gen, device=dev, dtype=torch.int8)

    out = []
    for name, n, kk, o, ks, s_dt in (
            ("llama_qkv", 1024, 3968, 12288, 256, torch.bfloat16),
            ("llama_o", 1024, 3968, 4096, 256, torch.bfloat16),
            ("llama_gate_up", 1024, 3968, 22528, 256, torch.bfloat16),
            ("llama_down", 1024, 10496, 4096, 640, torch.bfloat16),
            ("bloom_4h_to_h@2048", 2048, 15616, 4096, 896, torch.float32),
            ("bloom_4h_to_h@4", 4, 15616, 4096, 896, torch.float32)):
        a = (codes(n, kk), rnd(n, kk // 64, lo=0.01, hi=0.2),
             torch.randint(-128, 128, (kk // 2, o), generator=gen, device=dev, dtype=torch.int8),
             rnd(kk // 64, o, lo=0.01, hi=0.2).to(s_dt), rnd(n, ks).to(torch.bfloat16),
             rnd(ks, o).to(torch.bfloat16))
        out.append(("K6", name, lambda a=a: k6.int4_group_matmul(*a, group_size=64),
                    k6.int4_group_matmul_plain(*a, group_size=64)))
    for name, k, gs in (("gate@2048", 3904, 64), ("gate_one_group@2048", 3892, None)):
        g = 1 if gs is None else k // gs
        a = (rnd(2048, k).to(torch.bfloat16), rnd(2048, 256).to(torch.bfloat16),
             codes(k, 11008, q=7 if gs else 127), rnd(g, 11008, lo=0.001, hi=0.05),
             rnd(256, 11008).to(torch.bfloat16))
        kw = dict(group_size=gs or k, out_dtype=torch.bfloat16)
        out.append(("K9", name, lambda a=a, kw=kw: k9.dual_path_matmul(*a, **kw),
                    k9.dual_path_matmul_plain(*a, **kw)))
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("wg_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    libs = {}
    for name, (src, edits) in [("base", (None, None))] + list(VARIANTS.items()):
        lib, notes, err = build(name, src, edits)
        libs[name] = lib
        print(json.dumps({"variant": name, "built": lib is not None,
                          "serialized_notes": notes, **({"error": err} if err else {})}),
              flush=True)
    all_cases = cases(dev)
    names = [n for n in VARIANTS if libs[n] is not None]
    readings = {}
    for name in ["base"] + names + names[::-1] + ["base"]:
        _build._lib = libs[name]
        kernel = None if name == "base" else VARIANTS[name][0]
        for kern, case, fn, ref in all_cases:
            if kernel is not None and {"K6": K6_SRC, "K9": K9_SRC}[kern] != kernel:
                continue
            key = (name, case)
            try:
                got = fn()
                torch.cuda.synchronize()
                rel = ((got.float() - ref.float()).abs().max()
                       / ref.float().abs().max()).item()
                ms = cs.device_ms(lambda i: fn(), 8) if rel <= 1e-2 else None
            except RuntimeError as e:
                rel, ms = None, None
                readings.setdefault(key, {})["error"] = str(e)[:200]
            r = readings.setdefault(key, {"rel_err": rel, "ms": []})
            r["ms"].append(ms)
    _build._lib = libs["base"]
    for (name, case), r in readings.items():
        print(json.dumps({"variant": name, "case": case, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

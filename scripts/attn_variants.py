"""Time variants of the split-S body (csrc/split_decode.cuh: K11, K3, K12)
and of K15b's attention bodies (csrc/int8.cu) against the committed ones, on
one H100: each variant is the committed csrc/ with a few edits to one file,
built into its own library beside the committed one (as
scripts/stream_variants.py does for the stream body).

    python3 scripts/attn_variants.py [names ...]   # from the repo root, one card
    python3 scripts/attn_variants.py --splits      # the split bodies at each cluster size

Variants are of two kinds.  Ablations ("abl_*") take a piece of the work
out, so the output is wrong by design and is not checked: their readings
say what that piece costs at each shape.  Designs are held against the
plain version (K11, K3, K12: 1e-2 of the largest output, chip_smoke's
tolerance; K15b: bit for bit) and timed only where they hold.

The split body (every mode, so K11, K3 and K12 alike): abl_loads_only (the
ring fills and drains, no scores, no p·v), abl_math_only (no row is loaded
or waited for), abl_no_exchange (each rank takes its own tile maxima: no
remote stores and no cluster barrier before the softmax),
abl_no_stage_bound (every row of the chunk is copied, not only the stages
of [lo, hi]); rows64 (64-position stages), slots8 / slots4 (ring depth),
warps8_rows64 (8 warps, 64-position stages).  K3's S-major copy schemes:
k3_row_copies (one 1-D bulk copy of D bytes a row, only the rows of [lo,
hi], in place of one 2-D TMA box a stage), k3_l2_256 / k3_l2_none (the
boxes' L2 promotion, 256 bytes or none, in place of 128).  K15b:
abl_qk_direct_store (the qk body's f32 tile written from the mma
fragments, not staged), abl_qk_no_store (nothing written), qk_one_block
(one persistent CTA an SM), qk_grid (one CTA a tile, no persistence),
qk_plain_stores (write-back stores, not streaming ones), pv_stages3 /
pv_stages6 (the pv body's ring depth), pv_tile_a_cta (one M tile a CTA).
The flash bodies (K11, K3, K12) and K15a's kernels (K15b's old bodies) are
timed beside the committed bodies in every pass; `--splits` also times the
kn GEMV at each rank count.

Each reading is the device ms of one call (chip_smoke.device_ms), each call
on the next of two layers / four operand sets (cold in L2), taken base,
variants, variants reversed, base.  Prints one JSON line per variant and
case, the card line first.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K11_SRC, K3_SRC, K15_SRC = "split_decode.cuh", "attn_smajor.cu", "int8.cu"
# the cases each source's variants are read at
CASES_BY_SRC = {K11_SRC: ("k11", "k3", "k12"), K3_SRC: ("k3",), K15_SRC: ("k15",)}

_SCORE_LIVE = "      const bool on = live(i);\n      float kv[EPL];"
_PV_LIVE = "      if (live(i)) {\n        float vv[EPL];"
_WAIT = "    mbar_wait(bar0 + 8 * (slot + 1), (g >> SD_LOG_SLOTS) & 1);\n"
_QK_EPI = """          *reinterpret_cast<float2*>(stage + r * QK_LD + c) =
              make_float2(__fmul_rn(f0, p.alpha), __fmul_rn(f1, p.alpha));"""
_L2_128 = "CU_TENSOR_MAP_L2_PROMOTION_L2_128B"   # K3's boxes' L2 promotion
_QK_STORE = "    for (int r = warp; r < BM && m0 + r < p.M; r += THREADS / 32) {"

VARIANTS = {
    # the ring alone: stages land and are freed, nothing is computed from them
    "abl_loads_only": (K11_SRC, [
        (_SCORE_LIVE, "      const bool on = false;\n      float kv[EPL];"),
        (_PV_LIVE, "      if (false) {\n        float vv[EPL];")]),
    # the math alone: nothing is copied and nothing waited for
    "abl_math_only": (K11_SRC, [
        ("  if (tid == 0)\n    for (int g = 0; g < items && g < SD_SLOTS; ++g) issue(g);\n", ""),
        ("    if (tid == 0 && g + SD_SLOTS < items) {\n      fence_async_smem();\n"
         "      issue(g + SD_SLOTS);\n    }\n", ""),
        (_WAIT, "", 2)]),
    # no exchange of the tile maxima: each rank's own
    "abl_no_exchange": (K11_SRC, [
        ("      if (lane < C)\n"
         "        cl_st_rank_f32(smem_u32(tall + (rank * REP + r) * SD_MAX_TILES + t), lane, m);",
         "      if (lane == 0) tall[(rank * REP + r) * SD_MAX_TILES + t] = m;"),
        ("  sg_cluster_sync();   // every rank's tile maxima have landed", "  __syncthreads();"),
        ("          m = fmaxf(m, tall[(q * REP + r) * SD_MAX_TILES + t]);",
         "          if (q == rank) m = fmaxf(m, tall[(q * REP + r) * SD_MAX_TILES + t]);")]),
    # every row of the chunk copied, masked or not
    "abl_no_stage_bound": (K11_SRC, [
        ("    const int r0 = max(j * SD_ROWS, lo), r1 = min((j + 1) * SD_ROWS, hi + 1);",
         "    const int r0 = j * SD_ROWS, r1 = min((j + 1) * SD_ROWS, n);"),
        ("  const int j0 = hi >= 0 ? lo >> SD_LOG_ROWS : 0;\n"
         "  const int n_st = hi >= 0 ? (hi >> SD_LOG_ROWS) - j0 + 1 : 0;",
         "  const int j0 = 0;\n  const int n_st = (n + SD_ROWS - 1) >> SD_LOG_ROWS;")]),
    "warps8_rows64": (K11_SRC, [("constexpr int SD_WARPS = 4;", "constexpr int SD_WARPS = 8;"),
                                ("constexpr int SD_ROWS = 32; ", "constexpr int SD_ROWS = 64; "),
                                ("constexpr int SD_LOG_ROWS = 5;", "constexpr int SD_LOG_ROWS = 6;")]),
    "rows64": (K11_SRC, [("constexpr int SD_ROWS = 32; ", "constexpr int SD_ROWS = 64; "),
                         ("constexpr int SD_LOG_ROWS = 5;", "constexpr int SD_LOG_ROWS = 6;")]),
    "slots8": (K11_SRC, [("constexpr int SD_SLOTS = 2; ", "constexpr int SD_SLOTS = 8; "),
                         ("constexpr int SD_LOG_SLOTS = 1;", "constexpr int SD_LOG_SLOTS = 3;")]),
    "slots4": (K11_SRC, [("constexpr int SD_SLOTS = 2; ", "constexpr int SD_SLOTS = 4; "),
                         ("constexpr int SD_LOG_SLOTS = 1;", "constexpr int SD_LOG_SLOTS = 2;")]),
    # K3: one bulk copy a row of [lo, hi] (D bytes, rows H_kv·D apart), no tensor map
    "k3_row_copies": (K11_SRC, [(
        "      mbar_expect_tx(bar, STAGE);\n"
        "      tma_2d(smem_u32(ring + slot * STAGE), is_k ? maps.k : maps.v, bar, kvh * ROWB,\n"
        "             b * a.S + c0 + j * SD_ROWS);",
        "      const int r0 = max(j * SD_ROWS, lo), r1 = min((j + 1) * SD_ROWS, hi + 1);\n"
        "      mbar_expect_tx(bar, (r1 - r0) * ROWB);\n"
        "      const unsigned char* src = static_cast<const unsigned char*>(is_k ? a.k : a.v) +\n"
        "          ((size_t)b * a.S + c0) * a.Hkv * ROWB + (size_t)kvh * ROWB;\n"
        "      for (int r = r0; r < r1; ++r)\n"
        "        cl_bulk_g2s(smem_u32(ring + slot * STAGE + (r - j * SD_ROWS) * ROWB),\n"
        "                    src + (size_t)r * a.Hkv * ROWB, ROWB, bar);")]),
    "k3_l2_256": (K3_SRC, [(_L2_128, "CU_TENSOR_MAP_L2_PROMOTION_L2_256B", 2)]),
    "k3_l2_none": (K3_SRC, [(_L2_128, "CU_TENSOR_MAP_L2_PROMOTION_NONE", 2)]),
    # the f32 tile written from the fragments (8-byte stores, 8 rows a warp store)
    "abl_qk_direct_store": (K15_SRC, [
        (_QK_EPI, "          int z_, m0_, n0_;\n          qk_coords(p, t, z_, m0_, n0_);\n"
                  "          if (m0_ + r < p.M && n0_ + c + 1 < p.N)\n"
                  "            *reinterpret_cast<float2*>(p.out + ((size_t)z_ * p.M + m0_ + r) * p.N"
                  " + n0_ + c) =\n"
                  "                make_float2(__fmul_rn(f0, p.alpha), __fmul_rn(f1, p.alpha));"),
        (_QK_STORE, "    for (int r = warp; r < 0; r += THREADS / 32) {")]),
    # nothing written: the operands, the mma and the staging alone
    "abl_qk_no_store": (K15_SRC, [(_QK_STORE, "    for (int r = warp; r < 0; r += THREADS / 32) {")]),
    "qk_one_block": (K15_SRC, [("int qk_blocks_per_sm(int smem) { return smem <= 113 * 1024 ? 2 : 1; }",
                                "int qk_blocks_per_sm(int smem) { return 1; }")]),
    "qk_grid": (K15_SRC, [("  const int grid = min(p.total, qk_blocks_per_sm(smem) * sm_count());",
                           "  const int grid = p.total;")]),
    # plain (write-back) stores of the logits, not streaming ones
    "qk_plain_stores": (K15_SRC, [
        ("        if (c < cols) __stcs(reinterpret_cast<float4*>(row + c), "
         "*reinterpret_cast<const float4*>(src));",
         "        if (c < cols) *reinterpret_cast<float4*>(row + c) = "
         "*reinterpret_cast<const float4*>(src);")]),
    # one M tile a CTA (b loaded and transposed by every CTA of a column tile)
    "pv_tile_a_cta": (K15_SRC, [
        ("  const int msplit = max(1, min(tiles_m, 2 * sm_count() / max(1, batch * tiles_n)));",
         "  const int msplit = tiles_m;")]),
    "pv_stages3": (K15_SRC, [("constexpr int PV_STAGES = 4; ", "constexpr int PV_STAGES = 3; ")]),
    "pv_stages6": (K15_SRC, [("constexpr int PV_STAGES = 4; ", "constexpr int PV_STAGES = 6; ")]),
}


def apply_edits(text, edits):
    for edit in edits:
        old, new = edit[:2]
        count = edit[2] if len(edit) > 2 else 1
        if text.count(old) != count:
            raise ValueError(f"edit does not match {count} time(s): {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name):
    """The library of one variant; returns (handle, error text or None)."""
    from smoothquant_tpu_torch.kernels import _build

    base_csrc, base_dir = _build.CSRC, _build.BUILD_DIR
    if name != "base":
        src, edits = VARIANTS[name]
        work = os.path.join(base_dir, "attn_variants", name)
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
        return _build.lib(), None
    except RuntimeError as e:
        return None, str(e)[-2000:]
    finally:
        _build.CSRC, _build.BUILD_DIR = base_csrc, base_dir


def _k11_case(dev, gen, b, s, quant, pos, alibi):
    """(call(i, body, split), plain output of call 0, the planned ranks) of
    one K11 shape: Llama-2-7B's / BLOOM-7b1's 32 heads of 128 over a
    two-layer stacked cache."""
    import torch

    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models import bloom
    from smoothquant_tpu_torch.models.common import decode_bias

    h, d, n_l = 32, 128, 2
    shape = (n_l, b, h, s, d)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    if quant:
        kv = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2)]
        kv += [torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005
               for _ in range(2)]
    else:
        kv = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2)] + [None, None]
    bias = decode_bias(torch.as_tensor(pos, device=dev), b, s, None)
    slopes = torch.as_tensor(bloom.alibi_slopes(h), device=dev) if alibi else None
    args = lambda i: (i % n_l, q, *kv[:2], bias, *kv[2:], slopes)
    call = lambda i, body=None, split=None: k11.decode_attention_stacked(
        *args(i), body=body, split=split)
    return call, k11.decode_attention_stacked_plain(*args(0)), k11.split_ranks(b * h, s)


def k11_cases(dev):
    """The K11 rows of chip_smoke: Llama B = 4 over 512 (bf16, int8), the
    ALiBi body at B = 4 over 640 and B = 64 over 512 (bf16, int8), Llama's
    int8 pool at B = 64 over 512 (positions 100-511)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    pos4 = [100, 300, 511, 50]
    out = {}
    for name, b, s, quant, pos, alibi in (
            ("llama_bf16@B4", 4, 512, False, pos4, False),
            ("llama_int8@B4", 4, 512, True, pos4, False),
            ("alibi_bf16@B4", 4, 640, False, [639, 600, 590, 620], True),
            ("alibi_int8@B4", 4, 640, True, [639, 600, 590, 620], True),
            ("alibi_bf16@B64", 64, 512, False,
             torch.randint(448, 512, (64,), generator=gen, device=dev), True),
            ("alibi_int8@B64", 64, 512, True,
             torch.randint(448, 512, (64,), generator=gen, device=dev), True),
            ("llama_int8@B64", 64, 512, True,
             torch.randint(100, 512, (64,), generator=gen, device=dev), False)):
        out[name] = _k11_case(dev, gen, b, s, quant, pos, alibi)
    return out


def k3_cases(dev):
    """The K3 rows of chip_smoke (Llama-2-7B's 32 heads of 128 over a
    two-layer S-major cache): B = 4 ragged (positions 100/300/511/50), B =
    64 from position 448, B = 4 over 1024 positions."""
    import torch

    from smoothquant_tpu_torch.kernels import attn_smajor as k3
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import decode_bias

    gen = torch.Generator(device=dev).manual_seed(2)
    h, d, n_l = 32, 128, 2
    out = {}
    for name, b, s, pos in (("ragged@B4", 4, 512, [100, 300, 511, 50]),
                            ("new_row@B64", 64, 512, [448] * 64),
                            ("ragged@S1024", 4, 1024, [100, 700, 1023, 50])):
        shape = (n_l, b, s, h * d)
        kv = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2)]
        sc = [torch.rand((n_l, b, h, s), generator=gen, device=dev) * 0.02 + 0.005
              for _ in range(2)]
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        bias = decode_bias(torch.tensor(pos, device=dev), b, s, None)
        args = lambda i, q=q, kv=kv, sc=sc, bias=bias: (i % n_l, q, *kv, bias, *sc)
        call = lambda i, body=None, split=None, args=args: k3.decode_attention_smajor_stacked(
            *args(i), body=body, split=split)
        out[name] = (call, k3.decode_attention_smajor_plain(*args(0)), k11.split_ranks(b * h, s))
    return out


def k12_cases(dev):
    """The K12 rows of chip_smoke (Llama-2-7B's 32 heads of 128 over a
    two-layer head-major int8 cache of 512 at position 448): the flat body
    at B = 4 and 64, the write body at B = 4, the stacked body at B = 4 over
    8 kv heads (rep 4)."""
    import torch

    from smoothquant_tpu_torch.kernels import attn_fused as k12
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.models.common import rotary_cos_sin

    gen = torch.Generator(device=dev).manual_seed(3)
    h, d, s, n_l = 32, 128, 512, 2
    pos = torch.tensor(448, dtype=torch.int32, device=dev)
    cos, sin = rotary_cos_sin(pos.long().reshape(1, 1), d)
    fns = {"flat": k12.fused_virtual_attn_flat, "stacked": k12.fused_virtual_attn_stacked,
           "write": k12.fused_rope_write_attn_stacked}
    out = {}
    for name, body, b, n_kv in (("flat@B4", "flat", 4, 32), ("write@B4", "write", 4, 32),
                                ("gqa@B4", "stacked", 4, 8), ("flat@B64", "flat", 64, 32)):
        shape = (n_l, b, n_kv, s, d)
        cache = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        cache += [torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.005
                  for _ in range(2)]
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        if body == "flat":
            q = q.reshape(b, 1, h * d)
        new = [torch.randn((b, n_kv, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(2)]
        args = lambda i, q=q, new=new, cache=cache: (i % n_l, pos, q, *new, cos, sin, *cache)
        ref = k12.fused_attn_plain(*args(0)[:7], *[t.clone() for t in cache],
                                   flat=body == "flat", write_cache=body == "write")
        call = lambda i, body_=None, split=None, fn=fns[body], args=args: fn(
            *args(i), body=body_, split=split)
        out[name] = (call, ref, k11.split_ranks(b * n_kv, s))
    return out


def k15_cases(dev):
    """K15b's four sites of chip_smoke (OPT-1.3B: 4 × 32 heads of 64): QKᵀ
    and PV at the 512-token prefill and at one query over 1024 positions."""
    import torch

    from smoothquant_tpu_torch.kernels import int8 as k15

    gen = torch.Generator(device=dev).manual_seed(1)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev, dtype=torch.int8)
    bh, d, n_buf = 128, 64, 4
    out = {}
    for name, sa, sb, b_kn, dt in (("qk@prefill", (bh, 512, d), (bh, 512, d), False, torch.float32),
                                   ("pv@prefill", (bh, 512, 512), (bh, 512, d), True, torch.int8),
                                   ("qk@decode", (bh, 1, d), (bh, 1024, d), False, torch.float32),
                                   ("pv@decode", (bh, 1, 1024), (bh, 1024, d), True, torch.int8)):
        a = [i8(*sa) for _ in range(n_buf)]
        b = [i8(*sb) for _ in range(n_buf)]
        kw = dict(out_dtype=dt, b_kn=b_kn)
        args = lambda i, a=a, b=b: (a[i % n_buf], b[i % n_buf], 0.0123)
        call = lambda i, body=None, split=None, args=args, kw=kw: k15.int8_bmm(
            *args(i), **kw, body=body, ranks=split)
        out[name] = (call, k15.int8_bmm_plain(*args(0), **kw), None)
    return out


def _old_body(kind, case):
    """The body each kind's committed one replaced, timed beside it in the
    base pass: the flash bodies, K15a's kernels."""
    if kind != "k15":
        return "flash"
    return "gemv" if case.endswith("decode") else "tiles"


def readings(dev, names):
    """{(variant, case): {"err": ..., "ms": [...]}} over base, names,
    reversed names, base."""
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build

    cases = {"k11": k11_cases(dev), "k3": k3_cases(dev), "k12": k12_cases(dev),
             "k15": k15_cases(dev)}
    out = {}
    for name, lib in names:
        _build._lib = lib
        kinds = CASES_BY_SRC[VARIANTS[name][0]] if name in VARIANTS else tuple(cases)
        for kind in kinds:
            for case, (call, ref, _) in cases[kind].items():
                old = _old_body(kind, case)
                for body in (None,) + ((old,) if name == "base" else ()):
                    label = name if body is None else ("k15a_" + old if kind == "k15" else old)
                    r = out.setdefault((label, f"{kind} {case}"), {"err": None, "ms": []})
                    fn = lambda i, body=body, call=call: call(i, body)
                    got = fn(0)
                    torch.cuda.synchronize()
                    if kind == "k15":
                        r["err"] = int((got != ref).sum())
                        held = r["err"] == 0
                    else:
                        r["err"] = ((got.float() - ref.float()).abs().max()
                                    / ref.float().abs().max()).item()
                        held = r["err"] <= 1e-2
                    r["ms"].append(cs.device_ms(fn, 8)
                                   if held or name.startswith("abl_") else None)
    return out


def splits(dev) -> None:
    """The split bodies of K11, K3 and K12 at every cluster size of SPLITS
    for each case, beside the size split_ranks plans; the kn GEMV (PV of one
    query) at every rank count of KN_SPLITS, beside the count kn_ranks
    plans."""
    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import decode_attention as k11
    from smoothquant_tpu_torch.kernels import int8 as k15

    call = k15_cases(dev)["pv@decode"][0]
    out = {c: cs.device_ms(lambda i: call(i, "kn_gemv", c), 8) for c in k15.KN_SPLITS}
    print(json.dumps({"case": "k15 pv@decode", "planned": k15.kn_ranks(128, 64, 1024),
                      "ms_by_ranks": out}), flush=True)
    for kind, cases in (("k11", k11_cases(dev)), ("k3", k3_cases(dev)),
                        ("k12", k12_cases(dev))):
        for case, (call, _, planned) in cases.items():
            out = {}
            for c in k11.SPLITS:
                try:
                    out[c] = cs.device_ms(lambda i: call(i, None, c), 8)
                except ValueError as e:
                    out[c] = str(e)[:80]
            print(json.dumps({"case": f"{kind} {case}", "planned": planned,
                              "ms_by_split": out}), flush=True)


def main(argv) -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("attn_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    if argv == ["--splits"]:
        build("base")
        splits(dev)
        return 0
    chosen = [n for n in VARIANTS if not argv or n in argv]
    libs = {}
    for name in ["base"] + chosen:
        lib, err = build(name)
        libs[name] = lib
        print(json.dumps({"variant": name, "built": lib is not None,
                          **({"error": err} if err else {})}), flush=True)
    names = [n for n in chosen if libs[n] is not None]
    order = ["base"] + names + names[::-1] + ["base"]
    r = readings(dev, [(n, libs[n]) for n in order])
    for (name, case), v in r.items():
        print(json.dumps({"variant": name, "case": case, **v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

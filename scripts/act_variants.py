"""Time the designs not taken of K7's row body (csrc/act_prep.cu
act_rows_kernel: K7b and K7a in one register-resident row kernel) and of
the chaining of K5's stream kind behind it, against the committed ones, on
one H100.  Each source variant is the committed csrc/ with a few edits, and
only act_prep.cu and int4_group_matmul.cu (the sources that hold the row
body's and K5's entries) are built, all variants' nvcc processes at once,
into a library of their own that the wrappers are pointed at while it is
timed (the other entry points stay the committed build's).  Host variants
time the committed build with another plan (act_prep.k7_plan) or body.

    python3 scripts/act_variants.py [--checks] [names ...]   # from the repo root, one card

--checks first runs chip_smoke's SASS phase and its k7_edges phase (a new
kernel's short first call).

Source variants:
  unchained      K5's stream kind launched after the prep ends (pdl = 0)
  scalar_loads   every load of x by 2- or 4-byte scalars (no 16-byte loads)
  late_trigger   the row body's griddepcontrol.launch_dependents after its
                 stores, not after its loads
  no_trigger     no launch_dependents: K5 starts as the prep's blocks exit
  early_trigger  launch_dependents after the loads up to 64 rows, not 32
  ieee_divide    the codes by `y / scale` (FCHK's branch a division)
  pairwise_sum   a chunk's eight squares added pairwise, not in order
  serial_exchange  the row's warps' sums added in warp order by every lane,
                 not by an xor tree
Ablations (a piece taken out, the outputs wrong by design and not held):
  abl_empty      every block returns at once (the launch alone)
  abl_loads_only the loads, then a sum of the registers kept alive, nothing else
  abl_no_sum     no Σx² (r = 1)
  abl_no_divide  the codes by a multiply, not the true division
Host variants:
  rows_r1, rows_r2, rows_r4  one, two or four rows a block of 16 warps,
                 16 / R warps a row (k7_plan takes one row a block)
  warps_least    the least warps a row that leave at most 4 slots a lane
                 (the plan gives each lane one or two)
  parts1, parts2, parts4  a row over one, two or four blocks of a cluster,
                 the Σx² exchanged through distributed shared memory (the
                 plan splits rows of more than 1024 slots while the blocks
                 leave SMs to spare)
  groups         the one-warp-a-(row, group) body (body="groups"), where it
                 takes the case
Cases (Llama-2-7B's serving pack: C = 4096 at qkv and gate_up, 11008 at
down, g64, 5 % salient, k_ns and k_s as the pack pads them; bf16 rows,
random norm rows and weights of 4 layers, each call on the next layer):
  k7b@8, k7b@32      K7b "rms" at qkv (the 5-32-row path)
  prep@64, down@64   qkv's prep at 64 rows ("rms_round") and down's (K7a
                     with the salient split)
  rows@2048          qkv's prep at 2048 rows (the many-rows plan)
  c16384@130         K7b "rms" at Bloom's dense_4h_to_h width, 130 rows
  c16384@4, none16384@4, none@4  K7b at 4 rows: "rms" and no norm at that
                     width, no norm at qkv's
  pair@32, pair@64   qkv's prep and K5's stream kind behind it (O = 12288)
  k5@32, k5@64       K5 alone on the same operands
Each reading is the device ms of one call (chip_smoke.device_ms), taken
base, variants, variants reversed, base.  Prints one JSON line per variant
and case, the card line first.
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

AP = "act_prep.cu"
GM = "int4_group_matmul.cu"
SOURCES = (AP, GM)

VARIANTS = {
    "unchained": [(GM, "n_sal, n_grp, n_split, s_bf16, t_bf16, /*pdl=*/1};",
                   "n_sal, n_grp, n_split, s_bf16, t_bf16, /*pdl=*/0};")],
    "scalar_loads": [(AP, "(uintptr_t)x % 16 == 0 && (ld * xb) % 16 == 0,", "0,")],
    "late_trigger": [(AP, "  if (a.N <= AR_EARLY_TRIGGER_ROWS) ar_launch_dependents();\n", ""),
                     (AP, "  // the padding rows N .. N_pad − 1: row p by the warps of live row (p − N) mod N\n",
                      "  ar_launch_dependents();\n")],
    "no_trigger": [(AP, "  if (a.N <= AR_EARLY_TRIGGER_ROWS) ar_launch_dependents();\n", "")],
    "early_trigger": [(AP, "constexpr int AR_EARLY_TRIGGER_ROWS = 32;",
                       "constexpr int AR_EARLY_TRIGGER_ROWS = 64;")],
    "ieee_divide": [(AP, "if (scale >= AR_DIV_LO && scale <= AR_DIV_HI) {", "if (false) {")],
    "serial_exchange": [(AP, "      ss = lane < (1 << a.w_log) ? red[(rg << a.w_log) + lane] : 0.0;\n"
                              "      for (int o = (1 << a.w_log) >> 1; o > 0; o >>= 1) ss += "
                              "__shfl_xor_sync(0xffffffffu, ss, o);\n"
                              "      ss = __shfl_sync(0xffffffffu, ss, 0);\n",
                         "      ss = 0.0;\n      for (int i = 0; i < (1 << a.w_log); ++i) "
                         "ss += red[(rg << a.w_log) + i];\n")],
    "pairwise_sum": [(AP, "#pragma unroll\n        for (int e = 0; e < 8; ++e) ss += (double)v[k][e] * "
                          "(double)v[k][e];",
                      "        ss += (((double)v[k][0] * v[k][0] + (double)v[k][1] * v[k][1]) +\n"
                      "               ((double)v[k][2] * v[k][2] + (double)v[k][3] * v[k][3])) +\n"
                      "              (((double)v[k][4] * v[k][4] + (double)v[k][5] * v[k][5]) +\n"
                      "               ((double)v[k][6] * v[k][6] + (double)v[k][7] * v[k][7]));")],
    # ablations: a piece taken out, outputs wrong by design (not held)
    "abl_empty": [(AP, "  if (row >= a.N) return;   // the whole group of the row's warps leaves",
                   "  if (row >= 0) return;")],
    "abl_loads_only": [(AP, "  if (a.N <= AR_EARLY_TRIGGER_ROWS) ar_launch_dependents();\n\n  float r = 1.0f;",
                        "  {\n    float s = 0.0f;\n"
                        "    for (int k = 0; k < CH; ++k)\n      for (int e = 0; e < 8; ++e) s += v[k][e];\n"
                        "    if (s == 1.2345f) a.xs_t[0] = s;\n    return;\n  }\n  float r = 1.0f;")],
    "abl_no_sum": [(AP, "  if (a.mode != 0) {\n    double ss = 0.0;", "  if (false) {\n    double ss = 0.0;")],
    "abl_no_divide": [(AP, "for (int e = 0; e < 8; ++e) q[e] = ar_div(y[e], scale, r1);",
                       "for (int e = 0; e < 8; ++e) q[e] = y[e] * r1;")],
}
ABLATIONS = {"abl_empty", "abl_loads_only", "abl_no_sum", "abl_no_divide"}


def _fit(slots, w, r, p):
    """(w, r, p, the least build that covers the row)."""
    need = -(-slots // (32 * w * p))
    return w, r, p, next((c for c in (1, 2, 4, 8) if c >= need), 16)


def _rows(r):
    """r rows a block of 16 warps, 16 / r warps a row (more slots a lane)."""
    return lambda n, slots, plan: _fit(slots, 16 // r, r, 1)


def _parts(p):
    """a row over p blocks of a cluster, the plan's warps a block."""
    return lambda n, slots, plan: _fit(slots, plan[0], 1, p)


def _warps_least(n, slots, plan):
    w = 1
    while w < 16 and 32 * w * 4 < slots:
        w *= 2
    return _fit(slots, w, 1, plan[2])


# host variants: (rows, slots, the committed plan) → (warps a block, rows a block, blocks a
# row, slots a lane)
HOST = {"rows_r1": {"plan": _rows(1)}, "rows_r2": {"plan": _rows(2)},
        "rows_r4": {"plan": _rows(4)}, "warps_least": {"plan": _warps_least},
        "parts1": {"plan": _parts(1)},
        "parts2": {"plan": _parts(2)}, "parts4": {"plan": _parts(4)},
        "groups": {"body": "groups"}}
# the cases each variant is read at (base reads every case)
READ_AT = {"unchained": ("pair@32", "pair@64"),
           "late_trigger": ("pair@32", "pair@64"), "no_trigger": ("pair@32", "pair@64"),
           "early_trigger": ("pair@64",),
           "ieee_divide": ("k7b@8", "k7b@32", "prep@64", "down@64"),
           "pairwise_sum": ("k7b@8", "k7b@32", "prep@64"),
           "serial_exchange": ("k7b@8", "k7b@32", "prep@64", "down@64"),
           **{a: ("k7b@8", "k7b@32", "prep@64", "down@64") for a in ABLATIONS},
           "parts1": ("down@64", "c16384@130", "c16384@4", "none16384@4"),
           "parts2": ("k7b@8", "k7b@32", "down@64", "c16384@4", "none16384@4", "none@4"),
           "parts4": ("k7b@8", "down@64", "c16384@4", "none16384@4", "none@4"),
           "scalar_loads": ("k7b@8", "k7b@32", "prep@64", "down@64", "rows@2048"),
           "rows_r1": ("prep@64", "rows@2048"), "rows_r2": ("prep@64", "rows@2048"),
           "rows_r4": ("prep@64", "rows@2048"),
           "warps_least": ("k7b@8", "k7b@32", "prep@64", "down@64", "c16384@130"),
           "groups": ("k7b@8", "k7b@32", "c16384@130", "c16384@4", "none16384@4", "none@4")}


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
    """One variant's build: its own K7 and K5 entry points with their
    ctypes signatures, every other entry point the committed build's."""

    def __init__(self, path, base):
        from smoothquant_tpu_torch.kernels import _build

        self._base = base
        handle = ctypes.CDLL(path)
        for fn in ("sq_act_rows", "sq_quantize_grouped_t", "sq_norm_quantize_t",
                   "sq_int4_gmm_stacked_stream"):
            f = getattr(handle, fn)
            f.argtypes, f.restype = _build._SIGNATURES[fn]
            setattr(self, fn, f)

    def __getattr__(self, name):
        return getattr(self._base, name)


def build_all(names, base):
    """Build every source variant's two entry sources at once; {name: (_Lib
    or None, error)}."""
    from smoothquant_tpu_torch.kernels import _build

    root = os.path.join(_build.BUILD_DIR, "act_variants")
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


def cases(dev):
    """(case, fn(i, options), plain outputs or None): the cases of the
    module docstring."""
    import torch

    from smoothquant_tpu_torch.kernels import act_prep as k7
    from smoothquant_tpu_torch.kernels import int4_group_matmul as k5
    from smoothquant_tpu_torch.models.llama import LlamaConfig
    from smoothquant_tpu_torch.utils import roofline

    shapes = roofline.llama_pack_shapes(LlamaConfig.llama2_7b())
    gs, n_l = 64, 4
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []

    def site(c, kk, k_s):
        return dict(group_size=gs, act_bits=4, k_ns=kk, num_salient=int(0.05 * c), k_s=k_s)

    def norm_rows(c):
        return (torch.rand((n_l, c), generator=gen, device=dev) + 0.5).to(torch.bfloat16).float()

    def rows(n, c):
        return [torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(n_l)]

    c, o, kk, k_s = shapes["qkv"]
    qkv, w = site(c, kk, k_s), norm_rows(c)

    def k7b(xs, kind, kw):
        def fn(i, opts):
            return k7.norm_quantize_acts_t(xs[i % n_l], w[i % n_l], **kw, eps=1e-5,
                                           norm_kind=kind, sal_dtype=torch.bfloat16, **opts)
        ref = k7.norm_quantize_acts_t_plain(xs[1], w[1], **kw, eps=1e-5, norm_kind=kind,
                                            sal_dtype=torch.bfloat16)
        return fn, ref

    for n in (8, 32):
        out.append((f"k7b@{n}", *k7b(rows(n, c), "rms", qkv)))
    out.append(("prep@64", *k7b(rows(64, c), "rms_round", qkv)))
    out.append(("rows@2048", *k7b(rows(2048, c), "rms_round", qkv)))
    cd, _, kkd, k_sd = shapes["down"]
    xd, down = rows(64, cd), site(cd, kkd, k_sd)
    out.append(("down@64", lambda i, opts: k7.quantize_acts_split_t(
        xd[i % n_l], **down, sal_dtype=torch.bfloat16),
        k7.norm_quantize_acts_t_plain(xd[1], None, **down, norm_kind=None)))
    cb = 16384
    kkb, k_sb = -(-(cb - int(0.05 * cb)) // gs) * gs, -(-int(0.05 * cb) // 128) * 128
    w_b = (torch.rand(cb, generator=gen, device=dev) + 0.5)
    xb = rows(130, cb)
    bloom = site(cb, kkb, k_sb)
    out.append(("c16384@130", lambda i, opts: k7.norm_quantize_acts_t(
        xb[i % n_l], w_b, **bloom, eps=1e-5, norm_kind="rms", **opts),
        k7.norm_quantize_acts_t_plain(xb[1], w_b, **bloom, eps=1e-5, norm_kind="rms")))
    # K7b at 4 rows: the RMSNorm at Bloom's widest input, no norm there and at qkv's
    for case, xs4, w4, kw4, kind in (("c16384@4", rows(4, cb), [w_b] * n_l, bloom, "rms"),
                                     ("none16384@4", rows(4, cb), [w_b] * n_l, bloom, None),
                                     ("none@4", rows(4, c), w, qkv, None)):
        out.append((case, lambda i, opts, xs4=xs4, w4=w4, kw4=kw4, kind=kind:
                    k7.norm_quantize_acts_t(xs4[i % n_l], w4[i % n_l], **kw4, eps=1e-5,
                                            norm_kind=kind, **opts),
                    k7.norm_quantize_acts_t_plain(xs4[1], w4[1], **kw4, eps=1e-5,
                                                  norm_kind=kind)))
    wq = torch.randint(-128, 128, (n_l, kk // 2, o), generator=gen, device=dev,
                       dtype=torch.int8)
    ws = (torch.rand((n_l, kk // gs, o), generator=gen, device=dev) * 0.02 + 0.001
          ).to(torch.bfloat16)
    wsal = (torch.rand((n_l, k_s, o), generator=gen, device=dev) * 0.2 - 0.1
            ).to(torch.bfloat16)
    for n in (32, 64):
        xs = rows(n, c)
        kind = "rms" if n <= 32 else "rms_round"

        def prep(i, xs=xs, kind=kind):
            return k7.norm_quantize_acts_t(xs[i % n_l], w[i % n_l], **qkv, eps=1e-5,
                                           norm_kind=kind, sal_dtype=torch.bfloat16)

        def k5_on(i, ops, n=n):
            return k5.int4_group_matmul_stacked(i % n_l, ops[0], ops[1], wq, ws, ops[2][:n],
                                                wsal, group_size=gs, out_dtype=torch.bfloat16,
                                                pre_laid=n)

        ops = prep(1)
        ref = k5.int4_group_matmul_stacked_plain(1, ops[0], ops[1], wq, ws, ops[2][:n], wsal,
                                                 group_size=gs, out_dtype=torch.bfloat16,
                                                 pre_laid=n)
        out.append((f"pair@{n}", lambda i, opts, prep=prep, k5_on=k5_on: k5_on(i, prep(i)),
                    ref))
        out.append((f"k5@{n}", lambda i, opts, ops=ops, k5_on=k5_on: k5_on(i, ops), None))
    return out


def _held(got, ref):
    """K7's outputs against the plain version (codes identical or one off,
    scales within 1e-6 relative, x_sal within a bf16 rounding), K5's within
    1e-2 of the largest output."""
    if isinstance(got, tuple):
        codes = (got[0].int() - ref[0].int()).abs().max().item() <= 1
        scales = bool(((got[1] - ref[1]).abs() <= 1e-6 * ref[1].abs()).all())
        sal = bool(((got[2].float() - ref[2].float()).abs()
                    <= 2.0 ** -8 * ref[2].float().abs()).all())
        return codes and scales and sal
    return bool((got.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max())


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from smoothquant_tpu_torch.kernels import _build
    from smoothquant_tpu_torch.kernels import act_prep as k7

    if not torch.cuda.is_available():
        print("act_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    checks = "--checks" in argv
    names = [a for a in argv if a not in ("--checks", "base")] or list(VARIANTS) + list(HOST)
    unknown = set(names) - set(VARIANTS) - set(HOST)
    if unknown:
        print(f"act_variants: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    if checks:   # the SASS phase reads ptxas' notes of a build made in this process
        cached = _build.build()
        if not _build.build_log:
            os.remove(cached)
            _build.build()
    base = _build.lib()
    if checks:
        print(json.dumps({"phase": "sass", **{k: v for k, v in cs.sass_check().items()
                                              if k.startswith("k7")}}), flush=True)
        print(json.dumps({"phase": "k7_edges", **cs.check_k7_edges(dev)}), flush=True)
    built = build_all([n for n in names if n in VARIANTS], base)
    for name, (lib, err) in built.items():
        print(json.dumps({"variant": name, "built": lib is not None,
                          **({"error": err} if err else {})}), flush=True)
    built.update({n: (base, None) for n in names if n in HOST})
    todo = cases(dev)
    ok = [n for n in names if built[n][0] is not None]
    readings = {}
    plan = k7.k7_plan
    try:
        for name in ["base"] + ok + ok[::-1] + ["base"]:
            _build._lib = base if name == "base" else built[name][0]
            opts = dict(HOST.get(name, {}))
            rule = opts.pop("plan", None)
            if rule is not None:
                k7.k7_plan = lambda n, slots, rule=rule: rule(n, slots, plan(n, slots))
            for case, fn, ref in todo:
                if name != "base" and case not in READ_AT[name]:
                    continue
                r = readings.setdefault((name, case), {"ms": []})
                try:
                    if ref is not None and name not in ABLATIONS and "held" not in r:
                        got = fn(1, opts)
                        torch.cuda.synchronize()
                        r["held"] = _held(got, ref)
                    r["ms"].append(cs.device_ms(lambda i: fn(i, opts), 8)
                                   if r.get("held", True) else None)
                except (RuntimeError, ValueError) as e:
                    r["error"] = str(e)[:200]
            k7.k7_plan = plan
    finally:
        _build._lib = base
        k7.k7_plan = plan
    for (name, case), r in readings.items():
        print(json.dumps({"variant": name, "case": case, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

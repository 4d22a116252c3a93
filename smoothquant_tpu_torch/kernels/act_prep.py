"""Per-group activation quantize into K5's layout: K7a and K7b, each with
its plain PyTorch version.

K7a quantize_acts_grouped_t — port of smoothquant_tpu/kernels/act_prep.py:40
    (pallas_call :66).  x_ns (N, k_ns), the zero-padded non-salient slice →
    x3 (G, N_pad, gs) int8 and xs_t (G, N_pad) f32 with N_pad =
    max(8, ⌈N/8⌉·8): scale = max(absmax, 1e-5)/qmax (the f32 reciprocal
    multiply jitted XLA compiles the division to) and codes round(y / scale)
    half to even; zero rows quantize to 0 with the floor scale.
    quantize_acts_split_t is the same quantize with the salient split of
    K7b and no norm row: x (N, C) in the pack's channel order → x3 and xs_t
    over the k_ns non-salient columns and x_sal (N_pad, k_s), in one launch
    where the stacked path used to pad, quantize and pad again.
K7b norm_quantize_acts_t — port of act_prep.py:127 (pallas_call :182).
    x (N, C) bf16 / f32 in the pack's channel order (pre-norm), the norm
    weight (C,) → K7a's x3 and xs_t over the k_ns non-salient columns and
    x_sal (N_pad, k_s) in sal_dtype: y = (x·r)·w, r the row's RMSNorm
    factor ("rms", "rms_round") or 1 (None); columns at or past C −
    num_salient zeroed before the quantize; x_sal the num_salient normed
    tail columns, zero-padded to k_s.  "rms_round" rounds y to x's dtype
    before the quantize and the split: models.common.rms_norm exactly, what
    the stacked path's many-rows branch computes (the JAX package runs
    rms_norm there, then K7a).  r takes the port's rule (quant.core.
    rms_factor: Σx² in f64, 1/√v correctly rounded) — K1's pre-pass takes it
    too, so K7b → K5 and K1 quantize the same values on the card; the JAX
    kernel takes XLA's rsqrt, which may put r an ulp away and move a code on
    a rounding edge.

CUDA source: csrc/act_prep.cu, two bodies.  Every call takes the row body
(a row in registers over the warps, and for the widest rows the blocks of
a cluster, of k7_plan, its Σx² summed once; its
launches count under the kernel's name: K7a's for a call with no norm row,
K7b's for one with); the groups body (one warp a (row, group), the old
design) runs only when body="groups" forces it, to be timed beside the row
body, and counts under LAUNCH_KEYS.  The wrapper runs the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoothquant_tpu_torch.kernels import _build
from smoothquant_tpu_torch.quant.core import compute_scale, f32_reciprocal, qmax, rms_factor

NORM_KINDS = ("rms", "rms_round", None)
NORM_MODE = {None: 0, "rms": 1, "rms_round": 2}     # the row body's mode argument
BODIES = ("rows", "groups")
# the launch counter of each body of each kernel: the row body counts under
# the kernel's name, so a path that expects it proves the row body served it
LAUNCH_KEYS = {"quantize_acts_grouped_t": {"rows": "quantize_acts_grouped_t",
                                           "groups": "quantize_acts_grouped_t_groups"},
               "norm_quantize_acts_t": {"rows": "norm_quantize_acts_t",
                                        "groups": "norm_quantize_acts_t_groups"}}
CHUNKS = (1, 2, 4, 8)    # 8-column slots a lane of the row body holds at most (its builds)
LANE_CHUNKS = 2      # the slots a lane the plan aims at
MAX_WARPS = 16       # warps a block of the row body holds
MAX_PARTS = 8        # blocks of one cluster a row may take
SMS = 132            # streaming multiprocessors of an H100 SXM
GROUP_SIZES = (8, 16, 32, 64, 128, 256)   # a group is gs / 8 lanes of one warp


def padded_rows(n: int) -> int:
    """N_pad of K7a's layout."""
    return max(8, -(-n // 8) * 8)


def row_slots(c: int, k_ns: int, k_s: int) -> tuple[int, int, int]:
    """The row body's 8-column slots of a row: (the k_ns / 8 quantize chunks,
    then the chunks of the columns past k_ns that Σx² needs, then the x_sal
    chunks) as their three ends."""
    q8 = k_ns // 8
    qe = max(q8, -(-c // 8))
    return q8, qe, qe + -(-k_s // 8)


def k7_plan(n: int, slots: int) -> tuple[int, int, int, int]:
    """The row body's (warps a block W, rows a block R, blocks a row P, slots
    a lane at most) for n rows of `slots` slots: W the least power of two,
    up to MAX_WARPS, whose lanes take the row's slots at most LANE_CHUNKS
    each (a short chain a lane); a wider row over P blocks of a cluster
    (the Σx² met through distributed shared memory), the least that keeps
    LANE_CHUNKS slots a lane while the n·P blocks leave SMs to spare, else
    more slots a lane; one row a block; the least build in CHUNKS that
    covers it.  Measured on an H100 (scripts/act_variants.py): fewer warps
    slower at 8-64 rows (warps_least), packing rows slower at 64 and 2048
    (rows_r2, rows_r4), two blocks a row faster at down's C = 11008 and 64
    rows and at 16384 and 4 rows, one faster at 16384 and 130 rows and at
    4096 with the RMSNorm (parts1, parts2, parts4)."""
    w = 1
    while w < MAX_WARPS and 32 * w * LANE_CHUNKS < slots:
        w *= 2
    p = 1
    while p < MAX_PARTS and 32 * w * p * LANE_CHUNKS < slots and n * 2 * p <= SMS:
        p *= 2
    need = -(-slots // (32 * w * p))
    ch = next((c for c in CHUNKS if c >= need), None)
    if ch is None:
        raise ValueError(f"K7's row body holds {32 * w * p * CHUNKS[-1]} slots of 8 columns "
                         f"a row, not {slots}")
    return w, 1, p, ch


def quantize_acts_grouped_t_plain(x_ns: torch.Tensor, *, group_size: int,
                                  act_bits: int):
    """Plain PyTorch K7a (same arguments as the wrapper)."""
    n, k_ns = x_ns.shape
    g = k_ns // group_size
    n_pad = padded_rows(n)
    xf = torch.nn.functional.pad(x_ns.float(), (0, 0, 0, n_pad - n))
    blk = xf.reshape(n_pad, g, group_size).transpose(0, 1)      # (G, N_pad, gs)
    scale = compute_scale(blk.abs().amax(dim=-1, keepdim=True), act_bits)
    return torch.round(blk / scale).to(torch.int8), scale[..., 0]


def norm_quantize_acts_t_plain(x_perm: torch.Tensor, norm_w: Optional[torch.Tensor], *,
                               group_size: int, act_bits: int, k_ns: int,
                               num_salient: int, k_s: int, eps: float = 0.0,
                               norm_kind: Optional[str] = "rms",
                               sal_dtype=torch.bfloat16):
    """Plain PyTorch K7b (same arguments as the wrapper); with no norm row
    (norm_w None, norm_kind None) K7a's quantize with the salient split."""
    if norm_kind not in NORM_KINDS:
        raise ValueError(f"norm_kind {norm_kind!r}: one of {NORM_KINDS}")
    if norm_kind is not None and norm_w is None:
        raise ValueError(f"norm_kind {norm_kind!r} needs a norm row")
    n, c = x_perm.shape
    k_ns_raw = c - num_salient
    n_pad = padded_rows(n)
    p = max(c, k_ns)
    xf = torch.nn.functional.pad(x_perm.float(), (0, p - c, 0, n_pad - n))
    if norm_kind is not None:
        xf = xf * rms_factor(xf[:, :c], eps)
    y = xf if norm_w is None else xf * torch.nn.functional.pad(norm_w.float(), (0, p - c))
    if norm_kind == "rms_round":
        y = y.to(x_perm.dtype).float()
    x3, xs_t = quantize_acts_grouped_t_plain(
        torch.where(torch.arange(p, device=y.device) < k_ns_raw, y, 0.0)[:, :k_ns],
        group_size=group_size, act_bits=act_bits)
    x_sal = torch.zeros((n_pad, k_s), dtype=torch.float32, device=x_perm.device)
    if k_s:
        x_sal[:, :num_salient] = y[:, k_ns_raw:c]
    return x3, xs_t, x_sal.to(sal_dtype)


def row_args(x: torch.Tensor, norm_w: Optional[torch.Tensor], *, group_size: int,
             act_bits: int, k_ns: int, num_salient: int, k_s: int,
             norm_kind: Optional[str], body: str = "rows") -> None:
    """Raise on what the kernels do not take (the CUDA path's checks, before
    any launch): a group of gs / 8 lanes of one warp (the groups body: any
    group size up to 128), 2-8 bits, whole groups, the salient tail inside
    C and k_s, a norm row of C values for a norm, a row that fits the row
    body's registers."""
    if norm_kind not in NORM_KINDS:
        raise ValueError(f"norm_kind {norm_kind!r}: one of {NORM_KINDS}")
    if body not in BODIES:
        raise ValueError(f"K7 has no {body!r} body")
    n, c = x.shape
    if n < 1:
        raise ValueError("K7 takes at least one row")
    if body == "rows" and group_size not in GROUP_SIZES:
        raise ValueError(f"K7's row body takes group sizes {GROUP_SIZES}, not {group_size}")
    if k_ns % group_size or group_size > (256 if body == "rows" else 128):
        raise ValueError(f"K7 needs whole groups: k_ns {k_ns}, group size {group_size}")
    if not 2 <= act_bits <= 8:
        raise ValueError(f"K7 quantizes to 2..8 bits, not {act_bits}")
    if not (0 <= num_salient < c and c - num_salient <= k_ns
            and (k_s == 0 or num_salient <= k_s)):
        raise ValueError(f"K7: {num_salient} salient of {c} channels do not fit "
                         f"k_ns {k_ns} and k_s {k_s}")
    if norm_kind is not None and norm_w is None:
        raise ValueError(f"norm_kind {norm_kind!r} needs a norm row")
    if norm_w is not None and tuple(norm_w.shape) != (c,):
        raise ValueError(f"norm weight {tuple(norm_w.shape)} != ({c},)")
    if body == "groups" and (norm_kind == "rms_round" or (norm_w is None and num_salient)):
        raise ValueError("K7's groups body takes no 'rms_round' and no salient split "
                         "without a norm row")
    if body == "rows":
        k7_plan(n, row_slots(c, k_ns, k_s)[2])


def _launch_rows(x, norm_w, *, group_size, act_bits, k_ns, num_salient, k_s, eps,
                 norm_kind, sal_dtype, key):
    """One launch of the row body (arguments checked by row_args)."""
    n, c = x.shape
    dev = x.device
    if x.stride(1) != 1 or (n > 1 and x.stride(0) < c):
        x = x.contiguous()
    ld = x.stride(0) if n > 1 else c     # rows may lie apart (a column slice)
    if norm_w is not None:
        norm_w = norm_w.float()
        _build.check_operands(dev, norm_w=norm_w)
    n_pad, g = padded_rows(n), k_ns // group_size
    w, r, p, ch = k7_plan(n, row_slots(c, k_ns, k_s)[2])
    x3 = torch.empty((g, n_pad, group_size), dtype=torch.int8, device=dev)
    xs_t = torch.empty((g, n_pad), dtype=torch.float32, device=dev)
    x_sal = torch.empty((n_pad, k_s), dtype=sal_dtype, device=dev)
    _build.check(_build.lib().sq_act_rows(
        x.data_ptr(), 0 if norm_w is None else norm_w.data_ptr(), x3.data_ptr(),
        xs_t.data_ptr(), x_sal.data_ptr(), n, n_pad, c, ld, k_ns, group_size,
        num_salient, k_s, NORM_MODE[norm_kind], w, r, p, ch, float(eps), f32_reciprocal(c),
        f32_reciprocal(qmax(act_bits)), _build.dt_code(x), _build.dt_code(x_sal),
        _build.stream_ptr(x)), "sq_act_rows")
    _build.LAUNCHES[key] += 1
    return x3, xs_t, x_sal


def quantize_acts_grouped_t(x_ns: torch.Tensor, *, group_size: int, act_bits: int,
                            body: str = "rows"):
    """(x3 (G, N_pad, gs) int8, xs_t (G, N_pad) f32) of x_ns (N, k_ns);
    body="groups" forces the one-warp-a-group body."""
    if x_ns.device.type == "cpu":
        return quantize_acts_grouped_t_plain(x_ns, group_size=group_size,
                                             act_bits=act_bits)
    n, k_ns = x_ns.shape
    kw = dict(group_size=group_size, act_bits=act_bits, k_ns=k_ns, num_salient=0, k_s=0)
    row_args(x_ns, None, **kw, norm_kind=None, body=body)
    if x_ns.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_ns.device}")
    key = LAUNCH_KEYS["quantize_acts_grouped_t"][body]
    if body == "rows":
        return _launch_rows(x_ns, None, **kw, eps=0.0, norm_kind=None,
                            sal_dtype=torch.float32, key=key)[:2]
    x_ns = x_ns.contiguous()
    n_pad, g = padded_rows(n), k_ns // group_size
    x3 = torch.empty((g, n_pad, group_size), dtype=torch.int8, device=x_ns.device)
    xs_t = torch.empty((g, n_pad), dtype=torch.float32, device=x_ns.device)
    _build.check(_build.lib().sq_quantize_grouped_t(
        x_ns.data_ptr(), x3.data_ptr(), xs_t.data_ptr(), n, n_pad, k_ns, group_size,
        f32_reciprocal(qmax(act_bits)), _build.dt_code(x_ns), _build.stream_ptr(x_ns)),
        "sq_quantize_grouped_t")
    _build.LAUNCHES[key] += 1
    return x3, xs_t


def quantize_acts_split_t(x: torch.Tensor, *, group_size: int, act_bits: int, k_ns: int,
                          num_salient: int, k_s: int, sal_dtype=torch.bfloat16):
    """K7a with the salient split, on the row body: (x3, xs_t, x_sal
    (N_pad, k_s) sal_dtype) of x (N, C) in the pack's channel order — the
    quantize of its first C − num_salient columns zero-padded to k_ns, and
    its last num_salient columns zero-padded to k_s."""
    kw = dict(group_size=group_size, act_bits=act_bits, k_ns=k_ns,
              num_salient=num_salient, k_s=k_s)
    if x.device.type == "cpu":
        return norm_quantize_acts_t_plain(x, None, **kw, norm_kind=None, sal_dtype=sal_dtype)
    row_args(x, None, **kw, norm_kind=None)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _launch_rows(x, None, **kw, eps=0.0, norm_kind=None, sal_dtype=sal_dtype,
                        key=LAUNCH_KEYS["quantize_acts_grouped_t"]["rows"])


def norm_quantize_acts_t(
    x_perm: torch.Tensor,     # (N, C) pre-norm activations, the pack's channel order
    norm_w: torch.Tensor,     # (C,) norm weight in the same order
    *,
    group_size: int,
    act_bits: int,
    k_ns: int,
    num_salient: int,
    k_s: int,
    eps: float,
    norm_kind: Optional[str] = "rms",
    sal_dtype=torch.bfloat16,
    body: str = "rows",       # "groups" forces the one-warp-a-group body
):
    """(x3 (G, N_pad, gs) int8, xs_t (G, N_pad) f32, x_sal (N_pad, k_s)
    sal_dtype) of x_perm; see the module docstring."""
    kw = dict(group_size=group_size, act_bits=act_bits, k_ns=k_ns,
              num_salient=num_salient, k_s=k_s)
    if norm_w is None:
        raise ValueError("K7b takes a norm row (quantize_acts_split_t takes none)")
    if x_perm.device.type == "cpu":
        return norm_quantize_acts_t_plain(x_perm, norm_w, **kw, eps=eps, norm_kind=norm_kind,
                                          sal_dtype=sal_dtype)
    row_args(x_perm, norm_w, **kw, norm_kind=norm_kind, body=body)
    if x_perm.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_perm.device}")
    key = LAUNCH_KEYS["norm_quantize_acts_t"][body]
    if body == "rows":
        return _launch_rows(x_perm, norm_w, **kw, eps=eps, norm_kind=norm_kind,
                            sal_dtype=sal_dtype, key=key)
    n, c = x_perm.shape
    x_perm, norm_w = x_perm.contiguous(), norm_w.float().contiguous()
    _build.check_operands(x_perm.device, norm_w=norm_w)
    n_pad, g = padded_rows(n), k_ns // group_size
    dev = x_perm.device
    x3 = torch.empty((g, n_pad, group_size), dtype=torch.int8, device=dev)
    xs_t = torch.empty((g, n_pad), dtype=torch.float32, device=dev)
    x_sal = torch.empty((n_pad, k_s), dtype=sal_dtype, device=dev)
    _build.check(_build.lib().sq_norm_quantize_t(
        x_perm.data_ptr(), norm_w.data_ptr(), x3.data_ptr(), xs_t.data_ptr(),
        x_sal.data_ptr(), n, n_pad, c, k_ns, group_size, num_salient, k_s,
        int(norm_kind == "rms"), float(eps), f32_reciprocal(qmax(act_bits)),
        _build.dt_code(x_perm), _build.dt_code(x_sal), _build.stream_ptr(x_perm)),
        "sq_norm_quantize_t")
    _build.LAUNCHES[key] += 1
    return x3, xs_t, x_sal

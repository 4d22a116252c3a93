"""Host-side rules of the warp-specialized s8 wgmma GEMM body
(csrc/wg_s8_gemm.cuh) that K4 (int8_prefill.py) and K15a (int8.py) share:
the stages a tile streams, the persistent grid, the order in which its
blocks take the tiles, and the body's int32 → f32 conversion written in
PyTorch.  Plain Python on shapes, so the CPU tests hold them; the shape
rules that pick the body live beside each wrapper
(int8_prefill.prefill_body, int8.linear_body).
"""

from __future__ import annotations

import torch

BM = 128          # tile rows: two consumer warpgroups of 64
SAL_BN = 128      # tile columns beside K4's salient accumulator
WIDE_BN = 256     # tile columns without one (K15a, K4's lm_head)
KB = 128          # k bytes an int8 stage takes
SAL_K = 64        # salient k a bf16 stage takes


def tile_cols(k_s: int) -> int:
    """Columns of a tile: SAL_BN with salient channels, else WIDE_BN."""
    return SAL_BN if k_s else WIDE_BN


def stages(kk: int, k_s: int) -> tuple[int, int]:
    """(salient stages, int8 stages) of one tile: k_s salient channels in
    stages of SAL_K, K bytes in stages of KB (TMA zero-fills the tails)."""
    return -(-k_s // SAL_K), -(-kk // KB)


def tiles(n: int, o: int, bn: int) -> tuple[int, int]:
    """(row tiles, column tiles) of an (n, o) output."""
    return -(-n // BM), -(-o // bn)


def magic(d: int) -> int:
    """ceil(2^32 / d): x // d as umulhi(x, magic(d)) where fast_div_ok."""
    return (2 ** 32 + d - 1) // d


def fast_div_ok(d: int, x_max: int) -> bool:
    """Whether umulhi(x, magic(d)) == x // d for every x <= x_max."""
    return x_max * (magic(d) * d - 2 ** 32) < 2 ** 32


def tile_of(t: int, tiles_m: int, bn: int) -> tuple[int, int]:
    """(first row, first column) of tile t: row tile t % tiles_m (fastest),
    column tile t // tiles_m, the division by the kernel's magic multiply."""
    tn = t if tiles_m == 1 else (t * magic(tiles_m)) >> 32
    return (t - tn * tiles_m) * BM, tn * bn


def blocks(n: int, o: int, sms: int, bn: int) -> int:
    """The persistent grid: one block an SM, at most one a tile."""
    tm, tn = tiles(n, o, bn)
    return min(tm * tn, sms)


def tile_walk(n: int, o: int, grid: int, bn: int) -> list[list[tuple[int, int]]]:
    """The tiles each of `grid` blocks computes, in its order: block b takes
    tiles b, b + grid, ... (s8_consume and s8_produce walk the same list)."""
    tm, tn = tiles(n, o, bn)
    if tm > 1 and not fast_div_ok(tm, tm * tn):
        raise ValueError(f"no exact magic for {tm} row tiles over {tm * tn} tiles")
    return [[tile_of(t, tm, bn) for t in range(b, tm * tn, grid)] for b in range(grid)]


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def s32_f32_rn(acc: torch.Tensor) -> torch.Tensor:
    """f32(acc) of int32 acc as the body converts it (wg_gemm.cuh
    s32_f32_rn, no I2F): the high 16 bits under the exponent of 1.5·2^23,
    the low 16 under 2^23 — each exact in f32 — joined by one fma, which
    rounds hi·2^16 + lo = acc once, to nearest even (the f64 sum is exact)."""
    a = acc.to(torch.int64)
    hi = ((a >> 16) + 0x4B400000).to(torch.int32).view(torch.float32) - 12582912.0
    lo = ((a & 0xFFFF) | 0x4B000000).to(torch.int32).view(torch.float32) - 8388608.0
    return (hi.double() * 65536.0 + lo.double()).float()

"""Host-side rules of the weight-streaming body (csrc/stream_gmm.cuh) and
its five weight kinds — K8's int8 containers, K5's nibbles, K13's bf16 slab,
K1's nibbles on raw x and K15a's (O, K) int8 rows: the stages a call
streams, how a 128-column
tile's stages split over the ranks of a thread-block cluster, K1's shared
memory, the paired column map and epilogue shares of K14's gate_up launch
(K1's kind with gate and up halves), and the body's int32 →
f32 conversion and nibble operand written in PyTorch.  Plain Python on
shapes, so the CPU tests hold them; the shape rules that pick the body live
beside each wrapper (int_group_matmul.int_gmm_body,
int4_group_matmul.stacked_body and rawx_body, fp_matmul.fp_body,
int8.linear_body).
"""

from __future__ import annotations

import torch

MAX_ROWS = 64          # token rows the body takes: 8 n8 tiles
TILE_COLS = 128        # output columns of a block tile
MAX_BLOCKS = 132       # blocks a call launches at most: one an SM (H100 SXM)
SPLITS = (1, 2, 4, 8)  # ranks of a cluster (8: the portable cluster size)
MIN_STAGES = 2         # stages each rank streams at least
MAGIC_BITS = 0x4B400000   # the f32 bits of 1.5·2^23
MAGIC = 12582912.0
K13_ROWS = 8           # token rows K13's kind takes (one n8 tile)
K1_ROWS = 32           # token rows K1's kind takes (4 n8 tiles)
SMEM_MAX = 232448      # a block's dynamic shared memory at most (227 KB)


def k8_stages(kk: int, k_s: int, bf16: bool) -> int:
    """K8's stages: 128 weight rows a group stage, and 64 salient rows a
    salient stage where the salient dot runs on the tensor cores (bf16; the
    f32 dot runs on the CUDA cores beside the ring)."""
    return -(-kk // 128) + (-(-k_s // 64) if bf16 else 0)


def k5_stages(kk: int, group_size: int, k_s: int, bf16: bool) -> int:
    """K5's stages: one group pair (group_size packed rows) a group stage,
    32 salient rows a bf16 salient stage."""
    return kk // group_size // 2 + (-(-k_s // 32) if bf16 else 0)


def k13_kb(o: int, kk: int) -> int:
    """Weight rows of a K13 stage: 64, or 32 where the 128-column tiles
    outnumber the SMs or leave room for a split over K (finer stages
    measured faster there: scripts/stream_variants.py k13_kb32)."""
    tiles = -(-o // TILE_COLS)
    return 64 if tiles <= MAX_BLOCKS < 2 * tiles else 32


def k13_stages(kk: int, kb: int = 64) -> int:
    """K13's stages: kb weight rows (and the x tile of those k) each."""
    return -(-kk // kb)


def k15_stages(kk: int) -> int:
    """K15a's stages: 128 bytes of K each (a box of 128 weight rows × 128
    bytes and the x tile of those k)."""
    return -(-kk // 128)


K14_HALF = 64          # gate (and up) columns a tile of K14's gate_up launch takes


def k14_tiles(inter: int) -> int:
    """Tiles of K14's gate_up launch (stream_swiglu_kernel): one for each 64
    channels of down's input, i.e. each 64 gate columns."""
    return -(-inter // K14_HALF)


def k14_columns(tile: int, inter: int) -> tuple[range, range]:
    """The paired column map: the gate_up columns tile `tile` streams as its
    two 64-column halves — gate 64t .. 64t + 63 and up inter + 64t .. (the
    [gate | up] columns split at the true intermediate width), so down's
    input channel c = 64t + i finds gate[c] in column i of the block's
    tile and up[c] in column 64 + i."""
    c0 = K14_HALF * tile
    return range(c0, c0 + K14_HALF), range(inter + c0, inter + c0 + K14_HALF)


def k14_c_end(inter: int, kk2: int, k_ns2_raw: int, xsal_rs: int, k_s2: int) -> int:
    """The channel the last tile's epilogue covers up to (a multiple of 64):
    past inter it writes zero codes up to down's padded width kk2 and zero
    salient columns up to k_ns2_raw + xsal_rs, reading no partial."""
    end = max(K14_HALF * k14_tiles(inter), -(-kk2 // K14_HALF) * K14_HALF)
    if k_s2:
        end = max(end, -(-(k_ns2_raw + xsal_rs) // K14_HALF) * K14_HALF)
    return end


def k14_shares(tile: int, n_tiles: int, c_end: int, group_size: int,
               n_split: int) -> list[list[tuple[int, int]]]:
    """Each cluster rank's share of tile `tile`'s epilogue (sw_epilogue):
    items (first channel of a group of down's input, row), the rows padded
    to 8, items in (64-channel segment, group, row) order, split into
    contiguous shares (rank · items) >> lg .. — whole groups, so no group's
    absmax spans two ranks."""
    segs = (c_end - K14_HALF * tile) // K14_HALF if tile == n_tiles - 1 else 1
    items, lg = segs * (K14_HALF // group_size) * 8, n_split.bit_length() - 1
    return [[(K14_HALF * tile + (it >> 3) * group_size, it & 7)
             for it in range((r * items) >> lg, ((r + 1) * items) >> lg)]
            for r in range(n_split)]


def tiles_for(n: int) -> int:
    """n8 token tiles of the padded width 8·NT the body gives n rows."""
    return 1 if n <= 8 else 2 if n <= 16 else 4 if n <= 32 else 8


def k1_smem(n: int, group_size: int, sal_stages: int) -> int:
    """K1's dynamic shared memory (SrGeo::smem): the ring (6 slots) — a
    slot holds a pair's nibbles, its column scales, the
    raw x tiles and norm rows of its two groups, their codes and scales —
    two copies of the rows' RMS factors, three mbarriers a slot, then the
    salient tiles (N_BOX rows of 32 bf16) of a rank's salient stages."""
    n_box, stages = 8 * tiles_for(n), 6
    x_tile, nw_tile, c_tile = 2 * n_box * group_size, max(4 * group_size, 128), n_box * group_size
    slot = -(-(8192 + 1024 + 2 * x_tile + 2 * nw_tile + 2 * c_tile + 8 * n_box) // 1024) * 1024
    off_bar = stages * slot + 8 * n_box
    off_sal = -(-(off_bar + 24 * stages) // 128) * 128
    return off_sal + sal_stages * 64 * n_box


def k1_split(o: int, stages: int, n: int, group_size: int, sal_stages: int):
    """K1's ranks: split's, or more where the salient tiles of a rank would
    not fit a block's shared memory; None where no split of SPLITS makes
    them fit."""
    c = split(o, stages)
    while k1_smem(n, group_size, min(sal_stages, -(-stages // c))) > SMEM_MAX:
        more = [s for s in SPLITS if s > c and stages >= s * MIN_STAGES]
        if not more:
            return None
        c = more[0]
    return c


def split(o: int, stages: int) -> int:
    """Ranks a tile's stages split into: the most of SPLITS that keep the
    blocks within MAX_BLOCKS and MIN_STAGES stages on each rank (1 where
    the tiles alone fill the card).  A block streams its range through a
    ring deep enough that one an SM reads at the card's rate; more blocks
    only add ring fills and a second wave."""
    tiles = -(-o // TILE_COLS)
    fits = [c for c in SPLITS if tiles * c <= MAX_BLOCKS and stages >= c * MIN_STAGES]
    return max(fits, default=1)


def exact_f32(p: torch.Tensor) -> torch.Tensor:
    """f32(p) of int32 p as the body converts it, with no int → float
    conversion: the mma's accumulator starts at MAGIC_BITS, which puts p
    under the exponent of 1.5·2^23 (exact for |p| < 2^22), and one f32
    subtract of 1.5·2^23 leaves its value."""
    bits = (p.to(torch.int32) + MAGIC_BITS).to(torch.int32)
    return bits.view(torch.float32) - MAGIC


def nibble_s8(packed: torch.Tensor, half: int) -> torch.Tensor:
    """The s8 operand the body makes of split-half nibble bytes: the low
    (half 0) or high (half 1) nibble b moved to the byte's top four bits
    with its top bit flipped, i.e. 16·(b − 8) — so the int8 products carry
    no −8·Σx bias term, and the activation scale divided by 16 (exact)
    takes the ×16 back out."""
    u = packed.to(torch.int32) & 0xFF
    top = (u << 4 if half == 0 else u) & 0xF0
    return ((top ^ 0x80) - 256 * ((top ^ 0x80) >> 7)).to(torch.int8)

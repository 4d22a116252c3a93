"""Host-side rules of the weight-streaming body K8 and K5 share
(csrc/stream_gmm.cuh): the stages a call streams, how a 128-column tile's
stages split over the ranks of a thread-block cluster, and the body's
int32 → f32 conversion and nibble operand written in PyTorch.  Plain Python on shapes, so the
CPU tests hold them; the shape rules that pick the body live beside each
wrapper (int_group_matmul.int_gmm_body, int4_group_matmul.stacked_body).
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


def k8_stages(kk: int, k_s: int, bf16: bool) -> int:
    """K8's stages: 128 weight rows a group stage, and 64 salient rows a
    salient stage where the salient dot runs on the tensor cores (bf16; the
    f32 dot runs on the CUDA cores beside the ring)."""
    return -(-kk // 128) + (-(-k_s // 64) if bf16 else 0)


def k5_stages(kk: int, group_size: int, k_s: int, bf16: bool) -> int:
    """K5's stages: one group pair (group_size packed rows) a group stage,
    32 salient rows a bf16 salient stage."""
    return kk // group_size // 2 + (-(-k_s // 32) if bf16 else 0)


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

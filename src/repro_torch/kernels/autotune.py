"""Launch geometry of the three Hopper kernels, re-derived for an H100.

The reference (`repro/kernels/autotune.py`) budgets TPU VMEM and 128-lane
tiles. On Hopper the scarce things are different: shared memory per CTA
(48 KB static, up to 227 KB dynamic), registers per thread, and enough CTAs
in flight to cover 132 SMs. This module holds only what the port's kernels
and plain versions need:

  gemv_splits       split-K count of the decode GeMV: one CTA owns
                    GEMV_COLS columns, so narrow outputs (N = 1024 gives 8
                    column blocks) split K until >= 2 CTAs per SM are in
                    flight; the f32 partials are summed by a second,
                    deterministic pass
  attention_smem    shared bytes of one paged-attention CTA (slot, KV head):
                    one page's stored K and V bytes, the same decoded to f32,
                    plus the g query rows, scores and accumulators
  select_block      largest divisor helper (the plain GeMV's column tiles)
"""
from __future__ import annotations

import math

SM_COUNT = 132            # H100 SXM streaming multiprocessors
GEMV_COLS = 128           # output columns per GeMV CTA (one per thread)
GEMV_MAX_SPLITS = 64
MAX_SMEM = 227 * 1024     # per-CTA ceiling on Hopper


def divisors(n: int):
    """All divisors of n, ascending (O(sqrt n))."""
    small, large = [], []
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
    return small + large[::-1]


def select_block(n: int, target: int) -> int:
    """Largest divisor of `n` that is <= `target` (>= 1)."""
    if n <= 0:
        raise ValueError(f"dimension must be positive, got {n}")
    best = 1
    for d in divisors(n):
        if d > max(1, target):
            break
        best = d
    return best


def gemv_splits(n: int, n_groups: int) -> int:
    """Split-K count for an (M <= 32, K) x (K, N) GeMV: enough CTAs for two
    per SM, each split keeping at least one compression group."""
    col_blocks = -(-n // GEMV_COLS)
    want = max(1, min(-(-2 * SM_COUNT // col_blocks), n_groups, GEMV_MAX_SPLITS))
    per = -(-n_groups // want)  # groups per split; every split owns >= 1
    return -(-n_groups // per)


def attention_smem(block_size: int, d_head: int, group: int, row_bytes: int) -> int:
    """Shared bytes of one paged-attention CTA (see csrc/paged_attention.cu):
    the page's stored K and V rows (`row_bytes` per token), K and V decoded
    to f32 rows padded by one word, query rows, accumulators, scores,
    (m, l, alpha) per query head, and per-token scales and positions."""
    floats = (
        2 * block_size * (d_head + 1)
        + 2 * group * d_head
        + group * block_size
        + 3 * group
        + 2 * block_size
    )
    return 4 * floats + 4 * block_size + 2 * block_size * row_bytes

"""Launch geometry of the Hopper kernels, re-derived for an H100.

The reference (`repro/kernels/autotune.py`) budgets TPU VMEM and 128-lane
tiles. On Hopper the scarce things are different: shared memory per CTA
(48 KB static, up to 227 KB dynamic), registers per thread, and enough CTAs
in flight to cover 132 SMs. This module holds only what the port's kernels
and plain versions need:

  gemv_splits       split-K count of the decode GeMV: one CTA owns
                    GEMV_COLS columns, so narrow outputs (N = 1024 gives 8
                    column blocks) split K until >= 2 CTAs per SM are in
                    flight; the f32 partials are summed by a second,
                    deterministic pass (none with one split)
  gemv_plan         the GeMV's whole launch plan: splits, the compression
                    groups a stage of its shared-memory ring holds, and the
                    CTA's dynamic shared bytes (gemv_smem_bytes, the sum
                    csrc/deca_gemm.cu's `layout` carves and checks)
  attention_splits  split-KV plan of the paged-attention decode, from the
                    shapes alone (MB, B, Hkv): enough splits of the page
                    walk for a grid of ATTENTION_CTAS_PER_SM CTAs per SM,
                    each split at least one page, so that several CTAs an
                    SM wait on page loads at once. At 4 slots of llama3-8b
                    that is 32 splits of 2 pages (1024 CTAs)
  select_block      largest divisor helper (the plain GeMV's column tiles)
"""
from __future__ import annotations

import functools
import math

SM_COUNT = 132            # H100 SXM streaming multiprocessors
GEMV_COLS = 128           # output columns per GeMV CTA (two threads each)
GEMV_MAX_SPLITS = 64
GEMV_CTAS_PER_SM = 2      # split-K aims at this many GeMV CTAs an SM
GEMV_MB = (1, 2, 4, 8, 16, 32)  # row buckets the GeMV is instantiated for
GEMV_MAX_CHUNK = 8        # compression groups a GeMV ring stage holds, at most
GEMV_CODE_STAGE = 16384   # code bytes a stage holds, at most
GEMV_X_STAGE = 8192       # f32 x bytes a stage holds, at most
ATTENTION_CTAS_PER_SM = 8  # split-KV grid size over the SM count (4 fit an SM at once)


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
    """Split-K count for an (M <= 32, K) x (K, N) GeMV: enough CTAs for
    GEMV_CTAS_PER_SM per SM, each split keeping at least one compression
    group."""
    col_blocks = -(-n // GEMV_COLS)
    want = max(1, min(-(-GEMV_CTAS_PER_SM * SM_COUNT // col_blocks), n_groups,
                      GEMV_MAX_SPLITS))
    per = -(-n_groups // want)  # groups per split; every split owns >= 1
    return -(-n_groups // per)


def gemv_mb(m: int) -> int:
    """The row bucket (instance) of the GeMV for M rows of x."""
    return next(b for b in GEMV_MB if m <= b)


def gemv_smem_bytes(chunk: int, ck: int, mb: int, sparse: bool, scale_bytes: int) -> int:
    """Dynamic shared bytes of a GeMV CTA: two ring stages, each the code
    rows (chunk ck x GEMV_COLS bytes), mask words, scale bits and x
    (chunk 32 x mb f32), planes 16-byte aligned; the halves' partial sums
    reuse the ring; then a 16-float nibble table."""
    a16 = lambda b: -(-b // 16) * 16
    stage = (a16(chunk * ck * GEMV_COLS) + (chunk * GEMV_COLS * 4 if sparse else 0)
             + a16(chunk * GEMV_COLS * scale_bytes) + chunk * 32 * mb * 4)
    return max(2 * stage, GEMV_COLS * mb * 4) + 16 * 4


@functools.lru_cache(maxsize=None)
def gemv_plan(n: int, n_groups: int, m: int, ck: int, sparse: bool, scale_bytes: int):
    """(splits, chunk groups, shared bytes) of a GeMV launch, from shapes
    alone. A stage holds at most GEMV_MAX_CHUNK groups, GEMV_CODE_STAGE
    code bytes and GEMV_X_STAGE bytes of x, and at least one group."""
    mb = gemv_mb(m)
    chunk = max(1, min(GEMV_MAX_CHUNK, GEMV_X_STAGE // (32 * mb * 4),
                       GEMV_CODE_STAGE // (ck * GEMV_COLS)))
    return (gemv_splits(n, n_groups), chunk,
            gemv_smem_bytes(chunk, ck, mb, sparse, scale_bytes))


def attention_splits(mb: int, batch: int, kv_heads: int):
    """(splits, pages per split) of the split-KV walk over a block table of
    `mb` pages: ATTENTION_CTAS_PER_SM CTAs per SM over the (KV head, slot,
    split) grid, each split at least one page, every page in exactly one
    split. Shapes only: the slots' lengths stay on the device."""
    ctas = ATTENTION_CTAS_PER_SM * SM_COUNT
    want = max(1, min(mb, -(-ctas // max(1, batch * kv_heads))))
    pps = -(-mb // want)
    return -(-mb // pps), pps

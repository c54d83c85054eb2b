"""Block-paged KV cache: host-side free-list allocator and per-request block
tables over the device pools built by `Model.init_paged_cache`.

Counterpart of the base path of `repro/serve/paged_cache.py` and of its
speculative-decode rollback (the prefix index, park and the host tier are
later ROADMAP items). Layout:
per attention layer one (num_blocks+1, block_size, Hkv, W) pool for K and V
plus a (num_blocks+1, block_size) position plane. Device page 0 is the null
page: pad and inactive-slot writes land there with the empty-position
sentinel. Allocator page `a` is device page `a + 1`.

A request at length `len` holds exactly ceil(len / block_size) pages.
Admission reserves its worst-case page count up front, so lazy per-step
allocation never deadlocks mid-flight; allocating past the reservation is an
accounting bug and raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Set

import numpy as np
import torch


class BlockAllocator:
    """LIFO free-list over `num_blocks` page ids [0, num_blocks). Freeing a
    page that is not held is a double-free and raises. (The reference
    refcounts pages for its prefix cache, ROADMAP Queue A item 5; without
    one every page has exactly one holder.)"""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"need at least one block, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._held: Set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._held)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV pool exhausted (admission should prevent this)")
        b = self._free.pop()
        self._held.add(b)
        return b

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._held:
                raise ValueError(f"double-free / foreign block {b}")
            self._held.remove(b)
            self._free.append(b)


class PagedKVCache:
    """Block tables + device pools for one serving engine instance."""

    def __init__(
        self,
        model: Any,
        *,
        num_blocks: int,
        block_size: int,
        device="cuda",
        dtype=torch.bfloat16,
    ):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.kv_quant = model.cfg.kv_quant
        self.allocator = BlockAllocator(num_blocks)
        self.pools = model.init_paged_cache(
            num_blocks, block_size, device=device, dtype=dtype
        )
        self._tables: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        self._fresh: List[int] = []  # device pages allocated since last drain

    # -- admission accounting ------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    def bytes_per_token(self) -> float:
        """Pool bytes one KV token slot costs across all layers: codes,
        codec scale planes and the position plane."""
        total = sum(
            t.numel() * t.element_size() for pool in self.pools for t in pool.values()
        )
        return total / ((self.num_blocks + 1) * self.block_size)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_count

    @property
    def reserved_blocks(self) -> int:
        """Pages promised to admitted requests but not yet allocated."""
        return sum(self._reserved.values())

    def can_admit(self, kv_len: int) -> bool:
        return self.free_blocks - self.reserved_blocks >= self.blocks_for(kv_len)

    def admit(self, rid: int, kv_len: int) -> int:
        """Admit a request and reserve pages for its worst case. Returns
        the prompt tokens already in the pool (0: no prefix cache yet)."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already admitted")
        need = self.blocks_for(kv_len)
        if need > self.free_blocks - self.reserved_blocks:
            raise RuntimeError(f"admitting request {rid} would oversubscribe the pool")
        self._tables[rid] = []
        self._reserved[rid] = need
        return 0

    def release(self, rid: int) -> None:
        """Idempotent teardown: drop the request's pages and reservation."""
        table = self._tables.pop(rid, None)
        if table is None:
            return
        self.allocator.free(table)
        self._reserved.pop(rid, None)

    def blocks_held(self, rid: int) -> int:
        return len(self._tables[rid])

    def rollback(self, rid: int, n_keep: int) -> int:
        """Speculative-decode rollback: shrink the request back to the
        pages covering its first `n_keep` tokens. Rejected drafts within a
        page need nothing (a later round rewrites their positions); whole
        trailing pages are freed, each credited back to the request's
        reservation, since a later write there allocates again, and
        dropped from the un-drained fresh list so no step scrubs a page
        the request no longer holds. Without a prefix cache every page has
        one holder, so every trimmed page is freed. Returns pages freed."""
        table = self._tables[rid]
        keep = self.blocks_for(max(0, n_keep))
        if len(table) <= keep:
            return 0
        tail = table[keep:]
        del table[keep:]
        self._reserved[rid] = self._reserved.get(rid, 0) + len(tail)
        self.allocator.free(tail)
        drop = {p + 1 for p in tail}
        self._fresh = [d for d in self._fresh if d not in drop]
        return len(tail)

    # -- slot / table arrays for the device steps ----------------------------

    def _alloc_page(self, rid: int) -> int:
        """One lazy page against the request's reservation."""
        left = self._reserved.get(rid, 0)
        if left <= 0:
            raise RuntimeError(
                f"request {rid}: page allocation exceeds its admission "
                "reservation (accounting bug)"
            )
        b = self.allocator.alloc()
        self._reserved[rid] = left - 1
        self._fresh.append(b + 1)
        return b

    def write_slots(self, rid: int, start_pos: int, n: int) -> np.ndarray:
        """Flat device slot ids for positions [start_pos, start_pos + n),
        allocating pages lazily as positions cross page boundaries."""
        table = self._tables[rid]
        bs = self.block_size
        out = np.empty(n, np.int32)
        for i, p in enumerate(range(start_pos, start_pos + n)):
            bi = p // bs
            while len(table) <= bi:
                table.append(self._alloc_page(rid))
            out[i] = (table[bi] + 1) * bs + p % bs
        return out

    def drain_fresh_rows(self, pad_to: int) -> List[np.ndarray]:
        """Device pages allocated since the last drain, as null-page-padded
        rows of `pad_to`. The first row rides the device step (scrubbed
        before its scatter); overflow rows go to dedicated scrub calls."""
        if pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        fresh, self._fresh = self._fresh, []
        rows = []
        for i in range(0, len(fresh), pad_to):
            chunk = fresh[i:i + pad_to]
            row = np.zeros(pad_to, np.int32)
            row[: len(chunk)] = chunk
            rows.append(row)
        if not rows:
            rows.append(np.zeros(pad_to, np.int32))
        return rows

    def drain_fresh(self, pad_to: int) -> np.ndarray:
        """Single-row `drain_fresh_rows`; raises on overflow."""
        rows = self.drain_fresh_rows(pad_to)
        if len(rows) > 1:
            n = sum(int((r != 0).sum()) for r in rows)
            raise ValueError(f"{n} fresh pages > pad_to={pad_to}")
        return rows[0]

    def null_slots(self, offsets) -> np.ndarray:
        """Null-page slots for pad tokens (distinct within one page span)."""
        return (np.asarray(offsets, np.int64) % self.block_size).astype(np.int32)

    def block_table_row(self, rid: Optional[int], max_blocks: int) -> np.ndarray:
        """(max_blocks,) device page ids, null-page-padded; all-null when
        the slot is inactive (rid None)."""
        row = np.zeros(max_blocks, np.int32)
        if rid is not None:
            table = self._tables[rid]
            if len(table) > max_blocks:
                raise ValueError(
                    f"request {rid} holds {len(table)} pages > max_blocks={max_blocks}"
                )
            row[: len(table)] = np.asarray(table, np.int32) + 1
        return row

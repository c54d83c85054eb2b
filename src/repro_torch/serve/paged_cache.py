"""Block-paged KV cache: host-side refcounted free-list allocator, radix
prefix index, and per-request block tables over the device pools built by
`Model.init_paged_cache`.

Counterpart of `repro/serve/paged_cache.py`. Layout:
per attention layer one (num_blocks+1, block_size, Hkv, W) pool for K and V
plus a (num_blocks+1, block_size) position plane. Device page 0 is the null
page: pad and inactive-slot writes land there with the empty-position
sentinel. Allocator page `a` is device page `a + 1`.

  BlockAllocator  refcounted free-list: a page returns to the free list
                  when its last holder drops it
  PrefixIndex     radix tree over `block_size`-token prompt chunks mapping
                  shared prompt prefixes to pages; it holds one reference
                  on every page it caches, and LRU leaf eviction reclaims
                  index-only pages when admission needs headroom. With a
                  host tier installed a node may instead be tiered: its
                  page spilled to host memory as a checksummed payload
                  under the node's content key; admission restores tiered
                  hits into fresh device pages before the prefill launch
  PagedKVCache    block tables, lazy page allocation, admission
                  reservations, copy-on-write, park, and the flat
                  write-slot / block-table / fresh-page / copy arrays the
                  device steps take; owns the device pools and routes
                  index-eviction victims into the host tier; window
                  freeing (`free_behind`) for all-local attention stacks;
                  under a serving mesh (`ctx`) its pools are this rank's
                  slice of the KV heads (the `pkv` / `pkvs` specs: heads
                  over `model`, pages replicated over `data`) and the host
                  bookkeeping is the same on every rank

A request at length `len` holds exactly ceil(len / block_size) pages; with
the prefix index on, pages holding a prompt prefix another request already
computed are shared. Admission reserves the worst-case page count of the
non-shared tail up front (plus one page when a copy-on-write clone of the
last shared page is inevitable), so lazy per-step allocation never
deadlocks mid-flight; allocating past the reservation is an accounting bug
and raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.host_tier import (
    HostTier,
    chain_key,
    extract_page_planes,
    pack_payload,
    unpack_payload,
)


class BlockAllocator:
    """Refcounted LIFO free-list over `num_blocks` page ids [0, num_blocks).

    `alloc()` hands out a page at count 1; `incref` adds a holder (a
    request sharing a prefix page, or the prefix index pinning it); `free`
    drops one holder per listed page and returns the pages whose count
    reached zero to the free list. Dropping a page nobody holds is a
    double-free and raises."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"need at least one block, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Distinct pages allocated: a shared page counts once."""
        return len(self._refs)

    @property
    def shared_count(self) -> int:
        """Pages held by more than one holder."""
        return sum(1 for c in self._refs.values() if c > 1)

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV pool exhausted (admission should prevent this)")
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def incref(self, block: int) -> None:
        if block not in self._refs:
            raise ValueError(f"incref on unallocated block {block}")
        self._refs[block] += 1

    def free(self, blocks) -> List[int]:
        """Drop one reference per listed page; returns the pages whose
        count reached zero (now back on the free list)."""
        freed: List[int] = []
        for b in blocks:
            c = self._refs.get(b)
            if c is None:
                raise ValueError(f"double-free / foreign block {b}")
            if c > 1:
                self._refs[b] = c - 1
            else:
                del self._refs[b]
                self._free.append(b)
                freed.append(b)
        return freed


class _RadixNode:
    __slots__ = ("chunk", "page", "children", "parent", "tick", "key")

    def __init__(self, chunk: bytes, page: Optional[int],
                 parent: Optional["_RadixNode"], tick: int, key: bytes = b""):
        self.chunk = chunk
        self.page = page
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.parent = parent
        self.tick = tick
        self.key = key  # content address: chain_key over the root path

    @property
    def tiered(self) -> bool:
        """True when this node's page lives in the host tier, not on the
        device (the root, the only other page-less node, has no parent)."""
        return self.page is None and self.parent is not None


class PrefixIndex:
    """Radix tree keyed on `block_size`-token prompt chunks (int32 bytes).

    Each node maps one full page of prompt tokens to the page holding its
    KV; a root-to-node path is a cached prompt prefix. The index increfs
    every page it caches, so a request's release never drops a cached
    prefix: pages leave the index only through `evict` (oldest-touched
    frontier first, and only while no request shares them) or `spill`.

    With a host tier attached (`self.tier`) a node can be tiered: its page
    spilled to host memory as a checksummed payload under the node's
    content key, `node.page` set to None. A resident node never sits below
    a tiered one: spilling walks leaf-first and restoring walks top-down
    along the hit chain, so every root-to-node prefix is a resident run
    followed by a tiered run."""

    def __init__(self, block_size: int, allocator: BlockAllocator):
        self.block_size = block_size
        self.allocator = allocator
        self.tier: Optional[HostTier] = None  # set by PagedKVCache
        self._root = _RadixNode(b"", None, None, 0)
        self._pages = 0
        self._tiered = 0
        self._tick = 0

    def _chunks(self, prompt) -> Iterator[bytes]:
        p = np.asarray(prompt, np.int32).reshape(-1)
        bs = self.block_size
        for i in range(len(p) // bs):
            yield p[i * bs:(i + 1) * bs].tobytes()

    @property
    def pages(self) -> int:
        """Device pages the index pins (one reference each)."""
        return self._pages

    @property
    def tiered_count(self) -> int:
        """Nodes whose page lives in the host tier."""
        return self._tiered

    def lookup(self, prompt) -> List[int]:
        """Longest device-resident cached full-page prefix of `prompt` ->
        its page ids in position order. Touches the matched chain's LRU
        ticks; tiered continuations are `lookup_chain`'s."""
        return self.lookup_chain(prompt)[0]

    def lookup_chain(self, prompt) -> Tuple[List[int], List[_RadixNode]]:
        """Longest cached full-page prefix of `prompt`, split into its
        resident run (page ids, position order) and the tiered run behind
        it (nodes whose payloads the tier can restore). Touches the matched
        chain's LRU ticks."""
        self._tick += 1
        node, pages, tiered = self._root, [], []
        for key in self._chunks(prompt):
            child = node.children.get(key)
            if child is None:
                break
            child.tick = self._tick
            if child.tiered:
                tiered.append(child)
            elif tiered:
                raise RuntimeError(
                    "prefix-index corruption: resident node below a tiered "
                    "node (spill must walk leaf-first)"
                )
            else:
                pages.append(child.page)
            node = child
        return pages, tiered

    def tiered_hit_pages(self, prompt) -> int:
        """Restorable tiered pages `lookup_chain(prompt)` would return,
        without touching LRU ticks: the TTFT gate prices the restore with
        it before committing to admit."""
        node, n = self._root, 0
        for key in self._chunks(prompt):
            child = node.children.get(key)
            if child is None:
                break
            if child.tiered:
                n += 1
            node = child
        return n

    def insert(self, prompt, table: List[Optional[int]]) -> int:
        """Cache every full page of a finished prefill: chunks already
        indexed are kept (first writer wins: the later request's identical
        page stays private), new chunks pin the request's page with one
        index reference. A tiered node on the path is re-adopted instead:
        the writer's page holds the same content (same chunk path, causal
        attention), so the node goes resident on it and its tier payload is
        dropped, which keeps resident nodes above tiered ones. Stops at a
        window-freed hole (a cached prefix must run from position 0).
        Returns pages newly pinned."""
        self._tick += 1
        node, added = self._root, 0
        for i, key in enumerate(self._chunks(prompt)):
            child = node.children.get(key)
            if child is not None and child.tiered:
                if i >= len(table) or table[i] is None:
                    break
                child.page = table[i]
                self.allocator.incref(table[i])
                self._pages += 1
                self._tiered -= 1
                if self.tier is not None:
                    self.tier.pop(child.key)
                child.tick = self._tick
                added += 1
            elif child is None:
                if i >= len(table) or table[i] is None:
                    break
                child = _RadixNode(key, table[i], node, self._tick,
                                   key=chain_key(node.key, key))
                node.children[key] = child
                self.allocator.incref(table[i])
                self._pages += 1
                added += 1
            else:
                child.tick = self._tick
            node = child
        return added

    def evictable_count(self) -> int:
        """Pages reclaimable now: resident nodes whose whole subtree the
        index alone holds (count 1), which evict or spill leaf-first
        without breaking a chain a request still shares. Tiered nodes hold
        no device page and never block an ancestor."""
        def walk(n: _RadixNode) -> Tuple[int, bool]:
            total, all_free = 0, True
            for c in n.children.values():
                t, a = walk(c)
                total += t
                all_free = all_free and a
            if n.page is None:  # the root or a tiered node: nothing to reclaim
                return total, all_free
            if all_free and self.allocator.ref_count(n.page) == 1:
                return total + 1, True
            return total, False

        return walk(self._root)[0]

    def _drop_tiered_subtree(self, node: _RadixNode) -> None:
        """Remove every (tiered) descendant of `node` and its tier payload.
        Called only where the subtree is all tiered: below an eviction or
        spill frontier node, or on a corrupt payload."""
        stack = list(node.children.values())
        node.children.clear()
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._tiered -= 1
            if self.tier is not None:
                self.tier.pop(n.key)

    def drop_subtree(self, node: _RadixNode) -> None:
        """Unlink tiered `node` and its (all-tiered) subtree: the fallback
        for a corrupt or missing payload, whose chain the admission then
        recomputes."""
        if not node.tiered:
            raise ValueError("drop_subtree is the tiered-fallback path only")
        self._drop_tiered_subtree(node)
        self._tiered -= 1
        if self.tier is not None:
            self.tier.pop(node.key)
        del node.parent.children[node.chunk]

    def drop_key(self, key: bytes) -> None:
        """Capacity-drop hook (`HostTier.on_drop`): the tier evicted this
        payload, so unlink the tiered node holding `key` and its subtree,
        which keeps nodes and payloads one-to-one."""
        found = None
        stack = [self._root]
        while stack and found is None:
            n = stack.pop()
            for c in n.children.values():
                if c.tiered and c.key == key:
                    found = c
                    break
                stack.append(c)
        if found is not None:
            self._drop_tiered_subtree(found)
            self._tiered -= 1
            del found.parent.children[found.chunk]

    def restore_node(self, node: _RadixNode, page: int) -> None:
        """Point a tiered node at a freshly allocated device page (the caller
        pops the payload and schedules the upload). Restores run top-down
        along a hit chain, so resident nodes stay above tiered ones."""
        if not node.tiered:
            raise ValueError("restore_node on a resident node")
        node.page = page
        self._pages += 1
        self._tiered -= 1

    def _frontier(self) -> List[_RadixNode]:
        """Reclaim candidates: resident, index-only (count 1) nodes with no
        resident child, so evicting or spilling one never breaks a chain
        above a page someone still reads from the device."""
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            resident_kids = False
            for c in n.children.values():
                if not c.tiered:
                    resident_kids = True
                    stack.append(c)
            if (n.page is not None and not resident_kids
                    and self.allocator.ref_count(n.page) == 1):
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """Reclaim up to `n_pages` index-only pages by dropping them, LRU
        frontier first (evicting a node may expose its parent). A dropped
        node takes its tiered subtree's payloads with it: the chain below
        would be unreachable. Returns pages returned to the free list."""
        freed = 0
        while freed < n_pages:
            frontier = self._frontier()
            if not frontier:
                break
            frontier.sort(key=lambda n: n.tick)
            for node in frontier:
                if freed >= n_pages:
                    break
                if any(not c.tiered for c in node.children.values()):
                    continue  # a sibling pass may have changed the frontier
                self._drop_tiered_subtree(node)
                del node.parent.children[node.chunk]
                self._pages -= 1
                freed += len(self.allocator.free([node.page]))
        return freed

    def spill(self, n_pages: int, extract_fn) -> int:
        """Reclaim up to `n_pages` index-only pages by spilling them to the
        host tier instead of dropping them: `extract_fn(page)` packs the
        page's planes into a checksummed payload, stored under the node's
        content key; the device page returns to the free list and the node
        stays, tiered. Same LRU frontier order as `evict`. Returns pages
        returned to the free list."""
        if self.tier is None:
            raise RuntimeError("spill without a host tier installed")
        freed = 0
        while freed < n_pages:
            frontier = self._frontier()
            if not frontier:
                break
            frontier.sort(key=lambda n: n.tick)
            for node in frontier:
                if freed >= n_pages:
                    break
                if any(not c.tiered for c in node.children.values()):
                    continue
                self.tier.put(node.key, extract_fn(node.page))
                page, node.page = node.page, None
                self._pages -= 1
                self._tiered += 1
                freed += len(self.allocator.free([page]))
        return freed

    def page_multiset(self) -> List[int]:
        """Every page the index holds a reference on, one entry per
        resident node (the audit hook of `Scheduler.check_invariants`)."""
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.page is not None:
                out.append(n.page)
        return out

    def tier_keys(self) -> List[bytes]:
        """Content keys of every tiered node: `check_invariants` matches
        them one-to-one against the tier's payload keys."""
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.tiered:
                out.append(n.key)
        return out


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
        prefix_cache: bool = False,
        tier: Optional[HostTier] = None,
        ctx=None,
    ):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.kv_quant = model.cfg.kv_quant
        self.allocator = BlockAllocator(num_blocks)
        self._ctx = ctx
        self._head_ax = None
        heads = {}
        if ctx is not None:
            from repro_torch.dist import sharding as sh

            hkv = model.cfg.n_kv_heads
            self._head_ax = sh.kv_head_axis(hkv, ctx)
            if self._head_ax is not None:
                heads["kv_heads"] = hkv // ctx.axis_sizes[self._head_ax]
        self.pools = model.init_paged_cache(
            num_blocks, block_size, device=device, dtype=dtype, **heads
        )
        if tier is not None and not prefix_cache:
            raise ValueError(
                "a host tier requires prefix_cache=True (tiered pages live "
                "under the prefix index's content keys)"
            )
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(block_size, self.allocator) if prefix_cache else None
        )
        self.tier = tier
        if tier is not None:
            self.prefix.tier = tier
            tier.on_drop = self.prefix.drop_key
        self._tables: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        self._fresh: List[int] = []  # device pages allocated since last drain
        self._pending_copies: List[Tuple[int, int]] = []  # (src, dst) device ids
        # verified tier payloads awaiting upload: (device page, planes)
        self._pending_restores: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        # lifetime counters (Scheduler.stats() reports them)
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.tier_hit_tokens = 0

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

    def occupancy(self) -> Dict[str, int]:
        """Pool occupancy now, in pages: used (distinct pages held by
        requests and the index), free, reserved, admittable (free minus
        reserved), shared (more than one holder), cached (pinned by the
        index), tiered (spilled to the host tier: the fourth conservation
        class, whose device pages are free and whose content lives on as
        host payloads), total, and the number of request tables."""
        used = self.allocator.used_count
        free = self.allocator.free_count
        reserved = self.reserved_blocks
        return {
            "used": used,
            "free": free,
            "reserved": reserved,
            "admittable": free - reserved,
            "shared": self.allocator.shared_count,
            "cached": self.prefix.pages if self.prefix is not None else 0,
            "tiered": self.tier.pages if self.tier is not None else 0,
            "total": self.num_blocks,
            "tables": len(self._tables),
        }

    def _hit_arithmetic(self, kv_len: int, prompt, n_resident: int,
                        n_tiered: int) -> Tuple[int, int]:
        """(hit tokens, pages to reserve) for a hit of `n_resident`
        resident and `n_tiered` restorable pages. The hit is capped at
        len(prompt) - 1 tokens: the last prompt token is always recomputed
        (its logits give the first sample), and when the cached pages cover
        the whole prompt its KV write lands in a shared page, so one more
        page is reserved for the copy-on-write clone."""
        total = n_resident + n_tiered
        hit_tokens = clone = 0
        if prompt is not None and len(prompt) > 1 and total:
            hit_tokens = min(total * self.block_size, len(prompt) - 1)
            clone = int(total * self.block_size >= len(prompt))
        return hit_tokens, self.blocks_for(kv_len) - total + clone

    def _plan(self, kv_len: int, prompt) -> Tuple[List[int], List[_RadixNode], int, int]:
        """Admission plan: (resident hit pages, restorable tiered nodes,
        hit tokens, pages to reserve). Tiered hits are immediate
        allocations on top of the reservation: admission restores their
        payloads into fresh device pages before the first prefill launch."""
        hit_pages: List[int] = []
        tiered: List[_RadixNode] = []
        if self.prefix is not None and prompt is not None and len(prompt) > 1:
            if self.tier is not None:
                hit_pages, chain = self.prefix.lookup_chain(prompt)
                for node in chain:  # the contiguous run of present payloads
                    if node.key not in self.tier:
                        break
                    tiered.append(node)
            else:
                hit_pages = self.prefix.lookup(prompt)
        hit_tokens, need = self._hit_arithmetic(kv_len, prompt, len(hit_pages),
                                                len(tiered))
        return hit_pages, tiered, hit_tokens, need

    def can_admit(self, kv_len: int, prompt=None) -> bool:
        hit_pages, tiered, _, need = self._plan(kv_len, prompt)
        headroom = self.free_blocks - self.reserved_blocks
        if self.prefix is not None:
            # index-only pages are reclaimable headroom, minus the hit
            # pages themselves, which admission pins instead of evicting
            hit_idx_only = sum(1 for p in hit_pages if self.allocator.ref_count(p) == 1)
            headroom += self.prefix.evictable_count() - hit_idx_only
        return headroom >= need + len(tiered)

    def admit(self, rid: int, kv_len: int, prompt=None) -> int:
        """Admit a request: pin its longest cached prompt prefix (with a
        prefix index and a `prompt`), restore the tier-resident rest of
        that prefix into fresh device pages (checksum-verified on the host
        first; a corrupt or missing payload truncates the hit and drops the
        damaged subtree, and the prompt tail is recomputed), reclaim
        index-only pages if the reservation needs them, and reserve pages
        for the rest of its worst case. Returns the prompt tokens the
        request shares or restores instead of computing (0 without an
        index)."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already admitted")
        hit_pages, tiered, hit_tokens, need = self._plan(kv_len, prompt)
        # verify payloads before touching any allocator state: the chain is
        # restorable only up to its first damaged payload
        verified: List[Tuple[_RadixNode, Dict[str, torch.Tensor]]] = []
        for node in tiered:
            payload = self.tier.get(node.key)
            planes = None if payload is None else unpack_payload(payload)
            if planes is None:
                if payload is not None:
                    self.tier.corrupt_pages += 1
                self.tier.fallback_recomputes += 1
                self.prefix.drop_subtree(node)
                hit_tokens, need = self._hit_arithmetic(kv_len, prompt, len(hit_pages),
                                                        len(verified))
                break
            verified.append((node, planes))
        for p in hit_pages:
            self.allocator.incref(p)
        want = need + len(verified)
        headroom = self.free_blocks - self.reserved_blocks
        if want > headroom and self.prefix is not None:
            headroom += self.reclaim_index_pages(want - headroom)
        if want > headroom:
            self.allocator.free(hit_pages)  # roll the pins back
            raise RuntimeError(f"admitting request {rid} would oversubscribe the pool")
        restored: List[int] = []
        for node, planes in verified:
            b = self.allocator.alloc()  # the index's reference
            self.tier.pop(node.key)
            self.prefix.restore_node(node, b)
            self.allocator.incref(b)  # the request's reference
            self._pending_restores.append((b + 1, planes))
            self.tier.restored_pages += 1
            restored.append(b)
        self._tables[rid] = list(hit_pages) + restored
        self._reserved[rid] = need
        self.prefix_hit_tokens += hit_tokens
        if restored:
            self.tier_hit_tokens += min(
                len(restored) * self.block_size,
                max(0, hit_tokens - len(hit_pages) * self.block_size),
            )
        return hit_tokens

    # -- host-tier spill / restore -------------------------------------------

    def _extract_payload(self, page: int):
        """Allocator page `page`'s planes (device page `page + 1`) as a
        checksummed tier payload. A payload holds whole pages: under a mesh
        the head slices are gathered over their axis first, so the bytes
        and the CRC are the unsharded engine's."""
        whole = None
        if self._head_ax is not None:
            from repro_torch.dist import sharding as sh

            whole = lambda name, t: (t if name == "ppos" else
                                     sh.all_gather(t, self._head_ax, self._ctx, 2))
        return pack_payload(extract_page_planes(self.pools, page + 1, whole), self.kv_quant)

    def local_page_planes(self, planes: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One whole page's layer-stacked planes cut to this rank's KV heads
        (dim 2 of every plane but the positions'); the planes themselves
        with no mesh."""
        if self._head_ax is None:
            return planes
        from repro_torch.dist import sharding as sh

        return {n: t if n == "ppos" else sh.cut(t, self._head_ax, self._ctx, 2)
                for n, t in planes.items()}

    def reclaim_index_pages(self, n_pages: int) -> int:
        """Reclaim up to `n_pages` index-only pages for admission headroom.
        With a host tier the victims spill (their content survives as host
        payloads a later hit restores); without one they are dropped.
        Returns pages returned to the free list."""
        if self.prefix is None or n_pages <= 0:
            return 0
        if self.tier is not None:
            return self.prefix.spill(n_pages, self._extract_payload)
        return self.prefix.evict(n_pages)

    def spill_all(self) -> int:
        """Flush every reclaimable index page to the host tier: the
        degradation ladder's `spill` rung, the most admission headroom
        short of dropping a cached prefix or parking anyone. Returns pages
        returned to the free list."""
        if self.prefix is None or self.tier is None:
            return 0
        return self.prefix.spill(self.num_blocks, self._extract_payload)

    @property
    def pending_restores(self) -> int:
        return len(self._pending_restores)

    def drain_restores(self) -> Optional[Tuple[np.ndarray, List[Dict[str, torch.Tensor]]]]:
        """Verified payloads staged by `admit`, as (device page ids,
        per-page plane dicts) for the engine's upload, which must run before
        the device step that reads (or clones) those pages; the scheduler
        drains this ahead of each prefill launch. None when nothing waits."""
        if not self._pending_restores:
            return None
        pending, self._pending_restores = self._pending_restores, []
        dev_pages = np.asarray([d for d, _ in pending], np.int32)
        return dev_pages, [planes for _, planes in pending]

    def tiered_hit_pages(self, prompt) -> int:
        """Restorable tiered pages an admission of `prompt` would upload
        (the TTFT gate prices them; no LRU side effects)."""
        if self.tier is None or self.prefix is None or prompt is None:
            return 0
        return self.prefix.tiered_hit_pages(prompt)

    def release(self, rid: int) -> None:
        """Idempotent teardown: drop the request's reference on every page
        it holds (shared pages survive for their other holders) and clear
        its reservation. An unknown or released rid is a no-op."""
        table = self._tables.pop(rid, None)
        if table is None:
            return
        self.allocator.free([p for p in table if p is not None])
        self._reserved.pop(rid, None)

    def prefix_insert(self, rid: int, prompt) -> int:
        """Index every full prompt page of a finished prefill so later
        requests can share it. No-op without a prefix index."""
        if self.prefix is None:
            return 0
        return self.prefix.insert(prompt, self._tables[rid])

    def blocks_held(self, rid: int) -> int:
        return sum(1 for p in self._tables[rid] if p is not None)

    def free_behind(self, rid: int, min_live_pos: int) -> int:
        """Window freeing: release every page whose tokens all lie below
        `min_live_pos`, positions no live or later query of an all-local
        stack can attend to once its window has slid past them. The table
        keeps a None in the page's place so later block indices stay
        position-addressed; `block_table_row` reads it as the null page,
        whose scrubbed sentinel masks it (never the stale page, which may
        already hold another tenant's KV). Returns the pages returned to
        the free list (a shared page only drops this request's
        reference)."""
        table = self._tables[rid]
        bs = self.block_size
        dead = []
        for bi in range(min(len(table), max(0, min_live_pos) // bs)):
            if table[bi] is not None and (bi + 1) * bs <= min_live_pos:
                dead.append(table[bi])
                table[bi] = None
        if dead:
            return len(self.allocator.free(dead))
        return 0

    def rollback(self, rid: int, n_keep: int) -> int:
        """Speculative-decode rollback: shrink the request back to the
        pages covering its first `n_keep` tokens. Rejected drafts within a
        page need nothing (a later round rewrites their positions). Each
        whole trailing page removed drops one reference (a page shared
        with the index or another request survives for them) and credits
        one page back to the request's reservation, since a later write
        there allocates again; freed pages leave the un-drained fresh list
        so no step scrubs a page the request no longer holds. Returns pages
        returned to the free list."""
        table = self._tables[rid]
        keep = self.blocks_for(max(0, n_keep))
        if len(table) <= keep:
            return 0
        tail = [p for p in table[keep:] if p is not None]
        removed = len(table) - keep
        del table[keep:]
        self._reserved[rid] = self._reserved.get(rid, 0) + removed
        freed = self.allocator.free(tail)
        if freed and self._fresh:
            drop = {p + 1 for p in freed}
            self._fresh = [d for d in self._fresh if d not in drop]
        return len(freed)

    def park(self, rid: int, tokens=None) -> int:
        """Preempt a resident: drop every page the request holds and its
        remaining reservation, so the pool can serve someone else; the
        scheduler keeps the request's emitted tokens and re-admits it later
        by prefilling them again.

        With a prefix index and `tokens` (the request's written history,
        prompt and committed output), the full pages holding it are indexed
        before the release: the index's reference keeps them, so the
        re-admission hits them and recomputes only the last partial page.
        Without an index, or once pressure evicts those pages, the resume
        prefills everything: correct either way. Shared pages drop only this
        request's reference; freed pages leave the un-drained fresh list.
        Returns pages returned to the free list. Parking an unknown or
        already parked rid raises: park is driven only by the scheduler's
        preemption, and a second park would index a table that is gone."""
        if rid not in self._tables:
            raise ValueError(f"park of unknown or already-parked request {rid}")
        if tokens is not None and self.prefix is not None:
            self.prefix.insert(tokens, self._tables[rid])
        table = self._tables.pop(rid)
        self._reserved.pop(rid, None)
        freed = self.allocator.free([p for p in table if p is not None])
        if freed and self._fresh:
            drop = {p + 1 for p in freed}
            self._fresh = [d for d in self._fresh if d not in drop]
        return len(freed)

    def held_pages(self, rid: int) -> List[int]:
        """The request's page ids, one entry per table reference (the audit
        hook of `check_invariants`); [] for a request without a table."""
        return [p for p in self._tables.get(rid, []) if p is not None]

    # -- slot / table arrays for the device steps ----------------------------

    def _alloc_page(self, rid: int, *, fresh: bool) -> int:
        """One lazy page against the request's reservation."""
        left = self._reserved.get(rid, 0)
        if left <= 0:
            raise RuntimeError(
                f"request {rid}: page allocation exceeds its admission "
                "reservation (accounting bug)"
            )
        b = self.allocator.alloc()
        self._reserved[rid] = left - 1
        if fresh:
            self._fresh.append(b + 1)
        return b

    def write_slots(self, rid: int, start_pos: int, n: int) -> np.ndarray:
        """Flat device slot ids for positions [start_pos, start_pos + n),
        allocating pages lazily as positions cross page boundaries.

        Copy-on-write: the first write into a page with other holders (a
        shared prefix page) clones it: a new page is allocated, a (src,
        dst) device copy is queued for the next prefill (`drain_copies`),
        the table entry moves to the clone and this request's reference on
        the original is dropped; the other holders keep reading the
        original. A clone is not a fresh page: the copy initializes all of
        it, and a scrub would erase the copied prefix."""
        table = self._tables[rid]
        bs = self.block_size
        out = np.empty(n, np.int32)
        for i, p in enumerate(range(start_pos, start_pos + n)):
            bi = p // bs
            while len(table) <= bi:
                table.append(self._alloc_page(rid, fresh=True))
            pg = table[bi]
            if pg is None:
                # positions only grow and free_behind releases only pages
                # behind the window: a write never lands on one
                raise ValueError(
                    f"request {rid}: write at position {p} targets a window-freed page")
            if self.allocator.ref_count(pg) > 1:
                dst = self._alloc_page(rid, fresh=False)
                self._pending_copies.append((pg + 1, dst + 1))
                self.allocator.free([pg])  # other holders remain: never freed here
                table[bi] = pg = dst
                self.cow_copies += 1
            out[i] = (pg + 1) * bs + p % bs
        return out

    @property
    def pending_copies(self) -> int:
        return len(self._pending_copies)

    def drain_copies(self, pad_to: int) -> np.ndarray:
        """Queued copy-on-write clones as a (pad_to, 2) (src, dst) device
        page array for the next prefill, which copies every pool plane
        before its scrub and scatter. Padding rows are (0, 0), a null-page
        self-copy."""
        copies, self._pending_copies = self._pending_copies, []
        if len(copies) > pad_to:
            raise ValueError(f"{len(copies)} CoW copies > pad_to={pad_to}")
        out = np.zeros((pad_to, 2), np.int32)
        if copies:
            out[: len(copies)] = copies
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
        the slot is inactive (rid None). Window-freed entries read the null
        page too: the page itself may already serve another tenant."""
        row = np.zeros(max_blocks, np.int32)
        if rid is not None:
            table = self._tables[rid]
            if len(table) > max_blocks:
                raise ValueError(
                    f"request {rid} holds {len(table)} pages > max_blocks={max_blocks}"
                )
            row[: len(table)] = np.asarray(
                [0 if p is None else p + 1 for p in table], np.int32)
        return row

"""Parity of the port's prefix cache, copy-on-write pages and chunked
prefill with the JAX reference (`tests/test_prefix_cache.py`).

Host bookkeeping is held bitwise in this process: each host-level test of
the reference drives the port's `PagedKVCache` and the reference's, each
over a pool stub, through the same operations, and after every operation
the two agree on block tables, refcounts, the free list, reservations,
fresh pages, queued copies, hit and clone counters and every node of the
prefix index (chunk, page, LRU tick and content key). Engines run the
reference's smoke config and prompt mix (8 prompts over two system
prompts, one of them page-aligned and re-submitted verbatim): against the
reference in a process where XLA rounds every bf16 op
(tests/torch_parity.py), where greedy tokens, every device-call argument,
the stats and every pool plane are the reference's; and port against
port in this process, where sharing and chunking change no token.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.host_tier import HostTier as JHostTier
from repro.serve.paged_cache import BlockAllocator as JAllocator
from repro.serve.paged_cache import PagedKVCache as JCache
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, SpecConfig
from repro_torch.serve.host_tier import HostTier
from repro_torch.serve.paged_cache import BlockAllocator, PagedKVCache, chain_key
from repro_torch.serve.scheduler import STAT_UNITS, Request, Scheduler
from test_torch_engine import _logs_equal, _record
from repro_torch.convert import to_tensor
from repro_torch.kernels.ref import CACHE_EMPTY_POS
from torch_parity import run_exact

KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")
CHUNKS = (1, 5, 8)
ENGINE = dict(max_len=64, block_size=8, max_slots=2, num_blocks=24, decode_chunk=4)
NEW = 4


# ---------------------------------------------------------------------------
# host bookkeeping: the port's cache and the reference's, operation by operation
# ---------------------------------------------------------------------------

class _Cfg:
    kv_quant = "none"


class _PortStub:
    cfg = _Cfg()

    def init_paged_cache(self, num_blocks, block_size, device=None, dtype=None):
        return []


class _RefStub:
    cfg = _Cfg()

    def init_paged_cache(self, num_blocks, block_size, dtype, kv_quant=None):
        return {}


def _index_state(index):
    if index is None:
        return None
    nodes, stack = [], [(index._root, b"")]
    while stack:
        n, parent = stack.pop()
        for c in n.children.values():
            nodes.append((c.key, parent, c.chunk, c.page, c.tick))
            stack.append((c, c.key))
    return sorted(nodes), index.pages, index.tiered_count, index._tick


def _tier_state(t):
    if t is None:
        return None
    return (sorted(t.keys()), t.spilled_pages, t.restored_pages, t.corrupt_pages,
            t.dropped_pages, t.fallback_recomputes)


def _state(c):
    """Everything the cache's host bookkeeping holds."""
    a = c.allocator
    return {
        "free": list(a._free), "refs": dict(a._refs),
        "tables": {r: list(t) for r, t in c._tables.items()},
        "reserved": dict(c._reserved), "fresh": list(c._fresh),
        "copies": list(c._pending_copies), "hit": c.prefix_hit_tokens,
        "cow": c.cow_copies, "index": _index_state(c.prefix),
        "tier": _tier_state(c.tier), "tier_hit": c.tier_hit_tokens,
        "restores": [d for d, _ in c._pending_restores],
    }


def _same(a, b) -> bool:
    if hasattr(a, "blob") and hasattr(b, "blob"):  # tier payloads of the two packages
        return _same(dataclasses.astuple(a), dataclasses.astuple(b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b)) and (
            np.asarray(a).dtype == np.asarray(b).dtype)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


class Twin:
    """The reference's object and the port's, driven together. A method
    call runs on both; their results (or the errors they raise, type and
    message) must agree, and so must the two caches' whole state after
    it. Attribute reads compare too; `prefix` and `allocator` come back as
    twins of their own. The port's result is returned, its error raised."""

    def __init__(self, ref, port, root=None):
        object.__setattr__(self, "_pair", (ref, port))
        object.__setattr__(self, "_root", root or self)

    def check(self):
        ref, port = self._root._pair
        assert _same(_state(ref), _state(port)), (_state(ref), _state(port))

    def __getattr__(self, name):
        ref, port = (getattr(x, name) for x in self._pair)
        if name in ("prefix", "allocator", "tier"):
            return Twin(ref, port, self._root)
        if not callable(ref):
            assert _same(ref, port), (name, ref, port)
            return port

        def call(*a, **kw):
            outs = []
            for fn in (ref, port):
                try:
                    outs.append((None, fn(*a, **kw)))
                except (ValueError, RuntimeError) as e:
                    outs.append((e, None))
            (re_, rv), (pe, pv) = outs
            assert (type(re_), str(re_)) == (type(pe), str(pe)), (name, re_, pe)
            assert _same(rv, pv), (name, rv, pv)
            self._root.check()
            if pe is not None:
                raise pe
            return pv

        return call


def _cache(num_blocks=24, block_size=4, prefix=True, tier=False):
    t = Twin(JCache(_RefStub(), num_blocks=num_blocks, block_size=block_size,
                    prefix_cache=prefix, tier=JHostTier() if tier else None),
             PagedKVCache(_PortStub(), num_blocks=num_blocks, block_size=block_size,
                          prefix_cache=prefix, tier=HostTier() if tier else None))
    t.check()
    return t


def test_release_is_idempotent():
    c = _cache(prefix=False)
    c.admit(7, 10)
    c.write_slots(7, 0, 10)
    c.release(7)
    assert c.free_blocks == c.num_blocks
    c.release(7)   # a second teardown: no-op
    c.release(99)  # a rid never admitted: no-op
    assert c.free_blocks == c.num_blocks


def test_scheduler_double_evict_is_noop():
    """The second `_evict` of one slot (EOS at prefill and the length cap in
    one round) changes nothing, in both packages."""
    c = _cache(prefix=False)
    ref, port = c._pair
    scheds = (
        JScheduler(ref, max_slots=1, max_len=64, prefill_fn=None, decode_fn=None,
                   sample_fn=None),
        Scheduler(port, max_slots=1, max_len=64, prefill_fn=None, decode_chunk_fn=None,
                  sample_fn=None, scrub_fn=None),
    )
    for sched, req in zip(scheds, (JRequest, Request)):
        r = req(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2)
        sched.cache.admit(r.rid, sched._kv_len(r))
        sched.cache.write_slots(r.rid, 0, 5)
        r.out = [1, 2]
        sched.slots[0] = r
        sched._evict(0)
        first = dict(sched.results)
        sched._evict(0)
        assert sched.slots[0] is None and sched.results.keys() == first.keys()
    c.check()
    assert c.free_blocks == c.num_blocks
    assert _same(scheds[0].results, scheds[1].results)


def test_reservation_accounting_is_exact():
    c = _cache(num_blocks=8, block_size=4, prefix=False)
    c.admit(1, 8)
    assert c.reserved_blocks == 2
    c.write_slots(1, 0, 8)
    assert c.reserved_blocks == 0
    with pytest.raises(RuntimeError, match="reservation"):
        c.write_slots(1, 8, 1)  # a third page was never reserved
    c.release(1)
    assert c.free_blocks == 8


def test_reservation_conserved_under_random_lifecycle():
    """A seeded stream of admissions, appends, spec rollbacks and
    evictions (the reference's stream with `free_behind`, ROADMAP item 10,
    replaced by rollback): both caches agree after every operation, the
    pool never leaks and reservations never exceed the free list."""
    rng = np.random.default_rng(0)
    bs = 4
    c = _cache(num_blocks=16, block_size=bs, prefix=False)
    live = {}  # rid -> [kv_len, written]
    next_rid = 0
    for _ in range(400):
        op = rng.choice(["admit", "append", "rollback", "evict"])
        if op == "admit":
            kv_len = int(rng.integers(1, 3 * bs))
            if c.can_admit(kv_len):
                before = c.reserved_blocks
                c.admit(next_rid, kv_len)
                assert c.reserved_blocks == before + c.blocks_for(kv_len)
                live[next_rid] = [kv_len, 0]
                next_rid += 1
        elif op == "append" and live:
            rid = int(rng.choice(list(live)))
            kv_len, written = live[rid]
            n = min(int(rng.integers(1, 4)), kv_len - written)
            if n > 0:
                c.write_slots(rid, written, n)
                live[rid][1] = written + n
        elif op == "rollback" and live:
            rid = int(rng.choice(list(live)))
            keep = max(0, live[rid][1] - int(rng.integers(0, 2 * bs)))
            c.rollback(rid, keep)
            live[rid][1] = keep
        elif op == "evict" and live:
            rid = int(rng.choice(list(live)))
            c.release(rid)
            del live[rid]
        used = c.allocator.used_count
        assert c.free_blocks + used == c.num_blocks
        assert used == sum(c.blocks_held(r) for r in live)
        assert c.reserved_blocks <= c.free_blocks
    for rid in list(live):
        c.release(rid)
    assert c.free_blocks == c.num_blocks and c.reserved_blocks == 0


def test_drain_fresh_rows_splits_overflow():
    c = _cache(num_blocks=12, block_size=4, prefix=False)
    c.admit(1, 20)
    c.write_slots(1, 0, 20)
    rows = c.drain_fresh_rows(2)
    assert [r.shape for r in rows] == [(2,), (2,), (2,)]
    flat = np.concatenate(rows)
    assert sorted(flat[flat != 0]) == [1, 2, 3, 4, 5]
    assert [r.tolist() for r in c.drain_fresh_rows(2)] == [[0, 0]]
    c.admit(2, 12)
    c.write_slots(2, 0, 12)
    with pytest.raises(ValueError, match="fresh pages"):
        c.drain_fresh(2)


def test_refcounted_allocator_frees_on_last_holder():
    for alloc in (JAllocator(4), BlockAllocator(4)):
        b = alloc.alloc()
        alloc.incref(b)
        assert alloc.ref_count(b) == 2 and alloc.shared_count == 1
        assert alloc.free([b]) == []
        assert alloc.free([b]) == [b]
        with pytest.raises(ValueError, match="double-free"):
            alloc.free([b])
        with pytest.raises(ValueError, match="incref on unallocated"):
            alloc.incref(b)


def test_prefix_hit_reserves_only_the_tail():
    bs = 4
    c = _cache(num_blocks=24, block_size=bs)
    prompt = np.arange(12, dtype=np.int32)  # 3 full pages
    assert c.admit(1, 19, prompt=prompt) == 0
    c.write_slots(1, 0, 12)
    c.prefix_insert(1, prompt)
    assert c.occupancy()["cached"] == 3
    free0, reserved0 = c.free_blocks, c.reserved_blocks
    assert c.admit(2, 19, prompt=prompt) == 11  # capped at P - 1
    assert c.reserved_blocks - reserved0 == 3  # 5 - 3 hit pages + 1 clone
    assert c.free_blocks == free0 and c.prefix_hit_tokens == 11
    slots = c.write_slots(2, 11, 1)  # the recomputed last token clones
    assert c.cow_copies == 1 and c.pending_copies == 1
    src_dst = c.drain_copies(2)
    src, dst = int(src_dst[0, 0]), int(src_dst[0, 1])
    assert src != dst and dst == slots[0] // bs
    assert c.allocator.ref_count(src - 1) == 2  # the donor's and the index's
    c.write_slots(2, 12, 3)  # the clone is private: no second copy
    assert c.cow_copies == 1 and c.pending_copies == 0
    for cache in c._pair:
        cache._pending_copies += [(src, dst), (src, dst)]
    with pytest.raises(ValueError, match="CoW copies"):
        c.drain_copies(1)


def test_cow_targets_are_never_shared_host_level():
    """Every slot `write_slots` hands out lies in a page with one holder:
    a shared page is cloned first, so no write lands in another request's
    page or the index's."""
    rng = np.random.default_rng(1)
    bs = 4
    c = _cache(num_blocks=48, block_size=bs)
    base = rng.integers(0, 100, 2 * bs).tolist()
    rid = 0
    for fork in range(8):
        if fork % 2 == 1:
            prompt = np.asarray(base, np.int32)  # fully cached: forces the clone
        else:
            tail = rng.integers(100, 200, int(rng.integers(1, 2 * bs))).tolist()
            prompt = np.asarray(base + tail, np.int32)
        kv_len = len(prompt) + 3
        if not c.can_admit(kv_len, prompt):
            break
        hit = c.admit(rid, kv_len, prompt=prompt)
        for p in range(hit, kv_len):
            (slot,) = c.write_slots(rid, p, 1)
            assert c.allocator.ref_count(int(slot) // bs - 1) == 1
        c.prefix_insert(rid, prompt)
        c.drain_copies(4)
        c.drain_fresh_rows(8)
        if rng.random() < 0.5:
            c.release(rid)
        rid += 1
    assert c.cow_copies >= 1
    occ = c.occupancy()
    assert occ["used"] + occ["free"] == c.num_blocks


def test_prefix_eviction_lru_and_headroom():
    bs = 4
    c = _cache(num_blocks=8, block_size=bs)
    for rid, lo in enumerate((0, 100)):
        prompt = np.arange(lo, lo + 2 * bs, dtype=np.int32)
        c.admit(rid, 2 * bs, prompt=prompt)
        c.write_slots(rid, 0, 2 * bs)
        c.prefix_insert(rid, prompt)
        c.release(rid)
    assert c.occupancy()["cached"] == 4 and c.prefix.evictable_count() == 4
    c.prefix.lookup(np.arange(0, 2 * bs, dtype=np.int32))  # the second is LRU now
    prompt = np.arange(0, 2 * bs, dtype=np.int32)
    assert c.can_admit(7 * bs, prompt=prompt)
    assert c.admit(9, 7 * bs, prompt=prompt) == 2 * bs - 1
    assert c.occupancy()["cached"] == 2  # the LRU tenant's pages went
    c.release(9)


def test_oversubscribed_admission_rolls_its_pins_back():
    """An admission that cannot reserve its tail raises and leaves every
    refcount as it was, the hit pages' included."""
    bs = 4
    c = _cache(num_blocks=6, block_size=bs)
    prompt = np.arange(2 * bs, dtype=np.int32)
    c.admit(0, 2 * bs, prompt=prompt)
    c.write_slots(0, 0, 2 * bs)
    c.prefix_insert(0, prompt)
    c.admit(1, 3 * bs)  # holds the rest of the pool in reservation
    assert not c.can_admit(5 * bs, prompt=prompt)
    with pytest.raises(RuntimeError, match="oversubscribe"):
        c.admit(2, 5 * bs, prompt=prompt)
    assert c.allocator.ref_count(0) == 2 and c.prefix_hit_tokens == 0


def test_rollback_on_shared_pages_only_drops_this_requests_ref():
    """Rolling a fork back across a CoW boundary: the donor's and the
    index's references on shared prefix pages survive; only the fork's own
    tail pages return to the free list (test_spec_decode.py's case)."""
    bs = 2
    c = _cache(num_blocks=16, block_size=bs)
    donor = list(range(1, 4 * bs + 1))
    c.admit(0, len(donor) + 2, prompt=donor)
    c.write_slots(0, 0, len(donor))
    c.prefix_insert(0, donor)
    hit = c.admit(1, len(donor) + 6, prompt=donor)
    assert hit == len(donor) - 1
    c.write_slots(1, hit, 6 + len(donor) - hit)  # the clone and a private tail
    held = c.blocks_held(1)
    port = c._pair[1]
    shared = [p for p in port._tables[1] if port.allocator.ref_count(p) > 1]
    assert shared
    free0 = c.allocator.free_count
    freed = c.rollback(1, len(donor) + 1)
    assert freed == held - c.blocks_held(1)
    assert c.allocator.free_count == free0 + freed
    assert all(port.allocator.ref_count(p) >= 1 for p in shared)
    c.release(0)
    c.release(1)
    occ = c.occupancy()
    assert occ["used"] == occ["cached"] == port.prefix.pages


def test_index_keys_drop_and_page_multiset():
    """Node keys are the reference's content addresses. `drop_subtree` and
    `drop_key` unlink tiered chains only (the corrupt-payload fallback and
    the tier's capacity hook), as in the reference: a resident node is
    refused or left alone, in both packages."""
    bs = 4
    c = _cache(num_blocks=12, block_size=bs, tier=True)
    prompt = np.arange(3 * bs, dtype=np.int32)
    c.admit(0, 3 * bs + 1, prompt=prompt)
    c.write_slots(0, 0, 3 * bs)
    c.prefix_insert(0, prompt)
    ref, port = c._pair
    assert sorted(port.prefix.page_multiset()) == sorted(port._tables[0])
    k0 = chain_key(b"", prompt[:bs].tobytes())
    k1 = chain_key(k0, prompt[bs:2 * bs].tobytes())
    root = port.prefix._root
    assert list(root.children.values())[0].key == k0
    c.prefix.drop_key(k1)  # resident: the capacity hook leaves it
    c.prefix.drop_key(b"no such key")
    assert c.prefix.pages == 3
    for cache in (ref, port):
        for node in (list(cache.prefix._root.children.values())[0], cache.prefix._root):
            with pytest.raises(ValueError, match="tiered-fallback"):
                cache.prefix.drop_subtree(node)
    c.release(0)
    assert c.reclaim_index_pages(2) == 2  # the two deepest pages spill
    assert c.prefix.tiered_count == 2 and c.occupancy()["tiered"] == 2
    assert sorted(port.prefix.tier_keys()) == sorted(port.tier.keys())
    c.tier.pop(k1)  # the tier let k1's payload go: its chain leaves the index
    c.prefix.drop_key(k1)
    assert c.prefix.tiered_count == 0 and c.tier.pages == 0 and c.prefix.pages == 1
    assert port.allocator.free_count == 11


# ---------------------------------------------------------------------------
# engines: the port against the reference (exact process), and against itself
# ---------------------------------------------------------------------------

def _reference_params():
    params = JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))
    return jcompress_tree(params, jget_spec("bf8_50"))


def _port_params(jparams):
    cfg = get_smoke_config("llama3-8b")
    return Model(cfg), params_from_jax(jax.device_get(jparams), cfg, device="cpu")


def _shared_prompts(vocab, seed=3):
    """The reference's mix: 8 prompts over 2 system prompts (19 tokens, and
    16 = two whole pages at block 8) with mixed tails; the page-aligned one
    comes back verbatim last, which forces the full-cover clone."""
    rng = np.random.default_rng(seed)
    sys_a = rng.integers(1, vocab, 19).tolist()
    sys_b = rng.integers(1, vocab, 16).tolist()
    tails = [rng.integers(1, vocab, k).tolist() for k in (3, 9, 1, 5, 13)]
    return [np.asarray(p, np.int32) for p in (
        sys_a + tails[0], sys_a + tails[1], sys_b,
        sys_b + tails[2], sys_a + tails[3], sys_b + tails[4],
        sys_a, sys_b,
    )]


def _drain(eng, prompts, port, eos_id=None):
    """Serve `prompts` at once; tokens, device-call log, stats (the port's
    keys), peaks, occupancy and the pools."""
    log = _record(eng, port)
    rids = [eng.submit(p, max_new_tokens=NEW, eos_id=eos_id) for p in prompts]
    done = eng.run_until_drained()
    st = eng.scheduler.stats()
    return {"tokens": [done[r].tolist() for r in rids], "log": log,
            "stats": {k: st[k] for k in STAT_UNITS},
            "peaks": dict(eng.scheduler.request_peaks), "occ": eng.kv.occupancy(),
            "pools": eng.kv.pools}


def _pair(kind, jparams, tm, tparams, **kw):
    """The reference's engine and the port's on the shared prompts."""
    jeng = JEngine(JModel(jget_smoke_config("llama3-8b")), jparams, paged=True,
                   kv_quant=kind, **ENGINE, **kw)
    teng = GenerationEngine(tm, tparams, kv_quant=kind, device="cpu", **ENGINE, **kw)
    prompts = _shared_prompts(tm.cfg.vocab_size)
    return _drain(jeng, prompts, False), _drain(teng, prompts, True)


#: bf16 pool planes of the port against the reference's, relative to the
#: plane's max |value|: the two frameworks' f32 sums of a matmul (XLA:CPU's
#: dot and torch's) take other orders at some row counts (a prefill of 16
#: rows runs the GeMV regime), so a bf16 rounding of an activation can
#: flip, and every K/V element a later layer computes from it may move by a
#: few ulps (ROADMAP Queue C). Code and position planes stay bitwise.
BF16_DRIFT = 1e-2


def _plane_drift(jpools, tpools):
    """(planes out of bounds, bf16 elements that differ): code and
    position planes must be bitwise, bf16 planes (the unquantized pool's
    K/V, the codec scales) within BF16_DRIFT. The null page's K/V take
    racing pad writes and are left out; its positions must stay empty."""
    bad, moved = [], 0
    for layer, planes in enumerate(tpools):
        for name, got in planes.items():
            want = to_tensor(np.asarray(jpools[name][layer]), "cpu")
            if name == "ppos":
                if not (torch.equal(got, want) and torch.all(got[0] == CACHE_EMPTY_POS)):
                    bad.append((layer, name))
                continue
            got, want = got[1:], want[1:]
            if got.dtype != torch.bfloat16:
                if not torch.equal(got, want):
                    bad.append((layer, name))
                continue
            diff = (got.float() - want.float()).abs()
            if float(diff.max()) > BF16_DRIFT * float(want.float().abs().max()):
                bad.append((layer, name))
            moved += int((diff > 0).sum())
    return bad, moved


def _differs(ref, got, moved=None) -> str:
    """'' when the port's serve is the reference's in every respect (bf16
    pool planes within BF16_DRIFT; the elements that moved go to `moved`)."""
    for field in ("tokens", "stats", "peaks", "occ"):
        if got[field] != ref[field]:
            return f"{field}: {got[field]} != {ref[field]}"
    if not _logs_equal(ref["log"], got["log"], with_tokens=True):
        return "device-call arguments differ"
    bad, n = _plane_drift(ref["pools"], got["pools"])
    if moved is not None:
        moved.append(n)
    return f"pool planes {bad}" if bad else ""


def prefix_report(kinds, chunks):
    """{case: "ok" or what differed}. `shared/<kind>`: prefix cache on,
    the port against the reference and against the port with it off;
    `chunk/<n>` and `chunk+shared/<n>`: chunked prefill (int8 pool), the
    port against the reference and against monolithic prefill.
    `moved/<case>` counts the bf16 pool elements that moved."""
    jparams = _reference_params()
    tm, tparams = _port_params(jparams)
    prompts = _shared_prompts(tm.cfg.vocab_size)
    out = {}
    off = {}
    for kind in kinds:
        plain = GenerationEngine(tm, tparams, kv_quant=kind, device="cpu", **ENGINE)
        off[kind] = _drain(plain, prompts, True)["tokens"]
        ref, got = _pair(kind, jparams, tm, tparams, prefix_cache=True)
        st, moved = got["stats"], []
        why = _differs(ref, got, moved)
        out[f"moved/shared/{kind}"] = moved[0] if moved else None
        if not why and got["tokens"] != off[kind]:
            why = f"prefix on {got['tokens']} != off {off[kind]}"
        if not why and not (st["prefix_hit_tokens"] > 0 and st["cow_copies"] >= 1
                            and got["occ"]["used"] == got["occ"]["cached"] > 0):
            why = f"no sharing: {st}, {got['occ']}"
        out[f"shared/{kind}"] = why or "ok"
    for n in chunks:
        for name, kw in (("chunk", {}), ("chunk+shared", {"prefix_cache": True})):
            ref, got = _pair("int8", jparams, tm, tparams, prefill_chunk=n, **kw)
            moved = []
            why = _differs(ref, got, moved)
            out[f"moved/{name}/{n}"] = moved[0] if moved else None
            if not why and got["tokens"] != off["int8"]:
                why = f"chunked {got['tokens']} != monolithic {off['int8']}"
            if not why and got["stats"]["prefill_chunk_calls"] == 0:
                why = "no chunked launch"
            if not why and kw and got["stats"]["prefix_hit_tokens"] == 0:
                why = "no prefix hit"
            out[f"{name}/{n}"] = why or "ok"
    return out


@pytest.fixture(scope="module")
def exact_report():
    return run_exact("test_torch_prefix", "prefix_report", list(KV_KINDS), list(CHUNKS))


@pytest.mark.parametrize("kind", KV_KINDS)
def test_shared_prefix_greedy_matches_reference(exact_report, kind):
    """With the prefix cache on, the port emits the reference's greedy
    tokens and hands the device the same arrays (clones included), with
    the same stats, peaks and occupancy and every pool plane equal; and
    its tokens are the port's own with the cache off. The drained pool
    holds only the index's pages. Code and position planes are bitwise;
    the unquantized pool's bf16 K/V may drift (BF16_DRIFT) in at most one
    token slot's K and V (128 elements): 44 elements of one token's
    layer-1 K and V on this traffic (ROADMAP Queue C)."""
    assert exact_report[f"shared/{kind}"] == "ok"
    assert exact_report[f"moved/shared/{kind}"] <= (128 if kind == "none" else 0)


@pytest.mark.parametrize("shared", [False, True], ids=["plain", "shared"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_prefill_matches_reference(exact_report, chunk, shared):
    """Chunked prefill (1-token, unaligned and page-aligned chunks), with
    and without sharing: the reference's tokens, arrays, stats and pool
    planes, and the port's monolithic tokens."""
    case = f"{'chunk+shared' if shared else 'chunk'}/{chunk}"
    assert exact_report[case] == "ok" and exact_report[f"moved/{case}"] == 0


@pytest.fixture(scope="module")
def port_model():
    return _port_params(_reference_params())


def _serve(tm, tparams, prompts, n=NEW, eos_id=None, **kw):
    eng = GenerationEngine(tm, tparams, device="cpu", **dict(ENGINE, **kw))
    rids = [eng.submit(p, max_new_tokens=n, eos_id=eos_id) for p in prompts]
    done = eng.run_until_drained()
    return [done[r].tolist() for r in rids], eng


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["none", "nf4"])
def test_chunked_and_shared_equal_monolithic_in_process(port_model, kind, chunk):
    """Port against port: every mode of sharing and chunking gives the
    monolithic unshared tokens."""
    tm, tparams = port_model
    prompts = _shared_prompts(tm.cfg.vocab_size)
    want, _ = _serve(tm, tparams, prompts, kv_quant=kind)
    for kw in (dict(prefill_chunk=chunk), dict(prefill_chunk=chunk, prefix_cache=True)):
        got, eng = _serve(tm, tparams, prompts, kv_quant=kind, **kw)
        assert got == want, kw
        st = eng.scheduler.stats()
        assert st["prefill_chunk_calls"] > 0
        assert (st["prefix_hit_tokens"] > 0) == ("prefix_cache" in kw)


def test_temperature_with_prefix_cache_equals_without(port_model):
    """At T = 0.7 a token's key is (seed, request, output index): sharing
    and chunking change neither the logits on the CPU nor the keys."""
    tm, tparams = port_model
    prompts = _shared_prompts(tm.cfg.vocab_size)
    want, _ = _serve(tm, tparams, prompts, n=6, temperature=0.7, seed=4)
    for kw in (dict(prefix_cache=True), dict(prefix_cache=True, prefill_chunk=5)):
        got, eng = _serve(tm, tparams, prompts, n=6, temperature=0.7, seed=4, **kw)
        assert got == want, kw
        assert eng.scheduler.stats()["prefix_hit_tokens"] > 0
    greedy, _ = _serve(tm, tparams, prompts, n=6)
    assert greedy != want


def _snapshot(pools, pages):
    dev = torch.as_tensor([p + 1 for p in pages])
    return [{name: t[dev].clone() for name, t in layer.items()} for layer in pools]


@pytest.mark.parametrize("kind", ["none", "int8", "nf4"])
def test_cow_never_mutates_sibling_pool_pages(port_model, kind):
    """A verbatim re-submission of a page-aligned donor recomputes its last
    token into a clone: every plane of the donor's cached pages is bitwise
    what it was."""
    tm, tparams = port_model
    rng = np.random.default_rng(5)
    donor = rng.integers(1, tm.cfg.vocab_size, 16).astype(np.int32)  # 2 pages
    eng = GenerationEngine(tm, tparams, device="cpu", kv_quant=kind, max_len=64,
                           block_size=8, max_slots=1, num_blocks=24, decode_chunk=2,
                           prefix_cache=True)
    eng.submit(donor, max_new_tokens=3)
    eng.run_until_drained()
    pages = eng.kv.prefix.lookup(donor)
    assert len(pages) == 2
    before = _snapshot(eng.kv.pools, pages)
    rid = eng.submit(donor.copy(), max_new_tokens=3)
    out = eng.run_until_drained()
    st = eng.scheduler.stats()
    assert st["prefix_hit_tokens"] == 15 and st["cow_copies"] == 1
    for layer, (old, new) in enumerate(zip(before, _snapshot(eng.kv.pools, pages))):
        for name in old:
            assert torch.equal(old[name], new[name]), (layer, name)
    assert len(out[rid]) == 3


def test_prefix_cache_defaults_off(port_model):
    tm, tparams = port_model
    _, eng = _serve(tm, tparams, _shared_prompts(tm.cfg.vocab_size)[:2], n=3)
    occ = eng.kv.occupancy()
    assert occ["used"] == 0 and occ["cached"] == 0 and eng.kv.prefix is None


def test_prefill_chunk_is_validated(port_model):
    tm, tparams = port_model
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        GenerationEngine(tm, tparams, device="cpu", prefill_chunk=0, **ENGINE)


def test_stats_report_sharing_in_their_units(port_model):
    tm, tparams = port_model
    _, eng = _serve(tm, tparams, _shared_prompts(tm.cfg.vocab_size), prefix_cache=True,
                    prefill_chunk=8)
    st = eng.scheduler.stats()
    assert set(st) == set(STAT_UNITS)
    for key in ("prefill_chunk_calls", "prefix_hit_tokens", "cow_copies",
                "prefix_cached_pages"):
        assert st[key] > 0, key
    assert st["prefix_cached_pages"] == eng.kv.occupancy()["cached"]
    assert st["shared_pages"] == 0  # nothing but the index holds a page now


def test_decode_refuses_a_pending_clone(port_model):
    """A clone still queued at decode is a scheduler bug: decode asserts."""
    tm, tparams = port_model
    eng = GenerationEngine(tm, tparams, device="cpu", prefix_cache=True, **ENGINE)
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    eng.scheduler._admit()
    eng.kv._pending_copies.append((1, 2))
    with pytest.raises(AssertionError, match="CoW"):
        eng.scheduler._decode_active()


def test_spec_with_prefix_cache_and_eos(port_model):
    """Spec decode composes with prefix sharing (rollback drops only its
    own references) and with chunked prefill, and honours an EOS
    mid-round: the port's spec tokens are its sequential tokens."""
    tm, tparams = port_model
    base = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, 17).astype(np.int32)
    # two slots: the last two prompts admit behind the first two and hit
    # the cache, base[:16] covering whole cached pages (a clone)
    prompts = [base, np.concatenate([base, base[:5]]), base[:16], base]
    kw = dict(max_len=64, block_size=8, max_slots=2, decode_chunk=8, num_blocks=None,
              prefix_cache=True)
    want, _ = _serve(tm, tparams, prompts, n=10, **kw)
    eos = int(want[0][4])
    spec = SpecConfig(k=3, draft_codec="nf4")
    for extra in ({}, {"prefill_chunk": 5}):
        got, eng = _serve(tm, tparams, prompts, n=10, spec_decode=spec, **kw, **extra)
        assert got == want, extra
        st = eng.scheduler.stats()
        assert st["verify_calls"] > 0 and st["prefix_hit_tokens"] > 0
        occ = eng.kv.occupancy()
        assert occ["used"] == occ["cached"] and occ["reserved"] == 0
    seq, _ = _serve(tm, tparams, prompts, n=10, eos_id=eos, **kw)
    got, _ = _serve(tm, tparams, prompts, n=10, eos_id=eos, spec_decode=spec, **kw)
    assert got == seq and len(seq[0]) <= 5 and seq[0][-1] == eos

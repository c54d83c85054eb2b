"""Parity of the port's host KV tier (`repro_torch/serve/host_tier.py` and
the tier half of `serve/paged_cache.py`) with the JAX reference: the
analogs of `tests/test_tiered.py` (payload format, the tier store, park
validation, spill and verified restore, the corrupt-payload chaos path)
and of the hypothesis batteries of `tests/test_paged_cache.py` (rollback
with park and re-admit; four-class conservation under spill and
restore), driven on the port's cache and the reference's in lockstep.

Payloads are held byte for byte: the same planes pack to the same
header, blob and CRC32C in both packages, and after the same serve (in
the exact-rounding process, tests/torch_parity.py) the spilled payloads
of every KV kind are the reference's.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="install the [test] extra")
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.codecs import codec_wire_id as jcodec_wire_id
from repro.models.model import Model as JModel
from repro.serve import host_tier as jtier
from repro.serve.engine import GenerationEngine as JEngine

from repro_torch.core.codecs import codec_wire_id
from repro_torch.dist.fault import FaultInjector
from repro_torch.obs import MetricsRegistry, Observability
from repro_torch.serve.engine import GenerationEngine
from repro_torch.serve.host_tier import (HostTier, apply_page_planes, chain_key, crc32c,
                                         extract_page_planes, pack_payload,
                                         unpack_payload)
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.slo import RequestStatus
from test_torch_prefix import KV_KINDS, _cache, _port_params, _PortStub, _reference_params
from torch_parity import run_exact


@pytest.fixture(scope="module")
def port_model():
    return _port_params(_reference_params())


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _engine(port_model, **kw):
    tm, tparams = port_model
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_slots", 2)
    kw.setdefault("decode_chunk", 4)
    return GenerationEngine(tm, tparams, device="cpu", **kw)


# ---------------------------------------------------------------------------
# payload format: CRC32C, content keys, wire ids, pack/unpack
# ---------------------------------------------------------------------------

def test_crc32c_known_vector_and_streaming():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283  # the iSCSI check vector
    assert crc32c(b"456789", crc32c(b"123")) == 0xE3069283
    assert crc32c(b"123456789") != crc32c(b"123456798")
    # streaming across the vectorized path's threshold and segments
    blob = np.random.default_rng(1).integers(0, 256, 70_001, dtype=np.uint8).tobytes()
    for cut in (0, 1, 255, 16_383, 16_384, 40_000, 70_001):
        assert crc32c(blob[cut:], crc32c(blob[:cut])) == crc32c(blob)


@pytest.mark.parametrize("n", [16_383, 16_384, 16_385, 16_640, 16_639, 65_536,
                               65_536 + 255, 100_003])
def test_crc32c_equals_reference_around_segment_boundaries(n):
    blob = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert crc32c(blob) == jtier.crc32c(blob)
    assert crc32c(blob, 0x1234ABCD) == jtier.crc32c(blob, 0x1234ABCD)


@settings(max_examples=60, deadline=None)
@given(blob=st.one_of(st.binary(max_size=600), st.binary(min_size=16_000, max_size=40_000)),
       seed=st.integers(0, 2**32 - 1))
def test_crc32c_equals_reference_on_drawn_blobs(blob, seed):
    assert crc32c(blob) == jtier.crc32c(blob)
    assert crc32c(blob, seed) == jtier.crc32c(blob, seed)


def test_chain_key_is_the_references_content_address():
    k1 = chain_key(b"", b"abc")
    assert len(k1) == 16 and k1 == chain_key(b"", b"abc") == jtier.chain_key(b"", b"abc")
    assert chain_key(k1, b"abc") != k1 and chain_key(k1, b"abc") == jtier.chain_key(k1, b"abc")
    assert chain_key(b"", b"abd") != k1


def test_codec_wire_ids_are_pinned_and_equal_reference():
    names = ("none", "bf16", "bf8", "mxfp4", "int8", "int4", "nf4")
    assert [codec_wire_id(n) for n in names] == list(range(len(names)))
    assert [codec_wire_id(n) for n in names] == [jcodec_wire_id(n) for n in names]
    with pytest.raises(ValueError):
        codec_wire_id("zstd")


def _planes(seed=0):
    """Port planes (CPU tensors, bf16 included) and the same planes as the
    reference's numpy arrays (bf16 through ml_dtypes)."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    kp = rng.integers(0, 255, (2, 8, 2, 4), dtype=np.uint8)
    vp = rng.standard_normal((2, 8, 2, 4)).astype(ml_dtypes.bfloat16)
    ks = rng.standard_normal((2, 8, 2)).astype(np.float32)
    ppos = np.arange(8, dtype=np.int32)
    ref = {"kp": kp, "vp": vp, "ks": ks, "ppos": ppos}
    port = {"kp": torch.from_numpy(kp.copy()),
            "vp": torch.from_numpy(vp.view(np.int16).copy()).view(torch.bfloat16),
            "ks": torch.from_numpy(ks.copy()), "ppos": torch.from_numpy(ppos.copy())}
    return port, ref


def _fields(p):
    return (p.codec, p.wire_id, tuple((a, tuple(s), d) for a, s, d in p.planes),
            p.nbytes, p.crc, p.blob)


def test_payload_roundtrip_and_corruption_detection():
    planes, _ = _planes()
    p = pack_payload(planes, "int8")
    assert p.codec == "int8" and p.wire_id == codec_wire_id("int8")
    assert p.nbytes == len(p.blob) and p.crc == crc32c(p.blob)
    assert dict((a, d) for a, _, d in p.planes)["vp"] == "bfloat16"
    out = unpack_payload(p)
    assert set(out) == set(planes)
    for k in planes:
        assert out[k].dtype == planes[k].dtype and torch.equal(out[k], planes[k])
    flipped = bytes([p.blob[0] ^ 1]) + p.blob[1:]
    assert unpack_payload(replace(p, blob=flipped)) is None
    assert unpack_payload(replace(p, blob=p.blob[:-1])) is None  # truncated
    assert unpack_payload(replace(p, nbytes=p.nbytes - 1)) is None
    assert unpack_payload(replace(p, planes=p.planes[:-1])) is None  # trailing bytes


def test_payload_bytes_equal_reference_both_ways():
    """The same planes pack to the reference's header, blob and CRC; each
    package unpacks the other's payload to the same values (bf16 read back
    as bf16 without ml_dtypes on the port's side)."""
    port, ref = _planes(3)
    got, want = pack_payload(port, "bf8"), jtier.pack_payload(ref, "bf8")
    assert _fields(got) == _fields(want)
    back = unpack_payload(want)
    for k in ref:
        assert back[k].dtype == port[k].dtype and torch.equal(back[k], port[k])
    jback = jtier.unpack_payload(got)
    for k in ref:
        assert jback[k].dtype == ref[k].dtype
        assert np.asarray(jback[k]).tobytes() == np.asarray(ref[k]).tobytes()


def test_host_tier_capacity_lru_drop_notifies():
    with pytest.raises(ValueError, match="capacity_pages"):
        HostTier(capacity_pages=0)
    drops = []
    t = HostTier(capacity_pages=2)
    t.on_drop = drops.append
    p = pack_payload({"ppos": torch.zeros(4, dtype=torch.int32)}, "none")
    t.put(b"a", p)
    t.put(b"b", p)
    t.get(b"a")  # refresh: b becomes the LRU victim
    t.put(b"c", p)
    assert drops == [b"b"]
    assert t.pages == 2 and t.dropped_pages == 1 and t.spilled_pages == 3
    assert b"a" in t and b"c" in t and t.get(b"b") is None
    assert t.payload_bytes == 2 * p.nbytes


def test_host_tier_equals_reference_over_a_seeded_op_stream():
    """put / get / pop / corrupt_one in lockstep with the reference's store
    at capacity 5: keys in LRU order, drops, counters, the corrupted keys
    and every stored payload agree."""
    rng = np.random.default_rng(0)
    got, want = HostTier(capacity_pages=5), jtier.HostTier(capacity_pages=5)
    gd, wd = [], []
    got.on_drop, want.on_drop = gd.append, wd.append
    for step in range(300):
        op = rng.choice(["put", "put", "get", "pop", "corrupt"])
        key = bytes([int(rng.integers(0, 9))])
        if op == "put":
            n = int(rng.integers(0, 6))
            vals = rng.integers(0, 1000, n).astype(np.int32)
            got.put(key, pack_payload({"ppos": torch.from_numpy(vals.copy())}, "int8"))
            want.put(key, jtier.pack_payload({"ppos": vals}, "int8"))
        elif op == "get":
            a, b = got.get(key), want.get(key)
            assert (a is None) == (b is None)
        elif op == "pop":
            a, b = got.pop(key), want.pop(key)
            assert (a is None) == (b is None) and (a is None or _fields(a) == _fields(b))
        else:
            assert got.corrupt_one() == want.corrupt_one()
        assert got.keys() == want.keys() and gd == wd
        assert [_fields(got.get(k)) for k in got.keys()] == [
            _fields(want.get(k)) for k in want.keys()]
        assert (got.spilled_pages, got.dropped_pages, got.payload_bytes) == (
            want.spilled_pages, want.dropped_pages, want.payload_bytes)


def test_corrupt_one_is_deterministic_and_detected():
    t = HostTier()
    assert t.corrupt_one() is None
    p = pack_payload({"ppos": torch.arange(4, dtype=torch.int32)}, "none")
    t.put(b"k2", p)
    t.put(b"k1", p)
    assert t.corrupt_one() == b"k1"  # the smallest key: seeded schedules replay
    assert unpack_payload(t.get(b"k1")) is None
    assert unpack_payload(t.get(b"k2")) is not None
    t2 = HostTier()
    t2.put(b"e", pack_payload({}, "none"))
    assert t2.corrupt_one() == b"e"
    assert unpack_payload(t2.get(b"e")) is None


# ---------------------------------------------------------------------------
# the cache's tier half, host bookkeeping in lockstep with the reference
# ---------------------------------------------------------------------------

def test_park_rejects_unknown_and_already_parked_rids():
    c = _cache(4, 2)
    with pytest.raises(ValueError, match="unknown or already-parked"):
        c.park(0)
    c.admit(0, 4)
    c.write_slots(0, 0, 4)
    c.park(0, [1, 2, 3, 4])
    with pytest.raises(ValueError, match="unknown or already-parked"):
        c.park(0, [1, 2, 3, 4])
    with pytest.raises(ValueError, match="unknown or already-parked"):
        c.park(99)
    c.release(0)
    c.release(0)
    assert c.prefix.pages == 2


def test_tier_requires_the_prefix_index():
    with pytest.raises(ValueError, match="prefix_cache"):
        PagedKVCache(_PortStub(), num_blocks=4, block_size=2, tier=HostTier())


def test_spill_restore_and_corrupt_fallback_bookkeeping():
    """Spill, restore through admission, a corrupt payload's fallback and
    the capacity hook, step by step against the reference."""
    bs = 4
    c = _cache(12, bs, tier=True)
    prompt = np.arange(3 * bs + 1, dtype=np.int32)
    c.admit(0, len(prompt) + 2, prompt=prompt)
    c.write_slots(0, 0, len(prompt))
    c.prefix_insert(0, prompt)
    c.release(0)
    assert c.spill_all() == 3 and c.occupancy()["tiered"] == 3
    assert c.tiered_hit_pages(prompt) == 3
    assert c.admit(1, len(prompt) + 2, prompt=prompt) == 3 * bs
    assert c.pending_restores == 3 and c.tier_hit_tokens == 3 * bs
    ref, port = c._pair
    pages, planes = port.drain_restores()
    jpages, _ = ref.drain_restores()
    assert pages.tolist() == jpages.tolist() and len(planes) == 3
    c.release(1)
    c.spill_all()
    for cache in c._pair:
        cache.tier.corrupt_one()
    assert c.admit(2, len(prompt) + 2, prompt=prompt) < 3 * bs
    assert c.tier.corrupt_pages == 1 and c.tier.fallback_recomputes == 1
    c.drain_restores()


# ---------------------------------------------------------------------------
# conservation batteries (tests/test_paged_cache.py's hypothesis tests)
# ---------------------------------------------------------------------------

def _check_holders(cache, live):
    alloc = cache.allocator
    assert alloc.free_count + alloc.used_count == cache.num_blocks
    holders = {}
    for rid in live:
        for p in cache._tables[rid]:
            holders[p] = holders.get(p, 0) + 1
    for p in cache.prefix.page_multiset():
        holders[p] = holders.get(p, 0) + 1
    assert alloc.used_count == len(holders)
    for p, c in holders.items():
        assert alloc.ref_count(p) == c
    assert cache.reserved_blocks <= alloc.free_count


def _family(bs):
    base = list(range(1, 2 * bs + 1))
    return [base, base + list(range(100, 100 + bs + 1)), list(range(300, 300 + 2 * bs + 1))]


_ROPS = st.lists(st.tuples(st.sampled_from(["admit", "append", "rollback", "park", "evict"]),
                           st.integers(0, 7), st.integers(1, 9)),
                 min_size=1, max_size=60)


@settings(max_examples=50, deadline=None)
@given(ops=_ROPS, num_blocks=st.integers(8, 24), block_size=st.integers(1, 6))
def test_spec_rollback_conserves_pool_and_refcounts(ops, num_blocks, block_size):
    """Admissions (fresh prompts or a parked request's folded history),
    appends, spec rollbacks, parks and evictions on the port's cache and
    the reference's together: both hold the same state after every op,
    free + allocated is the pool, every refcount is its table holders plus
    the index pin, and rollback frees exactly the trimmed private pages."""
    bs = block_size
    c = _cache(num_blocks, bs)
    port = c._pair[1]
    prompts = _family(bs)
    live, parked, next_rid = {}, [], 0
    for kind, pick, n in ops:
        if kind == "admit":
            prompt = parked[pick % len(parked)] if parked and pick % 2 else prompts[
                pick % len(prompts)]
            kv_len = len(prompt) + n
            if kv_len <= num_blocks * bs and c.can_admit(kv_len, prompt):
                hit = c.admit(next_rid, kv_len, prompt=prompt)
                if prompt in parked:
                    parked.remove(prompt)
                live[next_rid] = [prompt, kv_len, hit, False]
                next_rid += 1
        elif kind == "park" and live:
            rid = sorted(live)[pick % len(live)]
            prompt, _, written, _ = live[rid]
            history = (prompt + [10_000 + rid * 97 + j
                                 for j in range(written - len(prompt))])[:written]
            reserved_before = c.reserved_blocks
            c.park(rid, history)
            assert rid not in port._tables and c.reserved_blocks <= reserved_before
            if len(history) >= bs:
                parked.append(history)
            del live[rid]
        elif kind == "append" and live:
            rid = sorted(live)[pick % len(live)]
            prompt, kv_len, written, inserted = live[rid]
            take = min(n, kv_len - written)
            if take > 0:
                for s in c.write_slots(rid, written, take).tolist():
                    assert port.allocator.ref_count(s // bs - 1) == 1
                live[rid][2] = written + take
            if not inserted and live[rid][2] >= len(prompt):
                c.prefix_insert(rid, prompt)
                live[rid][3] = True
        elif kind == "rollback" and live:
            rid = sorted(live)[pick % len(live)]
            prompt, _, written, _ = live[rid]
            if written > len(prompt):
                keep = max(len(prompt), written - n)
                before, free0 = len(port._tables[rid]), port.allocator.free_count
                c.rollback(rid, keep)
                keep_pages = min(before, port.blocks_for(keep))
                assert len(port._tables[rid]) == keep_pages
                assert port.allocator.free_count == free0 + before - keep_pages
                live[rid][2] = keep
        elif kind == "evict" and live:
            rid = sorted(live)[pick % len(live)]
            c.release(rid)
            del live[rid]
        c.drain_copies(max(1, port.pending_copies))
        c.drain_fresh_rows(num_blocks)
        _check_holders(port, live)
    for rid in list(live):
        c.release(rid)
    occ = c.occupancy()
    assert occ["used"] == occ["cached"] == port.prefix.pages


_TOPS = st.lists(st.tuples(st.sampled_from(["admit", "append", "park", "spill", "evict"]),
                           st.integers(0, 7), st.integers(1, 9)),
                 min_size=1, max_size=60)


@settings(max_examples=50, deadline=None)
@given(ops=_TOPS, num_blocks=st.integers(8, 24), block_size=st.integers(1, 6))
def test_tiered_spill_restore_conserves_four_classes(ops, num_blocks, block_size):
    """Admissions that may restore tiered pages, appends, parks, spills and
    evictions on both caches in lockstep: the same state after every op;
    free + held is the pool; the tiered pages match the tier's payloads
    one to one; refcounts are table holders plus resident index nodes, a
    restored page carrying both."""
    bs = block_size
    c = _cache(num_blocks, bs, tier=True)
    port = c._pair[1]
    prompts = _family(bs)
    live, parked, next_rid = {}, [], 0
    for kind, pick, n in ops:
        if kind == "admit":
            prompt = parked[pick % len(parked)] if parked and pick % 2 else prompts[
                pick % len(prompts)]
            kv_len = len(prompt) + n
            if kv_len <= num_blocks * bs and c.can_admit(kv_len, prompt):
                hit = c.admit(next_rid, kv_len, prompt=prompt)
                assert hit <= len(prompt) - 1 and hit <= c.blocks_held(next_rid) * bs
                if prompt in parked:
                    parked.remove(prompt)
                live[next_rid] = [prompt, kv_len, hit, False]
                next_rid += 1
        elif kind == "park" and live:
            rid = sorted(live)[pick % len(live)]
            prompt, _, written, _ = live[rid]
            history = (prompt + [10_000 + rid * 97 + j
                                 for j in range(written - len(prompt))])[:written]
            c.park(rid, history)
            if len(history) >= bs:
                parked.append(history)
            del live[rid]
        elif kind == "append" and live:
            rid = sorted(live)[pick % len(live)]
            prompt, kv_len, written, inserted = live[rid]
            take = min(n, kv_len - written)
            if take > 0:
                for s in c.write_slots(rid, written, take).tolist():
                    assert port.allocator.ref_count(s // bs - 1) == 1
                live[rid][2] = written + take
            if not inserted and live[rid][2] >= len(prompt):
                c.prefix_insert(rid, prompt)
                live[rid][3] = True
        elif kind == "spill":
            c.reclaim_index_pages(n)
        elif kind == "evict" and live:
            rid = sorted(live)[pick % len(live)]
            c.release(rid)
            del live[rid]
        c.drain_restores()
        c.drain_copies(max(1, port.pending_copies))
        c.drain_fresh_rows(num_blocks)
        occ = c.occupancy()
        assert occ["tiered"] == port.prefix.tiered_count == port.tier.pages
        assert sorted(port.prefix.tier_keys()) == sorted(port.tier.keys())
        assert port.pending_restores == 0
        _check_holders(port, live)
    for rid in list(live):
        c.release(rid)
    occ = c.occupancy()
    assert occ["used"] == occ["cached"] == port.prefix.pages
    assert occ["tiered"] == port.tier.pages == port.prefix.tiered_count
    assert port.tier.spilled_pages >= port.tier.pages + port.tier.restored_pages


# ---------------------------------------------------------------------------
# pools <-> payloads on the port's device pools (CPU here)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KV_KINDS)
def test_extract_apply_round_trip_in_place(port_model, kind):
    """A page's planes come out layer-stacked in the reference's shapes and
    go back into another page bitwise, in place: no pool tensor moves."""
    eng = _engine(port_model, kv_quant=kind, num_blocks=8, prefix_cache=True)
    (p,) = _prompts(port_model[0].cfg.vocab_size, (17,))
    eng.submit(p, max_new_tokens=3)
    eng.run_until_drained()
    pools, cfg = eng.kv.pools, port_model[0].cfg
    planes = extract_page_planes(pools, 1)
    assert set(planes) == set(pools[0])
    assert planes["ppos"].shape == (cfg.n_layers, 8)
    assert planes["kp"].shape == (cfg.n_layers,) + tuple(pools[0]["kp"].shape[1:])
    assert all(t.device.type == "cpu" for t in planes.values())
    ptrs = [t.data_ptr() for layer in pools for t in layer.values()]
    apply_page_planes(pools, np.asarray([5, 6]), [planes, planes])
    assert ptrs == [t.data_ptr() for layer in pools for t in layer.values()]
    for layer in pools:
        for name, t in layer.items():
            assert torch.equal(t[5], t[1]) and torch.equal(t[6], t[1])
    payload = pack_payload(planes, kind)
    back = unpack_payload(payload)
    assert all(torch.equal(back[n], planes[n]) for n in planes)
    with pytest.raises(ValueError, match="payloads"):
        apply_page_planes(pools, np.asarray([5]), [planes, planes])


# ---------------------------------------------------------------------------
# the engine: spill -> verified restore, bit-identical (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["bf8", "int8"])
def test_spill_restore_bit_identical(port_model, kv_quant):
    vocab = port_model[0].cfg.vocab_size
    (pa,) = _prompts(vocab, (17,))
    kw = dict(num_blocks=16, prefix_cache=True, host_tier=True, kv_quant=kv_quant)
    eng = _engine(port_model, **kw)
    a = eng.submit(pa, max_new_tokens=8)
    res1 = eng.run_until_drained()[a]
    assert eng.kv.prefix.pages == 2
    assert eng.kv.spill_all() == 2
    occ = eng.scheduler.check_invariants()
    assert occ["tiered"] == 2 and occ["cached"] == 0 and occ["used"] == 0
    b = eng.submit(pa, max_new_tokens=8)
    res2 = eng.run_until_drained()[b]
    np.testing.assert_array_equal(res2, res1)
    st = eng.scheduler.stats()
    assert st["tier_spilled_pages"] == 2 and st["tier_restored_pages"] == 2
    assert st["tier_hit_tokens"] == 16
    assert st["tier_corrupt"] == 0 and st["tier_fallback_recompute"] == 0
    eng.scheduler.check_invariants()
    ref = _engine(port_model, num_blocks=16, prefix_cache=True, kv_quant=kv_quant)
    r = ref.submit(pa, max_new_tokens=8)
    np.testing.assert_array_equal(ref.run_until_drained()[r], res1)


def test_admission_pressure_spills_instead_of_dropping(port_model):
    vocab = port_model[0].cfg.vocab_size
    pa, pb = _prompts(vocab, (17, 33))
    eng = _engine(port_model, max_slots=1, num_blocks=6, prefix_cache=True, host_tier=True)
    a = eng.submit(pa, max_new_tokens=4)
    res_a = eng.run_until_drained()[a]
    assert eng.kv.prefix.pages == 2
    eng.submit(pb, max_new_tokens=4)
    eng.run_until_drained()
    assert eng.scheduler.stats()["tier_spilled_pages"] >= 1
    eng.scheduler.check_invariants()
    a2 = eng.submit(pa, max_new_tokens=4)
    np.testing.assert_array_equal(eng.run_until_drained()[a2], res_a)
    st = eng.scheduler.stats()
    assert st["tier_restored_pages"] >= 1 and st["tier_fallback_recompute"] == 0
    eng.scheduler.check_invariants()


def test_tier_restore_metrics_and_gauges(port_model):
    vocab = port_model[0].cfg.vocab_size
    (pa,) = _prompts(vocab, (17,))
    obs = Observability(metrics=MetricsRegistry())
    eng = _engine(port_model, prefix_cache=True, host_tier=True, obs=obs)
    eng.submit(pa, max_new_tokens=4)
    eng.run_until_drained()
    eng.kv.spill_all()
    eng.submit(pa, max_new_tokens=4)
    eng.run_until_drained()
    assert obs.metrics.histogram("serve.tier.restore_wall_s", unit="s").count >= 1
    assert (obs.metrics.gauge("serve.pool.tiered_pages", unit="pages").value
            == eng.kv.occupancy()["tiered"])


def test_corrupt_payload_falls_back_to_recompute(port_model):
    vocab = port_model[0].cfg.vocab_size
    (pa,) = _prompts(vocab, (17,))
    eng = _engine(port_model, num_blocks=16, prefix_cache=True, host_tier=True)
    a = eng.submit(pa, max_new_tokens=8)
    res1 = eng.run_until_drained()[a]
    eng.kv.spill_all()
    assert eng.tier.corrupt_one() is not None
    b = eng.submit(pa, max_new_tokens=8)
    np.testing.assert_array_equal(eng.run_until_drained()[b], res1)
    st = eng.scheduler.stats()
    assert st["tier_corrupt"] == 1 and st["tier_fallback_recompute"] == 1
    eng.scheduler.check_invariants()


def test_corrupt_tier_page_fault_recomputes_only_affected(port_model):
    vocab = port_model[0].cfg.vocab_size
    pa, pb = _prompts(vocab, (17, 33))
    inj = FaultInjector()
    eng = _engine(port_model, prefix_cache=True, host_tier=True, injector=inj)
    a = eng.submit(pa, max_new_tokens=6)
    b = eng.submit(pb, max_new_tokens=6)
    res1 = eng.run_until_drained()
    eng.kv.spill_all()
    assert eng.tier.pages == 6
    inj.plan[eng.scheduler._round] = "corrupt_tier_page"
    a2 = eng.submit(pa, max_new_tokens=6)
    b2 = eng.submit(pb, max_new_tokens=6)
    res2 = eng.run_until_drained()
    assert any(k == "corrupt_tier_page" for _, k in inj.fired)
    np.testing.assert_array_equal(res2[a2], res1[a])
    np.testing.assert_array_equal(res2[b2], res1[b])
    st = eng.scheduler.stats()
    assert st["tier_corrupt"] == 1 and st["tier_fallback_recompute"] == 1
    assert st["tier_restored_pages"] >= 2
    assert eng.statuses[a2] == eng.statuses[b2] == RequestStatus.OK
    eng.scheduler.check_invariants()


def test_host_tier_needs_the_prefix_cache(port_model):
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(port_model, host_tier=True)
    eng = _engine(port_model, prefix_cache=True, host_tier=HostTier(capacity_pages=3))
    assert eng.tier.capacity_pages == 3 and eng.kv.tier is eng.tier


# ---------------------------------------------------------------------------
# the spilled payloads against the reference's, exact-rounding process
# ---------------------------------------------------------------------------

def _spilled(eng, prompts):
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    done = eng.run_until_drained()
    eng.kv.spill_all()
    tier = eng.kv.tier
    return [done[r].tolist() for r in rids], {k: tier.get(k) for k in sorted(tier.keys())}


def _bf16_words_apart(a, b):
    x = np.frombuffer(a, np.uint16).astype(np.int32)
    y = np.frombuffer(b, np.uint16).astype(np.int32)
    return int((x != y).sum()), int(np.abs(x - y).max()) if len(x) else 0


def payload_report(kinds):
    """{kind: "ok" or what differed, "moved/<kind>": bf16 words apart}:
    the same two prompts served and spilled in both packages (the
    reference on its stacked pool), then every tier payload compared."""
    jparams = _reference_params()
    tm, tparams = _port_params(jparams)
    prompts = _prompts(tm.cfg.vocab_size, (17, 26))
    kw = dict(max_len=64, block_size=8, max_slots=2, decode_chunk=4, num_blocks=16,
              prefix_cache=True, host_tier=True)
    out = {}
    for kind in kinds:
        jt, jp = _spilled(JEngine(JModel(jget_smoke_config("llama3-8b")), jparams,
                                  paged=True, kv_quant=kind, **kw), prompts)
        tt, tp = _spilled(GenerationEngine(tm, tparams, device="cpu", kv_quant=kind, **kw),
                          prompts)
        why, moved = "", 0
        if tt != jt:
            why = f"tokens {tt} != {jt}"
        elif list(tp) != list(jp) or not tp:
            why = f"keys {len(tp)} != {len(jp)}"
        for k in tp if not why else ():
            got, want = tp[k], jp[k]
            head = _fields(got)[:4]
            if head != _fields(want)[:4]:
                why = f"header {head} != {_fields(want)[:4]}"
                break
            if (got.crc, got.blob) != (want.crc, want.blob):
                if kind != "none":
                    why = "blob or crc differ"
                    break
                # unquantized: every plane but ppos is bf16 words
                off, n_moved = 0, 0
                for path, shape, dt in got.planes:
                    size = int(np.prod(shape)) * (2 if dt == "bfloat16" else 4)
                    a, b = got.blob[off:off + size], want.blob[off:off + size]
                    if dt != "bfloat16" and a != b:
                        why = f"plane {path} differs"
                    elif dt == "bfloat16":
                        n_moved += _bf16_words_apart(a, b)[0]
                    off += size
                moved += n_moved
        out[kind] = why or "ok"
        out[f"moved/{kind}"] = moved
    return out


@pytest.fixture(scope="module")
def exact_payloads():
    return run_exact("test_torch_tier", "payload_report", list(KV_KINDS))


@pytest.mark.parametrize("kind", KV_KINDS)
def test_spilled_payloads_equal_reference(exact_payloads, kind):
    """After the same serve and spill, the port's tier holds the
    reference's keys, and each payload's header, blob and CRC32C are the
    reference's, for all six kinds: the unquantized pool's planes are
    compared word by word too (bf16 K/V, positions), and no bf16 word
    moved on this traffic."""
    assert exact_payloads[kind] == "ok", exact_payloads[kind]
    assert exact_payloads[f"moved/{kind}"] == 0

"""Window freeing in the port (`PagedKVCache.free_behind`, the scheduler's
`_free_window_pages`, the engine's all-local arming) against the
reference's.

The cache tests drive the port's `PagedKVCache` and the reference's
together (`test_torch_prefix.Twin`: every call's result or error and the
whole bookkeeping after it must agree): the analogs of
tests/test_paged_cache.py's idempotence test and window-freeing battery
and of tests/test_prefix_cache.py's random lifecycle, as seeded numpy op
streams. Then the reference's all-local variant of the llama3-8b smoke
config (tests/test_paged_attention.py) is served by both engines: the host
arrays, `window_freed_pages` and the stats must match in this process, and
the tokens in the exact-rounding process (tests/torch_parity.py); no page
may leak. gemma2-2b, whose stack alternates local and global layers, never
arms the freeing.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine
from repro_torch.serve.scheduler import STAT_UNITS
from test_torch_engine import _logs_equal, _record
from test_torch_prefix import _cache
from torch_parity import run_exact

SEEDS = range(4)


# ---------------------------------------------------------------------------
# the cache, port and reference driven together
# ---------------------------------------------------------------------------

def test_free_behind_is_idempotent_and_appends_still_work():
    """Freeing is page-granular and idempotent, freed entries read the null
    page, appends continue on fresh pages, and a write into the freed span
    fails loudly, in both packages alike."""
    c = _cache(num_blocks=6, block_size=2, prefix=False)
    c.admit(0, 12)
    c.write_slots(0, 0, 8)
    assert c.blocks_held(0) == 4
    assert c.free_behind(0, 5) == 2
    assert c.free_behind(0, 5) == 0
    assert c.blocks_held(0) == 2
    row = c.block_table_row(0, 6)
    assert (row[:2] == 0).all() and (row[2:4] > 0).all()
    c.write_slots(0, 8, 2)
    assert c.blocks_held(0) == 3
    with pytest.raises(ValueError, match="window-freed"):
        c.write_slots(0, 1, 1)
    c.release(0)
    assert c.allocator.free_count == 6


@pytest.mark.parametrize("seed", SEEDS)
def test_window_freeing_never_leaks_blocks(seed):
    """The analog of tests/test_paged_cache.py's window battery as a seeded
    stream of admit / append / free_behind / evict: free + allocated is the
    pool, a live request holds exactly the pages of its live span, freed
    entries read the null page, reservations never oversubscribe."""
    rng = np.random.default_rng(seed)
    num_blocks, bs = int(rng.integers(4, 25)), int(rng.integers(1, 9))
    window = int(rng.integers(1, 21))
    c = _cache(num_blocks=num_blocks, block_size=bs, prefix=False)
    live, next_rid = {}, 0
    for _ in range(120):
        kind = rng.choice(["admit", "append", "window", "evict"])
        pick, n = int(rng.integers(0, 8)), int(rng.integers(1, 10))
        if kind == "admit":
            kv_len = min(n * bs, num_blocks * bs)
            if c.can_admit(kv_len):
                c.admit(next_rid, kv_len)
                live[next_rid] = [kv_len, 0]
                next_rid += 1
        elif kind == "append" and live:
            rid = sorted(live)[pick % len(live)]
            budget, written = live[rid]
            take = min(n, budget - written)
            if take > 0:
                assert (c.write_slots(rid, written, take) >= bs).all()
                live[rid][1] += take
        elif kind == "window" and live:
            rid = sorted(live)[pick % len(live)]
            c.free_behind(rid, max(0, live[rid][1] - window))
        elif kind == "evict" and live:
            rid = sorted(live)[pick % len(live)]
            c.release(rid)
            del live[rid]
        alloc = c.allocator
        assert alloc.free_count + alloc.used_count == num_blocks
        assert sum(c.blocks_held(r) for r in live) == alloc.used_count
        for rid, (_, written) in live.items():
            total = math.ceil(written / bs)
            dead_max = max(0, written - window) // bs
            assert total - dead_max <= c.blocks_held(rid) <= total
            assert (c.block_table_row(rid, num_blocks) >= 0).all()
        assert c.reserved_blocks <= alloc.free_count
    for rid in list(live):
        c.release(rid)
    assert c.allocator.free_count == num_blocks and c.reserved_blocks == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_reservation_conserved_under_random_lifecycle(seed):
    """The analog of tests/test_prefix_cache.py's random lifecycle: freeing
    behind the window returns pages but never touches a reservation."""
    rng = np.random.default_rng(seed)
    bs = 4
    c = _cache(num_blocks=16, block_size=bs, prefix=False)
    live, next_rid = {}, 0
    for _ in range(200):
        op = rng.choice(["admit", "append", "window", "evict"])
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
        elif op == "window" and live:
            rid = int(rng.choice(list(live)))
            before = c.reserved_blocks
            c.free_behind(rid, max(0, live[rid][1] - bs))
            assert c.reserved_blocks == before
        elif op == "evict" and live:
            rid = int(rng.choice(list(live)))
            c.release(rid)
            del live[rid]
        assert c.free_blocks + c.allocator.used_count == c.num_blocks
        assert c.allocator.used_count == sum(c.blocks_held(r) for r in live)
        assert c.reserved_blocks <= c.free_blocks
    for rid in list(live):
        c.release(rid)
    assert c.free_blocks == c.num_blocks and c.reserved_blocks == 0


def test_prefix_insert_stops_at_a_window_freed_hole():
    """A cached prefix runs from position 0: indexing a table whose front
    pages were freed pins nothing; park, rollback and release skip the
    holes."""
    c = _cache(num_blocks=12, block_size=4)
    prompt = list(range(1, 17))
    c.admit(0, 20, prompt=prompt)
    c.write_slots(0, 0, 16)
    assert c.free_behind(0, 9) == 2
    assert c.prefix_insert(0, prompt) == 0
    c.write_slots(0, 16, 4)
    assert c.rollback(0, 17) == 0
    assert c.park(0, prompt) == 3
    assert c.allocator.free_count == 12
    c.admit(1, 12, prompt=prompt[:8])
    c.write_slots(1, 0, 12)
    assert c.free_behind(1, 4) == 1
    assert c.held_pages(1) == c._pair[1].held_pages(1)
    c.release(1)
    assert c.allocator.free_count == 12


# ---------------------------------------------------------------------------
# the all-local stack served by both engines
# ---------------------------------------------------------------------------

LOCAL = dict(block_pattern=("attn_local",), window=16)
ENGINES = {"plain": dict(max_len=64, block_size=8, max_slots=2, decode_chunk=4),
           "chunked": dict(max_len=64, block_size=8, max_slots=2, decode_chunk=4,
                           prefill_chunk=8)}
_PARAMS = {}


def _local_params():
    if "p" not in _PARAMS:
        cfg = dataclasses.replace(jget_smoke_config("llama3-8b"), **LOCAL)
        _PARAMS["p"] = jcompress_tree(JModel(cfg).init(jax.random.PRNGKey(0)),
                                      jget_spec("bf8_50"))
    return _PARAMS["p"]


def _serve_local(variant, kind):
    """Both engines over the reference's two prompts (24 and 9 tokens, 12
    new): returns (reference, port) dicts of tokens, call logs, stats, the
    engine's local window and whether the pool drained to empty."""
    jcfg = dataclasses.replace(jget_smoke_config("llama3-8b"), **LOCAL)
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), **LOCAL)
    jparams = _local_params()
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    kw = dict(ENGINES[variant], kv_quant=kind)
    engines = ((JEngine(JModel(jcfg), jparams, paged=True, **kw), False),
               (GenerationEngine(Model(tcfg), tparams, device="cpu", **kw), True))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab_size, 24).astype(np.int32),
               rng.integers(0, tcfg.vocab_size, 9).astype(np.int32)]
    out = []
    for eng, port in engines:
        log = _record(eng, port)
        rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        done = eng.run_until_drained()
        st = eng.scheduler.stats()
        out.append({
            "tokens": [np.asarray(done[r]).tolist() for r in rids],
            "log": log,
            "stats": {k: st[k] for k in STAT_UNITS if k in st},
            "window": eng.scheduler.local_window,
            "drained": eng.kv.free_blocks == eng.kv.num_blocks,
        })
    return out


@pytest.mark.parametrize("kind", ["none", "int8"])
@pytest.mark.parametrize("variant", sorted(ENGINES))
def test_all_local_stack_frees_the_references_pages(variant, kind):
    """Every host array handed to the device (block tables with their
    null-page holes included), every stat and `window_freed_pages` are
    the reference's; pages do slide out, and none leaks."""
    ref, got = _serve_local(variant, kind)
    assert got["window"] == ref["window"] == 16
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"]
    assert got["stats"]["window_freed_pages"] > 0
    assert got["drained"] and ref["drained"]


def local_report(variants, kinds):
    """{"variant/kind": "ok" or what differed}: tokens and every device-call
    argument, sampled tokens included."""
    out = {}
    for variant in variants:
        for kind in kinds:
            ref, got = _serve_local(variant, kind)
            name = f"{variant}/{kind}"
            out[name] = "ok"
            if got["tokens"] != ref["tokens"]:
                out[name] = f"tokens {got['tokens']} != {ref['tokens']}"
            elif not _logs_equal(ref["log"], got["log"], with_tokens=True):
                out[name] = "device-call arguments differ"
    return out


@pytest.fixture(scope="module")
def exact_local():
    return run_exact("test_torch_window", "local_report", sorted(ENGINES), ["none", "int8"])


@pytest.mark.parametrize("kind", ["none", "int8"])
@pytest.mark.parametrize("variant", sorted(ENGINES))
def test_all_local_stack_greedy_tokens_match_reference(exact_local, variant, kind):
    assert exact_local[f"{variant}/{kind}"] == "ok"


def test_gemma2_never_arms_window_freeing():
    """gemma2-2b alternates local and global layers: one global layer keeps
    the whole history live, so the engine leaves `local_window` unset."""
    cfg = get_smoke_config("gemma2-2b")
    model = Model(cfg)
    import torch

    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = GenerationEngine(model, params, max_len=64, block_size=8, device="cpu")
    assert eng.scheduler.local_window is None
    assert set(model.kinds) == {"attn_local", "attn"}

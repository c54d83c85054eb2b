"""Engine snapshots in the port (`checkpoint/ckpt.py`, `GenerationEngine.
snapshot` / `restore`) against the reference's.

The analogs of the reference's tests/test_tiered.py snapshot tests run on
the port alone: the directory format round-trips and publishes atomically,
a snapshot taken in mid-serve restores into a fresh engine whose tokens
are bitwise an uninterrupted serve's (port against port, as the reference
pins itself), and `restore` refuses an engine that could not resume the
same tokens. The two packages write the same bytes, so a snapshot written
by one restores in the other: those checks run in a process where XLA
rounds every bf16 op (tests/torch_parity.py), where the two packages'
tokens are bitwise equal, and hold the resumed tokens to the other
package's uninterrupted serve.
"""
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import load_snapshot as jload_snapshot
from repro.checkpoint.ckpt import save_snapshot as jsave_snapshot
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.codecs import codec_from_wire_id as jcodec_from_wire_id
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine

from repro_torch.checkpoint.ckpt import load_snapshot, save_snapshot
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.codecs import codec_from_wire_id, codec_wire_id
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine
from repro_torch.serve.host_tier import HostTier
from repro_torch.serve.slo import RequestStatus
from torch_parity import run_exact

ARCH = "llama3-8b"
ENGINE = dict(max_len=64, block_size=8, max_slots=2, decode_chunk=4)
TIERED = dict(num_blocks=16, prefix_cache=True, host_tier=True)
_CACHE = {}


def _jparams():
    if "p" not in _CACHE:
        _CACHE["p"] = JModel(jget_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    return _CACHE["p"]


def _tparams():
    if "t" not in _CACHE:
        _CACHE["t"] = params_from_jax(jax.device_get(_jparams()), get_smoke_config(ARCH),
                                      device="cpu")
    return _CACHE["t"]


def _engine(port: bool, **kw):
    kw = {**ENGINE, **kw}
    if port:
        return GenerationEngine(Model(get_smoke_config(ARCH)), _tparams(), device="cpu", **kw)
    return JEngine(JModel(jget_smoke_config(ARCH)), _jparams(), paged=True, **kw)


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# the directory format
# ---------------------------------------------------------------------------

def test_save_load_snapshot_roundtrip_and_atomicity(tmp_path):
    """Arrays, tensors and the manifest round-trip; bf16 comes back as a
    bf16 tensor of the same bits; a second save replaces the directory
    whole; a directory without a manifest is refused."""
    d = str(tmp_path / "snap")
    w = torch.arange(4, dtype=torch.float32).bfloat16()
    arrays = {"node/0/blob": np.frombuffer(b"hello", np.uint8), "w": w,
              "empty": np.zeros(0, np.uint8)}
    meta = {"version": 1, "nodes": [{"crc": 123, "planes": [["kp", [2], "u1"]]}]}
    save_snapshot(d, arrays, meta)
    arr2, meta2 = load_snapshot(d)
    assert meta2 == meta
    assert arr2["w"].dtype == torch.bfloat16 and torch.equal(arr2["w"], w)
    assert bytes(arr2["node/0/blob"]) == b"hello"
    assert arr2["empty"].size == 0
    save_snapshot(d, {"only": np.ones(1)}, {"version": 1})
    arr3, _ = load_snapshot(d)
    assert set(arr3) == {"only"}
    assert not os.path.exists(d + ".tmp")
    os.remove(os.path.join(d, "manifest.json"))  # a torn snapshot
    with pytest.raises(FileNotFoundError, match="no complete snapshot"):
        load_snapshot(d)
    with pytest.raises(FileNotFoundError, match="no complete snapshot"):
        load_snapshot(str(tmp_path / "missing"))


def test_snapshot_files_cross_packages(tmp_path):
    """Each package reads the other's directory: the same keys ("/" under
    the "§" escape), the same manifest, bf16 as the same 16-bit words."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**16, 8).astype(np.uint16)
    jw = words.view(ml_dtypes.bfloat16)
    tw = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    meta = {"version": 1, "tick": 7}
    blob = np.frombuffer(b"\x00\x01\xff", np.uint8)
    jsave_snapshot(str(tmp_path / "j"), {"req/0/w": jw, "node/0/blob": blob}, meta)
    got, gmeta = load_snapshot(str(tmp_path / "j"))
    assert gmeta == meta and set(got) == {"req/0/w", "node/0/blob"}
    assert torch.equal(got["req/0/w"].view(torch.int16), tw.view(torch.int16))
    assert np.array_equal(got["node/0/blob"], blob)
    save_snapshot(str(tmp_path / "t"), {"req/0/w": tw, "node/0/blob": blob}, meta)
    back, bmeta = jload_snapshot(str(tmp_path / "t"))
    assert bmeta == meta and back["req/0/w"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(back["req/0/w"].view(np.uint16), words)
    with open(tmp_path / "j" / "manifest.json") as a, open(tmp_path / "t" / "manifest.json") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("wire_id", range(7))
def test_codec_from_wire_id_is_the_references(wire_id):
    name = codec_from_wire_id(wire_id)
    assert name == jcodec_from_wire_id(wire_id)
    assert codec_wire_id(name) == wire_id
    with pytest.raises(ValueError, match="unknown codec wire id"):
        codec_from_wire_id(99)


# ---------------------------------------------------------------------------
# snapshot / restore in the port
# ---------------------------------------------------------------------------

def _cycle(tmp_path, kw, port_writes=True, port_restores=True):
    """Serve two sessions uninterrupted, then again with a snapshot after
    two rounds (the short one finished but undrained, the long one in
    mid-decode), restore into a fresh engine and drain it. Returns the
    uninterrupted results, the restored results, the rids, the snapshot's
    counts and the fresh engine."""
    pa, pb = _prompts(get_smoke_config(ARCH).vocab_size, (17, 33))
    ref = _engine(port_writes, **kw)
    ra, rb = ref.submit(pa, max_new_tokens=4), ref.submit(pb, max_new_tokens=12)
    want = ref.run_until_drained()
    eng = _engine(port_writes, **kw)
    a, b = eng.submit(pa, max_new_tokens=4), eng.submit(pb, max_new_tokens=12)
    assert (a, b) == (ra, rb)
    eng.scheduler.step()
    eng.scheduler.step()
    snap = str(tmp_path / "snap")
    counts = eng.snapshot(snap)
    fresh = _engine(port_restores, **kw)
    assert fresh.restore(snap) == counts
    got = fresh.run_until_drained()
    return want, got, (a, b), counts, fresh, eng


@pytest.mark.parametrize("kv_quant,temperature", [("bf8", 0.0), ("int8", 0.7)])
def test_snapshot_restore_resumes_bit_identically(tmp_path, kv_quant, temperature):
    """The analog of the reference's test_snapshot_restore_resumes_bit_
    identically: the restored engine starts warm at no device cost, the
    parked session resumes through the tier with the uninterrupted serve's
    tokens, the undrained result survives, and the snapshotted engine
    finishes the same tokens too."""
    kw = dict(TIERED, kv_quant=kv_quant, temperature=temperature)
    want, got, (a, b), counts, fresh, eng = _cycle(tmp_path, kw)
    assert counts["nodes"] > 0 and counts["requests"] >= 1
    np.testing.assert_array_equal(got[b], want[b])
    np.testing.assert_array_equal(got[a], want[a])
    assert fresh.statuses[b] == RequestStatus.OK
    st = fresh.scheduler.stats()
    assert st["tier_restored_pages"] > 0 and st["tier_hit_tokens"] > 0
    assert st["tier_fallback_recompute"] == 0
    fresh.scheduler.check_invariants()
    again = eng.run_until_drained()
    np.testing.assert_array_equal(again[b], want[b])
    eng.scheduler.check_invariants()


def test_restored_engine_starts_with_every_page_in_the_tier(tmp_path):
    pa, = _prompts(get_smoke_config(ARCH).vocab_size, (33,))
    eng = _engine(True, **TIERED, kv_quant="int8")
    eng.submit(pa, max_new_tokens=4)
    eng.run_until_drained()
    snap = str(tmp_path / "snap")
    counts = eng.snapshot(snap)
    fresh = _engine(True, **TIERED, kv_quant="int8")
    fresh.restore(snap)
    occ = fresh.kv.occupancy()
    assert occ["used"] == 0 and occ["tiered"] == counts["nodes"] == 4
    assert fresh.tier.state().keys() == eng.tier.state().keys()


def test_restore_validates_compatibility(tmp_path):
    """Restore refuses what would break the resumed tokens or the tier's
    audit: another codec, block size, seed or temperature, a used engine,
    an undersized tier, a missing snapshot, an engine without a tier."""
    pa, = _prompts(get_smoke_config(ARCH).vocab_size, (17,))
    kw = dict(TIERED, kv_quant="int8")
    eng = _engine(True, **kw)
    eng.submit(pa, max_new_tokens=4)
    eng.run_until_drained()
    snap = str(tmp_path / "snap")
    eng.snapshot(snap)
    for over, what in ((dict(kv_quant="bf8"), "kv_quant"), (dict(seed=1), "seed"),
                       (dict(temperature=0.5), "temperature"),
                       (dict(block_size=16), "block_size")):
        with pytest.raises(ValueError, match=f"{what} mismatch"):
            _engine(True, **{**kw, **over}).restore(snap)
    used = _engine(True, **kw)
    used.submit(pa, max_new_tokens=2)
    used.run_until_drained()
    with pytest.raises(RuntimeError, match="fresh engine"):
        used.restore(snap)
    with pytest.raises(ValueError, match="capacity"):
        _engine(True, **{**kw, "host_tier": HostTier(capacity_pages=1)}).restore(snap)
    with pytest.raises(FileNotFoundError):
        _engine(True, **kw).restore(str(tmp_path / "missing"))
    plain = _engine(True, prefix_cache=True)
    with pytest.raises(RuntimeError, match="host_tier"):
        plain.snapshot(snap)
    with pytest.raises(RuntimeError, match="host_tier"):
        plain.restore(snap)


# ---------------------------------------------------------------------------
# across the packages (exact-rounding process)
# ---------------------------------------------------------------------------

CROSS = {"jax_writes_greedy": (False, True, "int8", 0.0),
         "jax_writes_t07": (False, True, "int8", 0.7),
         "port_writes_greedy": (True, False, "int8", 0.0),
         "port_writes_t07": (True, False, "nf4", 0.7)}


def cross_report(names, root):
    """{name: "ok" or what differed}: one package snapshots in mid-serve,
    the other restores and drains; the resumed tokens and the undrained
    result must be the writer's uninterrupted serve's."""
    import pathlib

    out = {}
    for name in names:
        port_writes, port_restores, kv, temp = CROSS[name]
        d = pathlib.Path(root) / name
        d.mkdir(parents=True, exist_ok=True)
        want, got, (a, b), counts, fresh, _ = _cycle(
            d, dict(TIERED, kv_quant=kv, temperature=temp), port_writes, port_restores)
        out[name] = "ok"
        for rid in (a, b):
            if np.asarray(got[rid]).tolist() != np.asarray(want[rid]).tolist():
                out[name] = f"rid {rid}: {np.asarray(got[rid]).tolist()} != " \
                            f"{np.asarray(want[rid]).tolist()}"
        if counts["nodes"] == 0 or counts["requests"] < 1:
            out[name] = f"nothing parked: {counts}"
        st = fresh.scheduler.stats()
        if out[name] == "ok" and st["tier_restored_pages"] == 0:
            out[name] = "the resume did not restore from the tier"
    return out


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cross"))
    return run_exact("test_torch_snapshot", "cross_report", sorted(CROSS), root)


@pytest.mark.parametrize("name", sorted(CROSS))
def test_a_snapshot_restores_in_the_other_package(cross, name):
    assert cross[name] == "ok"

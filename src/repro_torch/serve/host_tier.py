"""Host memory tier for spilled KV pages (the counterpart of
`repro/serve/host_tier.py`).

A tiered page leaves device memory as the KV codec's packed planes
(codes, scale planes, the position plane), with a header that names the
codec, its wire id, each plane's path, shape and dtype, the payload length
and a CRC32C of the blob. Restoring a page is a checksum-verified upload,
never a recompute; a corrupt or missing payload degrades to recompute (the
caller drops the prefix-index subtree and prefills), never to a crash or a
wrong token.

The payload bytes are the reference's for the same page. The reference's
uniform stack keeps one pool dict with a leading layer axis; the port
keeps one dict of planes per layer (`models/layers.py`
`init_paged_kv_cache`), so a page's planes are gathered across layers on
the device into the reference's layer-stacked shapes, `kp`/`vp`
(L, bs, Hkv, W), `ppos` (L, bs), `ks`/`vs` (L, bs, Hkv), and cross to the
host in one copy. bf16 planes travel as their raw 16-bit words under the
dtype name "bfloat16", as numpy with `ml_dtypes` writes them; host planes
are CPU tensors, so nothing here needs `ml_dtypes`.

Tier keys are content addresses (`chain_key`): a radix-index node's key
hashes its parent's key and its own token chunk, and since attention is
causal the root-to-node path fixes the page's KV.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.codecs import codec_wire_id


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli)
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> Tuple[int, ...]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C_TABLE = _make_crc32c_table()
_CRC32C_TABLE_NP = np.asarray(_CRC32C_TABLE, np.uint32)
_SEGMENT_LOG2 = 8
_SEGMENT = 1 << _SEGMENT_LOG2  # bytes per segment of the vectorized pass
_VECTOR_MIN = 16384     # shorter inputs take the byte loop


def _crc_loop(c: int, data) -> int:
    """The CRC register after feeding `data` byte by byte from register `c`
    (no pre- or post-inversion)."""
    for b in data:
        c = (c >> 8) ^ _CRC32C_TABLE[(c ^ b) & 0xFF]
    return c


def _apply_columns(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """GF(2) matrix (32 column images of the single bits) times each
    register in `v`."""
    out = np.zeros(v.shape, np.uint32)
    for i in range(32):
        out ^= np.where((v >> np.uint32(i)) & np.uint32(1), cols[i], np.uint32(0))
    return out


class _ZeroShift:
    """The linear map of feeding `n` zero bytes into the CRC register, as
    four byte tables: shift(v) = T0[v & 255] ^ T1[v >> 8 & 255] ^ ..."""

    def __init__(self, cols: np.ndarray):
        self.cols = cols
        b = np.arange(256, dtype=np.uint32)
        self.tables = [_apply_columns(cols, b << np.uint32(8 * k)) for k in range(4)]

    def __call__(self, v):
        t = self.tables
        if isinstance(v, np.ndarray):
            return (t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF]
                    ^ t[2][(v >> 16) & 0xFF] ^ t[3][v >> 24])
        return int(t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF]
                   ^ t[2][(v >> 16) & 0xFF] ^ t[3][v >> 24])

    def square(self) -> "_ZeroShift":
        return _ZeroShift(self(self.cols))


_SHIFTS: List[_ZeroShift] = []  # _SHIFTS[k]: 2**k zero bytes


def _shift_pow2(k: int) -> _ZeroShift:
    if not _SHIFTS:
        one = np.asarray([_crc_loop(1 << i, b"\0") for i in range(32)], np.uint32)
        _SHIFTS.append(_ZeroShift(one))
    while len(_SHIFTS) <= k:
        _SHIFTS.append(_SHIFTS[-1].square())
    return _SHIFTS[k]


def _shift(c: int, n: int) -> int:
    """Register `c` after `n` zero bytes."""
    k = 0
    while n:
        if n & 1:
            c = _shift_pow2(k)(c)
        n >>= 1
        k += 1
    return c


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C checksum (the iSCSI/storage polynomial, e.g.
    crc32c(b"123456789") == 0xE3069283), streamable like the reference's:
    crc32c(b, crc32c(a)) == crc32c(a + b).

    The reference feeds one byte at a time in Python, which a full-width
    page (about 2.1 MB) makes the cost of every spill and restore. Here
    long inputs run as segments of `_SEGMENT` bytes, all segments one byte
    column at a time in numpy, and the segments' CRCs fold pairwise with
    the CRC's zero-byte shift (a GF(2) linear map):
    crc(A + B) = shift(crc(A), len(B)) ^ crc(B) for registers started at
    0. The result is the reference's, bit for bit."""
    c = ~crc & 0xFFFFFFFF
    n = len(data)
    if n < _VECTOR_MIN:
        return ~_crc_loop(c, data) & 0xFFFFFFFF
    buf = np.frombuffer(data, np.uint8)
    s = n // _SEGMENT
    cols = np.ascontiguousarray(buf[: s * _SEGMENT].reshape(s, _SEGMENT).T)
    reg = np.zeros(s, np.uint32)
    table = _CRC32C_TABLE_NP
    for row in cols:  # every segment's register, one byte column at a time
        reg = (reg >> np.uint32(8)) ^ table[(reg ^ row) & np.uint32(0xFF)]
    level = 0  # segments of _SEGMENT * 2**level bytes
    while len(reg) > 1:
        if len(reg) % 2:
            # a leading all-zero segment leaves a register started at 0 at 0
            reg = np.concatenate([np.zeros(1, np.uint32), reg])
        reg = _shift_pow2(level + _SEGMENT_LOG2)(reg[0::2]) ^ reg[1::2]
        level += 1
    c = _shift(c, s * _SEGMENT) ^ int(reg[0])
    return ~_crc_loop(c, buf[s * _SEGMENT:].tolist()) & 0xFFFFFFFF


def chain_key(parent_key: bytes, chunk: bytes) -> bytes:
    """Content address of a radix-index node: hash of the parent's key and
    this node's token-chunk bytes. The root's key is b""."""
    return hashlib.blake2b(parent_key + chunk, digest_size=16).digest()


# ---------------------------------------------------------------------------
# page payloads: header + packed plane bytes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TierPayload:
    """One spilled page: a self-describing header and the concatenated
    plane bytes. `planes` lists (path, shape, dtype name) in blob order;
    `crc` is CRC32C over the blob; `codec` names the KV codec whose packed
    planes the blob carries ("none" for an unquantized pool) and `wire_id`
    is its stable numeric id."""

    codec: str
    wire_id: int
    planes: Tuple[Tuple[str, Tuple[int, ...], str], ...]
    nbytes: int
    crc: int
    blob: bytes


_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _plane_bytes(a) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, raw bytes) of a host plane: a CPU tensor (bf16
    as its 16-bit words) or a numpy array."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        return tuple(a.shape), a.dtype.name, a.tobytes()
    t = a.detach().contiguous()
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return tuple(t.shape), _DTYPE_NAMES[t.dtype], words.numpy().tobytes()


def pack_payload(planes: Dict[str, object], codec: str) -> TierPayload:
    """Pack one page's planes (page axis already removed) into a
    checksummed payload. Plane order is sorted by path, so identical
    content always packs to identical bytes."""
    header: List[Tuple[str, Tuple[int, ...], str]] = []
    parts: List[bytes] = []
    for path in sorted(planes):
        shape, name, raw = _plane_bytes(planes[path])
        header.append((path, shape, name))
        parts.append(raw)
    blob = b"".join(parts)
    return TierPayload(codec=codec, wire_id=codec_wire_id(codec),
                       planes=tuple(header), nbytes=len(blob), crc=crc32c(blob),
                       blob=blob)


def _host_plane(blob, off: int, shape, name: str) -> Tuple[torch.Tensor, int]:
    """A CPU tensor of `shape` and dtype `name` from blob[off:], and its
    byte length."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unknown plane dtype {name!r}")
    dtype = _TORCH_DTYPES[name]
    size = torch.empty((), dtype=dtype).element_size()
    count = int(np.prod(shape, dtype=np.int64))
    words = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[size]
    t = torch.from_numpy(np.frombuffer(blob, dtype=words, count=count, offset=off).copy())
    t = t.to(torch.bool) if dtype == torch.bool else t.view(dtype)
    return t.reshape(tuple(shape)), count * size


def unpack_payload(payload: TierPayload) -> Optional[Dict[str, torch.Tensor]]:
    """Verify the checksum and unpack the blob into per-plane CPU tensors.
    Returns None on any integrity failure (length or CRC mismatch, planes
    that do not tile the blob): the caller falls back to recompute;
    corruption is never an exception."""
    if len(payload.blob) != payload.nbytes:
        return None
    if crc32c(payload.blob) != payload.crc:
        return None
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for path, shape, name in payload.planes:
        try:
            out[path], n = _host_plane(payload.blob, off, shape, name)
        except ValueError:  # the planes claim more bytes than the blob holds
            return None
        off += n
    if off != payload.nbytes:
        return None
    return out


# ---------------------------------------------------------------------------
# pool <-> payload plumbing
# ---------------------------------------------------------------------------

def _split(blob: torch.Tensor, meta) -> List[torch.Tensor]:
    """Typed views of a uint8 `blob` laid out as `meta` (shape, dtype)."""
    out, off = [], 0
    for shape, dtype in meta:
        size = torch.empty((), dtype=dtype).element_size()
        n = math.prod(shape) * size
        part = blob[off:off + n]
        if off % size:
            part = part.clone()  # a wider view needs an aligned start
        out.append(part.view(dtype).reshape(shape))
        off += n
    return out


def extract_page_planes(pools: Sequence[Dict[str, torch.Tensor]], dev_page: int,
                        whole=None) -> Dict[str, torch.Tensor]:
    """One device page's slice of every plane, stacked over the layers into
    the reference's layer-stacked shapes, as CPU tensors keyed by plane
    name. The planes are gathered and packed into one byte buffer on the
    device, which crosses to the host in one copy. `whole(name, plane)`,
    when given, maps each stacked plane on the device first (a sharded
    pool's head slices gathered whole)."""
    if not pools:
        return {}
    names = sorted(pools[0])
    stacked = [torch.stack([layer[n][dev_page] for layer in pools]) for n in names]
    if whole is not None:
        stacked = [whole(n, t) for n, t in zip(names, stacked)]
    blob = torch.cat([t.reshape(-1).view(torch.uint8) for t in stacked]).cpu()
    planes = _split(blob, [(tuple(t.shape), t.dtype) for t in stacked])
    return dict(zip(names, planes))


def apply_page_planes(pools: Sequence[Dict[str, torch.Tensor]], dev_pages,
                      planes_list: List[Dict[str, torch.Tensor]]):
    """Upload restored payload planes into the pools at `dev_pages` (device
    page ids, parallel to `planes_list`), in place: the pool tensors keep
    their addresses, which captured decode graphs hold. Every plane of
    every page crosses in one host-to-device copy. Returns `pools`."""
    if len(dev_pages) != len(planes_list):
        raise ValueError(f"{len(dev_pages)} pages != {len(planes_list)} payloads")
    if not planes_list or not pools:
        return pools
    names = sorted(pools[0])
    dev = pools[0][names[0]].device
    stacked = [torch.stack([pl[n] for pl in planes_list]).to(pools[0][n].dtype)
               for n in names]
    host = torch.cat([t.reshape(-1).view(torch.uint8) for t in stacked])
    blob = host.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else host
    idx = torch.as_tensor(np.asarray(dev_pages, np.int64), device=dev)
    for name, t in zip(names, _split(blob, [(tuple(t.shape), t.dtype) for t in stacked])):
        for i, layer in enumerate(pools):
            layer[name].index_copy_(0, idx, t[:, i])
    return pools


# ---------------------------------------------------------------------------
# the tier store
# ---------------------------------------------------------------------------

class HostTier:
    """Host-memory store of spilled KV pages, keyed by content address.

    Unbounded by default; with `capacity_pages` set, inserting past
    capacity drops the least-recently-used payload and notifies `on_drop`
    (the paged cache prunes the now payload-free index node with it, which
    keeps the tiered-page audit exact). Lifetime counters feed
    `Scheduler.stats()`:

      spilled_pages        pages that entered the tier
      restored_pages       verified payloads uploaded back into device pages
      corrupt_pages        payloads that failed checksum verification
      dropped_pages        payloads evicted by the capacity bound
      fallback_recomputes  admissions that recomputed a prefix because a
                           payload was corrupt or missing
    """

    def __init__(self, capacity_pages: Optional[int] = None):
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError(f"capacity_pages must be >= 1, got {capacity_pages}")
        self.capacity_pages = capacity_pages
        self.on_drop: Optional[Callable[[bytes], None]] = None
        self._store: "OrderedDict[bytes, TierPayload]" = OrderedDict()
        self.spilled_pages = 0
        self.restored_pages = 0
        self.corrupt_pages = 0
        self.dropped_pages = 0
        self.fallback_recomputes = 0

    @property
    def pages(self) -> int:
        return len(self._store)

    @property
    def payload_bytes(self) -> int:
        return sum(p.nbytes for p in self._store.values())

    def __contains__(self, key: bytes) -> bool:
        return key in self._store

    def keys(self) -> List[bytes]:
        return list(self._store)

    def put(self, key: bytes, payload: TierPayload) -> None:
        self._store[key] = payload
        self._store.move_to_end(key)
        self.spilled_pages += 1
        while self.capacity_pages is not None and len(self._store) > self.capacity_pages:
            victim, _ = self._store.popitem(last=False)
            self.dropped_pages += 1
            if self.on_drop is not None:
                self.on_drop(victim)

    def get(self, key: bytes) -> Optional[TierPayload]:
        p = self._store.get(key)
        if p is not None:
            self._store.move_to_end(key)
        return p

    def pop(self, key: bytes) -> Optional[TierPayload]:
        return self._store.pop(key, None)

    def state(self) -> Dict[bytes, TierPayload]:
        """Snapshot hook: the stored payloads, in insertion order."""
        return dict(self._store)

    def corrupt_one(self) -> Optional[bytes]:
        """Chaos hook (`corrupt_tier_page`): flip bytes in one stored
        payload, deterministically the smallest key, so seeded fault
        schedules replay. The header and its CRC stay, so the next restore
        detects the damage and falls back to recompute. Returns the
        corrupted key, or None when the tier is empty."""
        if not self._store:
            return None
        key = min(self._store)
        p = self._store[key]
        if p.nbytes == 0:
            # an empty blob (a pool-less bookkeeping stub): break the
            # recorded checksum instead, so verification still fails
            self._store[key] = replace(p, crc=p.crc ^ 0xDEADBEEF)
            return key
        blob = bytearray(p.blob)
        for i in range(min(8, len(blob))):
            blob[i] ^= 0xFF
        self._store[key] = replace(p, blob=bytes(blob))
        return key

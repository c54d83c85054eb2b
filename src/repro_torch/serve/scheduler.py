"""Continuous-batching scheduler over the block-paged KV cache.

Counterpart of the base path of `repro/serve/scheduler.py`. A FIFO request
queue feeds a fixed set of `max_slots` decode slots. Each scheduling round
the host admits queued requests into free slots while the pool has enough
unreserved pages for a request's worst case, prefills all requests admitted
in the round in one bucketed-shape call (batch rounded to a power of two,
prompt span to the round's max page count), and then runs up to `chunk`
decode steps on the device, where sampled tokens feed back and the per-slot
done flags (EOS / length cap) are computed; the host syncs once per chunk.

The decode step stays fixed-shape over all `max_slots` slots: inactive
slots feed token 0 at position 0, write to the null page, and their outputs
are ignored. Sampling is per request: every sampled row carries its request
id and its output index (`sample_fn(logits, rids, steps)`, and `rids` /
`start_steps` for the device steps), so admission order and batch
composition never change a request's tokens; padding and inactive rows
carry rid -1, a uint32 id no request has. With a `spec_fn` each decode launch is instead `spec_rounds`
self-speculative draft/verify rounds (`_decode_active_spec`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.kernels.ref import CACHE_EMPTY_POS
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.slo import RequestStatus


def _pow2ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


#: Units of every key `Scheduler.stats()` returns.
STAT_UNITS: Dict[str, str] = {
    "decode_steps": "steps (batch decode iterations actually counted)",
    "decode_chunks": "calls (device-resident chunk launches, 1 per round)",
    "host_syncs": "calls (device->host synchronizations: one per prefill "
                  "call and one per decode round)",
    "active_slot_steps": "slot*steps (decoded tokens across all requests)",
    "paged_block_steps": "pages*steps (pool pages held, summed per step)",
    "dense_block_steps": "pages*steps (what a max_len ring cache would hold)",
    "peak_blocks": "pages (max pool pages held at any step)",
    "prefill_calls": "calls (bucketed prefill launches)",
    "prefill_token_steps": "tokens (padded token-steps launched in prefill)",
    "prefill_real_tokens": "tokens (real prompt tokens prefilled)",
    "kv_pages_read": "pages (decode-attention pages actually walked)",
    "kv_pages_read_worst": "pages (max_blocks gather worst case)",
    "mean_occupancy": "ratio (active slot-steps / max_slots*steps)",
    "mean_blocks": "pages (mean pool pages held per decode step)",
    "padding_waste_saved": "ratio (ring-cache block-steps never allocated)",
    "prefill_padding_waste": "ratio (padded prefill token-steps wasted)",
    "kv_bytes_per_token": "bytes (pool footprint per token slot, all layers)",
    "kv_read_bytes_per_token": "bytes (KV actually streamed per decoded token)",
    "kv_read_bytes_per_token_worst": "bytes (max_blocks gather per token)",
    "draft_tokens": "tokens (draft proposals computed on the speculative path)",
    "verify_calls": "calls (per-slot verify passes on the speculative path)",
    "accepted_tokens_per_step": "tokens/call (tokens emitted per verify pass; "
                                ">1 is the speculative-decode win)",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    peak_blocks: int = 0
    prefilled: int = 0            # prompt tokens whose KV is in the pool

    @property
    def next_pos(self) -> int:
        return len(self.prompt) + len(self.out)


class Scheduler:
    """Request queue + admission/eviction around the device steps.

    prefill_fn(tokens (B,Sp), positions (B,Sp), block_tables (B,MB),
               write_slots (B,Sp), write_pos (B,Sp), fresh (F,),
               last_idx (B,)) -> last-token logits (B, V) on the device
    decode_chunk_fn(tokens0 (M,1), tables (M,MB), positions (C,M,1),
                    write_slots (C,M,1), write_pos (C,M,1), fresh (C,F),
                    kv_lens (C,M), rids (M,), start_steps (M,),
                    max_steps (M,), eos (M,), active (M,))
                    -> host tokens (C, M); step j of slot i is output
                    index start_steps[i] + j of request rids[i]
    sample_fn(logits (N,V) on the device, rids (N,), steps (N,))
              -> host tokens (N,)
    scrub_fn(pages (F,)) scrubs overflow fresh pages out of step.
    spec_fn(tokens0 (M,1), tables (M,TW), p0 (M,), fresh (F,), rids (M,),
            start_steps (M,), max_steps (M,), eos (M,), active (M,))
            -> host (out (spec_rounds*(spec_k+1), M), e_rounds (spec_rounds, M)),
            `spec_rounds` draft-`spec_k`/verify rounds; `spec_window` is the
            draft's attention window cap (0 = none), for the accounting.
    """

    def __init__(
        self,
        cache: PagedKVCache,
        *,
        max_slots: int,
        max_len: int,
        prefill_fn: Callable,
        decode_chunk_fn: Callable,
        sample_fn: Callable,
        scrub_fn: Callable,
        chunk: int = 1,
        prefill_batch: bool = True,
        spec_fn: Optional[Callable] = None,
        spec_k: int = 0,
        spec_rounds: int = 0,
        spec_window: int = 0,
    ):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if spec_fn is not None and (spec_k < 1 or spec_rounds < 1):
            raise ValueError(
                f"spec_fn requires spec_k >= 1 and spec_rounds >= 1, got "
                f"k={spec_k}, rounds={spec_rounds}"
            )
        self.cache = cache
        self.max_slots = max_slots
        self.max_len = max_len
        self.max_blocks = math.ceil(max_len / cache.block_size)
        self._prefill = prefill_fn
        self._decode_chunk = decode_chunk_fn
        self._sample = sample_fn
        self._scrub = scrub_fn
        self.chunk = chunk
        self.prefill_batch = prefill_batch
        self._spec = spec_fn
        self.spec_k = spec_k
        self.spec_rounds = spec_rounds
        self.spec_window = spec_window
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.results: Dict[int, np.ndarray] = {}
        self.statuses: Dict[int, RequestStatus] = {}
        self.request_peaks: Dict[int, int] = {}
        self._next_rid = 0
        self._stats = {
            "decode_steps": 0, "decode_chunks": 0, "host_syncs": 0,
            "active_slot_steps": 0,
            "paged_block_steps": 0, "dense_block_steps": 0, "peak_blocks": 0,
            "prefill_calls": 0, "prefill_token_steps": 0,
            "prefill_real_tokens": 0, "kv_pages_read": 0,
            "kv_pages_read_worst": 0, "draft_tokens": 0, "verify_calls": 0,
        }

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def submit(
        self, prompt: np.ndarray, *, max_new_tokens: int,
        eos_id: Optional[int] = None,
    ) -> int:
        """Enqueue one request; returns its id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # KV footprint: prompt + every fed-back token except the last sample
        kv_len = len(prompt) + max_new_tokens - 1
        if kv_len > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len={self.max_len}"
            )
        if self.cache.blocks_for(kv_len) > self.cache.num_blocks:
            raise ValueError(
                f"request needs {self.cache.blocks_for(kv_len)} pages but the "
                f"pool only has {self.cache.num_blocks}"
            )
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens, eos_id))
        return rid

    def run_until_drained(self) -> Dict[int, np.ndarray]:
        while self.queue or any(r is not None for r in self.slots):
            self.step()
        out, self.results = self.results, {}
        return out

    # ------------------------------------------------------------------
    # one scheduling round: admission -> batched prefill -> chunked decode
    # ------------------------------------------------------------------
    def step(self) -> None:
        self._admit()
        self._decode_active()

    def _kv_len(self, r: Request) -> int:
        return len(r.prompt) + r.max_new_tokens - 1

    def _admit(self) -> None:
        admitted: List[tuple] = []
        for slot in range(self.max_slots):
            if self.slots[slot] is not None:
                continue
            if not self.queue:
                break
            r = self.queue[0]
            if not self.cache.can_admit(self._kv_len(r)):
                break  # FIFO: don't let short requests starve the head
            self.queue.popleft()
            r.prefilled = self.cache.admit(r.rid, self._kv_len(r))
            self.slots[slot] = r
            admitted.append((slot, r))
        if not admitted:
            return
        rows = [
            (slot, r, r.prefilled, len(r.prompt) - r.prefilled)
            for slot, r in admitted
        ]
        if self.prefill_batch:
            self._prefill_rows(rows)
        else:
            for one in rows:  # one launch per request, exact page rounding
                self._prefill_rows([one], bucketed=False)
        for slot, r in admitted:
            if self._finished(r):
                self._evict(slot)

    def _prefill_rows(self, rows: List[tuple], bucketed: bool = True) -> None:
        """One prefill launch over `rows` of (slot, request, start, n): each
        row writes prompt tokens [start, start + n) at their positions and
        samples its first output token. The batch pads to a power of two
        (<= max_slots) and the span to the round's max page count; padding
        rows write to the null page under the empty-position sentinel."""
        bs = self.cache.block_size
        nrows = len(rows)
        pages = max(math.ceil(n / bs) for _, _, _, n in rows)
        b = min(_pow2ceil(nrows), self.max_slots) if bucketed else nrows
        sp = pages * bs
        tw = self.max_blocks

        tokens = np.zeros((b, sp), np.int32)
        positions = np.broadcast_to(np.arange(sp, dtype=np.int32), (b, sp)).copy()
        write_pos = np.full((b, sp), CACHE_EMPTY_POS, np.int32)
        write_slots = np.broadcast_to(
            self.cache.null_slots(np.arange(sp)), (b, sp)
        ).copy()
        tables = np.zeros((b, tw), np.int32)
        last_idx = np.zeros(b, np.int32)
        rids = np.full(b, -1, np.int64)  # padding rows: the unused uint32 id
        steps0 = np.zeros(b, np.int64)
        for row, (slot, r, start, n) in enumerate(rows):
            tokens[row, :n] = r.prompt[start:start + n]
            positions[row] = start + positions[row]
            write_pos[row, :n] = np.arange(start, start + n, dtype=np.int32)
            write_slots[row, :n] = self.cache.write_slots(r.rid, start, n)
            tables[row] = self.cache.block_table_row(r.rid, tw)
            r.prefilled = start + n
            last_idx[row] = n - 1
            rids[row] = r.rid
            steps0[row] = len(r.out)  # the request's first output index
        fresh_rows = self.cache.drain_fresh_rows(b * pages)
        for extra in fresh_rows[1:]:
            # more recycled pages than the launch's fresh vector carries:
            # scrub the overflow before the launch that writes into them
            self._scrub(extra)
        logits = self._prefill(
            tokens, positions, tables, write_slots, write_pos, fresh_rows[0],
            last_idx,
        )
        toks = self._sample(logits, rids, steps0)  # the round's device->host sync
        for row, (slot, r, start, n) in enumerate(rows):
            r.out.append(int(toks[row]))
            r.peak_blocks = max(r.peak_blocks, self.cache.blocks_held(r.rid))

        st = self._stats
        st["prefill_calls"] += 1
        st["host_syncs"] += 1
        st["prefill_token_steps"] += b * sp
        st["prefill_real_tokens"] += sum(n for _, _, _, n in rows)

    # ------------------------------------------------------------------
    # decode: device-resident chunk
    # ------------------------------------------------------------------
    def _decode_active(self) -> None:
        """Precompute a chunk's slot/position advancement, run it on the
        device, then replay the sampled tokens against host request state
        (the replay only decides how many of the C tokens each slot keeps)."""
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        if self._spec is not None:
            self._decode_active_spec(active)
            return
        m, mb, bs = self.max_slots, self.max_blocks, self.cache.block_size
        rem = {i: r.max_new_tokens - len(r.out) for i, r in active}
        c = min(self.chunk, _pow2ceil(max(rem.values())))
        f = m * ((c + bs - 1) // bs + 1)  # fresh-page bound for the chunk

        # page state before the chunk pre-allocates, so the accounting can
        # replay the single-step charging order
        used0 = self.cache.allocator.used_count
        held0 = {i: self.cache.blocks_held(r.rid) for i, r in active}
        p0s: Dict[int, int] = {}

        tokens0 = np.zeros((m, 1), np.int32)
        positions = np.zeros((c, m, 1), np.int32)
        write_slots = np.zeros((c, m, 1), np.int32)
        write_pos = np.full((c, m, 1), CACHE_EMPTY_POS, np.int32)
        tables = np.zeros((m, mb), np.int32)
        kv_lens = np.zeros((c, m), np.int32)
        rids = np.full(m, -1, np.int64)
        start_steps = np.zeros(m, np.int64)
        max_steps = np.zeros(m, np.int32)
        eos = np.full(m, -1, np.int32)
        act = np.zeros(m, bool)
        for i, r in active:
            p0 = p0s[i] = r.next_pos - 1  # feed back the last sampled token
            si = min(c, rem[i])
            tokens0[i, 0] = r.out[-1]
            rids[i] = r.rid
            start_steps[i] = len(r.out)
            max_steps[i] = si
            act[i] = True
            if r.eos_id is not None:
                eos[i] = r.eos_id
            # pre-allocate the chunk's pages; the device table is static for
            # the whole chunk (future slots are scrubbed-empty and mask to
            # zero weight until written)
            slots_i = self.cache.write_slots(r.rid, p0, si)
            positions[:, i, 0] = p0 + np.arange(c)
            write_slots[:si, i, 0] = slots_i
            write_pos[:si, i, 0] = p0 + np.arange(si)
            # the attention walk at step j covers positions through p0 + j
            kv_lens[:, i] = p0 + 1 + np.arange(c)
        for i, r in active:
            tables[i] = self.cache.block_table_row(r.rid, mb)
        fresh = np.zeros((c, f), np.int32)
        fresh[0] = self.cache.drain_fresh(f)

        toks = self._decode_chunk(
            tokens0, tables, positions, write_slots, write_pos, fresh,
            kv_lens, rids, start_steps, max_steps, eos, act,
        )  # (c, m) host tokens: the chunk's one device->host sync

        steps_taken: Dict[int, int] = {}
        for i, r in active:
            before = len(r.out)
            for j in range(int(max_steps[i])):
                r.out.append(int(toks[j, i]))
                if self._finished(r):
                    break
            steps_taken[i] = len(r.out) - before
            r.peak_blocks = max(r.peak_blocks, self.cache.blocks_held(r.rid))

        self._account_decode_chunk(active, steps_taken, used0, held0, p0s, c)
        for i, r in active:
            if self._finished(r):
                self._evict(i)

    def _account_decode_chunk(self, active, steps_taken, used0, held0, p0s, c):
        """Replay the single-step charging order over the chunk: a page is
        charged from the step its first token lands and released the step
        its request finishes, so the stats do not depend on the chunk size."""
        st = self._stats
        st["decode_chunks"] += 1
        st["host_syncs"] += 1
        bs = self.cache.block_size
        used = used0
        grown = dict.fromkeys(held0, 0)
        for j in range(c):
            live = [i for i, _ in active if j < steps_taken[i]]
            if not live:
                break  # dead tail of the chunk: every slot finished
            st["decode_steps"] += 1
            for i in live:
                if (p0s[i] + j) % bs == 0:
                    used += 1
                    grown[i] += 1
            st["active_slot_steps"] += len(live)
            st["paged_block_steps"] += used
            st["dense_block_steps"] += len(live) * self.max_blocks
            st["peak_blocks"] = max(st["peak_blocks"], used)
            for i in live:  # the fused walk covers ceil(kv_len / bs) pages
                kv_len = p0s[i] + j + 1
                st["kv_pages_read"] += min(self.max_blocks, -(-kv_len // bs))
                st["kv_pages_read_worst"] += self.max_blocks
            for i, r in active:
                if steps_taken[i] == j + 1 and self._finished(r):
                    used -= held0[i] + grown[i]

    def _decode_active_spec(self, active) -> None:
        """Speculative decode: `spec_rounds` draft-k/verify-once rounds in
        one device launch. The host pre-allocates each slot's span at full
        acceptance, hands the device a block table bounded to the furthest
        slot's span (pow2-rounded, read by both the draft walk and the
        verify gather), then replays the packed emissions against request
        state and rolls each request back to its committed length, which
        returns the pages rejection left unwritten."""
        m, bs = self.max_slots, self.cache.block_size
        k, rounds = self.spec_k, self.spec_rounds
        cap = rounds * (k + 1)
        rem = {i: r.max_new_tokens - len(r.out) for i, r in active}

        used0 = self.cache.allocator.used_count
        held0 = {i: self.cache.blocks_held(r.rid) for i, r in active}
        p0s: Dict[int, int] = {}
        sis: Dict[int, int] = {}

        tokens0 = np.zeros((m, 1), np.int32)
        p0 = np.zeros(m, np.int32)
        rids = np.full(m, -1, np.int64)
        start_steps = np.zeros(m, np.int64)
        max_steps = np.zeros(m, np.int32)
        eos = np.full(m, -1, np.int32)
        act = np.zeros(m, bool)
        for i, r in active:
            pos0 = p0s[i] = r.next_pos - 1
            si = sis[i] = min(cap, rem[i])
            tokens0[i, 0] = r.out[-1]
            rids[i] = r.rid
            start_steps[i] = len(r.out)  # sampling keys ride the global index
            p0[i] = pos0
            max_steps[i] = si
            act[i] = True
            if r.eos_id is not None:
                eos[i] = r.eos_id
            self.cache.write_slots(r.rid, pos0, si)
        tw = min(
            _pow2ceil(max(math.ceil((p0s[i] + sis[i]) / bs) for i, _ in active)),
            self.max_blocks,
        )
        tables = np.zeros((m, tw), np.int32)
        for i, r in active:
            tables[i] = self.cache.block_table_row(r.rid, tw)
        fresh = self.cache.drain_fresh(m * ((cap + bs - 1) // bs + 1))

        out, e_rounds = self._spec(tokens0, tables, p0, fresh, rids, start_steps,
                                   max_steps, eos, act)

        for i, r in active:
            emitted = 0
            for t in range(rounds):
                for _ in range(int(e_rounds[t, i])):
                    r.out.append(int(out[emitted, i]))
                    emitted += 1
            r.peak_blocks = max(r.peak_blocks, self.cache.blocks_held(r.rid))
            # positions from next_pos - 1 on hold only rejected drafts (the
            # pending token's KV is written next round)
            self.cache.rollback(r.rid, r.next_pos - 1)

        self._account_decode_spec(active, e_rounds, p0s, held0, used0, tw)
        for i, r in active:
            if self._finished(r):
                self._evict(i)

    def _account_decode_spec(self, active, e_rounds, p0s, held0, used0, tw):
        """Replay the spec chunk's per-round charging. A round is one decode
        step of the batch, so `mean_occupancy` reads as tokens per
        slot-round; pages are charged over committed tokens only, as in
        `_account_decode_chunk`. KV read per live slot-round: k fused draft
        walks (window-capped with a draft window) plus one verify gather
        over the bounded table width `tw`."""
        st = self._stats
        st["decode_chunks"] += 1
        st["host_syncs"] += 1
        bs, k, window = self.cache.block_size, self.spec_k, self.spec_window
        used = used0
        grown = dict.fromkeys(held0, 0)
        pos = dict(p0s)
        cum = dict.fromkeys(held0, 0)
        total = {i: int(np.sum(e_rounds[:, i])) for i, _ in active}
        for t in range(e_rounds.shape[0]):
            live = [i for i, _ in active if int(e_rounds[t, i]) > 0]
            if not live:
                break
            st["decode_steps"] += 1
            st["verify_calls"] += len(live)
            st["draft_tokens"] += k * len(live)
            for i in live:
                e = int(e_rounds[t, i])
                for j in range(e):
                    if (pos[i] + j) % bs == 0:
                        used += 1
                        grown[i] += 1
                for j in range(k):  # draft walks at kv_len = pos + j + 1
                    kv = pos[i] + j + 1
                    first = max(0, kv - window) // bs if window else 0
                    st["kv_pages_read"] += min(tw, -(-kv // bs)) - first
                st["kv_pages_read"] += tw  # the verify gather
                st["kv_pages_read_worst"] += e * self.max_blocks
                st["active_slot_steps"] += e
                pos[i] += e
                cum[i] += e
            st["paged_block_steps"] += used
            st["dense_block_steps"] += len(live) * self.max_blocks
            st["peak_blocks"] = max(st["peak_blocks"], used)
            for i, r in active:
                if i in live and cum[i] == total[i] and self._finished(r):
                    used -= held0[i] + grown[i]

    def _finished(self, r: Request) -> bool:
        return len(r.out) >= r.max_new_tokens or (
            r.eos_id is not None and bool(r.out) and r.out[-1] == r.eos_id
        )

    def _evict(self, slot: int) -> None:
        r = self.slots[slot]
        if r is None:
            return
        self.results[r.rid] = np.asarray(r.out, np.int32)
        self.statuses[r.rid] = RequestStatus.OK
        self.request_peaks[r.rid] = r.peak_blocks
        self.cache.release(r.rid)
        self.slots[slot] = None

    # ------------------------------------------------------------------
    # occupancy / padding-waste report
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """A fresh snapshot of the serving counters plus derived ratios;
        every key's unit is in `STAT_UNITS`."""
        st = dict(self._stats)
        steps = max(1, st["decode_steps"])
        st["mean_occupancy"] = st["active_slot_steps"] / (steps * self.max_slots)
        st["mean_blocks"] = st["paged_block_steps"] / steps
        dense = max(1, st["dense_block_steps"])
        st["padding_waste_saved"] = 1.0 - st["paged_block_steps"] / dense
        padded = max(1, st["prefill_token_steps"])
        st["prefill_padding_waste"] = 1.0 - st["prefill_real_tokens"] / padded
        st["kv_bytes_per_token"] = self.cache.bytes_per_token()
        page_bytes = self.cache.bytes_per_token() * self.cache.block_size
        toks = max(1, st["active_slot_steps"])
        st["kv_read_bytes_per_token"] = st["kv_pages_read"] * page_bytes / toks
        st["kv_read_bytes_per_token_worst"] = (
            st["kv_pages_read_worst"] * page_bytes / toks
        )
        # every token of a spec engine passes a verify; 0.0 without one
        st["accepted_tokens_per_step"] = (
            st["active_slot_steps"] / st["verify_calls"]
            if st["verify_calls"] else 0.0
        )
        return st

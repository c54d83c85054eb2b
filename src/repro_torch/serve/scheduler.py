"""Continuous-batching scheduler over the block-paged KV cache.

Counterpart of `repro/serve/scheduler.py`. A FIFO request queue feeds a
fixed set of `max_slots` decode slots. Each scheduling round the host
admits queued requests into free slots while the pool has enough
unreserved pages for a request's worst case, prefills all requests admitted
in the round in one bucketed-shape call (batch rounded to a power of two,
prompt span to the round's max page count), and then decodes. With
`chunk > 1` it runs up to `chunk` decode steps on the device, where sampled
tokens feed back and the per-slot done flags (EOS / length cap) are
computed; the host syncs once per chunk. With `chunk == 1` it runs the
reference's single-step loop (`_decode_active_single`): one `decode_fn`
step, one `sample_fn` call, one host sync a token.

The decode step stays fixed-shape over all `max_slots` slots: inactive
slots feed token 0 at position 0, write to the null page, and their outputs
are ignored. Sampling is per request: every sampled row carries its request
id and its output index (`sample_fn(logits, rids, steps)`, and `rids` /
`start_steps` for the device steps), so admission order and batch
composition never change a request's tokens; padding and inactive rows
carry rid -1, a uint32 id no request has. With a `spec_fn` each decode
launch is instead `spec_rounds` self-speculative draft/verify rounds
(`_decode_active_spec`).

With a prefix-cached pool admission first pins the longest cached prefix
of the prompt, so prefill starts at `Request.prefilled` instead of 0. With
`prefill_chunk` set, the rest of the prompt runs as chunks of at most that
many tokens, one launch a round over every mid-prefill slot, each reading
through a length-bounded block table; a slot joins decode once its last
chunk has sampled its first output token.

With an `obs` bundle (`repro_torch.obs.Observability`) the scheduler feeds
its collectors at the reference's sites: request lifecycle to the tracer,
each prefill call and decode launch to RoofLens and the metrics registry.
Each site reads the host clock just before a device call and just after
the host copy of its tokens, which already waits for the card: no site
adds a synchronization, a device op or a copy, and none runs inside a
graph capture (the capture happens within the device call). With
`prefill_sla_s` and a bound RoofLens the chunked-prefill span follows the
budget (`_prefill_span_cap`).

Overload resilience: an `SLAPolicy` bounds the queue, sheds candidates
that can no longer meet the TTFT objective, defers admission while RoofLens
predicts an ITL breach, and climbs the degradation ladder (`slo.LADDER`),
down to parking the lowest-priority resident through `PagedKVCache.park`,
when the pool blocks the queue head. Per-request deadlines drop expired
queued work at admission. Every request ends in exactly one
`RequestStatus` (`Scheduler.statuses`). A `dist.fault.FaultInjector` hooks
the round loop (pool exhaustion, straggler rounds, poisoned prefills,
corrupted host-tier payloads), and the non-finite guard fails only a
poisoned request: its per-row finite flags are computed on the device next
to the sampled tokens and cross in the same copy, so the guard adds no
host sync.

With a `HostTier` on the cache the ladder gains its `spill` rung, admission
restores tier-resident prefix hits through checksum-verified uploads
drained just before the prefill launch (`tier_restore_fn`), and
`check_invariants` audits the tiered pages as a fourth conservation class.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.kernels.ref import CACHE_EMPTY_POS
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.slo import LADDER, RequestStatus, SLAPolicy


def _pow2ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


#: Units of every key `Scheduler.stats()` returns, the reference's text
#: (the metrics registry publishes each as a gauge's unit). At chunk 1 a
#: decode round is one single step, and `decode_chunks` counts it.
STAT_UNITS: Dict[str, str] = {
    "decode_steps": "steps (batch decode iterations actually counted)",
    "decode_chunks": "calls (device-resident chunk launches, 1 per round)",
    "host_syncs": "calls (device->host synchronizations: one per prefill "
                  "call and one per decode round)",
    "active_slot_steps": "slot*steps (decoded tokens across all requests)",
    "paged_block_steps": "pages*steps (pool pages held, summed per step)",
    "dense_block_steps": "pages*steps (what a max_len ring cache would hold)",
    "peak_blocks": "pages (max pool pages held at any step)",
    "prefill_calls": "calls (bucketed prefill launches, incl. chunked)",
    "prefill_chunk_calls": "calls (length-bounded chunked-prefill launches)",
    "prefill_token_steps": "tokens (padded token-steps launched in prefill)",
    "prefill_real_tokens": "tokens (real prompt tokens prefilled)",
    "prefix_hit_tokens": "tokens (prompt tokens served from the prefix "
                         "cache instead of recomputed)",
    "cow_copies": "pages (copy-on-write clones of prefix-shared pages)",
    "shared_pages": "pages (pages currently held by >1 holder)",
    "prefix_cached_pages": "pages (pages the prefix index currently pins)",
    "kv_pages_read": "pages (decode-attention pages actually walked)",
    "kv_pages_read_worst": "pages (max_blocks gather worst case)",
    "window_freed_pages": "pages (released behind the attention window)",
    "mean_occupancy": "ratio (active slot-steps / max_slots*steps)",
    "mean_blocks": "pages (mean pool pages held per decode step)",
    "padding_waste_saved": "ratio (ring-cache block-steps never allocated)",
    "prefill_padding_waste": "ratio (padded prefill token-steps wasted)",
    "kv_bytes_per_token": "bytes (pool footprint per token slot, all layers)",
    "kv_read_bytes_per_token": "bytes (KV actually streamed per decoded token)",
    "kv_read_bytes_per_token_worst": "bytes (max_blocks gather per token)",
    "draft_tokens": "tokens (draft proposals computed on the speculative path)",
    "verify_calls": "calls (per-slot verify passes on the speculative path)",
    "shed_requests": "requests (rejected by the SLA policy: bounded queue "
                     "at submit or predicted TTFT breach at admission)",
    "expired_requests": "requests (deadline passed while queued, dropped "
                        "at admission time)",
    "preempted_requests": "requests (parked under pool pressure and "
                          "expired before resume; partial output kept)",
    "parked_requests": "events (residents preempted via PagedKVCache.park; "
                       "a request can park more than once)",
    "resumed_requests": "events (parked requests re-admitted through the "
                        "prefix cache)",
    "failed_requests": "requests (non-finite logits at the host sync; "
                       "pages reclaimed, co-batched survivors unaffected)",
    "degradations": "events (graceful-degradation ladder escalations)",
    "itl_deferrals": "events (admissions deferred by the predicted-ITL gate)",
    "accepted_tokens_per_step": "tokens/call (tokens emitted per verify pass; "
                                ">1 is the speculative-decode win)",
    "tier_spilled_pages": "pages (pages spilled into the host tier, lifetime)",
    "tier_restored_pages": "pages (verified tier payloads uploaded back "
                           "into HBM pages, lifetime)",
    "tier_pages": "pages (payloads resident in the host tier right now)",
    "tier_bytes": "bytes (packed payload bytes resident in the host tier)",
    "tier_corrupt": "pages (payloads that failed checksum verification)",
    "tier_fallback_recompute": "events (admissions that recomputed a prefix "
                               "because a tier payload was corrupt/missing)",
    "tier_hit_tokens": "tokens (prompt tokens served from tier-restored "
                       "pages instead of recomputed)",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    peak_blocks: int = 0
    # prompt tokens whose KV is in the pool: the prefix-cache hit at
    # admission, then advanced by each prefill chunk; the slot is
    # decode-ready (non-empty `out`) once it reaches len(prompt)
    prefilled: int = 0
    # resilience state
    priority: int = 0             # park-victim ordering; the queue stays FIFO
    deadline_t: Optional[float] = None  # absolute clock seconds, or None
    submit_t: float = 0.0         # clock stamp for the TTFT admission gate
    # tokens emitted before a park: park folds `out` into `prompt` (the
    # resume prefills them again) and banks them here; results and sampling
    # keys stay indexed by the global output position, so a resumed
    # request's tokens are an uninterrupted run's
    done_tokens: List[int] = dataclasses.field(default_factory=list)
    parks: int = 0                # times this request has been parked
    was_parked: bool = False      # pending-resume marker (resume counter)

    @property
    def next_pos(self) -> int:
        return len(self.prompt) + len(self.out)

    @property
    def emitted(self) -> int:
        """Tokens emitted over the request's whole life: the sampling-key
        step index and the length-cap meter, both park/resume invariant."""
        return len(self.done_tokens) + len(self.out)

    @property
    def all_out(self) -> List[int]:
        return self.done_tokens + self.out


class Scheduler:
    """Request queue + admission/eviction around the device steps.

    prefill_fn(tokens (B,Sp), positions (B,Sp), block_tables (B,TW),
               write_slots (B,Sp), write_pos (B,Sp), fresh (F,),
               copies (B,2), last_idx (B,)) -> last-token logits (B, V)
               on the device; TW is max_blocks for monolithic prefill and
               a length-bounded pow2 page count for chunked prefill
    decode_fn(tokens (M,1), positions (M,1), block_tables (M,MB),
              write_slots (M,1), write_pos (M,1), fresh (M,), kv_lens (M,))
              -> logits (M, V) on the device: one decode step, the
              single-step loop's (chunk == 1)
    decode_chunk_fn(tokens0 (M,1), tables (M,MB), positions (C,M,1),
                    write_slots (C,M,1), write_pos (C,M,1), fresh (C,F),
                    kv_lens (C,M), rids (M,), start_steps (M,),
                    max_steps (M,), eos (M,), active (M,))
                    -> host tokens (C, M); step j of slot i is output
                    index start_steps[i] + j of request rids[i]
    sample_fn(logits (N,V) on the device, rids (N,), steps (N,), guard=False)
              -> host tokens (N,); with guard=True -> (host tokens (N,),
              host finite flags (N,)), both from one device->host copy
    scrub_fn(pages (F,)) scrubs overflow fresh pages out of step.
    spec_fn(tokens0 (M,1), tables (M,TW), p0 (M,), fresh (F,), rids (M,),
            start_steps (M,), max_steps (M,), eos (M,), active (M,))
            -> host (out (spec_rounds*(spec_k+1), M), e_rounds (spec_rounds, M)),
            `spec_rounds` draft-`spec_k`/verify rounds; `spec_window` is the
            draft's attention window cap (0 = none), for the accounting.
    tier_restore_fn(dev_pages (P,), planes_list) uploads verified host-tier
            payloads into their device pages before the prefill launch that
            reads them.

    `local_window` (set by the engine when every attention layer is local)
    turns on window freeing: after each scheduling round the pages that
    have slid wholly behind every live and later query's window go back to
    the free list, and their table entries become null-page reads, which
    the position sentinel masks.

    `prefill_chunk` switches prefill to chunked mode: each round advances
    every mid-prefill slot by at most that many prompt tokens in one
    length-bounded launch, then runs a decode round for the slots that
    already sampled their first token, so a long prompt admits at once and
    interleaves with decode instead of stalling it.

    `sla` installs an `SLAPolicy`: bounded queue, TTFT shedding,
    predicted-ITL admission deferral and the degradation ladder under pool
    pressure. `injector` hooks a `dist.fault.FaultInjector` into the round
    loop (plan steps index scheduler rounds); `watchdog` feeds a
    `StragglerWatchdog` each round's wall time. The non-finite guard at the
    prefill's token copy is armed whenever `sla` or `injector` is set.
    Terminal statuses land in `self.statuses` (rid -> RequestStatus) beside
    `self.results`.
    """

    def __init__(
        self,
        cache: PagedKVCache,
        *,
        max_slots: int,
        max_len: int,
        prefill_fn: Callable,
        sample_fn: Callable,
        scrub_fn: Callable,
        decode_fn: Optional[Callable] = None,
        decode_chunk_fn: Optional[Callable] = None,
        chunk: int = 1,
        prefill_batch: bool = True,
        local_window: Optional[int] = None,
        spec_fn: Optional[Callable] = None,
        spec_k: int = 0,
        spec_rounds: int = 0,
        spec_window: int = 0,
        prefill_chunk: Optional[int] = None,
        obs=None,
        prefill_sla_s: Optional[float] = None,
        sla: Optional[SLAPolicy] = None,
        injector=None,
        watchdog=None,
        tier_restore_fn: Optional[Callable] = None,
    ):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if chunk > 1 and decode_chunk_fn is None:
            raise ValueError("chunk > 1 requires a decode_chunk_fn")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if local_window is not None and local_window < 1:
            raise ValueError(f"local_window must be >= 1, got {local_window}")
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
        self._decode = decode_fn
        self._decode_chunk = decode_chunk_fn
        self._sample = sample_fn
        self._scrub = scrub_fn
        self._tier_restore = tier_restore_fn
        self.chunk = chunk
        self.prefill_batch = prefill_batch
        self.local_window = local_window
        self._spec = spec_fn
        self.spec_k = spec_k
        self.spec_rounds = spec_rounds
        self.spec_window = spec_window
        self.prefill_chunk = prefill_chunk
        self.prefill_sla_s = prefill_sla_s
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.results: Dict[int, np.ndarray] = {}
        self.statuses: Dict[int, RequestStatus] = {}
        self.request_peaks: Dict[int, int] = {}
        self._next_rid = 0
        # resilience state
        self.sla = sla
        self._injector = injector
        self._watchdog = watchdog
        self._round = 0  # scheduler rounds: the injector plan's step index
        self.degradation_level = 0  # rungs of slo.LADDER applied now
        self._spec_enabled = True
        self._span_shrunk = False
        self._poison_pending = False
        self._guard_nonfinite = sla is not None or injector is not None
        self._stats = {
            "decode_steps": 0, "decode_chunks": 0, "host_syncs": 0,
            "active_slot_steps": 0,
            "paged_block_steps": 0, "dense_block_steps": 0, "peak_blocks": 0,
            "prefill_calls": 0, "prefill_chunk_calls": 0,
            "prefill_token_steps": 0, "prefill_real_tokens": 0,
            "kv_pages_read": 0, "kv_pages_read_worst": 0, "window_freed_pages": 0,
            "draft_tokens": 0, "verify_calls": 0,
            "shed_requests": 0, "expired_requests": 0, "preempted_requests": 0,
            "parked_requests": 0, "resumed_requests": 0, "failed_requests": 0,
            "degradations": 0, "itl_deferrals": 0,
        }
        # observability: every site below is guarded on the collector it
        # feeds; with obs=None the serving loop reads no clock for it and
        # allocates nothing
        self._obs_metrics = obs.metrics if obs is not None else None
        self._obs_tracer = obs.tracer if obs is not None else None
        self._obs_rooflens = obs.rooflens if obs is not None else None
        self._obs_clock = obs.clock if obs is not None else None
        self._observing = any(c is not None for c in (
            self._obs_metrics, self._obs_tracer, self._obs_rooflens))
        # deadlines and the TTFT gate need a clock even without
        # observability; the obs clock when installed, so stamps line up
        self._clock = self._obs_clock or time.monotonic

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def submit(
        self, prompt: np.ndarray, *, max_new_tokens: int,
        eos_id: Optional[int] = None, deadline_s: Optional[float] = None,
        priority: int = 0,
    ) -> int:
        """Enqueue one request; returns its id. `deadline_s` is a relative
        budget: a request still queued (or parked) when it runs out is
        dropped at admission with status EXPIRED (PREEMPTED once parked).
        `priority` orders park-victim selection under pool pressure (lower
        parks first); the queue itself stays FIFO. A submit past the SLA
        policy's `max_queue` is SHED at once: its rid still comes back, with
        an empty result and a terminal status."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
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
        now = self._clock()
        r = Request(rid, prompt, max_new_tokens, eos_id, priority=priority,
                    deadline_t=None if deadline_s is None else now + deadline_s,
                    submit_t=now)
        if self._obs_tracer is not None:
            self._obs_tracer.on_submit(rid, len(prompt), max_new_tokens)
        if self._obs_metrics is not None:
            self._obs_metrics.counter(
                "serve.requests.submitted", unit="requests"
            ).inc()
        if self.sla is not None and self.sla.queue_full(len(self.queue)):
            self._terminate(r, RequestStatus.SHED)
            return rid
        self.queue.append(r)
        self._set_queue_gauge()
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
        t0 = time.monotonic() if self._watchdog is not None else 0.0
        chaos_pages: List[int] = []
        if self._injector is not None:
            inj = self._injector
            if inj.take(self._round, "slow"):
                # straggler round: the sleep lies inside the watchdog's
                # timed window, so the round must be flagged
                time.sleep(inj.slow_s)
            if inj.take(self._round, "poison_prefill"):
                # the next prefill launch NaNs one real row's logits; the
                # guard must fail exactly that request
                self._poison_pending = True
            if inj.take(self._round, "corrupt_tier_page"):
                # flip bytes in one stored payload: the next restore of
                # that prefix detects it and recomputes
                if self.cache.tier is not None:
                    self.cache.tier.corrupt_one()
            if inj.take(self._round, "exhaust_pool"):
                # transient exhaustion for this round: grab only the
                # unreserved headroom, so residents' lazy allocations stay
                # backed while admission sees no admittable page
                n = self.cache.free_blocks - self.cache.reserved_blocks
                chaos_pages = [self.cache.allocator.alloc() for _ in range(max(0, n))]
        try:
            self._admit()
            if self.prefill_chunk is not None:
                self._prefill_pending()
            self._decode_active()
        finally:
            if chaos_pages:
                # never written: a later tenant scrubs them as fresh pages
                self.cache.allocator.free(chaos_pages)
            if self._watchdog is not None:
                self._watchdog.observe(self._round, time.monotonic() - t0)
            self._round += 1

    def _kv_len(self, r: Request) -> int:
        # park/resume: `prompt` absorbs the emitted tokens, so they leave
        # the output budget; the total stays len(P0) + max_new - 1
        return len(r.prompt) + (r.max_new_tokens - len(r.done_tokens)) - 1

    def _admit(self) -> None:
        t0 = self._obs_clock() if self._obs_tracer is not None else 0.0
        self._expire_queued()
        admitted: List[tuple] = []
        blocked = False  # pool pressure (not an SLO deferral) stalled the head
        for slot in range(self.max_slots):
            if self.slots[slot] is not None:
                continue
            r = self._next_candidate()
            if r is None:
                break
            if self._itl_defer(r):
                break
            if not self.cache.can_admit(self._kv_len(r), r.prompt):
                blocked = True
                break  # FIFO: don't let short requests starve the head
            self.queue.popleft()
            r.prefilled = self.cache.admit(r.rid, self._kv_len(r), prompt=r.prompt)
            if r.was_parked:
                r.was_parked = False
                self._stats["resumed_requests"] += 1
                if self._obs_metrics is not None:
                    self._obs_metrics.counter(
                        "serve.requests.resumed", unit="events"
                    ).inc()
            self.slots[slot] = r
            admitted.append((slot, r))
        if self.sla is not None:
            if blocked and self.queue:
                self._degrade()
            elif not self.queue and self.degradation_level:
                self._relax()  # backlog drained: full capability again
        if self._obs_tracer is not None and admitted:
            t1 = self._obs_clock()
            for slot, r in admitted:
                self._obs_tracer.on_admit(r.rid, slot)
            self._obs_tracer.on_admit_round(t0, t1, len(admitted), len(self.queue))
        if self._obs_metrics is not None and admitted:
            self._obs_metrics.counter(
                "serve.requests.admitted", unit="requests"
            ).inc(len(admitted))
            self._publish_gauges()
        if not admitted or self.prefill_chunk is not None:
            return  # chunked mode prefills in _prefill_pending
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
        self._free_window_pages()  # a long prompt may already out-span it

    # ------------------------------------------------------------------
    # overload resilience: deadlines, SLO gates, the degradation ladder,
    # park/resume and the page-conservation audit
    # ------------------------------------------------------------------
    def _set_queue_gauge(self) -> None:
        if self._obs_metrics is not None:
            self._obs_metrics.gauge("serve.queue_depth", unit="requests").set(
                len(self.queue))

    def _terminate(self, r: Request, status: RequestStatus) -> None:
        """Terminal bookkeeping for a request that ends off-slot (shed,
        expired, preempted for good, failed): its tokens so far become the
        result, exactly one status is recorded, and the collectors see a
        finish with the status as its reason."""
        self.results[r.rid] = np.asarray(r.all_out, np.int32)
        self.statuses[r.rid] = status
        self.request_peaks[r.rid] = r.peak_blocks
        self._stats[f"{status.value}_requests"] += 1
        if self._obs_tracer is not None:
            self._obs_tracer.on_finish(r.rid, status.value)
        if self._obs_metrics is not None:
            self._obs_metrics.counter(
                f"serve.requests.{status.value}", unit="requests"
            ).inc()

    def _expire_queued(self) -> None:
        """Drop queued requests whose deadline has passed, before they take
        pool pages: a request never admitted expires empty (EXPIRED), a
        parked one keeps the tokens it emitted (PREEMPTED)."""
        if not any(r.deadline_t is not None for r in self.queue):
            return
        now = self._clock()
        alive: collections.deque = collections.deque()
        dropped = 0
        for r in self.queue:
            if r.deadline_t is not None and now >= r.deadline_t:
                self._terminate(r, RequestStatus.PREEMPTED if r.parks
                                else RequestStatus.EXPIRED)
                dropped += 1
            else:
                alive.append(r)
        if dropped:
            self.queue = alive
            self._set_queue_gauge()

    def _next_candidate(self) -> Optional[Request]:
        """The queue head, after shedding heads that can no longer meet the
        TTFT objective: waited time plus the predicted prefill wall (with a
        bound RoofLens; a tier-resident hit adds its predicted restore)
        past `ttft_slo_s` would only spend pages on a certain miss. Resumed
        requests already delivered their first token and are exempt."""
        shed_gate = self.sla is not None and self.sla.ttft_slo_s is not None
        while self.queue:
            r = self.queue[0]
            if not shed_gate or r.done_tokens:
                return r
            pred = 0.0
            lens = self._obs_rooflens
            if lens is not None and getattr(lens, "_bound", False):
                bs = self.cache.block_size
                span = math.ceil(max(1, len(r.prompt)) / bs) * bs
                pred = lens.predict_prefill(1, span)
                n_tiered = self.cache.tiered_hit_pages(r.prompt)
                if n_tiered:
                    pred += lens.predict_tier_restore(
                        n_tiered, self.cache.bytes_per_token() * bs
                    )
            if not self.sla.ttft_breached(self._clock() - r.submit_t, pred):
                return r
            self.queue.popleft()
            self._terminate(r, RequestStatus.SHED)
            self._set_queue_gauge()
        return None

    def _itl_defer(self, cand: Request) -> bool:
        """RoofLens admission gate: defer the candidate while the predicted
        per-token time of one decode chunk over (residents + candidate)
        breaches the ITL objective. Inert without a bound RoofLens, and
        never defers onto an idle batch: a lone request always progresses."""
        if self.sla is None or self.sla.itl_slo_s is None:
            return False
        lens = self._obs_rooflens
        if lens is None or not getattr(lens, "_bound", False):
            return False
        resident = [float(r.next_pos) for r in self.slots if r is not None and r.out]
        if not resident:
            return False
        steps = max(1, self.chunk)
        pred = lens.predict_decode_chunk(resident + [float(len(cand.prompt) + 1)], steps)
        if not self.sla.itl_breached(pred, steps):
            return False
        self._stats["itl_deferrals"] += 1
        if self._obs_metrics is not None:
            self._obs_metrics.counter(
                "serve.admission.itl_deferrals", unit="events"
            ).inc()
        return True

    def _degrade(self) -> None:
        """Escalate one applicable rung of `slo.LADDER`, strictly in order,
        in a round where the pool blocked the queue head. Rungs this build
        lacks (no prefix index, no spec decode, monolithic prefill, no host
        tier) are skipped within the same call; the last rung (park the
        lowest-priority resident) may repeat on later blocked rounds."""
        head = self.queue[0]
        applied = None
        while self.degradation_level < len(LADDER) and applied is None:
            rung = LADDER[self.degradation_level]
            self.degradation_level += 1
            if rung == "prefix_evict":
                if self.cache.prefix is not None:
                    need = self.cache.blocks_for(self._kv_len(head))
                    # with a host tier the reclaim spills instead of dropping
                    if self.cache.reclaim_index_pages(need) > 0:
                        applied = rung
            elif rung == "spill":
                if self.cache.tier is not None and self.cache.spill_all() > 0:
                    applied = rung
            elif rung == "spec_off":
                if self._spec is not None and self._spec_enabled:
                    applied = rung
                self._spec_enabled = False
            elif rung == "prefill_shrink":
                if self.prefill_chunk is not None and not self._span_shrunk:
                    applied = rung
                self._span_shrunk = True
            elif self._park_lowest(head):
                applied = rung
        if applied is None and self.degradation_level >= len(LADDER):
            if self._park_lowest(head):
                applied = LADDER[-1]
        if applied is not None:
            self._stats["degradations"] += 1
            if self._obs_metrics is not None:
                self._obs_metrics.counter("serve.degradations", unit="events").inc()
                self._obs_metrics.gauge("serve.degradation_level", unit="rungs").set(
                    self.degradation_level)

    def _relax(self) -> None:
        """Undo the whole ladder once the queue drains: spec rounds and the
        full prefill span come back (parked requests have re-queued
        themselves; evicted index pages are simply gone)."""
        self.degradation_level = 0
        self._spec_enabled = True
        self._span_shrunk = False
        if self._obs_metrics is not None:
            self._obs_metrics.gauge("serve.degradation_level", unit="rungs").set(0)

    def _park_lowest(self, cand: Request) -> bool:
        """Park the lowest-priority resident strictly below the blocked
        head's priority (ties: youngest first, so the oldest keeps its
        progress). False when no resident may be preempted for this head."""
        victims = [(i, r) for i, r in enumerate(self.slots)
                   if r is not None and r.priority < cand.priority]
        if not victims:
            return False
        slot, _ = min(victims, key=lambda t: (t[1].priority, -t[1].rid))
        self._park(slot)
        return True

    def _park(self, slot: int) -> None:
        """Preempt one resident: index its written history (with a prefix
        cache), release its pages and reservation through
        `PagedKVCache.park`, fold its emitted tokens into the prompt and
        re-queue it at the tail. Sampling keys ride the global output index
        (`Request.emitted`), so the resume prefill's sample is its next
        output token and the rest follow as in an uninterrupted run."""
        r = self.slots[slot]
        if r.out:
            # the pool holds positions [0, next_pos - 1): the prompt and
            # every emitted token but the last (which the decode step that
            # feeds it back writes)
            written = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        else:
            written = r.prompt[:r.prefilled]  # a mid-prefill victim
        self.cache.park(r.rid, written)
        if r.out:
            r.done_tokens += r.out
            r.prompt = np.concatenate([r.prompt, np.asarray(r.out, np.int32)])
            r.out = []
        r.prefilled = 0
        r.parks += 1
        r.was_parked = True
        self.slots[slot] = None
        self.queue.append(r)
        self._stats["parked_requests"] += 1
        if self._obs_metrics is not None:
            self._obs_metrics.counter("serve.requests.parked", unit="events").inc()
            self._publish_gauges()

    def _fail(self, slot: int, r: Request) -> None:
        """Fail exactly one request at the guard: reclaim its pages, clear
        its slot, record FAILED. Its pages never enter the prefix index
        (the guard runs before `prefix_insert`)."""
        self.cache.release(r.rid)
        self.slots[slot] = None
        self._terminate(r, RequestStatus.FAILED)
        if self._obs_metrics is not None:
            self._publish_gauges()

    def check_invariants(self) -> Dict[str, int]:
        """Page-conservation audit: every allocator page is free or held;
        every held page's count equals its block-table references plus its
        prefix-index pin; reservations never exceed the free list; with a
        host tier, every tiered index node has exactly one payload under
        its content key and the other way round. Raises RuntimeError on a
        violation; returns the occupancy."""
        alloc = self.cache.allocator
        if alloc.free_count + alloc.used_count != self.cache.num_blocks:
            raise RuntimeError(
                f"page leak: free {alloc.free_count} + used "
                f"{alloc.used_count} != pool {self.cache.num_blocks}"
            )
        holders: Dict[int, int] = {}
        for r in self.slots:
            if r is None:
                continue
            for p in self.cache.held_pages(r.rid):
                holders[p] = holders.get(p, 0) + 1
        if self.cache.prefix is not None:
            for p in self.cache.prefix.page_multiset():
                holders[p] = holders.get(p, 0) + 1
        if alloc.used_count != len(holders):
            raise RuntimeError(
                f"orphaned pages: allocator holds {alloc.used_count} unique "
                f"pages but residents + prefix index account for {len(holders)}"
            )
        for p, c in holders.items():
            if alloc.ref_count(p) != c:
                raise RuntimeError(
                    f"refcount drift on page {p}: allocator says "
                    f"{alloc.ref_count(p)}, holders say {c}"
                )
        if self.cache.reserved_blocks > alloc.free_count:
            raise RuntimeError(
                f"reservations ({self.cache.reserved_blocks}) exceed the "
                f"free list ({alloc.free_count})"
            )
        if self.cache.tier is not None:
            # the fourth class: a drift either way means a page was lost
            # (an unresumable prefix) or leaked (an unreachable payload)
            idx_keys = sorted(self.cache.prefix.tier_keys())
            tier_keys = sorted(self.cache.tier.keys())
            if idx_keys != tier_keys:
                raise RuntimeError(
                    f"tiered-page drift: index holds {len(idx_keys)} tiered "
                    f"nodes but the tier stores {len(tier_keys)} payloads"
                )
            if self.cache.prefix.tiered_count != self.cache.tier.pages:
                raise RuntimeError(
                    f"tiered-count drift: index says "
                    f"{self.cache.prefix.tiered_count}, tier says "
                    f"{self.cache.tier.pages}"
                )
        return self.cache.occupancy()

    def _prefill_pending(self) -> None:
        """Chunked prefill: advance every mid-prefill slot by at most
        `prefill_chunk` prompt tokens in one length-bounded launch. A slot
        whose last chunk completes samples its first output token and joins
        the next decode round; until then decode skips it (empty `out`).
        The span per row is `_prefill_span_cap`."""
        pending = [
            (i, r) for i, r in enumerate(self.slots)
            if r is not None and r.prefilled < len(r.prompt)
        ]
        if not pending:
            return
        span_cap = self._prefill_span_cap(pending)
        rows = [
            (i, r, r.prefilled, min(span_cap, len(r.prompt) - r.prefilled))
            for i, r in pending
        ]
        self._prefill_rows(rows, bounded=True)
        for i, r in pending:
            if r.out and self._finished(r):
                self._evict(i)
        self._free_window_pages()

    def _prefill_span_cap(self, pending) -> int:
        """Tokens one chunked-prefill launch may process per request. The
        fixed `prefill_chunk` unless an SLA budget *and* a bound RoofLens
        are installed; then the cap is the largest page-aligned pow2 ladder
        step whose *predicted* launch time fits `prefill_sla_s`. A round
        whose gather term grows with the written prefix then takes smaller
        bites than a cold one: constant predicted stall on the interleaved
        decode stream instead of a constant token count. Never less than
        one page, so prefill progresses even over budget. Under the ladder's
        `prefill_shrink` rung the span is one page: prefill still
        progresses, and stops competing with the blocked head for pages."""
        if self._span_shrunk:
            return min(self.prefill_chunk, self.cache.block_size)
        if (
            self.prefill_sla_s is None
            or self._obs_rooflens is None
            or not getattr(self._obs_rooflens, "_bound", False)
        ):
            return self.prefill_chunk
        bs = self.cache.block_size
        rows = len(pending)
        best = min(bs, self.prefill_chunk)
        n = bs
        while n <= self.prefill_chunk:
            table = max(
                math.ceil(min(r.prefilled + n, len(r.prompt)) / bs)
                for _, r in pending
            ) * bs
            if self._obs_rooflens.predict_prefill_chunk(
                rows, n, table
            ) > self.prefill_sla_s:
                break
            best = n
            n *= 2
        return best

    def _prefill_rows(self, rows: List[tuple], bucketed: bool = True,
                      bounded: bool = False) -> None:
        """One prefill launch over `rows` of (slot, request, start, n): each
        row writes prompt tokens [start, start + n) at their positions.
        Monolithic admission passes start = the prefix-cache hit and n = the
        rest of the prompt; chunked mode passes chunks. The batch pads to a
        power of two (<= max_slots) and the span to the round's max page
        count; padding rows write to the null page under the empty-position
        sentinel. `bounded` (chunked prefill) narrows the block table to
        the pow2-rounded page count of the round's furthest row, so the
        gather reads the written prefix, not max_blocks.

        Only rows that reach the end of their prompt sample a token (the
        first output); the round's copy-on-write clones ride the launch,
        tier restores are uploaded before it, and finished prompts enter
        the prefix index after their sample. With the guard armed, a
        completing row whose logits are not all finite fails its request
        (before its token or its pages reach anyone)."""
        bs = self.cache.block_size
        nrows = len(rows)
        pages = max(math.ceil(n / bs) for _, _, _, n in rows)
        b = min(_pow2ceil(nrows), self.max_slots) if bucketed else nrows
        sp = pages * bs
        tw = self.max_blocks
        if bounded:
            tw = min(_pow2ceil(max(math.ceil((start + n) / bs)
                                   for _, _, start, n in rows)), self.max_blocks)

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
        completing: List[tuple] = []  # (row, slot, request) sampling a 1st token
        for row, (slot, r, start, n) in enumerate(rows):
            tokens[row, :n] = r.prompt[start:start + n]
            positions[row] = start + positions[row]
            write_pos[row, :n] = np.arange(start, start + n, dtype=np.int32)
            write_slots[row, :n] = self.cache.write_slots(r.rid, start, n)
            tables[row] = self.cache.block_table_row(r.rid, tw)
            r.prefilled = start + n
            if r.prefilled >= len(r.prompt):
                last_idx[row] = n - 1
                rids[row] = r.rid
                # a resume's sample is the request's next global output
                # token: it keys on the banked count
                steps0[row] = len(r.done_tokens)
                completing.append((row, slot, r))
        copies = self.cache.drain_copies(b)
        fresh_rows = self.cache.drain_fresh_rows(b * pages)
        for extra in fresh_rows[1:]:
            # more recycled pages than the launch's fresh vector carries:
            # scrub the overflow before the launch that writes into them
            self._scrub(extra)
        restores = self.cache.drain_restores()
        if restores is not None:
            # tier-restored pages: the upload is each page's whole
            # initialization (codes, scales, positions), so it needs no
            # scrub, and it lands before the launch that reads the pages
            if self._tier_restore is None:
                raise ValueError(f"{len(restores[0])} pending tier restores and no "
                                 "tier_restore_fn installed")
            rt0 = self._clock()
            self._tier_restore(*restores)
            rt1 = self._clock()
            if self._obs_rooflens is not None:
                self._obs_rooflens.observe_tier_restore(
                    len(restores[0]), self.cache.bytes_per_token() * bs, rt1 - rt0)
            if self._obs_metrics is not None:
                self._obs_metrics.histogram("serve.tier.restore_wall_s", unit="s").record(
                    rt1 - rt0)
        t0 = self._obs_clock() if self._observing else 0.0
        logits = self._prefill(
            tokens, positions, tables, write_slots, write_pos, fresh_rows[0],
            copies, last_idx,
        )
        if self._poison_pending and completing:
            # chaos "poison_prefill": NaN one real row's logits on the
            # device before sampling; the guard must fail exactly that row
            self._poison_pending = False
            logits[completing[0][0]] = float("nan")
        failed_rows: set = set()
        if self._guard_nonfinite and completing:
            # the finite flags cross in the sampler's one copy
            toks, finite = self._sample(logits, rids, steps0, guard=True)
            failed_rows = {row for row, _, _ in completing if not bool(finite[row])}
        else:
            toks = self._sample(logits, rids, steps0)  # the round's device->host sync
        # `toks` is on the host: t1 - t0 is the prefill wall, sampling included
        t1 = self._obs_clock() if self._observing else 0.0
        for row, slot, r in completing:
            if row in failed_rows:
                # before out and prefix_insert: a poisoned request never
                # emits a token and never seeds the prefix index
                self._fail(slot, r)
                continue
            r.out.append(int(toks[row]))
            self.cache.prefix_insert(r.rid, r.prompt)
        for row, (slot, r, start, n) in enumerate(rows):
            if row in failed_rows:
                continue  # released: its pages are already reclaimed
            r.peak_blocks = max(r.peak_blocks, self.cache.blocks_held(r.rid))

        st = self._stats
        st["prefill_calls"] += 1
        st["host_syncs"] += 1
        if bounded:
            st["prefill_chunk_calls"] += 1
        st["prefill_token_steps"] += b * sp
        st["prefill_real_tokens"] += sum(n for _, _, _, n in rows)
        if self._obs_tracer is not None:
            # a request's first token is visible at the completing call's sync
            self._obs_tracer.on_prefill(
                t0, t1, [r.rid for row, _, r in completing if row not in failed_rows],
                b, sp)
        if self._obs_rooflens is not None:
            if bounded:
                self._obs_rooflens.observe_prefill_chunk(b, sp, tw * bs, t1 - t0)
            else:
                self._obs_rooflens.observe_prefill(b, sp, t1 - t0)
        if self._obs_metrics is not None:
            self._obs_metrics.histogram("serve.prefill.wall_s", unit="s").record(t1 - t0)
            self._obs_metrics.counter("serve.host_syncs", unit="calls").inc()

    # ------------------------------------------------------------------
    # decode: single-step (chunk == 1), device-resident chunk, or spec
    # ------------------------------------------------------------------
    def _decode_active(self) -> None:
        """One decode round over the decode-ready slots: a spec launch, a
        chunk when `chunk > 1`, else one single step. A slot is
        decode-ready once prefill sampled its first token: mid-prefill
        slots (chunked mode, empty `out`) sit the round out as inactive
        slots."""
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None and r.out]
        if not active:
            return
        # CoW clones arise only from prefix-hit prompt recomputes, and the
        # prefill launch that made them drains them: decode writing into a
        # shared page would mean the admission plan is wrong. Nothing is
        # ever copied inside a captured decode graph.
        assert self.cache.pending_copies == 0, "unflushed CoW copies at decode"
        # tier restores arise only at admission, and the prefill launch that
        # follows every admission drains them
        assert self.cache.pending_restores == 0, "unflushed tier restores at decode"
        if self._spec is not None and self._spec_enabled:
            self._decode_active_spec(active)
        elif self.chunk > 1:
            self._decode_active_chunked(active)
        else:
            self._decode_active_single(active)

    def _decode_active_single(self, active) -> None:
        """One decode step: feed back each slot's last token, write its KV
        at the next position, sample on the device; the (M,) tokens are the
        step's one device->host sync."""
        m, mb = self.max_slots, self.max_blocks
        tokens = np.zeros((m, 1), np.int32)
        positions = np.zeros((m, 1), np.int32)
        write_pos = np.full((m, 1), CACHE_EMPTY_POS, np.int32)
        write_slots = np.zeros((m, 1), np.int32)  # null page, offset 0
        tables = np.zeros((m, mb), np.int32)
        kv_lens = np.zeros(m, np.int32)
        rids = np.full(m, -1, np.int64)  # -1: a uint32 id no request has
        steps = np.zeros(m, np.int64)
        for i, r in active:
            pos = r.next_pos - 1  # feed back the last sampled token
            tokens[i, 0] = r.out[-1]
            positions[i, 0] = pos
            write_pos[i, 0] = pos
            write_slots[i, 0] = self.cache.write_slots(r.rid, pos, 1)[0]
            tables[i] = self.cache.block_table_row(r.rid, mb)
            kv_lens[i] = r.next_pos  # the token this step writes included
            rids[i] = r.rid
            steps[i] = r.emitted  # the global output index: park/resume invariant
        fresh = self.cache.drain_fresh(m)
        t0 = self._obs_clock() if self._observing else 0.0
        logits = self._decode(tokens, positions, tables, write_slots, write_pos, fresh,
                              kv_lens)
        toks = self._sample(logits, rids, steps)  # the step's device->host sync
        t1 = self._obs_clock() if self._observing else 0.0
        for i, r in active:
            r.out.append(int(toks[i]))
            r.peak_blocks = max(r.peak_blocks, self.cache.blocks_held(r.rid))

        self._account_decode(1, len(active))
        for i, _ in active:
            self._account_kv_read(int(kv_lens[i]))
        if self._observing:
            self._observe_decode(t0, t1, 1, {r.rid: 1 for _, r in active},
                                 [int(kv_lens[i]) for i, _ in active])
        for i, r in active:
            if self._finished(r):
                self._evict(i)
        self._free_window_pages()

    def _decode_active_chunked(self, active) -> None:
        """Precompute a chunk's slot/position advancement, run it on the
        device, then replay the sampled tokens against host request state
        (the replay only decides how many of the C tokens each slot keeps)."""
        m, mb, bs = self.max_slots, self.max_blocks, self.cache.block_size
        rem = {i: r.max_new_tokens - r.emitted for i, r in active}
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
            start_steps[i] = r.emitted  # sampling keys ride the global index
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

        t0 = self._obs_clock() if self._observing else 0.0
        toks = self._decode_chunk(
            tokens0, tables, positions, write_slots, write_pos, fresh,
            kv_lens, rids, start_steps, max_steps, eos, act,
        )  # (c, m) host tokens: the chunk's one device->host sync
        t1 = self._obs_clock() if self._observing else 0.0

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
        if self._observing:
            # the fixed-shape step always runs all c steps, so the roofline
            # prediction is over c; the tracer gets only the kept tokens
            self._observe_decode(
                t0, t1, c, {r.rid: steps_taken[i] for i, r in active},
                [p0s[i] + 1 for i, _ in active],
            )
        for i, r in active:
            if self._finished(r):
                self._evict(i)
        self._free_window_pages()

    def _account_decode(self, steps: int, slot_steps: int) -> None:
        """Charge one single-step round: the pages held now, per step, and
        what a max_len ring cache would hold for the same slot-steps."""
        st = self._stats
        st["decode_steps"] += steps
        st["decode_chunks"] += 1
        st["host_syncs"] += 1
        st["active_slot_steps"] += slot_steps
        used = self.cache.allocator.used_count
        st["paged_block_steps"] += used * steps
        st["dense_block_steps"] += slot_steps * self.max_blocks
        st["peak_blocks"] = max(st["peak_blocks"], used)

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
            for i in live:
                self._account_kv_read(p0s[i] + j + 1)
            for i, r in active:
                if steps_taken[i] == j + 1 and self._finished(r):
                    used -= held0[i] + grown[i]

    def _account_kv_read(self, kv_len: int) -> None:
        """One decode token's KV read of one slot: the fused walk covers
        the pages from the first its window can see (all-local stacks) up
        to ceil(kv_len / bs); the worst case is the max_blocks gather."""
        bs = self.cache.block_size
        first = max(0, kv_len - self.local_window) // bs if self.local_window else 0
        self._stats["kv_pages_read"] += min(self.max_blocks, -(-kv_len // bs)) - first
        self._stats["kv_pages_read_worst"] += self.max_blocks

    def _free_window_pages(self) -> None:
        """Window freeing (all-local attention stacks only): a key at
        position p is visible to query q iff p > q - window, and live
        queries only advance, so every page wholly below `next query -
        window + 1` is dead for good. Its table entry becomes a null-page
        read, masked by the scrubbed sentinel, never the stale page, which
        may be reallocated to another tenant."""
        if self.local_window is None:
            return
        freed = 0
        for r in self.slots:
            if r is not None:
                # the next query position: decode feeds back the last
                # sampled token at next_pos - 1; a mid-prefill slot's next
                # chunk starts at `prefilled`
                nq = r.next_pos - 1 if r.out else r.prefilled
                freed += self.cache.free_behind(r.rid, nq + 1 - self.local_window)
        self._stats["window_freed_pages"] += freed

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
        rem = {i: r.max_new_tokens - r.emitted for i, r in active}

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
            start_steps[i] = r.emitted  # sampling keys ride the global index
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

        t0 = self._obs_clock() if self._observing else 0.0
        out, e_rounds = self._spec(tokens0, tables, p0, fresh, rids, start_steps,
                                   max_steps, eos, act)
        t1 = self._obs_clock() if self._observing else 0.0

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
        if self._observing:
            self._observe_spec(t0, t1, active, e_rounds, p0s)
        for i, r in active:
            if self._finished(r):
                self._evict(i)
        self._free_window_pages()

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
        bs, k = self.cache.block_size, self.spec_k
        wins = [w for w in (self.spec_window or None, self.local_window) if w is not None]
        window = min(wins) if wins else None
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

    def _observe_decode(self, t0: float, t1: float, steps: int,
                        kept: Dict[int, int], kv_lens: List[int]) -> None:
        """Feed one decode chunk to whichever collectors are installed.
        `steps` is the device steps launched, `kept` the tokens each request
        keeps, `kv_lens` the active slots' context lengths at chunk start."""
        if self._obs_tracer is not None:
            self._obs_tracer.on_decode_chunk(t0, t1, steps, kept)
        if self._obs_rooflens is not None:
            self._obs_rooflens.observe_decode(kv_lens, steps, t1 - t0)
        if self._obs_metrics is not None:
            self._record_decode_metrics(t1 - t0, kept)

    def _observe_spec(self, t0: float, t1: float, active, e_rounds: np.ndarray,
                      p0s: Dict[int, int]) -> None:
        """Feed one spec launch to the collectors: each request keeps the
        tokens its rounds emitted, the tracer counts the live rounds as
        steps, and RoofLens splits the wall between the draft and verify
        regimes (`RoofLens.observe_spec`) at the slots' context lengths at
        launch start."""
        kept = {r.rid: int(np.sum(e_rounds[:, i])) for i, r in active}
        kv_lens = [p0s[i] + 1 for i, _ in active]
        live_rounds = int(np.sum(np.any(np.asarray(e_rounds) > 0, axis=1)))
        if self._obs_tracer is not None:
            self._obs_tracer.on_decode_chunk(t0, t1, live_rounds, kept)
        if self._obs_rooflens is not None:
            self._obs_rooflens.observe_spec(
                kv_lens, self.spec_k, max(1, live_rounds), t1 - t0
            )
        if self._obs_metrics is not None:
            self._record_decode_metrics(t1 - t0, kept)

    def _record_decode_metrics(self, wall_s: float, kept: Dict[int, int]) -> None:
        m = self._obs_metrics
        m.histogram("serve.decode.chunk_wall_s", unit="s").record(wall_s)
        m.counter("serve.host_syncs", unit="calls").inc()
        m.counter("serve.decode.tokens", unit="tokens").inc(sum(kept.values()))
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        """Pool / queue occupancy gauges (metrics registry installed)."""
        m = self._obs_metrics
        m.gauge("serve.queue_depth", unit="requests").set(len(self.queue))
        occ = self.cache.occupancy()
        m.gauge("serve.pool.used_pages", unit="pages").set(occ["used"])
        m.gauge("serve.pool.free_pages", unit="pages").set(occ["free"])
        m.gauge("serve.pool.reserved_pages", unit="pages").set(occ["reserved"])
        m.gauge("serve.pool.admittable_pages", unit="pages").set(occ["admittable"])
        m.gauge("serve.pool.shared_pages", unit="pages").set(occ["shared"])
        m.gauge("serve.pool.prefix_cached_pages", unit="pages").set(occ["cached"])
        m.gauge("serve.pool.tiered_pages", unit="pages").set(occ["tiered"])
        m.gauge("serve.slots.active", unit="slots").set(
            sum(1 for r in self.slots if r is not None)
        )

    def _finished(self, r: Request) -> bool:
        # `emitted` counts banked pre-park tokens too: a resumed request's
        # length cap is unchanged by the interruption
        return r.emitted >= r.max_new_tokens or (
            r.eos_id is not None and bool(r.out) and r.out[-1] == r.eos_id
        )

    def _evict(self, slot: int) -> None:
        r = self.slots[slot]
        if r is None:
            return
        self.results[r.rid] = np.asarray(r.all_out, np.int32)
        self.statuses[r.rid] = RequestStatus.OK
        self.request_peaks[r.rid] = r.peak_blocks
        self.cache.release(r.rid)
        self.slots[slot] = None
        if self._obs_tracer is not None:
            reason = (
                "eos" if r.eos_id is not None and r.out
                and r.out[-1] == r.eos_id else "length"
            )
            self._obs_tracer.on_finish(r.rid, reason)
        if self._obs_metrics is not None:
            self._obs_metrics.counter(
                "serve.requests.finished", unit="requests"
            ).inc()
            self._publish_gauges()

    # ------------------------------------------------------------------
    # occupancy / padding-waste report
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """A fresh snapshot of the serving counters plus derived ratios;
        every key's unit is in `STAT_UNITS`. With a metrics registry
        installed the snapshot is also folded into it as `serve.stats.*`
        gauges."""
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
        # prefix sharing: hit tokens and CoW clones are lifetime counters of
        # the cache; shared and cached pages are occupancy now
        occ = self.cache.occupancy()
        st["prefix_hit_tokens"] = self.cache.prefix_hit_tokens
        st["cow_copies"] = self.cache.cow_copies
        st["shared_pages"] = occ["shared"]
        st["prefix_cached_pages"] = occ["cached"]
        # host tier: lifetime spill / restore / corruption counters and
        # residency now; all 0 without a tier
        tier = self.cache.tier
        st["tier_spilled_pages"] = tier.spilled_pages if tier else 0
        st["tier_restored_pages"] = tier.restored_pages if tier else 0
        st["tier_pages"] = tier.pages if tier else 0
        st["tier_bytes"] = tier.payload_bytes if tier else 0
        st["tier_corrupt"] = tier.corrupt_pages if tier else 0
        st["tier_fallback_recompute"] = tier.fallback_recomputes if tier else 0
        st["tier_hit_tokens"] = self.cache.tier_hit_tokens
        if self._obs_metrics is not None:
            self._obs_metrics.ingest("serve.stats", st, units=STAT_UNITS)
        return st

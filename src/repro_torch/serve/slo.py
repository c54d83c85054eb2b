"""SLO admission control and the request-status taxonomy (the counterpart of
`repro/serve/slo.py`).

The scheduler consults one `SLAPolicy` at three points:

  submit     bounded queue: a submit past `max_queue` is SHED at once
             instead of growing a backlog whose tail can meet no deadline
  admission  TTFT gate: a queued candidate whose waited time plus the
             predicted prefill wall already breaches `ttft_slo_s` is SHED
             at the head of the queue; ITL gate: admitting onto a busy
             batch is deferred while the predicted per-token decode time
             of (residents + candidate) breaches `itl_slo_s`
  pressure   the degradation ladder (`LADDER`): when the pool blocks the
             queue head, the scheduler escalates one rung per blocked
             round (reclaim prefix-index-only pages, switch off spec
             rounds, shrink the chunked-prefill span, flush every
             reclaimable index page to the host tier, park the
             lowest-priority resident through `PagedKVCache.park`) and
             relaxes to rung 0 once the queue drains.

Predictions come from RoofLens and gate only when one is installed and
bound; otherwise the policy keeps its prediction-free checks (queue bound,
waited-time TTFT, deadlines). Every request ends with exactly one
`RequestStatus`, in `Scheduler.statuses` beside its (possibly partial)
tokens: overload and faults downgrade single requests, never the engine.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class RequestStatus(str, enum.Enum):
    """Terminal state of one request. Exactly one per submitted rid."""

    #: ran to completion (EOS or length cap) — possibly after a park/resume
    OK = "ok"
    #: rejected by the policy (bounded queue at submit, or a predicted
    #: TTFT breach at admission) before any pool pages were spent on it
    SHED = "shed"
    #: deadline passed while queued and never admitted; empty output
    EXPIRED = "expired"
    #: parked under pool pressure and its deadline passed before resume;
    #: the tokens emitted before preemption are kept in the result
    PREEMPTED = "preempted"
    #: failed by the non-finite-logit guard (poisoned forward); pages
    #: reclaimed, co-batched survivors unaffected
    FAILED = "failed"


#: Degradation-ladder rungs, escalated strictly in this order, one rung per
#: scheduler round in which the pool blocks the queue head (DESIGN.md §17).
#: Rungs that do not apply to the engine build (no prefix index, no spec
#: decode, monolithic prefill, no host tier) are skipped in the same round.
#: `spill` sits deliberately before `park`: flushing cold index pages to
#: the host tier costs only restore latency on the next hit, while parking
#: costs a live request its slot.
LADDER = ("prefix_evict", "spec_off", "prefill_shrink", "spill", "park")


@dataclasses.dataclass(frozen=True)
class SLAPolicy:
    """Service-level objectives the scheduler enforces at admission.

    ttft_slo_s  time-to-first-token objective: shed queued candidates whose
                waited time (+ predicted prefill, when a bound RoofLens is
                installed) already exceeds it — the surviving admitted
                population then meets the SLO by construction
    itl_slo_s   inter-token-latency objective: defer admission while the
                predicted per-token decode time of the residents plus the
                candidate breaches it (requires a bound RoofLens; without
                one the gate is inert)
    max_queue   bounded queue: submits past this depth are SHED immediately
                (None = unbounded, the pre-PR9 behavior)
    """

    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None
    max_queue: Optional[int] = None

    def __post_init__(self):
        for name in ("ttft_slo_s", "itl_slo_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")

    # -- the three gates (pure predicates; the scheduler owns all state) ----

    def queue_full(self, depth: int) -> bool:
        """True when a new submit at queue depth `depth` must be shed."""
        return self.max_queue is not None and depth >= self.max_queue

    def ttft_breached(self, waited_s: float,
                      predicted_prefill_s: float = 0.0) -> bool:
        """True when a queued candidate can no longer meet the TTFT SLO:
        time already waited plus the predicted prefill exceeds the budget.
        Pass 0 for the prediction when no bound RoofLens is available —
        the gate then sheds only on already-elapsed waiting time."""
        if self.ttft_slo_s is None:
            return False
        return waited_s + predicted_prefill_s > self.ttft_slo_s

    def itl_breached(self, predicted_chunk_s: float, steps: int) -> bool:
        """True when the predicted per-token decode time of one chunk over
        the would-be batch breaches the ITL SLO."""
        if self.itl_slo_s is None:
            return False
        return predicted_chunk_s / max(1, steps) > self.itl_slo_s

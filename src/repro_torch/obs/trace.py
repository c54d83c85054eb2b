"""Per-request lifecycle tracing for the continuous-batching scheduler.

Port-owned copy of `repro/obs/trace.py`: plain Python, the same semantics
and the same Chrome-trace output.

Event taxonomy (DESIGN.md §14): a request's life is
`submit -> admit(slot) -> prefill -> decode chunk* -> finish(eos|length)`.
The scheduler calls the `on_*` hooks at each transition; every hook is a
cheap host-side append, timestamped by the injected clock (tests use a fake
monotonic clock and get deterministic TTFT/ITL numbers).

Token timestamps are *visibility* times: a token exists for a client when
its device->host sync completes, so every token kept from one decode chunk
shares the chunk-end timestamp, and the first token of a request lands at
prefill end (the prefill call samples it). TTFT and ITL are derived from
those — TTFT = first token visibility - submit; ITL = successive token
visibility deltas, which for chunked decode is a burst pattern (zeros
inside a chunk, the chunk wall time between chunks). That burstiness is
the real client-observed latency structure of DESIGN.md §12's
one-sync-per-chunk design, not an artifact.

`export_chrome_trace` writes Chrome trace-event JSON (catapult format):
open it in Perfetto / chrome://tracing and the scheduler timeline (admit /
prefill / decode-chunk spans on one track, one track per request) is the
§14 debugging view.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable, Dict, IO, List, Optional, Union

from repro_torch.obs.metrics import exact_percentiles

Clock = Callable[[], float]

# scheduler-track span names (chrome trace `name` field)
SPAN_ADMIT = "admit"
SPAN_PREFILL = "prefill"
SPAN_DECODE_CHUNK = "decode_chunk"


@dataclasses.dataclass
class RequestTrace:
    """Everything recorded about one request's lifecycle (times in the
    tracer clock's seconds)."""

    rid: int
    submit_t: float
    prompt_len: int
    max_new_tokens: int
    admit_t: Optional[float] = None
    slot: Optional[int] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None

    @property
    def ttft(self) -> float:
        """Time to first token (s); nan before the first token lands."""
        if not self.token_times:
            return math.nan
        return self.token_times[0] - self.submit_t

    @property
    def itl(self) -> List[float]:
        """Inter-token visibility deltas (s), len == n_tokens - 1."""
        tt = self.token_times
        return [b - a for a, b in zip(tt, tt[1:])]

    @property
    def queue_wait(self) -> float:
        if self.admit_t is None:
            return math.nan
        return self.admit_t - self.submit_t


@dataclasses.dataclass
class _Span:
    name: str
    t0: float
    t1: float
    args: Dict[str, Union[int, float, str]]


class Tracer:
    """Collects request lifecycles + scheduler-track spans; exports Chrome
    trace JSON and TTFT/ITL summaries. All hooks are O(1) host appends."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock: Clock = clock if clock is not None else time.perf_counter
        self.requests: Dict[int, RequestTrace] = {}
        self.spans: List[_Span] = []

    def reset(self) -> None:
        """Drop recorded lifecycles/spans (e.g. after a compile-warmup
        drain, so summaries cover only the measured run). The instance —
        and every scheduler holding it — stays live."""
        self.requests.clear()
        self.spans.clear()

    # -- scheduler hooks ----------------------------------------------------

    def on_submit(self, rid: int, prompt_len: int, max_new_tokens: int) -> None:
        self.requests[rid] = RequestTrace(
            rid, self.clock(), prompt_len, max_new_tokens
        )

    def on_admit(self, rid: int, slot: int) -> None:
        r = self.requests.get(rid)
        if r is not None:
            r.admit_t = self.clock()
            r.slot = slot

    def on_admit_round(self, t0: float, t1: float, n_admitted: int,
                       queue_depth: int) -> None:
        self.spans.append(_Span(SPAN_ADMIT, t0, t1, {
            "admitted": n_admitted, "queue_depth": queue_depth,
        }))

    def on_prefill(self, t0: float, t1: float, rids: List[int],
                   batch_rows: int, span_tokens: int) -> None:
        """One bucketed prefill call; each admitted rid's first token
        becomes visible at t1 (prefill samples it)."""
        self.spans.append(_Span(SPAN_PREFILL, t0, t1, {
            "rids": len(rids), "batch_rows": batch_rows, "span": span_tokens,
        }))
        for rid in rids:
            r = self.requests.get(rid)
            if r is not None:
                r.token_times.append(t1)

    def on_decode_chunk(self, t0: float, t1: float, steps: int,
                        kept: Dict[int, int]) -> None:
        """One decode round (chunk of `steps` scan steps, or a single host-
        loop step); `kept[rid]` tokens became visible at t1 per request."""
        self.spans.append(_Span(SPAN_DECODE_CHUNK, t0, t1, {
            "steps": steps, "slots": len(kept),
            "tokens": sum(kept.values()),
        }))
        for rid, n in kept.items():
            r = self.requests.get(rid)
            if r is not None:
                r.token_times.extend([t1] * n)

    def on_finish(self, rid: int, reason: str) -> None:
        r = self.requests.get(rid)
        if r is not None:
            r.finish_t = self.clock()
            r.finish_reason = reason

    # -- derived views ------------------------------------------------------

    def finished(self) -> List[RequestTrace]:
        return [r for r in self.requests.values() if r.finish_t is not None]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Exact TTFT / ITL / queue-wait percentiles over finished requests
        (seconds). ITL pools every finished request's deltas — the client-
        observed distribution, bursts included."""
        done = self.finished()
        ttfts = [r.ttft for r in done if not math.isnan(r.ttft)]
        itls = [d for r in done for d in r.itl]
        waits = [r.queue_wait for r in done if not math.isnan(r.queue_wait)]
        out = {
            "ttft_s": exact_percentiles(ttfts),
            "itl_s": exact_percentiles(itls),
            "queue_wait_s": exact_percentiles(waits),
        }
        out["ttft_s"]["mean"] = (
            sum(ttfts) / len(ttfts) if ttfts else math.nan
        )
        out["itl_s"]["mean"] = sum(itls) / len(itls) if itls else math.nan
        out["n_requests"] = len(done)
        out["n_tokens"] = sum(len(r.token_times) for r in done)
        return out

    # -- Chrome trace-event export (Perfetto / chrome://tracing) ------------

    def chrome_trace_events(self) -> List[Dict]:
        """Catapult trace-event list: scheduler spans on pid 0 / tid 0,
        one tid per request on pid 1, token visibility as instant events.
        Timestamps are microseconds relative to the earliest event."""
        origin = min(
            [s.t0 for s in self.spans]
            + [r.submit_t for r in self.requests.values()],
            default=0.0,
        )

        def us(t: float) -> float:
            return (t - origin) * 1e6

        ev: List[Dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "scheduler"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        for s in self.spans:
            ev.append({
                "ph": "X", "pid": 0, "tid": 0, "name": s.name,
                "ts": us(s.t0), "dur": max(0.0, (s.t1 - s.t0) * 1e6),
                "args": dict(s.args),
            })
        for r in self.requests.values():
            ev.append({"ph": "M", "pid": 1, "tid": r.rid,
                       "name": "thread_name",
                       "args": {"name": f"req {r.rid}"}})
            end = r.finish_t if r.finish_t is not None else (
                r.token_times[-1] if r.token_times else r.submit_t
            )
            ev.append({
                "ph": "X", "pid": 1, "tid": r.rid, "name": f"req{r.rid}",
                "ts": us(r.submit_t), "dur": max(0.0, (end - r.submit_t) * 1e6),
                "args": {
                    "prompt_len": r.prompt_len,
                    "max_new_tokens": r.max_new_tokens,
                    "n_tokens": len(r.token_times),
                    "slot": -1 if r.slot is None else r.slot,
                    "reason": r.finish_reason or "in-flight",
                    "ttft_ms": round(r.ttft * 1e3, 3)
                    if not math.isnan(r.ttft) else -1,
                },
            })
            if r.admit_t is not None:
                ev.append({"ph": "i", "pid": 1, "tid": r.rid, "name": "admit",
                           "ts": us(r.admit_t), "s": "t"})
            for j, t in enumerate(r.token_times):
                ev.append({"ph": "i", "pid": 1, "tid": r.rid,
                           "name": "first_token" if j == 0 else "token",
                           "ts": us(t), "s": "t"})
        return ev

    def export_chrome_trace(self, path_or_file: Union[str, IO]) -> None:
        """Write `{"traceEvents": [...]}` JSON openable in Perfetto."""
        doc = {
            "traceEvents": self.chrome_trace_events(),
            "displayTimeUnit": "ms",
        }
        if hasattr(path_or_file, "write"):
            json.dump(doc, path_or_file)
        else:
            with open(path_or_file, "w") as f:
                json.dump(doc, f)

"""Process-local metrics registry: counters, gauges, log-bucketed histograms.

Port-owned copy of `repro/obs/metrics.py`: plain Python, the same
semantics and the same output.

The serving stack's observables (DESIGN.md §14) live here instead of ad-hoc
dicts: `Scheduler` publishes its occupancy/paging counters, the engine its
host-sync counts, and `RoofLens` its predicted-vs-measured step times. The
registry is deliberately dependency-free and host-side only — recording a
sample is a dict lookup plus an integer increment, never a device op — so
instrumentation can stay on in production serving loops.

Clock injection: every time-derived metric goes through the registry's
`clock` (a zero-arg seconds callable, default `time.perf_counter`). Tests
substitute a fake monotonic clock and get exactly reproducible timings.

Histograms are log-bucketed: sample `v > 0` lands in bucket
`floor(log(v) / log(ratio))`, so relative resolution is constant across
twelve orders of magnitude at O(1) memory. Quantile extraction returns the
geometric midpoint of the target bucket, clamped into the observed
[min, max] — which makes the single-sample and constant-stream cases exact.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, List, Optional, Union


Clock = Callable[[], float]


class Counter:
    """Monotonically increasing count of events (unit: whatever the site
    counts — requests, tokens, pages, host syncs)."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = "count"):
        self.name = name
        self.unit = unit
        self.value = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (pool occupancy, queue depth)."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = "value"):
        self.name = name
        self.unit = unit
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed distribution with p50/p90/p99 quantile extraction.

    `ratio` is the geometric bucket width (default 2**0.25 — ~19% relative
    error worst case, 4 buckets per octave). Samples must be >= 0; zeros go
    to a dedicated bucket so a stream of exact zeros stays exact.
    """

    __slots__ = ("name", "unit", "ratio", "_log_ratio", "_buckets",
                 "count", "total", "min", "max")

    def __init__(self, name: str, unit: str = "value", ratio: float = 2 ** 0.25):
        if ratio <= 1.0:
            raise ValueError(f"histogram {name}: ratio must be > 1, got {ratio}")
        self.name = name
        self.unit = unit
        self.ratio = ratio
        self._log_ratio = math.log(ratio)
        self._buckets: Dict[int, int] = {}  # bucket index -> sample count
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        if v < 0 or math.isnan(v):
            raise ValueError(f"histogram {self.name}: bad sample {v}")
        # zero bucket sits below every real bucket index
        idx = -(2 ** 62) if v == 0.0 else math.floor(math.log(v) / self._log_ratio)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1); nan when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        # nearest-rank over cumulative bucket counts
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                if idx == -(2 ** 62):
                    return 0.0
                # geometric midpoint of [ratio^idx, ratio^(idx+1)), clamped
                # into the observed range: single-sample histograms are exact
                mid = math.exp((idx + 0.5) * self._log_ratio)
                return min(max(mid, self.min), self.max)
        return self.max  # unreachable; defensive

    def percentiles(self) -> Dict[str, float]:
        return {
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named metric store with get-or-create accessors and one shared clock.

    Naming convention (DESIGN.md §14): dotted lowercase paths,
    `<subsystem>.<object>.<observable>[_<unit>]` — e.g.
    `serve.prefill.wall_s`, `serve.pool.used_pages`, `rooflens.decode.ratio`.
    Re-requesting a name with a conflicting type or unit raises: one name,
    one meaning, for the whole process.
    """

    def __init__(self, clock: Optional[Clock] = None):
        self.clock: Clock = clock if clock is not None else time.perf_counter
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls, unit: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, unit, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls) or m.unit != unit:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}({m.unit!r}), requested "
                f"{cls.__name__}({unit!r})"
            )
        return m

    def counter(self, name: str, unit: str = "count") -> Counter:
        return self._get(name, Counter, unit)

    def gauge(self, name: str, unit: str = "value") -> Gauge:
        return self._get(name, Gauge, unit)

    def histogram(self, name: str, unit: str = "value",
                  ratio: float = 2 ** 0.25) -> Histogram:
        return self._get(name, Histogram, unit, ratio=ratio)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Record one wall-clock span (seconds) into histogram `name`."""
        h = self.histogram(name, unit="s")
        t0 = self.clock()
        try:
            yield
        finally:
            h.record(self.clock() - t0)

    def ingest(self, prefix: str, values: Dict[str, float],
               units: Optional[Dict[str, str]] = None) -> None:
        """Fold a plain stats dict (e.g. `Scheduler.stats()`) into gauges
        under `prefix.` — the bridge from legacy dict reporting into the
        registry."""
        for k, v in values.items():
            unit = (units or {}).get(k, "value")
            self.gauge(f"{prefix}.{k}", unit=unit).set(v)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Defensive plain-dict view of every metric (safe to mutate)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "unit": m.unit,
                             "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "unit": m.unit, "value": m.value}
            else:
                row = {"type": "histogram", "unit": m.unit, "count": m.count,
                       "mean": m.mean,
                       "min": m.min if m.count else math.nan,
                       "max": m.max if m.count else math.nan}
                row.update(m.percentiles())
                out[name] = row
        return out


def exact_percentiles(samples: List[float],
                      qs=(0.50, 0.90, 0.99)) -> Dict[str, float]:
    """Exact nearest-rank percentiles over a finite sample list (offline
    reporting — the Tracer's TTFT/ITL summaries — where O(n log n) is fine
    and bucket error is not)."""
    if not samples:
        return {f"p{int(q * 100)}": math.nan for q in qs}
    s = sorted(samples)
    out = {}
    for q in qs:
        rank = max(1, math.ceil(q * len(s)))
        out[f"p{int(q * 100)}"] = s[rank - 1]
    return out

"""Serving observability: metrics, tracing, roofline lens.

Port-owned copy of `repro/obs/__init__.py`. Three independent collectors,
bundled by `Observability` and installed with one engine argument:

    from repro_torch.obs import Observability
    obs = Observability.default()
    engine = GenerationEngine(model, params, obs=obs, ...)
    ...
    obs.tracer.summary()            # TTFT / ITL percentiles
    obs.tracer.export_chrome_trace("trace.json")   # open in Perfetto
    obs.rooflens.error_report()     # roofline predicted-vs-measured
    obs.metrics.snapshot()          # counters / gauges / histograms

Design rule: observability is a layer, not printf. Every instrumentation
site in the serving stack is guarded (`if obs is None: ...` — no
allocation, no clock read, no device op when nothing is installed), and no
collector ever runs on the device: the sites read the host clock around
the scheduler's device calls, whose token copy back to the host already
waits for the card, so they add no synchronization and never run inside a
CUDA graph capture. The decode chunk launches the same aten ops with and
without observers (tests/test_torch_obs.py). All three collectors share
one injectable monotonic clock so cross-collector timestamps agree and
tests are deterministic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, exact_percentiles,
)
from repro_torch.obs.rooflens import RoofLens  # noqa: F401
from repro_torch.obs.trace import RequestTrace, Tracer  # noqa: F401


@dataclasses.dataclass
class Observability:
    """Collector bundle the serving stack instruments against. Any field
    may be None — each site checks what it needs. `clock` is the shared
    timestamp source for sites that time spans for more than one
    collector."""

    metrics: Optional[MetricsRegistry] = None
    tracer: Optional[Tracer] = None
    rooflens: Optional[RoofLens] = None
    clock: Callable[[], float] = time.perf_counter

    @classmethod
    def default(cls, clock: Optional[Callable[[], float]] = None,
                profile=None) -> "Observability":
        """All three collectors on one (optionally fake) clock; `profile`
        defaults to the H100's (`core.roofsurface.H100_SXM`)."""
        clk = clock if clock is not None else time.perf_counter
        metrics = MetricsRegistry(clock=clk)
        return cls(
            metrics=metrics,
            tracer=Tracer(clock=clk),
            rooflens=RoofLens(profile, registry=metrics),
            clock=clk,
        )

"""Deterministic fault injection and straggler detection for the serving
scheduler (the serving half of `repro/dist/fault.py`; numpy only).

A `FaultInjector` plan names scheduler rounds and the fault each one
suffers; `p_fail` draws crash steps from a stream that is a pure function
of (seed, step), so two injectors with one seed fail the same steps. The
scheduler consumes the `SERVING_FAULTS` kinds through `take` at the point
in its round where each applies; a `StragglerWatchdog` flags rounds whose
wall time exceeds a multiple of the running mean.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Simulated process crash (never raised by real failures)."""

    def __init__(self, step: int, action: str):
        super().__init__(f"injected {action} at step {step}")
        self.step = step
        self.action = action


#: Fault kinds the serving scheduler consumes via `take` (DESIGN.md §17).
#: "slow" is shared with the training path; the others only make sense
#: inside the scheduler loop: "exhaust_pool" grabs the pool's unreserved
#: headroom for one round (admission sees zero admittable pages, residents'
#: reservations stay backed), "poison_prefill" overwrites one prefill row's
#: logits with NaN so the host-sync guard must fail exactly that request,
#: and "corrupt_tier_page" flips bytes in one stored host-tier payload
#: (DESIGN.md §18) so the checksum-verified restore path must fall back to
#: recompute for exactly the affected prefix — never a crash, never a
#: wrong token.
SERVING_FAULTS = ("slow", "exhaust_pool", "poison_prefill",
                  "corrupt_tier_page")


class FaultInjector:
    """Deterministic, seed-driven step failures.

    Two sources, both deterministic:
      plan   : explicit {step: action} schedule — "crash" (raise
               InjectedFault) or "slow" (sleep `slow_s`, a straggler the
               watchdog should catch); the serving scheduler additionally
               understands the `SERVING_FAULTS` kinds through `take`
      p_fail : per-step crash probability drawn from a counter-based seeded
               stream — a pure function of (seed, step), so two injectors
               with the same seed fail the same steps.

    Each step fails at most once across restarts (`fired`), modelling a
    transient fault rather than a deterministic poison step.
    """

    def __init__(
        self,
        plan: Optional[Dict[int, str]] = None,
        *,
        seed: int = 0,
        p_fail: float = 0.0,
        slow_s: float = 0.25,
    ):
        self.plan = dict(plan or {})
        self.seed = seed
        self.p_fail = p_fail
        self.slow_s = slow_s
        self.fired: set = set()

    def action_for(self, step: int) -> Optional[str]:
        """The action scheduled for `step`, independent of firing state."""
        if step in self.plan:
            return self.plan[step]
        if self.p_fail > 0.0:
            u = np.random.default_rng(
                np.random.SeedSequence([self.seed, step])
            ).random()
            if u < self.p_fail:
                return "crash"
        return None

    def poll(self, step: int) -> None:
        """Inject the fault scheduled for `step`, at most once: "crash"
        raises InjectedFault; "slow" sleeps so the step shows up as a
        straggler."""
        action = self.action_for(step)
        if action is None or step in self.fired:
            return
        self.fired.add(step)
        if action == "slow":
            time.sleep(self.slow_s)
            return
        raise InjectedFault(step, action)

    def take(self, step: int, kind: str) -> bool:
        """Consume a scheduled fault of `kind` at `step`, at most once.

        The serving scheduler's polling shape: it asks for each fault kind
        it knows how to apply at the point in the round where that fault is
        applied (sleep before the round, poison inside the prefill launch,
        pool grab before admission), instead of one raise-at-poll site —
        a serving fault degrades one request or one round, never the
        engine. Returns True exactly once per (step, kind) hit."""
        if self.plan.get(step) != kind or (step, kind) in self.fired:
            return False
        self.fired.add((step, kind))
        return True


class StragglerWatchdog:
    """Per-step wall-clock tracking with a slow-step threshold.

    A step is flagged when it exceeds `factor` x the running mean of
    non-straggler steps (the first `warmup` observations only build the
    baseline — there is nothing to compare against yet). Flagged durations
    are kept out of the baseline so one straggler does not mask the next.
    """

    def __init__(self, factor: float = 3.0, warmup: int = 3):
        self.factor = factor
        self.warmup = warmup
        self.durations: List[float] = []
        self.events: List[int] = []

    def observe(self, step: int, duration_s: float) -> bool:
        slow = False
        if len(self.durations) >= self.warmup:
            mean = sum(self.durations) / len(self.durations)
            slow = duration_s > self.factor * mean
        if slow:
            self.events.append(step)
        else:
            self.durations.append(duration_s)
        return slow

    def report(self) -> Dict[str, Any]:
        n = len(self.durations)
        return {
            "n_steps": n + len(self.events),
            "n_stragglers": len(self.events),
            "events": list(self.events),
            "mean_step_s": (sum(self.durations) / n) if n else 0.0,
            "threshold_factor": self.factor,
        }

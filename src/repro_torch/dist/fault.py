"""Deterministic fault injection, straggler detection and checkpoint-
restart training (the port of `repro/dist/fault.py`).

A `FaultInjector` plan names scheduler rounds or train steps and the fault
each one suffers; `p_fail` draws crash steps from a stream that is a pure
function of (seed, step), so two injectors with one seed fail the same
steps. The scheduler consumes the `SERVING_FAULTS` kinds through `take` at
the point in its round where each applies; a `StragglerWatchdog` flags
rounds or steps whose wall time exceeds a multiple of the running mean.

`ResilientTrainer` drives training through injected crashes: a run
interrupted and resumed from its latest complete checkpoint ends with
params bit-identical to an uninterrupted run's. What makes that hold lies
elsewhere: a data pipeline that is a pure function of (seed, step),
checkpoints that round-trip every bit, and deterministic kernels.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.train.trainer import device_batch, params_device


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


class ResilientTrainer:
    """Checkpoint-restart wrapper around a train step.

    An InjectedFault aborts the attempt; the next attempt re-inits
    (`init_fn`), restores the latest complete checkpoint onto the fresh
    params' device, rebuilds the step (`make_step`, as a real restart
    would) and replays from the checkpointed step. Because the pipeline is
    a pure function of (seed, step) and checkpoints round-trip bits, the
    replayed steps reproduce the uninterrupted run bit for bit."""

    def __init__(
        self,
        model: Any,
        make_step: Callable[[], Callable],
        pipeline: Any,
        checkpointer: Any,
        *,
        checkpoint_every: int = 0,
        injector: Optional[FaultInjector] = None,
        watchdog: Optional[StragglerWatchdog] = None,
        max_restarts: int = 16,
    ):
        self.model = model
        self.make_step = make_step
        self.pipeline = pipeline
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.injector = injector
        self.watchdog = watchdog
        self.max_restarts = max_restarts
        self.restarts = 0
        self.history: List[Tuple[int, Dict[str, float]]] = []

    def run(self, init_fn: Callable[[], Tuple[Any, Any]], n_steps: int):
        """Train to `n_steps`, surviving injected faults. Returns the final
        (params, opt_state)."""
        while True:
            try:
                return self._attempt(init_fn, n_steps)
            except InjectedFault:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise

    def _attempt(self, init_fn, n_steps: int):
        params, opt_state = init_fn()
        start = 0
        if self.checkpointer is not None and self.checkpointer.latest_step() is not None:
            start, tree = self.checkpointer.restore({"params": params, "opt_state": opt_state})
            params, opt_state = tree["params"], tree["opt_state"]
        # replayed steps overwrite their pre-crash entries, not duplicate them
        self.history = [(s, m) for s, m in self.history if s < start]
        step_fn = self.make_step()
        device = params_device(params)
        for step in range(start, n_steps):
            t0 = time.monotonic()
            # inside the timed window so "slow" injections hit the watchdog
            if self.injector is not None:
                self.injector.poll(step)
            batch = device_batch(self.pipeline.batch(step), device)
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}  # a host sync
            if self.watchdog is not None:
                self.watchdog.observe(step, time.monotonic() - t0)
            self.history.append((step, metrics))
            if (self.checkpointer is not None and self.checkpoint_every
                    and (step + 1) % self.checkpoint_every == 0):
                self.checkpointer.save(step + 1, params, opt_state)
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return params, opt_state

"""Parity of the port's overload resilience (`repro_torch/serve/slo.py`,
`repro_torch/dist/fault.py`, the scheduler's gates, ladder, park/resume,
chaos hooks and audit) with the JAX reference.

The port's analogs of `tests/test_resilience.py` and of the fault tests of
`tests/test_dist.py` run in this process on the port alone, on a fake
clock through `Observability(clock=...)`. Then the same scenarios run in
both packages in the process where XLA rounds every bf16 op
(tests/torch_parity.py), on an int8 pool: statuses, every `stats()` key
of the port, the rungs the ladder applied round by round, the faults that
fired, the drained occupancy and every token are held equal.
"""
import time
import traceback

import numpy as np
import pytest

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.dist import fault as jfault
from repro.models.model import Model as JModel
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Observability as JObservability
from repro.serve import slo as jslo
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import SpecConfig as JSpecConfig

from repro_torch.dist import fault
from repro_torch.dist.fault import (SERVING_FAULTS, FaultInjector, InjectedFault,
                                    StragglerWatchdog)
from repro_torch.obs import MetricsRegistry, Observability
from repro_torch.serve.engine import GenerationEngine, SpecConfig
from repro_torch.serve.paged_cache import BlockAllocator
from repro_torch.serve.scheduler import STAT_UNITS
from repro_torch.serve.slo import LADDER, RequestStatus, SLAPolicy
from test_torch_prefix import _port_params, _reference_params
from torch_parity import run_exact


class FakeClock:
    """Injectable monotonic clock: advances only when told."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


@pytest.fixture(scope="module")
def port_model():
    return _port_params(_reference_params())


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _engine(port_model, **kw):
    tm, tparams = port_model
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_slots", 2)
    kw.setdefault("decode_chunk", 4)
    return GenerationEngine(tm, tparams, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the taxonomy, the policy and the injector against the reference
# ---------------------------------------------------------------------------

def test_taxonomy_and_ladder_equal_reference():
    assert [(s.name, s.value) for s in RequestStatus] == [
        (s.name, s.value) for s in jslo.RequestStatus]
    assert LADDER == jslo.LADDER
    assert SERVING_FAULTS == jfault.SERVING_FAULTS


def test_slapolicy_validates_and_predicates():
    for bad in (dict(ttft_slo_s=0), dict(itl_slo_s=-1.0), dict(max_queue=0)):
        with pytest.raises(ValueError):
            SLAPolicy(**bad)
    p = SLAPolicy(max_queue=2)
    assert p.queue_full(2) and p.queue_full(3) and not p.queue_full(1)
    none = SLAPolicy()
    assert not none.queue_full(10**6)
    assert not none.ttft_breached(1e9) and not none.itl_breached(1e9, 1)
    assert SLAPolicy(ttft_slo_s=1.0).ttft_breached(0.5, 0.6)
    assert not SLAPolicy(ttft_slo_s=1.0).ttft_breached(0.5, 0.4)
    assert SLAPolicy(itl_slo_s=0.1).itl_breached(0.9, 4)
    assert not SLAPolicy(itl_slo_s=0.1).itl_breached(0.2, 4)
    assert LADDER == ("prefix_evict", "spec_off", "prefill_shrink", "spill", "park")
    assert set(SERVING_FAULTS) == {"slow", "exhaust_pool", "poison_prefill",
                                   "corrupt_tier_page"}


def test_slapolicy_predicates_equal_reference():
    """The three predicates give the reference's answers over a grid of
    objectives and inputs, boundaries included."""
    vals = (None, 0.05, 1.0, 5.0)
    for ttft in vals:
        for itl in vals:
            for mq in (None, 1, 3):
                p, j = (SLAPolicy(ttft, itl, mq), jslo.SLAPolicy(ttft, itl, mq))
                for depth in range(5):
                    assert p.queue_full(depth) == j.queue_full(depth)
                for waited in (0.0, 0.5, 1.0, 4.99, 5.0, 7.0):
                    for pred in (0.0, 0.01, 0.5):
                        assert p.ttft_breached(waited, pred) == j.ttft_breached(waited, pred)
                for chunk_s in (0.0, 0.2, 0.4, 4.0):
                    for steps in (0, 1, 4, 8):
                        assert p.itl_breached(chunk_s, steps) == j.itl_breached(chunk_s, steps)


def test_fault_injector_take_consumes_once():
    inj = FaultInjector({3: "exhaust_pool"})
    assert not inj.take(3, "slow")  # wrong kind: not consumed
    assert inj.take(3, "exhaust_pool")
    assert not inj.take(3, "exhaust_pool")  # at most once per (step, kind)
    assert not inj.take(4, "exhaust_pool")


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("p_fail", [0.05, 0.2, 0.9])
def test_fault_injector_action_for_equals_reference(seed, p_fail):
    plan = {3: "slow", 11: "exhaust_pool", 40: "poison_prefill"}
    got = FaultInjector(plan, seed=seed, p_fail=p_fail)
    want = jfault.FaultInjector(plan, seed=seed, p_fail=p_fail)
    assert [got.action_for(s) for s in range(300)] == [want.action_for(s) for s in range(300)]


def test_fault_injector_seeded_determinism():
    a = FaultInjector(seed=7, p_fail=0.2)
    b = FaultInjector(seed=7, p_fail=0.2)
    actions = [a.action_for(s) for s in range(100)]
    assert actions == [b.action_for(s) for s in range(100)]
    assert any(x == "crash" for x in actions)
    step = next(s for s, x in enumerate(actions) if x == "crash")
    with pytest.raises(InjectedFault):
        a.poll(step)
    a.poll(step)  # second poll: the transient fault already fired


def test_fault_injector_slow_action_hits_watchdog():
    """A planned 'slow' step sleeps instead of crashing, so the straggler
    watchdog catches it."""
    inj = FaultInjector(plan={5: "slow"}, slow_s=0.05)
    w = StragglerWatchdog(factor=3.0)
    for step in range(8):
        t0 = time.monotonic()
        inj.poll(step)  # never raises for 'slow'
        time.sleep(0.003)
        assert w.observe(step, time.monotonic() - t0) == (step == 5)
    assert w.events == [5]


def test_straggler_watchdog_report_equals_reference():
    durations = [0.01, 0.012, 0.009, 0.011, 0.05, 0.01, 0.2, 0.013, 0.01]
    w, j = StragglerWatchdog(factor=2.0), jfault.StragglerWatchdog(factor=2.0)
    assert [w.observe(i, d) for i, d in enumerate(durations)] == [
        j.observe(i, d) for i, d in enumerate(durations)]
    assert w.report() == j.report()
    assert w.report()["n_stragglers"] == 2 and w.report()["events"] == [4, 6]
    assert w.report()["n_steps"] == len(durations)


def test_fault_module_imports_numpy_only():
    import ast
    import inspect

    names = {a.name for node in ast.walk(ast.parse(inspect.getsource(fault)))
             if isinstance(node, ast.Import) for a in node.names}
    assert names == {"time", "numpy"}


# ---------------------------------------------------------------------------
# allocator error paths the resilience layer leans on
# ---------------------------------------------------------------------------

def test_allocator_exhaustion_error_names_admission():
    a = BlockAllocator(1)
    a.alloc()
    with pytest.raises(RuntimeError, match="admission should prevent this"):
        a.alloc()
    assert a.free_count == 0 and a.used_count == 1


def test_allocator_incref_rejects_unallocated_and_foreign_blocks():
    a = BlockAllocator(2)
    b0 = a.alloc()
    a.incref(b0)
    with pytest.raises(ValueError, match="incref on unallocated block"):
        a.incref(b0 + 1)
    with pytest.raises(ValueError, match="incref on unallocated block"):
        a.incref(99)
    assert a.ref_count(b0) == 2
    a.free([b0])
    assert a.free([b0]) == [b0]
    with pytest.raises(ValueError, match="incref on unallocated block"):
        a.incref(b0)
    assert a.free_count == 2


# ---------------------------------------------------------------------------
# bounded queue, statuses, deadlines (the port alone)
# ---------------------------------------------------------------------------

def test_bounded_queue_sheds_at_submit_and_serves_the_rest(port_model):
    vocab = port_model[0].cfg.vocab_size
    prompts = _prompts(vocab, (5, 9, 7, 6))
    obs = Observability(metrics=MetricsRegistry())
    eng = _engine(port_model, max_slots=1, sla=SLAPolicy(max_queue=2), obs=obs)
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    assert eng.statuses[rids[2]] == RequestStatus.SHED
    assert eng.statuses[rids[3]] == RequestStatus.SHED
    res = eng.run_until_drained()
    assert set(res) == set(rids)
    assert eng.statuses[rids[0]] == eng.statuses[rids[1]] == RequestStatus.OK
    assert len(res[rids[2]]) == 0 and len(res[rids[3]]) == 0
    clean_eng = _engine(port_model, max_slots=1)
    for i in range(2):
        rid = clean_eng.submit(prompts[i], max_new_tokens=4)
        np.testing.assert_array_equal(clean_eng.run_until_drained()[rid], res[rids[i]])
    assert obs.metrics.gauge("serve.queue_depth", unit="requests").value == 0
    assert obs.metrics.counter("serve.requests.shed", unit="requests").value == 2
    assert eng.scheduler.stats()["shed_requests"] == 2
    eng.scheduler.check_invariants()


def test_deadline_expires_queued_request(port_model):
    vocab = port_model[0].cfg.vocab_size
    pa, pb, pc = _prompts(vocab, (6, 8, 5))
    clk = FakeClock()
    eng = _engine(port_model, max_slots=1, obs=Observability(clock=clk))
    a = eng.submit(pa, max_new_tokens=6)
    b = eng.submit(pb, max_new_tokens=6, deadline_s=5.0)
    c = eng.submit(pc, max_new_tokens=6, deadline_s=500.0)
    clk.tick(10.0)
    res = eng.run_until_drained()
    assert eng.statuses[b] == RequestStatus.EXPIRED and len(res[b]) == 0
    assert eng.statuses[a] == RequestStatus.OK and len(res[a]) == 6
    assert eng.statuses[c] == RequestStatus.OK and len(res[c]) == 6
    eng.scheduler.check_invariants()
    eng.kv.allocator.alloc()  # an out-of-band page grab is an orphan
    with pytest.raises(RuntimeError, match="orphaned"):
        eng.scheduler.check_invariants()
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(pa, max_new_tokens=2, deadline_s=-1.0)


def test_ttft_gate_sheds_stale_heads(port_model):
    vocab = port_model[0].cfg.vocab_size
    pa, pb, pc = _prompts(vocab, (5, 7, 9))
    clk = FakeClock()
    eng = _engine(port_model, max_slots=1, sla=SLAPolicy(ttft_slo_s=5.0),
                  obs=Observability(clock=clk))
    a = eng.submit(pa, max_new_tokens=4)
    b = eng.submit(pb, max_new_tokens=4)
    c = eng.submit(pc, max_new_tokens=4)
    eng.scheduler.step()
    clk.tick(10.0)
    res = eng.run_until_drained()
    assert eng.statuses[a] == RequestStatus.OK and len(res[a]) == 4
    for rid in (b, c):
        assert eng.statuses[rid] == RequestStatus.SHED and len(res[rid]) == 0
    assert eng.scheduler.stats()["shed_requests"] == 2
    eng.scheduler.check_invariants()


# ---------------------------------------------------------------------------
# park / resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_park_resume_outputs_bit_identical(port_model, temperature):
    """A low-priority resident parked for a high-priority arrival resumes
    and finishes with the tokens of an unpressured run, greedy and at a
    temperature (the keys ride the global output index)."""
    vocab = port_model[0].cfg.vocab_size
    pa, pb = _prompts(vocab, (17, 33))
    kw = dict(max_slots=2, num_blocks=8, prefix_cache=True,
              temperature=temperature, sla=SLAPolicy(max_queue=8))
    eng = _engine(port_model, **kw)
    a = eng.submit(pa, max_new_tokens=16, priority=0)
    eng.scheduler.step()
    b = eng.submit(pb, max_new_tokens=16, priority=1)
    res = eng.run_until_drained()
    st = eng.scheduler.stats()
    assert st["parked_requests"] >= 1 and st["resumed_requests"] >= 1
    assert st["degradations"] >= 1
    assert eng.scheduler.degradation_level == 0
    assert eng.statuses[a] == eng.statuses[b] == RequestStatus.OK
    assert len(res[a]) == 16 and len(res[b]) == 16
    # the resume hit the pages park indexed: it recomputed the tail only
    assert st["prefix_hit_tokens"] > 0
    eng.scheduler.check_invariants()

    solo = _engine(port_model, **kw)
    sa = solo.submit(pa, max_new_tokens=16, priority=0)
    np.testing.assert_array_equal(solo.run_until_drained()[sa], res[a])
    sb_eng = _engine(port_model, **kw)
    sb_eng.submit(np.asarray([1], np.int32), max_new_tokens=1)  # burn rid 0
    sb = sb_eng.submit(pb, max_new_tokens=16, priority=1)
    np.testing.assert_array_equal(sb_eng.run_until_drained()[sb], res[b])


def test_parked_request_expiring_keeps_partial_output(port_model):
    vocab = port_model[0].cfg.vocab_size
    pa, pb = _prompts(vocab, (17, 33))
    clk = FakeClock()
    eng = _engine(port_model, max_slots=2, num_blocks=8, sla=SLAPolicy(max_queue=8),
                  obs=Observability(clock=clk))
    a = eng.submit(pa, max_new_tokens=16, priority=0, deadline_s=50.0)
    eng.scheduler.step()
    n_before = len(eng.scheduler.slots[0].out)
    assert n_before >= 1
    b = eng.submit(pb, max_new_tokens=16, priority=1)
    eng.scheduler.step()  # pool pressure parks a (the ladder's last rung)
    assert eng.scheduler.stats()["parked_requests"] == 1
    clk.tick(100.0)
    res = eng.run_until_drained()
    assert eng.statuses[a] == RequestStatus.PREEMPTED
    assert len(res[a]) >= n_before
    assert eng.statuses[b] == RequestStatus.OK and len(res[b]) == 16
    assert eng.scheduler.stats()["preempted_requests"] == 1
    eng.scheduler.check_invariants()


# ---------------------------------------------------------------------------
# the RoofLens ITL gate
# ---------------------------------------------------------------------------

def test_itl_gate_defers_admission_but_never_deadlocks(port_model):
    vocab = port_model[0].cfg.vocab_size
    prompts = _prompts(vocab, (5, 7, 6))
    eng = _engine(port_model, max_slots=2, obs=Observability.default(),
                  sla=SLAPolicy(itl_slo_s=1e-12))
    lens = (16, 6, 6)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, lens)]
    res = eng.run_until_drained()
    assert eng.scheduler.stats()["itl_deferrals"] >= 1
    for rid, n in zip(rids, lens):
        assert eng.statuses[rid] == RequestStatus.OK and len(res[rid]) == n
    eng2 = _engine(port_model, max_slots=2, obs=Observability.default(),
                   sla=SLAPolicy(itl_slo_s=1e6))
    for p, n in zip(prompts, lens):
        eng2.submit(p, max_new_tokens=n)
    eng2.run_until_drained()
    assert eng2.scheduler.stats()["itl_deferrals"] == 0


# ---------------------------------------------------------------------------
# the serving chaos harness
# ---------------------------------------------------------------------------

def test_chaos_fails_only_poisoned_request_survivors_bit_identical(port_model):
    vocab = port_model[0].cfg.vocab_size
    prompts = _prompts(vocab, (10, 9, 7, 5, 8))
    plan = {0: "poison_prefill", 2: "exhaust_pool", 4: "slow"}
    inj = FaultInjector(plan, slow_s=0.01)
    wd = StragglerWatchdog()
    eng = _engine(port_model, max_slots=2, prefix_cache=True, injector=inj, watchdog=wd)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    res = eng.run_until_drained()
    assert eng.statuses[rids[0]] == RequestStatus.FAILED
    assert len(res[rids[0]]) == 0
    assert eng.scheduler.stats()["failed_requests"] == 1
    assert eng.kv.prefix.lookup(prompts[0]) == []
    assert {(s, k) for s, k in inj.fired} == set(plan.items())
    assert wd.report()["n_steps"] >= 5
    eng.scheduler.check_invariants()

    clean = _engine(port_model, max_slots=2, prefix_cache=True)
    crids = [clean.submit(p, max_new_tokens=6) for p in prompts]
    cres = clean.run_until_drained()
    for i in range(1, len(prompts)):
        assert clean.statuses[crids[i]] == RequestStatus.OK
        np.testing.assert_array_equal(cres[crids[i]], res[rids[i]])


def test_exhaust_pool_round_is_transient_and_conserving(port_model):
    vocab = port_model[0].cfg.vocab_size
    prompts = _prompts(vocab, (6, 7, 8))
    inj = FaultInjector({1: "exhaust_pool", 2: "exhaust_pool"})
    eng = _engine(port_model, max_slots=1, injector=inj)
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    res = eng.run_until_drained()
    for rid in rids:
        assert eng.statuses[rid] == RequestStatus.OK and len(res[rid]) == 5
    occ = eng.scheduler.check_invariants()
    assert occ["used"] == 0 and occ["free"] == eng.kv.num_blocks


def test_nonfinite_guard_off_without_resilience(port_model):
    eng = _engine(port_model)
    assert not eng.scheduler._guard_nonfinite
    eng2 = _engine(port_model, sla=SLAPolicy(max_queue=4))
    assert eng2.scheduler._guard_nonfinite


def test_guarded_prefill_samples_once_and_flags_on_the_same_copy(port_model):
    """A guarded prefill calls the sampler once, which returns the tokens
    and the per-row finite flags together; the tokens are the unguarded
    ones."""
    vocab = port_model[0].cfg.vocab_size
    prompts = _prompts(vocab, (9, 12, 5))
    got = {}
    for name, kw in (("plain", {}), ("guarded", dict(sla=SLAPolicy(max_queue=8)))):
        eng = _engine(port_model, **kw)
        calls, inner = [], eng.scheduler._sample

        def sample(*a, _inner=inner, _calls=calls, **k):
            out = _inner(*a, **k)
            _calls.append(k.get("guard", False))
            return out

        eng.scheduler._sample = sample
        rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
        done = eng.run_until_drained()
        got[name] = ([done[r].tolist() for r in rids], calls,
                     eng.scheduler.stats()["host_syncs"])
    assert got["plain"][0] == got["guarded"][0]
    assert got["plain"][2] == got["guarded"][2]
    assert got["guarded"][1] == [True] * len(got["plain"][1])
    assert not any(got["plain"][1])


# ---------------------------------------------------------------------------
# both packages on the same scenarios, exact-rounding process
# ---------------------------------------------------------------------------

KV = "int8"
SCENARIOS = ("shed", "expire", "ttft", "park/0.0", "park/0.7", "preempt", "itl",
             "chaos", "chaos_tier", "ladder")


class _Pkg:
    """One package's entry points, so a scenario is written once."""

    def __init__(self, port: bool, model, params):
        self.port, self.model, self.params = port, model, params
        if port:
            self.SLAPolicy, self.FaultInjector = SLAPolicy, FaultInjector
            self.StragglerWatchdog, self.SpecConfig = StragglerWatchdog, SpecConfig
            self.Observability, self.MetricsRegistry = Observability, MetricsRegistry
        else:
            self.SLAPolicy, self.FaultInjector = jslo.SLAPolicy, jfault.FaultInjector
            self.StragglerWatchdog, self.SpecConfig = jfault.StragglerWatchdog, JSpecConfig
            self.Observability, self.MetricsRegistry = JObservability, JMetricsRegistry

    def engine(self, **kw):
        for k, v in (("max_len", 64), ("block_size", 8), ("max_slots", 2),
                     ("decode_chunk", 4), ("kv_quant", KV)):
            kw.setdefault(k, v)
        if self.port:
            eng = GenerationEngine(self.model, self.params, device="cpu", **kw)
        else:
            eng = JEngine(self.model, self.params, paged=True, **kw)
        rungs, sched = [], eng.scheduler
        inner = sched._degrade

        def degrade():
            lvl, n = sched.degradation_level, sched._stats["degradations"]
            inner()
            rungs.append((sched._round, lvl, sched.degradation_level,
                          sched._stats["degradations"] - n))

        sched._degrade = degrade
        eng.rungs = rungs
        return eng


def _observe(eng, rids, res, inj=None):
    st = eng.scheduler.stats()
    return {
        "tokens": {int(r): [int(t) for t in res[r]] for r in rids},
        "statuses": {int(r): s.value for r, s in eng.statuses.items()},
        "stats": {k: st[k] for k in STAT_UNITS},
        "rungs": eng.rungs,
        "fired": sorted(map(list, inj.fired)) if inj is not None else [],
        "occupancy": eng.scheduler.check_invariants(),
        "level": eng.scheduler.degradation_level,
    }


def _ladder_traffic(vocab):
    """A 24-token system prompt, two tenants behind it (wave 0); two
    residents at priority 0; two priority-1 arrivals that need most of the
    pool; last, a tenant behind the system prompt again."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, 24).tolist()
    wave0 = [np.asarray(system + rng.integers(0, vocab, n).tolist(), np.int32)
             for n in (3, 6)]
    residents = _prompts(vocab, (8, 10), seed=12)
    arrivals = _prompts(vocab, (30, 27), seed=13)
    wave2 = np.asarray(system + rng.integers(0, vocab, 5).tolist(), np.int32)
    return wave0, residents, arrivals, wave2


def _run_scenario(pkg: _Pkg, name: str):
    vocab = pkg.model.cfg.vocab_size
    if name == "shed":
        prompts = _prompts(vocab, (5, 9, 7, 6))
        eng = pkg.engine(max_slots=1, sla=pkg.SLAPolicy(max_queue=2),
                         obs=pkg.Observability(metrics=pkg.MetricsRegistry()))
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        return _observe(eng, rids, eng.run_until_drained())
    if name == "expire":
        pa, pb, pc = _prompts(vocab, (6, 8, 5))
        clk = FakeClock()
        eng = pkg.engine(max_slots=1, obs=pkg.Observability(clock=clk))
        rids = [eng.submit(pa, max_new_tokens=6),
                eng.submit(pb, max_new_tokens=6, deadline_s=5.0),
                eng.submit(pc, max_new_tokens=6, deadline_s=500.0)]
        clk.tick(10.0)
        return _observe(eng, rids, eng.run_until_drained())
    if name == "ttft":
        clk = FakeClock()
        eng = pkg.engine(max_slots=1, sla=pkg.SLAPolicy(ttft_slo_s=5.0),
                         obs=pkg.Observability(clock=clk))
        rids = [eng.submit(p, max_new_tokens=4) for p in _prompts(vocab, (5, 7, 9))]
        eng.scheduler.step()
        clk.tick(10.0)
        return _observe(eng, rids, eng.run_until_drained())
    if name.startswith("park/"):
        pa, pb = _prompts(vocab, (17, 33))
        eng = pkg.engine(num_blocks=8, prefix_cache=True, temperature=float(name[5:]),
                         sla=pkg.SLAPolicy(max_queue=8))
        a = eng.submit(pa, max_new_tokens=16, priority=0)
        eng.scheduler.step()
        b = eng.submit(pb, max_new_tokens=16, priority=1)
        return _observe(eng, [a, b], eng.run_until_drained())
    if name == "preempt":
        pa, pb = _prompts(vocab, (17, 33))
        clk = FakeClock()
        eng = pkg.engine(num_blocks=8, sla=pkg.SLAPolicy(max_queue=8),
                         obs=pkg.Observability(clock=clk))
        a = eng.submit(pa, max_new_tokens=16, priority=0, deadline_s=50.0)
        eng.scheduler.step()
        b = eng.submit(pb, max_new_tokens=16, priority=1)
        eng.scheduler.step()
        clk.tick(100.0)
        return _observe(eng, [a, b], eng.run_until_drained())
    if name == "itl":
        eng = pkg.engine(obs=pkg.Observability.default(),
                         sla=pkg.SLAPolicy(itl_slo_s=1e-12))
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(_prompts(vocab, (5, 7, 6)), (16, 6, 6))]
        return _observe(eng, rids, eng.run_until_drained())
    if name == "chaos":
        plan = {0: "poison_prefill", 2: "exhaust_pool", 4: "slow"}
        inj = pkg.FaultInjector(plan, slow_s=0.01)
        eng = pkg.engine(prefix_cache=True, injector=inj,
                         watchdog=pkg.StragglerWatchdog())
        rids = [eng.submit(p, max_new_tokens=6) for p in _prompts(vocab, (10, 9, 7, 5, 8))]
        return _observe(eng, rids, eng.run_until_drained(), inj)
    if name == "chaos_tier":
        pa, pb = _prompts(vocab, (17, 33))
        inj = pkg.FaultInjector()
        eng = pkg.engine(prefix_cache=True, host_tier=True, injector=inj)
        rids = [eng.submit(pa, max_new_tokens=6), eng.submit(pb, max_new_tokens=6)]
        res = eng.run_until_drained()
        eng.kv.spill_all()
        inj.plan[eng.scheduler._round] = "corrupt_tier_page"
        rids += [eng.submit(pa, max_new_tokens=6), eng.submit(pb, max_new_tokens=6)]
        res.update(eng.run_until_drained())
        return _observe(eng, rids, res, inj)
    if name == "ladder":
        wave0, residents, arrivals, wave2 = _ladder_traffic(vocab)
        eng = pkg.engine(max_slots=3, num_blocks=LADDER_PAGES, prefix_cache=True,
                         prefill_chunk=16,
                         host_tier=True, sla=pkg.SLAPolicy(max_queue=16),
                         spec_decode=pkg.SpecConfig(k=3, draft_codec="nf4"))
        rids = [eng.submit(p, max_new_tokens=4) for p in wave0]
        res = eng.run_until_drained()
        rids += [eng.submit(p, max_new_tokens=40, priority=0) for p in residents]
        sched = eng.scheduler
        while sched._stats["decode_chunks"] == 0:
            sched.step()
        rids += [eng.submit(p, max_new_tokens=12, priority=1) for p in arrivals]
        rids.append(eng.submit(wave2, max_new_tokens=4, priority=1))
        res.update(eng.run_until_drained())
        out = _observe(eng, rids, res)
        out["spec_on"] = sched._spec_enabled
        return out
    raise KeyError(name)


#: the ladder scenario's pool: tight enough that the arrivals climb every
#: rung down to park
LADDER_PAGES = 14


def _differs(want: dict, got: dict) -> str:
    for key in want:
        if key == "rungs":
            same = [tuple(x) for x in want[key]] == [tuple(x) for x in got[key]]
        else:
            same = want[key] == got[key]
        if not same:
            return f"{key}: port {got[key]} != reference {want[key]}"
    return ""


def resilience_report(names):
    """{scenario: "ok" or what differed, plus "<scenario>/port": the
    port's observations}; run in the exact-rounding process."""
    jm = JModel(jget_smoke_config("llama3-8b"))
    jparams = _reference_params()
    tm, tparams = _port_params(jparams)
    ref, port = _Pkg(False, jm, jparams), _Pkg(True, tm, tparams)
    out = {}
    for name in names:
        try:
            want, got = _run_scenario(ref, name), _run_scenario(port, name)
            got["rungs"] = [list(x) for x in got["rungs"]]
            want["rungs"] = [list(x) for x in want["rungs"]]
            out[name] = _differs(want, got) or "ok"
            out[f"{name}/port"] = {k: got[k] for k in ("statuses", "rungs", "fired",
                                                      "level", "occupancy", "stats",
                                                      "tokens")}
            out[f"{name}/port"]["spec_on"] = got.get("spec_on")
        except Exception:  # report it: one scenario's error fails only its test
            out[name] = traceback.format_exc()[-3000:]
    return out


@pytest.fixture(scope="module")
def exact_resilience():
    return run_exact("test_torch_resilience", "resilience_report", list(SCENARIOS),
                     timeout=900)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_reference(exact_resilience, name):
    """The same traffic through both packages: statuses, every stat, the
    ladder's rungs round by round, the faults fired, the drained
    occupancy and every token agree."""
    assert exact_resilience[name] == "ok", exact_resilience[name]


def test_ladder_reaches_park_and_relaxes(exact_resilience):
    """The ladder scenario applies prefix_evict, spec_off, prefill_shrink
    and park in that order (spill where it finds pages), parks and resumes
    a resident, spills and restores tier pages, ends every request OK and
    drains back to rung 0 with spec rounds on."""
    port = exact_resilience["ladder/port"]
    applied = [LADDER[lvl - 1] for _, _, lvl, n in port["rungs"] if n]
    firsts = [r for i, r in enumerate(applied) if r not in applied[:i]]
    assert [r for r in firsts if r != "spill"] == ["prefix_evict", "spec_off",
                                                   "prefill_shrink", "park"], applied
    st = port["stats"]
    assert st["parked_requests"] >= 1 and st["resumed_requests"] >= 1
    assert st["tier_spilled_pages"] > 0 and st["tier_restored_pages"] > 0
    assert set(port["statuses"].values()) == {"ok"}
    assert port["level"] == 0 and port["spec_on"]


def test_chaos_tier_recomputes_only_the_corrupted_chain(exact_resilience):
    port = exact_resilience["chaos_tier/port"]
    st = port["stats"]
    assert [k for _, k in port["fired"]] == ["corrupt_tier_page"]
    assert st["tier_corrupt"] == 1 and st["tier_fallback_recompute"] == 1
    assert st["tier_restored_pages"] >= 2
    toks = list(port["tokens"].values())
    assert toks[2] == toks[0] and toks[3] == toks[1]

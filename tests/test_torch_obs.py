"""Parity of the port's observability layer (`repro_torch/obs/`) with the
JAX package's (`repro/obs/`), and the port's analogs of the reference's
engine-level observability tests (`tests/test_obs.py`,
`tests/test_spec_decode.py`).

The collectors are host-side Python. The same seeded stream of records,
spans and observations through both packages gives equal snapshots,
percentiles, Chrome-trace JSON, predictions, calibrations and error
reports; they are compared exactly (`==`): the arithmetic is the same
float operations in the same order. The engines then serve the
reference's 8-prompt mix on a clock that advances a fixed step per read,
and their counters, tracer spans and RoofLens samples are held equal.
"""
import dataclasses
import io
import json
import math
import traceback
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import roofsurface as jrs
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models.model import Model as JModel
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Observability as JObservability
from repro.obs import RoofLens as JRoofLens
from repro.obs import Tracer as JTracer
from repro.obs.metrics import Histogram as JHistogram
from repro.obs.metrics import exact_percentiles as jexact_percentiles
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import SpecConfig as JSpecConfig
from repro.serve.slo import SLAPolicy as JSLAPolicy

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import roofsurface as rs
from repro_torch.core.formats import get_spec
from repro_torch.models.model import Model
from repro_torch.obs import MetricsRegistry, Observability, RoofLens, Tracer
from repro_torch.obs.metrics import Histogram, exact_percentiles
from repro_torch.serve.engine import GenerationEngine, SpecConfig
from repro_torch.serve.scheduler import STAT_UNITS
from repro_torch.serve.slo import SLAPolicy
from test_torch_prefix import _shared_prompts
from torch_parity import run_exact

KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")


class FakeClock:
    """Injectable monotonic clock: advances only when told."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


class StepClock:
    """A clock that advances one second per read: every timestamp is the
    count of reads so far, exact in float arithmetic."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _json(x) -> str:
    return json.dumps(x, sort_keys=True)


def _profiles():
    """(port, reference) profile pairs with the same fields: the H100 and
    the reference's TPU-v5e."""
    return [
        (rs.H100_SXM, jrs.HardwareProfile(**dataclasses.asdict(rs.H100_SXM))),
        (rs.HardwareProfile(**dataclasses.asdict(jrs.TPU_V5E)), jrs.TPU_V5E),
    ]


# ---------------------------------------------------------------------------
# metrics: the same seeded stream through both registries
# ---------------------------------------------------------------------------

def _metrics_stream(reg, clock, seed):
    rng = np.random.default_rng(seed)
    for i in range(400):
        op = int(rng.integers(0, 5))
        name = f"t.m{int(rng.integers(0, 6))}"
        if op == 0:
            reg.counter(name + ".c", unit="tokens").inc(int(rng.integers(0, 9)))
        elif op == 1:
            reg.gauge(name + ".g", unit="pages").set(float(rng.normal()))
        elif op == 2:
            v = 0.0 if rng.random() < 0.1 else float(np.exp(rng.uniform(-12, 6)))
            reg.histogram(name + ".h", unit="s").record(v)
        elif op == 3:
            reg.histogram(name + ".h2", unit="s", ratio=1.1).record(float(rng.random()))
        else:
            with reg.timer(name + ".t"):
                clock.tick(float(rng.random()))
    reg.ingest("pre", {"a": 1.5, "b": 7}, units={"a": "pages"})
    reg.histogram("t.empty", unit="s")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_registry_matches_reference(seed):
    got = _metrics_stream(MetricsRegistry(clock=(pc := FakeClock())), pc, seed)
    want = _metrics_stream(JMetricsRegistry(clock=(jc := FakeClock())), jc, seed)
    assert _json(got.snapshot()) == _json(want.snapshot())
    for name, m in got._metrics.items():
        if isinstance(m, Histogram):
            jm = want._metrics[name]
            for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
                a, b = m.quantile(q), jm.quantile(q)
                assert a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("n", [0, 1, 7, 100, 513])
def test_exact_percentiles_match_reference(n):
    rng = np.random.default_rng(n)
    samples = rng.exponential(size=n).tolist()
    qs = (0.1, 0.5, 0.9, 0.99, 1.0)
    assert _json(exact_percentiles(samples, qs)) == _json(jexact_percentiles(samples, qs))
    assert _json(exact_percentiles(samples)) == _json(jexact_percentiles(samples))


def test_metrics_errors_match_reference():
    for H, R in ((Histogram, MetricsRegistry), (JHistogram, JMetricsRegistry)):
        h = H("t.h")
        assert math.isnan(h.quantile(0.5)) and math.isnan(h.mean)
        h.record(0.125)
        assert all(h.quantile(q) == 0.125 for q in (0.0, 0.5, 1.0))
        for bad in (lambda: h.record(-1.0), lambda: h.record(math.nan),
                    lambda: h.quantile(1.5), lambda: H("t.bad", ratio=1.0)):
            with pytest.raises(ValueError):
                bad()
        reg = R()
        c = reg.counter("t.x", unit="tokens")
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            reg.gauge("t.x", unit="tokens")
        with pytest.raises(ValueError):
            reg.counter("t.x", unit="pages")
        assert reg.counter("t.x", unit="tokens") is c
        reg.ingest("pre", {"a": 1.0}, units={"a": "pages"})
        snap = reg.snapshot()
        snap["pre.a"]["value"] = 999  # the snapshot is a copy
        assert reg.gauge("pre.a", unit="pages").value == 1.0


# ---------------------------------------------------------------------------
# tracer: the same seeded lifecycle stream through both tracers
# ---------------------------------------------------------------------------

def _tracer_stream(tr, clock, seed):
    rng = np.random.default_rng(seed)
    queue, live, nxt = [], [], 0
    for _ in range(60):
        clock.tick(float(rng.random()))
        if rng.random() < 0.4 or not (queue or live):
            tr.on_submit(nxt, int(rng.integers(1, 99)), int(rng.integers(1, 9)))
            queue.append(nxt)
            nxt += 1
        if queue and rng.random() < 0.5:
            t0 = clock()
            admitted = queue[: int(rng.integers(1, len(queue) + 1))]
            del queue[: len(admitted)]
            for slot, rid in enumerate(admitted):
                tr.on_admit(rid, slot)
            tr.on_admit_round(t0, clock.tick(0.01), len(admitted), len(queue))
            t0 = clock()
            tr.on_prefill(t0, clock.tick(float(rng.random())), admitted,
                          int(rng.integers(1, 5)), int(rng.integers(8, 64)))
            live += admitted
        if live:
            t0 = clock()
            kept = {rid: int(rng.integers(0, 5)) for rid in live}
            tr.on_decode_chunk(t0, clock.tick(float(rng.random())), 4, kept)
            for rid in list(live):
                if rng.random() < 0.3:
                    tr.on_finish(rid, "eos" if rng.random() < 0.5 else "length")
                    live.remove(rid)
    return tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracer_matches_reference(seed):
    got = _tracer_stream(Tracer(clock=(pc := FakeClock())), pc, seed)
    want = _tracer_stream(JTracer(clock=(jc := FakeClock())), jc, seed)
    assert _json(got.summary()) == _json(want.summary())
    assert [dataclasses.asdict(r) for r in got.requests.values()] == [
        dataclasses.asdict(r) for r in want.requests.values()]
    a, b = io.StringIO(), io.StringIO()
    got.export_chrome_trace(a)
    want.export_chrome_trace(b)
    assert a.getvalue() == b.getvalue()
    got.reset()
    assert got.requests == {} and got.spans == []


def test_tracer_fake_clock_ttft_itl():
    """One request through submit/admit/prefill/2 decode chunks/finish."""
    clk = FakeClock(t=10.0)
    tr = Tracer(clock=clk)
    tr.on_submit(0, prompt_len=8, max_new_tokens=5)
    clk.tick(0.5)
    tr.on_admit(0, slot=1)
    tr.on_admit_round(10.0, 10.5, 1, 0)
    clk.tick(0.5)
    tr.on_prefill(10.5, 11.0, [0], batch_rows=1, span_tokens=8)
    tr.on_decode_chunk(11.0, 11.25, steps=2, kept={0: 2})
    tr.on_decode_chunk(11.25, 11.5, steps=2, kept={0: 2})
    clk.tick(1.0)
    tr.on_finish(0, "length")
    r = tr.requests[0]
    assert r.token_times == [11.0, 11.25, 11.25, 11.5, 11.5]
    assert r.ttft == pytest.approx(1.0) and r.queue_wait == pytest.approx(0.5)
    s = tr.summary()
    assert s["itl_s"]["p50"] == 0.0 and s["itl_s"]["p99"] == pytest.approx(0.25)
    evs = tr.chrome_trace_events()
    assert [e["name"] for e in evs].count("token") == 4
    pre = next(e for e in evs if e["name"] == "prefill")
    assert pre["ts"] == pytest.approx(0.5e6) and pre["dur"] == pytest.approx(0.5e6)


# ---------------------------------------------------------------------------
# RoofLens: bound alike, predictions and the calibration loop equal
# ---------------------------------------------------------------------------

def _bind_args(full: bool, kv: str, spec: bool):
    cfg, jcfg = ((get_config("llama3-8b"), jget_config("llama3-8b")) if full else
                 (get_smoke_config("llama3-8b"), jget_smoke_config("llama3-8b")))
    kw = dict(weight_bytes=5_742_000_000 if full else 124_672, kv_quant=kv, m_slots=4,
              weight_spec="bf8_50", weight_elems=7_500_000_000 if full else 118_784)
    if spec:
        kw.update(draft_weight_bytes=kw["weight_bytes"] // 3, spec_k=3, draft_window=48)
    return cfg, jcfg, kw


def _lens_stream(lens, seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        kv = [float(x) for x in rng.integers(1, 2048, int(rng.integers(1, 5)))]
        f = float(np.exp(rng.normal(2.0, 0.5)))
        lens.observe_prefill(int(rng.integers(1, 5)), 32 * int(rng.integers(1, 33)),
                             f * 1e-3)
        lens.observe_prefill_chunk(1, 256, float(rng.integers(256, 2048)), f * 2e-3)
        lens.observe_decode(kv, 8, f * 1e-2)
        lens.observe_spec(kv, 3, int(rng.integers(1, 3)), f * 3e-2)
        lens.observe_tier_restore(int(rng.integers(1, 9)), 65536.0, f * 1e-4)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("kv", KV_KINDS)
def test_rooflens_matches_reference(full, kv):
    for spec in (False, True):
        cfg, jcfg, kw = _bind_args(full, kv, spec)
        for port_p, ref_p in _profiles():
            got = RoofLens(port_p, registry=MetricsRegistry())
            want = JRoofLens(ref_p, registry=JMetricsRegistry())
            got.bind(cfg=cfg, **kw)
            want.bind(cfg=jcfg, **kw)
            assert got.codec_key == want.codec_key
            assert got._w_vops == want._w_vops
            assert got._linear_flops_per_token == want._linear_flops_per_token
            for rows, span, table in ((1, 32, 64), (4, 512, 512), (1, 256, 1536)):
                assert got.predict_prefill(rows, span) == want.predict_prefill(rows, span)
                assert got.predict_prefill_chunk(rows, span, table) == (
                    want.predict_prefill_chunk(rows, span, table))
            for kv_lens in ([8.0], [600.0, 700.0, 800.0, 900.0], [1.0, 2047.0]):
                for steps in (1, 8):
                    assert got.predict_decode(kv_lens, steps) == want.predict_decode(
                        kv_lens, steps)
                    assert got.predict_decode_chunk(kv_lens, steps) == (
                        want.predict_decode_chunk(kv_lens, steps))
                for k, rounds in ((3, 1), (3, 2), (1, 4)):
                    assert got.predict_draft(kv_lens, k, rounds) == want.predict_draft(
                        kv_lens, k, rounds)
                    assert got.predict_verify(kv_lens, k, rounds) == want.predict_verify(
                        kv_lens, k, rounds)
            assert got.predict_tier_restore(7, 65536.0) == want.predict_tier_restore(
                7, 65536.0)
            _lens_stream(got, 3)
            _lens_stream(want, 3)
            assert got.calibrate() == want.calibrate()
            assert _json(got.error_report()) == _json(want.error_report())
            assert _json(got.registry.snapshot()) == _json(want.registry.snapshot())
            got.reset_samples()
            want.reset_samples()
            _lens_stream(got, 4)
            _lens_stream(want, 4)
            assert _json(got.error_report()) == _json(want.error_report())
            assert got.predict_decode([900.0], 8) == want.predict_decode([900.0], 8)


def test_rooflens_perfect_proxy_calibrates_to_unity():
    lens = RoofLens()
    lens.bind(cfg=get_smoke_config("llama3-8b"), weight_bytes=10 ** 6, kv_quant=None,
              m_slots=2)
    assert lens.profile is rs.H100_SXM
    comps = [([8.0], 4), ([16.0, 24.0], 4), ([40.0], 2), ([4.0, 4.0], 8)]
    for kv_lens, steps in comps:
        lens.observe_decode(kv_lens, steps, 1234.0 * lens._raw_decode(kv_lens, steps))
    lens.observe_prefill(2, 16, 987.0 * lens._raw_prefill(2, 16))
    scale = lens.calibrate()
    assert scale["decode"] == pytest.approx(1234.0)
    assert scale["prefill"] == pytest.approx(987.0)
    rep = lens.error_report()
    assert rep["decode"]["n"] == len(comps)
    assert rep["decode"]["geomean_ratio"] == pytest.approx(1.0)
    assert "decode[w=dense,kv=none]" in rep
    assert lens._raw_prefill(4, 32) > lens._raw_prefill(1, 32)
    assert lens._raw_decode([64.0], 4) > lens._raw_decode([8.0], 4)
    with pytest.raises(RuntimeError, match="not bound"):
        RoofLens().predict_decode([8.0], 1)


# ---------------------------------------------------------------------------
# the engine's binding: the reference's traffic shape for the same params
# ---------------------------------------------------------------------------

ENGINE = dict(max_len=64, block_size=8, max_slots=2, num_blocks=24, decode_chunk=4)
NEW = 4


def _layout(stacked: bool):
    jcfg = dataclasses.replace(jget_smoke_config("llama3-8b"), scan_layers=stacked)
    jm = JModel(jcfg)
    jparams = jcompress_tree(jm.init(jax.random.PRNGKey(0)), jget_spec("bf8_50"))
    cfg = get_smoke_config("llama3-8b")
    return jm, jparams, Model(cfg), params_from_jax(jax.device_get(jparams), cfg, device="cpu")


@pytest.fixture(scope="module")
def layouts():
    """The reference's smoke llama compressed to bf8_50, its layers
    unstacked (`scan_layers=False`) and stacked, each with the port's model
    on the same params. The reference's `_bind_rooflens` counts the dense
    elements of a compressed leaf by its `shape`, which for a stacked leaf
    is one layer's slice; unstacked, both packages count every layer. The
    port's draft tree follows the stacked layout's compression floor (a
    (2, 64, 32) stack of k/v weights is compressed, one (64, 32) layer is
    not), so the spec engine is held against the stacked reference."""
    return {False: _layout(False), True: _layout(True)}


def _lens_fields(lens) -> dict:
    return {k: getattr(lens, k) for k in (
        "weight_bytes", "weight_elems", "kv_quant", "weight_spec", "m_slots", "n_chips",
        "draft_weight_bytes", "spec_k", "draft_window", "codec_key", "_w_vops",
        "_linear_flops_per_token")}


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_bind_rooflens_matches_reference(layouts, spec):
    jm, jparams, tm, tparams = layouts[spec]
    kw = dict(ENGINE, kv_quant="int8")
    jspec = JSpecConfig(k=3, draft_codec="nf4", draft_window=16) if spec else None
    tspec = SpecConfig(k=3, draft_codec="nf4", draft_window=16) if spec else None
    jeng = JEngine(jm, jparams, paged=True, obs=JObservability.default(),
                   spec_decode=jspec, **kw)
    teng = GenerationEngine(tm, tparams, device="cpu", obs=Observability.default(),
                            spec_decode=tspec, **kw)
    got, want = _lens_fields(teng.obs.rooflens), _lens_fields(jeng.obs.rooflens)
    if spec:  # stacked: see test_bind_rooflens_counts_every_layer_of_a_stacked_reference
        for k in ("weight_elems", "_w_vops"):
            got.pop(k), want.pop(k)
    assert got == want


def test_bind_rooflens_counts_every_layer_of_a_stacked_reference(layouts):
    """The reference's stacked (scan) tree: the stored bytes agree; the
    port counts the dense elements of every layer, where the reference's
    bind counts one slice of each stacked leaf."""
    jm, jparams, tm, tparams = layouts[True]
    cfg = tm.cfg
    jeng = JEngine(jm, jparams, paged=True, obs=JObservability.default(), **ENGINE)
    teng = GenerationEngine(tm, tparams, device="cpu", obs=Observability.default(),
                            **ENGINE)
    got, want = teng.obs.rooflens, jeng.obs.rooflens
    assert got.weight_bytes == want.weight_bytes
    layer = sum(math.prod(ct.shape) for ct in tparams["layers"][0]["attn"].values()) + sum(
        math.prod(ct.shape) for ct in tparams["layers"][0]["mlp"].values())
    lm_head = math.prod(tparams["lm_head"].shape)
    assert want.weight_elems == layer + lm_head
    assert got.weight_elems == cfg.n_layers * layer + lm_head


# ---------------------------------------------------------------------------
# both engines on the reference's 8-prompt mix, on a clock of fixed steps
# ---------------------------------------------------------------------------

def _serve_observed(eng, prompts):
    rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    done = eng.run_until_drained()
    eng.scheduler.stats()  # folds the stats into the registry
    return [done[r].tolist() for r in rids]


#: Metrics only the reference publishes: none since the port's window
#: freeing publishes `window_freed_pages`.
REF_ONLY = set()

SERVES = {
    "plain": (dict(kv_quant="int8"), {}),
    "prefix_chunked_sla": (dict(kv_quant="nf4", prefix_cache=True, prefill_chunk=16,
                                prefill_sla_s="mid"), {}),
    "spec": (dict(kv_quant="none"), dict(k=3, draft_codec="nf4")),
    # a bounded queue sheds one submit, the TTFT gate two heads; a 6-page
    # pool spills index pages to the host tier and restores two of them
    "sla_tier": (dict(kv_quant="int8", prefix_cache=True, host_tier=True, num_blocks=6,
                      sla=dict(max_queue=7, ttft_slo_s=45.0)), {}),
}


def _check_observed_serve(layouts, case):
    """Serve `case` in both packages, each on a `StepClock`, and assert
    that the metrics, the tracer and the RoofLens samples agree."""
    kw, spec = SERVES[case]
    jm, jparams, tm, tparams = layouts[bool(spec)]
    kw = dict(ENGINE, **kw)
    prompts = _shared_prompts(tm.cfg.vocab_size)
    jobs = JObservability.default(clock=StepClock(),
                                  profile=jrs.HardwareProfile(**dataclasses.asdict(rs.H100_SXM)))
    tobs = Observability.default(clock=StepClock(), profile=rs.H100_SXM)
    if kw.get("prefill_sla_s") == "mid":
        # a budget between the raw predictions of a one-page and a
        # two-page chunk: the cap picks spans of 8 over spans of 16
        probe = RoofLens(rs.H100_SXM)
        probe.bind(cfg=tm.cfg, weight_bytes=124_672, kv_quant="nf4", m_slots=2)
        kw["prefill_sla_s"] = 0.5 * (probe.predict_prefill_chunk(2, 8, 32)
                                     + probe.predict_prefill_chunk(2, 16, 32))
    sla = kw.pop("sla", None)
    jeng = JEngine(jm, jparams, paged=True, obs=jobs,
                   spec_decode=JSpecConfig(**spec) if spec else None,
                   sla=JSLAPolicy(**sla) if sla else None, **kw)
    teng = GenerationEngine(tm, tparams, device="cpu", obs=tobs,
                            spec_decode=SpecConfig(**spec) if spec else None,
                            sla=SLAPolicy(**sla) if sla else None, **kw)
    _serve_observed(jeng, prompts)
    _serve_observed(teng, prompts)

    got, want = tobs.metrics.snapshot(), jobs.metrics.snapshot()
    assert set(want) - set(got) == REF_ONLY & set(want) and set(got) <= set(want)
    assert _json(got) == _json({k: want[k] for k in got})
    assert got["serve.host_syncs"]["value"] == teng.scheduler.stats()["host_syncs"]

    assert tobs.tracer.requests.keys() == jobs.tracer.requests.keys()
    for rid, r in tobs.tracer.requests.items():
        j = jobs.tracer.requests[rid]
        assert (j.submit_t, j.admit_t, j.finish_t, j.token_times) == (
            r.submit_t, r.admit_t, r.finish_t, r.token_times)
        assert (j.slot, j.finish_reason, j.prompt_len) == (r.slot, r.finish_reason,
                                                           r.prompt_len)
    spans = [(s.name, s.t0, s.t1, s.args) for s in tobs.tracer.spans]
    assert spans == [(s.name, s.t0, s.t1, s.args) for s in jobs.tracer.spans]

    samples = [dataclasses.astuple(s) for s in tobs.rooflens.samples]
    assert samples == [dataclasses.astuple(s) for s in jobs.rooflens.samples]
    regimes = {s[0] for s in samples}
    assert regimes == {"plain": {"prefill", "decode"},
                       "prefix_chunked_sla": {"prefill_chunk", "decode"},
                       "spec": {"prefill", "draft", "verify"},
                       "sla_tier": {"prefill", "decode", "tier_restore"}}[case]
    if case == "sla_tier":
        st = teng.scheduler.stats()
        assert st["shed_requests"] == 3 and st["tier_restored_pages"] > 0
        assert got["serve.requests.shed"]["value"] == 3
        assert got["serve.pool.tiered_pages"]["value"] == teng.kv.occupancy()["tiered"]
        assert teng.statuses == {r: s.value for r, s in jeng.statuses.items()}
    if case == "prefix_chunked_sla":
        assert {s.args["span"] for s in tobs.tracer.spans if s.name == "prefill"} == {8}
    assert tobs.rooflens.calibrate() == jobs.rooflens.calibrate()
    assert _json(tobs.rooflens.error_report()) == _json(jobs.rooflens.error_report())


def observed_serve_report(cases):
    """{case: "ok" or the failed assertion's traceback}; run in the
    exact-rounding process."""
    layouts = {False: _layout(False), True: _layout(True)}
    out = {}
    for case in cases:
        try:
            _check_observed_serve(layouts, case)
            out[case] = "ok"
        except AssertionError:
            out[case] = traceback.format_exc()[-3000:]
    return out


@pytest.fixture(scope="module")
def exact_observed():
    return run_exact("test_torch_obs", "observed_serve_report", list(SERVES))


@pytest.mark.parametrize("case", list(SERVES))
def test_observed_serve_matches_reference(exact_observed, case):
    """Counters, tracer spans and RoofLens samples of the port's serve are
    the reference's, in the process where XLA rounds every bf16 op
    (tests/torch_parity.py): there the spec serve's tokens, which set its
    schedule, are the reference's too. The spec serve is held against the
    stacked reference (see `layouts`); the binds' vector-op terms then
    differ, and the predictions still agree since the weight bytes bound
    every step. Both packages read the clock at the same sites (the
    submit stamp the SLA gates read included), so every stamp, span and
    `measured_s` is equal. The SLA + host-tier serve adds the shed,
    spill and restore counters, the tiered-pages gauge and the
    `tier_restore` RoofLens samples to the comparison."""
    assert exact_observed[case] == "ok", exact_observed[case]


# ---------------------------------------------------------------------------
# the port's engine: observers change nothing (tests/test_obs.py analogs)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_llama():
    cfg = get_smoke_config("llama3-8b")
    m = Model(cfg)
    return m, m.init(torch.Generator().manual_seed(0), device="cpu", spec=get_spec("bf8_50"))


def _prompts(vocab, lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _drain(m, params, prompts, n_steps, *, chunk=4, obs=None, **kw):
    kw = dict(dict(max_len=64, block_size=8, max_slots=2, decode_chunk=chunk), **kw)
    eng = GenerationEngine(m, params, device="cpu", obs=obs, **kw)
    rids = [eng.submit(p, max_new_tokens=n_steps) for p in prompts]
    done = eng.run_until_drained()
    return [done[r].tolist() for r in rids], eng


def test_engine_outputs_bit_identical_with_and_without_obs(port_llama):
    m, params = port_llama
    prompts = _prompts(m.cfg.vocab_size, lengths=(5, 13, 9))
    want, _ = _drain(m, params, prompts, 5)
    got, eng = _drain(m, params, prompts, 5, obs=Observability.default())
    assert got == want
    s = eng.obs.tracer.summary()
    assert s["n_requests"] == 3 and s["n_tokens"] == sum(len(t) for t in got)
    assert eng.obs.metrics.counter("serve.requests.finished", unit="requests").value == 3


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched while active, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_decode_chunk_ops_identical_with_and_without_obs(port_llama):
    """Observability adds no device work: each decode chunk, and the whole
    serve around it, dispatches the same aten ops in the same order with
    and without observers (the reference's jaxpr check)."""
    m, params = port_llama
    prompts = _prompts(m.cfg.vocab_size, lengths=(5, 13, 9))
    logs = []
    for obs in (None, Observability.default()):
        eng = GenerationEngine(m, params, device="cpu", obs=obs, max_len=64, block_size=8,
                               max_slots=2, decode_chunk=4)
        chunks, inner = [], eng.scheduler._decode_chunk

        def chunk(*a, inner=inner, chunks=chunks):
            with _OpLog() as one:
                out = inner(*a)
            chunks.append(one.ops)
            return out

        eng.scheduler._decode_chunk = chunk
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        with _OpLog() as whole:
            eng.run_until_drained()
        logs.append((chunks, whole.ops))
    (c0, w0), (c1, w1) = logs
    assert len(c0) >= 2 and all(c0) and c0 == c1
    assert w0 == w1


@pytest.mark.parametrize("chunk", [1, 4])
def test_host_sync_accounting(port_llama, chunk):
    """host_syncs = one per prefill call + one per decode launch."""
    m, params = port_llama
    obs = Observability.default()
    _, eng = _drain(m, params, _prompts(m.cfg.vocab_size, (5, 9)), 4, chunk=chunk, obs=obs)
    st = eng.scheduler.stats()
    assert st["host_syncs"] == st["prefill_calls"] + st["decode_chunks"]
    assert obs.metrics.counter("serve.host_syncs", unit="calls").value == st["host_syncs"]
    if chunk == 1:
        assert st["decode_chunks"] == st["decode_steps"]
    else:
        assert st["decode_chunks"] < st["decode_steps"]


def test_stats_fold_into_registry_and_pool_gauges(port_llama):
    m, params = port_llama
    obs = Observability.default()
    _, eng = _drain(m, params, _prompts(m.cfg.vocab_size, (5, 9)), 4, obs=obs)
    st = eng.scheduler.stats()  # folds the snapshot into serve.stats.* gauges
    snap = obs.metrics.snapshot()
    for k in STAT_UNITS:
        assert snap[f"serve.stats.{k}"] == {"type": "gauge", "unit": STAT_UNITS[k],
                                            "value": float(st[k])}
    occ = eng.kv.occupancy()
    assert occ["used"] == 0 and occ["free"] == occ["total"]  # drained
    # the last published sample: pages conserved at that instant
    assert (snap["serve.pool.used_pages"]["value"] + snap["serve.pool.free_pages"]["value"]
            == occ["total"])
    assert snap["serve.host_syncs"]["value"] == st["host_syncs"]
    assert snap["serve.requests.submitted"]["value"] == 2
    assert snap["serve.decode.tokens"]["value"] == st["active_slot_steps"]


def test_rooflens_engine_loose_factor(port_llama):
    """After calibrating on one drain, the decode-regime prediction tracks
    measured chunk walls within a loose factor (8x): CPU timings are
    noisy, but the model's relative structure has to hold."""
    m, params = port_llama
    obs = Observability.default()
    eng = GenerationEngine(m, params, device="cpu", obs=obs, max_len=64, block_size=8,
                           max_slots=2, decode_chunk=4)
    prompts = _prompts(m.cfg.vocab_size, lengths=(5, 9, 13))

    def drain():
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        eng.run_until_drained()

    drain()  # warm-up: first calls of each shape
    obs.rooflens.reset_samples()
    drain()
    obs.rooflens.calibrate()
    obs.rooflens.reset_samples()
    drain()
    dec = obs.rooflens.error_report()["decode"]
    assert dec["n"] >= 2
    assert 1 / 8 < dec["geomean_ratio"] < 8
    assert dec["max_abs_log2"] < 5.0
    assert obs.metrics.histogram("rooflens.decode.measured_s", unit="s").count >= dec["n"]


# ---------------------------------------------------------------------------
# spec regimes and SLA-sized chunked prefill (tests/test_spec_decode.py)
# ---------------------------------------------------------------------------

def test_rooflens_draft_verify_regimes(port_llama):
    m, params = port_llama
    obs = Observability.default()
    _drain(m, params, _prompts(m.cfg.vocab_size, (6, 11), seed=2), 8, chunk=8, obs=obs,
           spec_decode=SpecConfig(k=3, draft_codec="nf4"))
    lens = obs.rooflens
    assert lens.spec_k == 3 and lens.draft_weight_bytes < lens.weight_bytes
    assert lens.predict_draft([32, 48], 3, 2) > 0
    assert lens.predict_verify([32, 48], 3, 2) > 0
    assert {"draft", "verify"} <= {s.regime for s in lens.samples}
    assert set(lens.calibrate()) >= {"draft", "verify"}


def test_prefill_span_cap_follows_sla(port_llama):
    """With a bound RoofLens and an SLA budget the chunked-prefill span is
    the largest page-aligned pow2 step whose predicted launch fits the
    budget; without either, the fixed `prefill_chunk`."""
    m, params = port_llama
    kw = dict(max_len=64, block_size=8, max_slots=2, prefill_chunk=32, device="cpu")
    eng = GenerationEngine(m, params, obs=Observability.default(), prefill_sla_s=1e9, **kw)
    sched = eng.scheduler
    pend = [(0, types.SimpleNamespace(prefilled=0, prompt=list(range(48))))]
    assert sched._prefill_span_cap(pend) == 32
    sched.prefill_sla_s = 1e-12
    assert sched._prefill_span_cap(pend) == 8
    lens = eng.obs.rooflens
    sched.prefill_sla_s = 0.5 * (lens.predict_prefill_chunk(1, 16, 16)
                                 + lens.predict_prefill_chunk(1, 32, 32))
    assert sched._prefill_span_cap(pend) == 16
    sched.prefill_sla_s = None
    assert sched._prefill_span_cap(pend) == 32
    eng2 = GenerationEngine(m, params, prefill_sla_s=1e-12, **kw)  # no obs: inert
    assert eng2.scheduler._prefill_span_cap(pend) == 32


def test_sla_prefill_sizing_never_changes_tokens(port_llama):
    """A starvation budget forces one-page prefill bites; the tokens are
    the default engine's."""
    m, params = port_llama
    prompts = _prompts(m.cfg.vocab_size, (26, 19), seed=5)
    want, _ = _drain(m, params, prompts, 6, chunk=8, prefill_chunk=32)
    got, eng = _drain(m, params, prompts, 6, chunk=8, prefill_chunk=32,
                      obs=Observability.default(), prefill_sla_s=1e-12)
    assert got == want
    spans = {s.args["span"] for s in eng.obs.tracer.spans if s.name == "prefill"}
    assert spans == {8}

"""Parity of the port's serving engine with the JAX `GenerationEngine`.

The same traffic (mixed prompt lengths, a pool small enough to block
admission) goes through both engines with the same compressed weights. The
host bookkeeping (block tables, write slots, positions, fresh pages, the
KV length vectors, admission order, per-request peaks and the serving
stats) must match exactly in this process; greedy tokens must match
exactly in a process where XLA rounds every bf16 op as the reference's
source says (tests/torch_parity.py), for all six KV pool kinds.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, SpecConfig
from repro_torch.serve.scheduler import STAT_UNITS
from torch_parity import run_exact

KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")
LENGTHS = (4, 19, 11, 26, 7)
ENGINE = dict(max_len=64, block_size=8, max_slots=3, num_blocks=10, decode_chunk=4)


def _reference_params():
    params = JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))
    return jcompress_tree(params, jget_spec("bf8_50"))


@pytest.fixture(scope="module")
def reference_params():
    return _reference_params()


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENGTHS]


def _record(eng, port: bool):
    """Wrap the scheduler's device calls to log what the host hands them."""
    sched, log = eng.scheduler, []
    prefill, chunk = sched._prefill, sched._decode_chunk
    decode, sample = sched._decode, sched._sample

    def on_prefill(*a):
        # tokens, positions, tables, slots, wpos, fresh, copy-on-write
        # rows, last_idx: the same arguments in both packages
        log.append(("prefill", [r.rid if r else -1 for r in sched.slots],
                    [np.array(x) for x in a]))
        return prefill(*a)

    def on_chunk(*a):
        # tokens0, tables, positions, wslots, wpos, fresh, kv_lens, request
        # ids, output indices, max_steps, eos, active: the same arguments
        # in both packages
        log.append(("chunk", [r.rid if r else -1 for r in sched.slots],
                    [np.array(x) for x in a]))
        return chunk(*a)

    def on_decode(*a):
        # tokens, positions, tables, write_slots, write_pos, fresh, kv_lens:
        # the single step's arguments in both packages (decode_chunk=1)
        log.append(("decode", [r.rid if r else -1 for r in sched.slots],
                    [np.array(x) for x in a]))
        return decode(*a)

    def on_sample(logits, rids, steps, *a, **kw):
        # the sampler right after a single step: its request ids and output
        # indices join that step's entry
        if log and log[-1][0] == "decode" and len(log[-1][2]) == 7:
            log[-1][2].extend([np.array(rids), np.array(steps)])
        return sample(logits, rids, steps, *a, **kw)

    sched._prefill, sched._decode_chunk = on_prefill, on_chunk
    sched._decode, sched._sample = on_decode, on_sample
    return log


def _serve(kind, jparams, *, eos_id=None, eos_ids=None, **overrides):
    """Both engines over the same requests; returns (reference, port)
    dicts of tokens, call logs, stats and per-request page peaks.
    `eos_ids` serves the prompts once per entry, one wave after another
    on the same engines, each wave with that EOS id."""
    kw = dict(ENGINE, **overrides)
    jeng = JEngine(JModel(jget_smoke_config("llama3-8b")), jparams, paged=True,
                   kv_quant=kind, **kw)
    tcfg = get_smoke_config("llama3-8b")
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    teng = GenerationEngine(Model(tcfg), tparams, kv_quant=kind, device="cpu", **kw)
    out = []
    for eng, port in ((jeng, False), (teng, True)):
        log = _record(eng, port)
        tokens = []
        for eos in (eos_id,) if eos_ids is None else eos_ids:
            rids = [eng.submit(p, max_new_tokens=6, eos_id=eos) for p in _prompts()]
            done = eng.run_until_drained()
            tokens += [done[r].tolist() for r in rids]
        st = eng.scheduler.stats()
        out.append({
            "tokens": tokens,
            "log": log,
            "stats": {k: st[k] for k in STAT_UNITS},
            "peaks": dict(eng.scheduler.request_peaks),
        })
    return out


def _logs_equal(a, b, with_tokens: bool) -> bool:
    """Call logs equal; without tokens the sampled-token arguments (the
    chunk's tokens0 and the single step's tokens; prompts containing
    nothing sampled are kept) are left out, since they follow the logits."""
    if len(a) != len(b):
        return False
    for (ka, sa, xa), (kb, sb, xb) in zip(a, b):
        skip = {0} if (ka in ("chunk", "decode") and not with_tokens) else set()
        if ka != kb or sa != sb or len(xa) != len(xb):
            return False
        if not all(np.array_equal(u, v) for i, (u, v) in enumerate(zip(xa, xb))
                   if i not in skip):
            return False
    return True


@pytest.mark.parametrize("kind", KV_KINDS)
def test_host_bookkeeping_matches_reference(reference_params, kind):
    """Without EOS the schedule depends only on lengths, so every host
    array handed to the device, the admission order, the peaks and the
    stats match exactly; tokens may differ only by XLA's excess precision
    (see the exact-rounding test below)."""
    ref, got = _serve(kind, reference_params)
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"]
    assert got["peaks"] == ref["peaks"]
    assert [len(t) for t in got["tokens"]] == [6] * len(LENGTHS)


def engine_report(kinds):
    """{kind: "ok" or what differed}, with and without an EOS id."""
    params = _reference_params()
    out = {}
    for kind in kinds:
        out[kind] = "ok"
        for eos in (None, 7):
            ref, got = _serve(kind, params, eos_id=eos)
            for field in ("tokens", "stats", "peaks"):
                if got[field] != ref[field]:
                    out[kind] = f"eos={eos}: {field} {got[field]} != {ref[field]}"
            if not _logs_equal(ref["log"], got["log"], with_tokens=True):
                out[kind] = f"eos={eos}: device-call arguments differ"
    return out


@pytest.fixture(scope="module")
def exact_report():
    return run_exact("test_torch_engine", "engine_report", list(KV_KINDS))


@pytest.mark.parametrize("kind", KV_KINDS)
def test_greedy_tokens_match_reference(exact_report, kind):
    """Same greedy tokens, block tables, admission order and stats as the
    JAX engine, with and without an EOS id that ends requests early."""
    assert exact_report[kind] == "ok"


def test_unbatched_prefill_matches_reference_bookkeeping(reference_params):
    ref, got = _serve("int8", reference_params, prefill_batch=False)
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"]


def _port_engine(**kw):
    cfg = get_smoke_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return GenerationEngine(model, params, device="cpu", **dict(ENGINE, **kw))


def test_generate_and_request_validation():
    eng = _port_engine(kv_quant="int4")
    prompts = np.stack([p[:4] for p in _prompts()])
    out = eng.generate(prompts, 5)
    assert out.shape == (len(LENGTHS), 5) and out.dtype == np.int32
    assert eng.kv.allocator.used_count == 0 and eng.kv.reserved_blocks == 0
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32), max_new_tokens=3)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(60, np.int32), max_new_tokens=10)  # > max_len
    with pytest.raises(ValueError):
        eng.submit(np.zeros(4, np.int32), max_new_tokens=0)


def test_temperature_sampling_is_refused_with_its_roadmap_item():
    """Temperature sampling (Queue A item 4b) is no longer refused: the
    engine serves at T > 0, every token in the vocabulary. The dense
    ring-cache engine (item 10.4) is ported too: `paged=False` serves, and
    refuses spec decoding as the reference's does; params on another
    device than the engine's raise."""
    cfg = get_smoke_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = GenerationEngine(model, params, temperature=0.7, seed=5, device="cpu",
                           **ENGINE)
    out = eng.generate(np.stack([p[:4] for p in _prompts()[:2]]), 4)
    assert out.shape == (2, 4) and ((0 <= out) & (out < cfg.vocab_size)).all()
    dense = GenerationEngine(model, params, temperature=0.7, paged=False, max_len=16,
                             device="cpu")
    assert dense.generate(np.stack([p[:4] for p in _prompts()[:2]]), 4).shape == (2, 4)
    with pytest.raises(ValueError, match="spec_decode requires the paged engine"):
        GenerationEngine(model, params, paged=False, spec_decode=SpecConfig(), device="cpu")
    on_meta = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="lie on"):
        GenerationEngine(model, on_meta, device="cpu")


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_smoke_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(model, params)


def test_overflow_fresh_pages_are_scrubbed_before_the_launch():
    """Fresh pages beyond what one prefill launch carries are scrubbed by
    dedicated calls before the launch that writes into them."""
    eng = _port_engine(kv_quant="none", num_blocks=20)
    scrubbed = []
    inner = eng.scheduler._scrub
    eng.scheduler._scrub = lambda pages: (scrubbed.append(pages.copy()), inner(pages))
    for layer in eng.kv.pools:
        layer["ppos"][15:18] = 123  # stale positions left by an old tenant
    eng.kv._fresh.extend([15, 16, 17])
    eng.submit(_prompts()[0], max_new_tokens=2)
    eng.run_until_drained()
    assert scrubbed and set(np.concatenate(scrubbed).tolist()) >= {16, 17}
    for layer in eng.kv.pools:
        assert torch.all(layer["ppos"][15:18] != 123)


def test_stats_units_cover_every_key():
    eng = _port_engine(kv_quant="nf4")
    eng.generate(np.stack([p[:4] for p in _prompts()[:2]]), 3)
    st = eng.scheduler.stats()
    assert set(st) == set(STAT_UNITS)
    assert st["decode_steps"] > 0 and st["prefill_calls"] > 0
    assert 0 < st["mean_occupancy"] <= 1

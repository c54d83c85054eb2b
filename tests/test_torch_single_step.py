"""The single-step paged decode loop (`decode_chunk=1`) and the port-side
twins of `examples/quickstart.py` and `examples/compressed_serving.py`,
held against the JAX reference.

At `decode_chunk=1` both schedulers run `_decode_active_single`: one
decode step a round, then the sampler, one host sync a token. The same
traffic as `tests/test_torch_engine.py` (mixed prompt lengths, a pool
small enough to block admission) goes through both engines, once without
an EOS id and then once with one, on the same engines. In the process where
XLA rounds every bf16 op (tests/torch_parity.py) every host array handed
to the single step (tokens, positions, tables, write slots and positions,
fresh pages, KV lengths) and to its sampler (request ids, output indices),
the admission order, `stats()` and the per-request peaks equal the
reference's, and so do the greedy tokens, for all six KV kinds. Within
each package the chunked loop (`decode_chunk=4`) gives the single step's
tokens, and its stats differ from the single step's in the same keys.
Everything here is exact: no tolerance.
"""
import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import roofsurface as jrs
from repro.core.codecs import codec_names as jcodec_names
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.decompress import compressed_bytes as jcompressed_bytes
from repro.core.formats import PAPER_SCHEMES as JPAPER_SCHEMES
from repro.core.formats import CompressionSpec as JCompressionSpec
from repro.core.formats import get_spec as jget_spec
from repro.models.model import Model as JModel
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.core.codecs import codec_names
from repro_torch.core.formats import PAPER_SCHEMES, CompressionSpec
from repro_torch.serve.engine import SpecConfig
from repro_torch.serve.scheduler import STAT_UNITS, Scheduler
from test_torch_engine import KV_KINDS, _logs_equal, _port_engine, _prompts, _reference_params, _serve
from test_torch_optim import one_thread  # noqa: F401 (an autouse fixture)
from torch_parity import Exact

ROOT = pathlib.Path(__file__).resolve().parents[1]
EOS_WAVES = (None, 7)
# the stats the reference's own chunked and single-step loops count apart
# on this traffic: decode launches (one per step against one per chunk) and
# host syncs with them; every other key is the same in both loops
CHUNK_ONLY_STATS = {"decode_chunks", "host_syncs"}
CHUNKED_KIND = "int8"  # the kind also served chunked, to hold the two loops together


def _chunked_against_single(one, four) -> str:
    """Within each package (`one`, `four`: the (reference, port) serves at
    decode_chunk 1 and 4): the same tokens, stats apart exactly in
    CHUNK_ONLY_STATS, and at chunk 1 one launch and one host sync a step
    beside the prefill calls; "ok" or what differed."""
    for name, single, chunked in zip(("reference", "port"), one, four):
        apart = {k for k in STAT_UNITS if single["stats"][k] != chunked["stats"][k]}
        st = single["stats"]
        kinds = [k for k, _, _ in single["log"]], [k for k, _, _ in chunked["log"]]
        if single["tokens"] != chunked["tokens"]:
            return f"{name}: chunked and single-step tokens differ"
        if apart != CHUNK_ONLY_STATS:
            return f"{name}: stats apart {sorted(apart)}"
        if (st["decode_chunks"] != st["decode_steps"]
                or st["host_syncs"] != st["prefill_calls"] + st["decode_steps"]):
            return f"{name}: not one launch and one host sync a single step: {st}"
        if "chunk" in kinds[0] or "decode" in kinds[1]:
            return f"{name}: the loops ran each other's step"
    return "ok"


def exact_report(kinds, chunked=()):
    """{kind: {"bookkeeping": ..., "tokens": ...}}, each "ok" or what
    differed, at decode_chunk=1 over both EOS waves, in the exact-rounding
    process; a kind in `chunked` also serves at decode_chunk=4 and adds
    "chunked_vs_single" (`_chunked_against_single`)."""
    torch.set_num_threads(1)
    params = _reference_params()
    out = {}
    for kind in kinds:
        ref, got = _serve(kind, params, eos_ids=EOS_WAVES, decode_chunk=1)
        steps = [x for k, _, x in got["log"] if k == "decode"]
        book, toks = "ok", "ok"
        if not steps or any(len(x) != 9 for x in steps):
            book = f"the single step was not recorded with its sampler: {len(steps)} steps"
        elif not _logs_equal(ref["log"], got["log"], with_tokens=False):
            book = "device-call arguments or admission order differ"
        for field in ("stats", "peaks"):
            if got[field] != ref[field]:
                book = f"{field} {got[field]} != {ref[field]}"
        if got["tokens"] != ref["tokens"]:
            toks = f"tokens {got['tokens']} != {ref['tokens']}"
        elif not _logs_equal(ref["log"], got["log"], with_tokens=True):
            toks = "the fed-back tokens differ"
        out[kind] = {"bookkeeping": book, "tokens": toks}
        if kind in chunked:
            four = _serve(kind, params, eos_ids=EOS_WAVES, decode_chunk=4)
            out[kind]["chunked_vs_single"] = _chunked_against_single((ref, got), four)
    return out


def twin_tokens():
    """The serving twin's default run with the reference's seeded llama3-8b
    smoke tree carried in (its `Model.init` returns `params_from_jax` of
    it), and the reference example's default engine on the same tree and
    prompts (`GenerationEngine(model, cparams, max_len=128,
    temperature=0.0)`, `generate(prompts, 24)`): {"port", "reference":
    tokens, "paged": whether the twin's engine was the paged one}."""
    from repro.serve.engine import GenerationEngine as JEngine
    from repro_torch.convert import params_from_jax
    from repro_torch.serve import engine as port_engine

    torch.set_num_threads(1)
    cfg = jget_smoke_config("llama3-8b")
    jparams = JModel(cfg).init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    ref = JEngine(JModel(cfg), jcompress_tree(jparams, jget_spec("mxfp4_100")), max_len=128,
                  temperature=0.0).generate(prompts, 24)
    twin = _twin("compressed_serving_torch")

    class Carried(twin.Model):
        def init(self, *args, **kw):
            return params_from_jax(jax.device_get(jparams), self.cfg, device="cpu")

    paged = []
    build = port_engine.GenerationEngine.__init__

    def noting(eng, *args, **kw):
        build(eng, *args, **kw)
        paged.append(eng.paged)

    twin.Model = Carried
    port_engine.GenerationEngine.__init__ = noting
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = twin.main(["--device", "cpu"])
    finally:
        port_engine.GenerationEngine.__init__ = build
    return {"port": np.asarray(out).tolist(), "reference": np.asarray(ref).tolist(),
            "paged": paged == [True]}


_EXACT = {}


@pytest.fixture(scope="module", autouse=True)
def _exact_runs():
    """Three exact-rounding runs of two KV kinds each, started when the
    file's first test starts so they run beside the in-process tests (the
    tests that read them come last); stopped if the file ends first."""
    for i in range(0, len(KV_KINDS), 2):
        kinds = KV_KINDS[i:i + 2]
        chunked = [k for k in kinds if k == CHUNKED_KIND]
        run = Exact("test_torch_single_step", "exact_report", list(kinds), chunked)
        _EXACT.update(dict.fromkeys(kinds, run))
    _EXACT["twin"] = Exact("test_torch_single_step", "twin_tokens")
    yield
    for run in set(_EXACT.values()):
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.communicate()
    _EXACT.clear()


def test_a_chunk_above_one_needs_a_chunk_function():
    """Both schedulers refuse chunk > 1 without a decode_chunk_fn, before
    they look at the cache."""
    for sched in (JScheduler, Scheduler):
        with pytest.raises(ValueError, match="chunk > 1 requires a decode_chunk_fn"):
            sched(None, max_slots=1, max_len=8, prefill_fn=None, decode_fn=None,
                  sample_fn=None, scrub_fn=None, chunk=4)


def _drain(eng, prompts, new):
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = eng.run_until_drained()
    return [done[r].tolist() for r in rids]


def test_spec_engine_with_spec_off_decodes_single_steps():
    """The ladder's spec-off rung on a decode_chunk=1 spec engine: decode
    falls to the single step (no chunk, no spec launch) and gives the
    plain single-step engine's tokens."""
    plain = _drain(_port_engine(decode_chunk=1, kv_quant="int8"), _prompts(), 6)
    eng = _port_engine(decode_chunk=1, kv_quant="int8", spec_decode=SpecConfig(k=2))
    sched = eng.scheduler
    sched._spec_enabled = False  # what the ladder's spec-off rung sets
    calls = {"decode": 0}
    decode = sched._decode

    def counted(*a):
        calls["decode"] += 1
        return decode(*a)

    sched._decode = counted
    sched._decode_chunk = None  # the chunk path may not run; a spec launch would verify
    assert _drain(eng, _prompts(), 6) == plain
    st = sched.stats()
    assert calls["decode"] == st["decode_steps"] > 0 and st["verify_calls"] == 0


# ---------------------------------------------------------------------------
# CompressionSpec.compression_factor and the example twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", jcodec_names())
def test_compression_factor_matches_reference(codec):
    """Every registered codec at the paper's densities and a wider group,
    and the paper's scheme grid: 16 / bits_per_element, the reference's."""
    assert codec in codec_names()
    for density in (1.0, 0.5, 0.3, 0.2, 0.1, 0.05):
        for group in (32, 64):
            want = JCompressionSpec(codec, density, group).compression_factor()
            assert CompressionSpec(codec, density, group).compression_factor() == want
    for jspec, spec in zip(JPAPER_SCHEMES, PAPER_SCHEMES):
        assert spec.compression_factor() == jspec.compression_factor()


def _twin(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(name, argv):
    """The twin's `main(argv)` and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = _twin(name).main(argv)
    return result, out.getvalue()


def test_quickstart_twin_prints_the_references_cf_and_bounds():
    """On the CPU: each scheme's CF and its Roof-Surface bound on SPR-HBM
    with and without DECA are the reference's, and the kernel column says
    that no kernel ran."""
    _, text = _run("quickstart_torch", ["--device", "cpu"])
    rows = [line.split() for line in text.splitlines()[1:] if line.strip()][:4]
    assert [r[0] for r in rows] == ["bf16_50", "bf8_100", "bf8_20", "mxfp4_100"]
    for row in rows:
        spec = jget_spec(row[0])
        deca = jrs.evaluate(spec, jrs.deca_profile(jrs.SPR_HBM), ai_xv=jrs.deca_ai_xv(spec))
        assert row[1] == f"{spec.compression_factor():.2f}"
        assert row[-2:] == [jrs.evaluate(spec, jrs.SPR_HBM).bound, deca.bound]
        assert " ".join(row[2:-2]) == "no kernel on cpu"


@pytest.mark.parametrize("argv", [["--paged", "--chunk", "1"], ["--paged", "--spec-k", "2"]])
def test_serving_twin_paged_paths(argv):
    """--paged at chunk 1 runs the single-step loop: one launch and one
    host sync a step, beside the one prefill call that admits all four
    requests. With --spec-k the spec path runs several rounds a launch."""
    done, text = _run("compressed_serving_torch", ["--device", "cpu"] + argv)
    assert sorted(len(t) for t in done.values()) == [24] * 4
    line = next(x for x in text.splitlines() if x.startswith("decode: "))
    st = dict(kv.split("=") for kv in line.split()[1:])
    steps, launches, syncs = (int(st[k]) for k in ("decode_steps", "decode_chunks",
                                                   "host_syncs"))
    if "--spec-k" in argv:
        assert launches < steps and "accepted_tokens_per_step=" in text
    else:
        assert st["chunk"] == "1" and launches == steps == 23 and syncs == steps + 1
    assert "mean_occupancy=" in text


@pytest.mark.parametrize("name", ["quickstart_torch", "compressed_serving_torch"])
def test_twins_default_to_the_card(name):
    """Without --device a twin runs on the card; with no card it raises,
    never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(name, [])


def test_serving_twin_serves_on_a_one_rank_mesh():
    """--mesh 1x1 opens a one-rank gloo group in this process, serves the
    paged demo on it (4 x 24 tokens) with the CF the reference's
    compress_tree gives, and closes the group."""
    import torch.distributed as dist

    jparams = JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))
    spec = jget_spec("mxfp4_100")
    dense, comp = jcompressed_bytes(jparams), jcompressed_bytes(jcompress_tree(jparams, spec))
    done, text = _run("compressed_serving_torch", ["--device", "cpu", "--mesh", "1x1"])
    assert sorted(len(t) for t in done.values()) == [24] * 4
    assert (f"weights {dense/1e6:.2f} MB -> {comp/1e6:.2f} MB (CF={dense/comp:.2f}, "
            f"scheme CF={spec.compression_factor():.2f})") in text
    assert "mesh: 1x1 (data x model) over 1 rank(s)" in text
    assert not dist.is_initialized()


def test_serving_twin_refuses_a_mesh_larger_than_the_world():
    """--mesh 2x1 in a world of one rank (no torchrun) is refused, as the
    reference refuses a mesh larger than its device count."""
    with pytest.raises(SystemExit, match="needs 2 ranks, have 1"):
        _run("compressed_serving_torch", ["--device", "cpu", "--mesh", "2x1"])


# the tests that wait for the exact-rounding runs: last, so the tests above
# run meanwhile

def test_serving_twin_defaults_print_the_references_cf():
    """The default path is the reference example's: `paged="auto"`, the
    paged engine for llama3-8b, `generate` of 4 x 24 tokens, and the CF and
    scheme CF the reference's compress_tree gives the same model. With the
    reference's seeded tree carried into the twin (`params_from_jax` in
    place of its own draw) its tokens are the reference example's engine's
    (`examples/compressed_serving.py`'s defaults) on the same prompts, in
    the exact-rounding process (`twin_tokens`)."""
    jparams = JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))
    spec = jget_spec("mxfp4_100")
    dense, comp = jcompressed_bytes(jparams), jcompressed_bytes(jcompress_tree(jparams, spec))
    out, text = _run("compressed_serving_torch", ["--device", "cpu"])
    assert out.shape == (4, 24)
    assert (f"weights {dense/1e6:.2f} MB -> {comp/1e6:.2f} MB (CF={dense/comp:.2f}, "
            f"scheme CF={spec.compression_factor():.2f})") in text
    assert "sample:" in text
    got = _EXACT["twin"].result()
    assert got["paged"] and got["port"] == got["reference"]
    assert np.asarray(got["port"]).shape == (4, 24)


@pytest.mark.parametrize("kind", KV_KINDS)
def test_single_step_bookkeeping_matches_reference(kind):
    """Every host array handed to the single step and its sampler, the
    admission order, `stats()` over STAT_UNITS and the peaks."""
    assert _EXACT[kind].result()[kind]["bookkeeping"] == "ok"


@pytest.mark.parametrize("kind", KV_KINDS)
def test_single_step_greedy_tokens_match_reference(kind):
    """Greedy tokens with and without an EOS id that ends requests early."""
    assert _EXACT[kind].result()[kind]["tokens"] == "ok"


def test_chunked_and_single_step_agree_as_in_the_reference():
    """Both EOS waves: within each package chunked and single-step decode
    give the same tokens, and their stats differ only in the decode
    launches and host syncs, in both packages alike; at chunk 1 a launch
    and a host sync are one step (the prefill calls apart)."""
    assert _EXACT[CHUNKED_KIND].result()[CHUNKED_KIND]["chunked_vs_single"] == "ok"

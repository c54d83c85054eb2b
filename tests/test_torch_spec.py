"""Parity of the port's self-speculative decode with the JAX reference.

The same numbers go through both packages: the reference's `Model.init`
tree, compressed by its `compress_tree` and carried into the port with
`convert.params_from_jax`, at the llama3-8b smoke config. Decompression
and the draft tree are bitwise in this process. The spec round
(`spec_decode_chunk`) and the spec engine are compared in a process where
XLA rounds every bf16 op (tests/torch_parity.py): there the emitted
tokens, the per-round emission counts, every KV pool plane and the
speculative stats are those of the reference. Engines stay small, as the
reference's own spec tests keep them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import compress as jcompress
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.decompress import make_draft_tree as jmake_draft_tree
from repro.core.formats import CompressionSpec as JSpec
from repro.core.formats import get_spec as jget_spec
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.kernels import ref as jref
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import SpecConfig as JSpecConfig
from repro.serve.engine import make_paged_prefill_step as jmake_prefill
from repro.serve.engine import make_paged_spec_decode_step as jmake_spec

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import _leaf, params_from_jax
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import compressed_bytes, make_draft_tree
from repro_torch.core.formats import get_spec
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.serve.engine import (
    GenerationEngine, SpecConfig, make_paged_prefill_step, make_paged_spec_decode_step,
)
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.scheduler import Scheduler
from test_torch_model import _pool_mismatches, _prefill_inputs, _same_leaf
from torch_parity import run_exact

CODECS = ("bf16", "bf8", "mxfp4", "int8", "int4", "nf4")
ENGINE_KINDS = ("none", "bf8", "int8", "nf4")
CHUNK_KINDS = ("none", "int8")
LENGTHS = (4, 19, 11)
ENGINE = dict(max_len=64, block_size=8, max_slots=2, decode_chunk=8)
SPEC = dict(k=3, draft_codec="nf4")
STATS = ("draft_tokens", "verify_calls", "accepted_tokens_per_step", "kv_pages_read",
         "decode_steps", "active_slot_steps", "paged_block_steps", "peak_blocks")
BS, NB = 8, 12


def _dense_reference():
    return JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))


def _reference_params(target="bf8_50"):
    dense = _dense_reference()
    return dense if target == "none" else jcompress_tree(dense, jget_spec(target))


@pytest.fixture(scope="module")
def reference_params():
    return _reference_params()


def _port(jparams, kind="none"):
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), kv_quant=kind)
    return Model(cfg), params_from_jax(jax.device_get(jparams), cfg, device="cpu")


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n).astype(np.int32) for n in LENGTHS]


# ---------------------------------------------------------------------------
# decompression and the draft tree: bitwise in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", CODECS)
def test_ops_decompress_bitwise(quant, density):
    """`ops.decompress` on CPU tensors is the reference's `ref.decompress`
    to the bit (-0.0 and +0.0 told apart), in f32 and in bf16."""
    rng = np.random.default_rng(len(quant) + int(density * 100))
    w = (rng.standard_normal((128, 72)) * 0.05).astype(np.float32)
    w[5, :] = 0.0
    jct = jcompress(w, JSpec(quant, density))
    tct = _leaf(jct, None, "cpu")
    for jdt, tdt, view in ((jnp.float32, torch.float32, np.uint32),
                           (jnp.bfloat16, torch.bfloat16, np.uint16)):
        r = np.asarray(jref.decompress(jct, out_dtype=jdt)).view(view)
        got = ops.decompress(tct, out_dtype=tdt)
        assert got.dtype == tdt and tuple(got.shape) == (128, 72)
        g = got.view(torch.int32 if tdt == torch.float32 else torch.int16).numpy().view(view)
        assert np.array_equal(r, g), (quant, density, tdt)


def _leaf_pairs(got, want):
    yield "embed", got["embed"], want["embed"]
    yield "final_norm", got["final_norm"], want["final_norm"]
    yield "lm_head", got["lm_head"], want["lm_head"]
    for i, (gl, wl) in enumerate(zip(got["layers"], want["layers"])):
        for name in ("pre_norm", "pre_mlp_norm"):
            yield f"{i}/{name}", gl[name], wl[name]
        for group in ("attn", "mlp"):
            for name in gl[group]:
                yield f"{i}/{group}/{name}", gl[group][name], wl[group][name]


@pytest.mark.parametrize("draft", ["nf4", "bf8", "int4_50", "mxfp4"])
@pytest.mark.parametrize("target", ["bf8_50", "int8_50", "none"])
def test_make_draft_tree_matches_reference_bitwise(target, draft):
    """The port's draft tree is the reference's, every plane of every leaf;
    leaves the draft shares with the target are the target's objects."""
    jtarget = _reference_params(target)
    cfg = get_smoke_config("llama3-8b")
    want = params_from_jax(jax.device_get(jmake_draft_tree(jtarget, jget_spec(draft))),
                           cfg, device="cpu")
    tparams = params_from_jax(jax.device_get(jtarget), cfg, device="cpu")
    got = make_draft_tree(tparams, get_spec(draft))
    for name, g, w in _leaf_pairs(got, want):
        assert _same_leaf(g, w), name
    assert got["embed"] is tparams["embed"] and got["final_norm"] is tparams["final_norm"]
    for gl, tl in zip(got["layers"], tparams["layers"]):
        assert gl["pre_norm"] is tl["pre_norm"] and gl["pre_mlp_norm"] is tl["pre_mlp_norm"]
        assert isinstance(gl["mlp"]["w_up"], CompressedTensor)
        assert gl["mlp"]["w_up"].spec == get_spec(draft)


def test_draft_tree_shares_leaves_the_draft_group_does_not_divide():
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import CompressionSpec

    leaf = compress(torch.randn(96, 64) * 0.05, get_spec("int8"))  # three 32-groups
    tree = {"layers": [{"mlp": {"w_up": leaf}}]}
    draft = make_draft_tree(tree, CompressionSpec("nf4", 1.0, group=64))
    assert draft["layers"][0]["mlp"]["w_up"] is leaf


# ---------------------------------------------------------------------------
# rollback bookkeeping
# ---------------------------------------------------------------------------

class _PoolStub:
    class cfg:
        kv_quant = "none"

    def init_paged_cache(self, num_blocks, block_size, device=None, dtype=None):
        return []


def test_rollback_trims_tail_credits_reservation_and_regrows():
    """Whole trailing pages drop, within-page rejects are a no-op, the
    reservation credit lets the request re-grow to its admitted budget,
    and freed pages leave the un-drained fresh list."""
    cache = PagedKVCache(_PoolStub(), num_blocks=8, block_size=2)
    cache.admit(0, 12)
    cache.write_slots(0, 0, 9)  # pages 0..4, reservation 6 -> 1
    assert cache.blocks_held(0) == 5 and cache._reserved[0] == 1
    fresh0 = list(cache._fresh)
    # pos 8 rejected: page 4 held only token 8, so it drops whole
    assert cache.rollback(0, 8) == 1
    assert cache.blocks_held(0) == 4 and cache._reserved[0] == 2
    assert len(cache._fresh) == len(fresh0) - 1
    assert cache.rollback(0, 7) == 0  # pos 7 is mid-page 3: nothing to trim
    assert cache.blocks_held(0) == 4
    assert cache.rollback(0, 3) == 2  # pages 2, 3 drop
    assert cache.blocks_held(0) == 2 and cache._reserved[0] == 4
    cache.write_slots(0, 3, 9)  # re-grow to the full admitted budget
    assert cache.blocks_held(0) == 6 and cache._reserved[0] == 0
    cache.release(0)
    assert cache.allocator.free_count == 8


# ---------------------------------------------------------------------------
# the spec round and the spec engine against the reference (exact process)
# ---------------------------------------------------------------------------

def _chunk_inputs():
    """After a prefill of two prompts (16 and 9 tokens), a spec launch of 2
    rounds of k=3: slot 0 may emit 8 tokens, slot 1 only 6, so its last
    drafts write past its budget; pages 4 and 6 open at the launch."""
    tables = np.zeros((2, 4), np.int32)
    tables[0, :3], tables[1, :3] = [3, 7, 4], [5, 2, 6]
    return dict(
        tokens0=np.array([[5], [9]], np.int32), tables=tables,
        p0=np.array([16, 9], np.int32), fresh=np.array([4, 6, 0, 0], np.int32),
        max_steps=np.array([8, 6], np.int32), active=np.ones(2, bool),
    )


def _spec_round_both(kind, jparams, *, eos, window):
    """Prefill, then one spec launch, through both packages from the same
    inputs. Returns (reference (out, e_rounds), port (out, e_rounds),
    reference pools, port pools)."""
    jcfg = dataclasses.replace(jget_smoke_config("llama3-8b"), kv_quant=kind)
    jm = JModel(jcfg)
    tm, tparams = _port(jparams, kind)
    jdraft = jmake_draft_tree(jparams, jget_spec("nf4"))
    tdraft = make_draft_tree(tparams, get_spec("nf4"))
    tokens, pos, ptables, slots, wpos, pfresh, lens = _prefill_inputs()
    T = torch.from_numpy
    jpools = jm.init_paged_cache(NB, BS)
    tpools = tm.init_paged_cache(NB, BS, device="cpu")
    _, jpools = jax.jit(jmake_prefill(jm))(
        jparams, jnp.asarray(tokens), jnp.asarray(pos), jpools, jnp.asarray(ptables),
        jnp.asarray(slots), jnp.asarray(wpos), jnp.asarray(pfresh),
        jnp.zeros((2, 2), jnp.int32), jnp.asarray(lens - 1),
    )
    _, tpools = make_paged_prefill_step(tm)(
        tparams, T(tokens), T(pos), tpools, T(ptables), T(slots), T(wpos), T(pfresh),
        torch.zeros((2, 2), dtype=torch.int32), T(lens - 1),
    )
    c = _chunk_inputs()
    eos = np.asarray(eos, np.int32)
    geo = dict(k=3, rounds=2, draft_window=window, block_size=BS)
    jout, je, jpools = jmake_spec(jm, **geo)(
        jparams, jdraft, jpools, jnp.asarray(c["tokens0"]), jnp.asarray(c["tables"]),
        jnp.asarray(c["p0"]), jnp.asarray(c["fresh"]), jnp.zeros(2, jnp.uint32),
        jnp.zeros(2, jnp.uint32), jnp.asarray(c["max_steps"]), jnp.asarray(eos),
        jnp.asarray(c["active"]), jnp.float32(0.0), jax.random.PRNGKey(0), greedy=True,
    )
    tout, te, tpools = make_paged_spec_decode_step(tm, **geo)(
        tparams, tdraft, tpools, T(c["tokens0"]), T(c["tables"]), T(c["p0"]),
        T(c["fresh"]), torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64),
        T(c["max_steps"]), T(eos), T(c["active"]), torch.tensor(0.0),
        torch.zeros(2, dtype=torch.int64), greedy=True,
    )
    return ((np.asarray(jout), np.asarray(je)), (tout.numpy(), te.numpy()),
            jpools, tpools)


def spec_round_report(kinds):
    """{kind: "ok" or what differed}: plain, with a draft window, and with
    an EOS that slot 0 emits mid-round (the eos run must end slot 0 after
    one token)."""
    params = _reference_params()
    out = {}
    for kind in kinds:
        out[kind] = "ok"
        eos = [-1, -1]
        for variant, window in (("plain", 0), ("window", 4), ("eos", 0)):
            ref, got, jpools, tpools = _spec_round_both(kind, params, eos=eos, window=window)
            bad = _pool_mismatches(jpools, tpools, range(len(tpools)))
            if variant == "eos" and ref[1][:, 0].sum() != 1:
                out[kind] = f"the EOS did not end slot 0: {ref[1].tolist()}"
                break
            if not (np.array_equal(ref[0], got[0]) and np.array_equal(ref[1], got[1])) or bad:
                out[kind] = f"{variant}: out {ref[0].T.tolist()} / {got[0].T.tolist()}, " \
                            f"e_rounds {ref[1].tolist()} / {got[1].tolist()}, planes {bad}"
                break
            if variant == "plain":
                # slot 0's first token, which its first round accepted with
                # more after it: as an EOS it cuts that round short
                eos = [int(ref[0][0, 0]), -1]
                if ref[1][0, 0] < 2:
                    out[kind] = f"too few tokens accepted to place an EOS: {ref[1].tolist()}"
                    break
    return out


def _record_spec(eng, port: bool):
    sched, log = eng.scheduler, []
    inner = sched._spec

    def on_spec(*a):
        # tokens0, tables, p0, fresh, request ids, output indices,
        # max_steps, eos, active: the same arguments in both packages
        log.append([np.array(x) for x in a])
        return inner(*a)

    sched._spec = on_spec
    return log


def _drain(eng, eos_id=None):
    rids = [eng.submit(p, max_new_tokens=12, eos_id=eos_id) for p in _prompts()]
    done = eng.run_until_drained()
    st = eng.scheduler.stats()
    return [done[r].tolist() for r in rids], {k: st[k] for k in STATS}


def _engines(kind, jparams, *, eos_id=None):
    """Reference spec engine, port spec engine and port non-spec engine on
    the same requests: their (tokens, stats, spec-call log)."""
    jeng = JEngine(JModel(jget_smoke_config("llama3-8b")), jparams, paged=True,
                   kv_quant=kind, spec_decode=JSpecConfig(**SPEC), **ENGINE)
    tm, tparams = _port(jparams)
    teng = GenerationEngine(tm, tparams, kv_quant=kind, device="cpu",
                            spec_decode=SpecConfig(**SPEC), **ENGINE)
    plain = GenerationEngine(tm, tparams, kv_quant=kind, device="cpu", **ENGINE)
    out = []
    for eng, port in ((jeng, False), (teng, True)):
        log = _record_spec(eng, port)
        out.append(_drain(eng, eos_id) + (log,))
    out.append(_drain(plain, eos_id) + ([],))
    return out


def spec_engine_report(kinds):
    """{kind: "ok" or what differed}; the entry "eos" repeats the first kind
    with an EOS id that ends a request mid-round."""
    params = _reference_params()
    out = {}
    for kind in kinds + ["eos"]:
        eos = None
        if kind == "eos":
            kind, eos = kinds[0], int(first[0][4])
        ref, got, plain = _engines(kind, params, eos_id=eos)
        if eos is None and kind == kinds[0]:
            first = ref[0]
        name = "eos" if eos is not None else kind
        out[name] = "ok"
        if got[0] != ref[0]:
            out[name] = f"spec tokens {got[0]} != reference {ref[0]}"
        elif plain[0] != got[0]:
            out[name] = f"non-spec tokens {plain[0]} != spec tokens {got[0]}"
        elif got[1] != ref[1]:
            out[name] = f"stats {got[1]} != reference {ref[1]}"
        elif len(got[2]) != len(ref[2]) or not all(
                np.array_equal(u, v) for a, b in zip(got[2], ref[2]) for u, v in zip(a, b)):
            out[name] = "spec-call arguments differ"
    return out


@pytest.fixture(scope="module")
def round_report():
    return run_exact("test_torch_spec", "spec_round_report", list(CHUNK_KINDS))


@pytest.fixture(scope="module")
def engine_report():
    return run_exact("test_torch_spec", "spec_engine_report", list(ENGINE_KINDS))


@pytest.mark.parametrize("kind", CHUNK_KINDS)
def test_spec_decode_chunk_matches_reference_bitwise(round_report, kind):
    """`spec_decode_chunk` from the same prefilled pools: the packed tokens,
    the per-round emission counts and every pool plane of every layer
    (null page excluded) are the reference's, plain, with a draft window
    and with an EOS mid-round."""
    assert round_report[kind] == "ok"


@pytest.mark.parametrize("kind", ENGINE_KINDS + ("eos",))
def test_spec_engine_matches_reference(engine_report, kind):
    """The spec engine emits the reference spec engine's tokens, which are
    also the port's own non-spec tokens; its speculative stats and every
    host array of every spec launch are the reference's."""
    assert engine_report[kind] == "ok"


# ---------------------------------------------------------------------------
# port against port, configuration and accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_spec_greedy_equals_non_spec_in_process(reference_params, kind):
    """Speculation changes how tokens are found, never which: the spec
    engine's tokens are the non-spec engine's, and it accepts more than
    one token per verify."""
    tm, tparams = _port(reference_params)
    want, _ = _drain(GenerationEngine(tm, tparams, kv_quant=kind, device="cpu", **ENGINE))
    eng = GenerationEngine(tm, tparams, kv_quant=kind, device="cpu",
                           spec_decode=SpecConfig(**SPEC), **ENGINE)
    got, st = _drain(eng)
    assert got == want
    assert st["draft_tokens"] > 0 and st["verify_calls"] > 0
    assert st["accepted_tokens_per_step"] >= 1.0
    assert eng.kv.allocator.used_count == 0 and eng.kv.reserved_blocks == 0


def test_spec_draft_window_still_exact(reference_params):
    """A draft window caps the proposal walk only; verify attends over the
    full history, so the tokens do not change."""
    tm, tparams = _port(reference_params)
    want, _ = _drain(GenerationEngine(tm, tparams, device="cpu", **ENGINE))
    got, st = _drain(GenerationEngine(
        tm, tparams, device="cpu", **ENGINE,
        spec_decode=SpecConfig(k=3, draft_codec="nf4", draft_window=16)))
    assert got == want and st["verify_calls"] > 0


def test_spec_config_validation(reference_params):
    with pytest.raises(ValueError, match="k >= 1"):
        SpecConfig(k=0)
    with pytest.raises(ValueError, match="draft_window"):
        SpecConfig(draft_window=-1)
    with pytest.raises(ValueError, match="rounds"):
        SpecConfig(rounds=0)
    tm, tparams = _port(reference_params)
    with pytest.raises(ValueError, match="paged"):
        GenerationEngine(tm, tparams, paged=False, spec_decode=SpecConfig(), device="cpu")
    # temperature is a working option of the spec engine (Queue A item 4b)
    warm = GenerationEngine(tm, tparams, temperature=0.5, spec_decode=SpecConfig(),
                            device="cpu", **ENGINE)
    assert not warm.greedy and warm.spec_rounds == 2
    cache = PagedKVCache(_PoolStub(), num_blocks=4, block_size=2)
    with pytest.raises(ValueError, match="spec_k >= 1"):
        Scheduler(cache, max_slots=1, max_len=8, prefill_fn=None, decode_chunk_fn=None,
                  sample_fn=None, scrub_fn=None, spec_fn=lambda *a: None, spec_k=0,
                  spec_rounds=1)


def test_non_spec_engine_reports_zero_acceptance(reference_params):
    tm, tparams = _port(reference_params)
    eng = GenerationEngine(tm, tparams, device="cpu", **ENGINE)
    eng.submit(_prompts()[0], max_new_tokens=4)
    eng.run_until_drained()
    st = eng.scheduler.stats()
    assert st["draft_tokens"] == 0 and st["verify_calls"] == 0
    assert st["accepted_tokens_per_step"] == 0.0


def test_spec_engine_builds_cheaper_draft_tree(reference_params):
    tm, tparams = _port(reference_params)
    eng = GenerationEngine(tm, tparams, device="cpu", spec_decode=SpecConfig(**SPEC),
                           **ENGINE)
    assert eng.draft_params is not None and eng.spec_rounds == 2
    assert compressed_bytes(eng.draft_params) < compressed_bytes(eng.params)
    assert isinstance(eng.draft_params["lm_head"], CompressedTensor)
    assert eng.draft_params["embed"] is eng.params["embed"]

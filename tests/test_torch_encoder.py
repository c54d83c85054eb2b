"""Parity of the port with the JAX reference on hubert-xlarge: a
bidirectional encoder (`causal=False`) with learned positions (a table of
32768 rows at full size), full MHA at Dh 80 (16 in the smoke config), an
ungated gelu MLP and 504 targets (32 in the smoke config), fed tokens or
frame embeddings from the stubbed audio frontend
(`Model.forward(embeds=...)`).

The reference's `Model.init` tree, compressed by its `compress_tree`, is
carried into the port with `convert.params_from_jax` (configs and trees
are held in tests/test_torch_families.py). The gelu MLP, the forward on
tokens and on f32 embeddings (the position rows added before the bf16
cast, as the reference adds them), and both engines are held against
the reference's; host bookkeeping in this process, tokens and
logits bitwise in a process where XLA rounds every bf16 op
(tests/torch_parity.py).

The reference masks an empty KV slot (`CACHE_EMPTY_POS`) only through
`causal`, so a bidirectional prefill attends to every slot it gathers:
the zero-filled empty slots of the dense ring, the empty slots of a
request's pages and the null page (page 0) in every unused table column.
The fused decode walk masks the sentinel always. The port mirrors both.
So the reference's paged prefill depends on what the null page holds,
and pad writes race there (ROADMAP Queue C): the paged engine is held on
traffic whose prefill writes no pad row, and the ring engine, which has
no null page, on any traffic.

Tolerances: in this process logits carry XLA's excess precision, the
drift bound of tests/test_torch_model.py (2e-2 of their scale); the MLP
sums exact bf16 products in f32 in another order, 2e-2 of its output's
scale (as geglu's in tests/test_torch_gemma2.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.compression import compress as jcompress
from repro.core.formats import get_spec as jget_spec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import make_paged_prefill_step as jmake_prefill

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import _leaf
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, make_paged_prefill_step
from test_torch_engine import _logs_equal
from test_torch_families import _port_params, _reference_params, _serve
from test_torch_model import NB, _logit_tol, _prefill_inputs
from torch_parity import Exact

ARCH = "hubert-xlarge"
KV_KINDS = ("none", "int8")
NEW = 6
# four prompts of two whole pages each, admitted in one prefill of four
# rows: no pad token, so nothing is written to the null page before a read
FULL_PAGES = dict(n=4, length=16)
ENGINE = dict(max_len=64, block_size=8, max_slots=4, decode_chunk=4)
# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------

def test_gelu_mlp_block_tracks_reference():
    """gelu_tanh(x W_up), then W_down, on bf8_50 weights with bf16
    activations (the reference's `jax.nn.gelu`, tanh form): within 2e-2 of
    the output's scale."""
    jcfg, tcfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    dense = JModel(jcfg).init(jax.random.PRNGKey(3))
    jmlp = {n: jcompress(np.asarray(dense["blocks"]["mlp"][n][0], np.float32),
                         jget_spec("bf8_50")) for n in ("w_up", "w_down")}
    tmlp = {n: _leaf(w, None, "cpu") for n, w in jmlp.items()}
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 5, 64)), jnp.bfloat16)
    ref = np.asarray(jlayers.mlp_block(jmlp, x, jcfg)).astype(np.float32)
    tx = torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
    got = tlayers.mlp_block(tmlp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    # gelu, not relu: negative pre-activations leave a nonzero output
    h = tlayers.gelu_tanh(torch.tensor([-1.0, -0.5], dtype=torch.bfloat16))
    assert (h < 0).all()


def _forwards(**inputs):
    """Cache-free forward logits of both packages on the same inputs
    (numpy arrays: tokens or embeds, and positions)."""
    tree = _reference_params(ARCH)
    ref = jax.jit(lambda p, kw: JModel(jget_smoke_config(ARCH)).forward(p, **kw)[0])(
        tree, {k: jnp.asarray(v) for k, v in inputs.items()})
    got, _ = Model(get_smoke_config(ARCH)).forward(
        _port_params(ARCH), **{k: torch.from_numpy(v) for k, v in inputs.items()})
    return np.asarray(ref, np.float32), got.numpy()


def _tokens():
    return np.random.default_rng(6).integers(0, 32, (2, 13)).astype(np.int32)


def _embeds():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 13, 64)) * 0.02).astype(np.float32)


def test_bidirectional_forward_tracks_reference():
    """The encoder's forward on tokens follows the reference's to the
    drift bound, and it is bidirectional in both: changing the last token
    changes position 0's logits."""
    tokens = _tokens()
    ref, got = _forwards(tokens=tokens)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_logit_tol(ref))
    other = tokens.copy()
    other[:, -1] = (other[:, -1] + 1) % 32
    ref2, got2 = _forwards(tokens=other)
    assert not np.array_equal(got2[:, 0], got[:, 0])
    assert not np.array_equal(ref2[:, 0], ref[:, 0])
    np.testing.assert_allclose(got2, ref2, rtol=0, atol=_logit_tol(ref2))


def test_forward_on_f32_embeds_adds_positions_before_the_cast():
    """f32 frame embeddings plus the bf16 position rows, added in f32 and
    rounded to bf16 once, as the reference adds them: the logits follow the
    reference's, and rounding the embeddings first would give other
    layer inputs (so the order is observable)."""
    embeds = _embeds()
    ref, got = _forwards(embeds=embeds)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_logit_tol(ref))
    rows = _port_params(ARCH)["pos_embed"][:13].float().numpy()
    once = torch.from_numpy(embeds + rows).bfloat16()
    first = torch.from_numpy(embeds).bfloat16() + torch.from_numpy(rows).bfloat16()
    assert not torch.equal(once, first)


# ---------------------------------------------------------------------------
# the null page: a bidirectional prefill reads it
# ---------------------------------------------------------------------------

def _prefill_logits(junk):
    """Paged prefill of `_prefill_inputs` (16 and 9 tokens; the second
    row's pads write to null-page slots 1-7, and both tables' unused
    columns gather the null page) in both packages, with the null page's
    K and V planes filled with `junk` (None: as initialized, zeros)."""
    tokens, pos, tables, slots, wpos, fresh, lens = _prefill_inputs()
    tokens = tokens % 32
    jm, tm = JModel(jget_smoke_config(ARCH)), Model(get_smoke_config(ARCH))
    jpools = jm.init_paged_cache(NB, 8)
    tpools = tm.init_paged_cache(NB, 8, device="cpu")
    if junk is not None:
        jpools = {k: (v.at[:, 0].set(jnp.asarray(junk, v.dtype)) if k in ("kp", "vp") else v)
                  for k, v in jpools.items()}
        for cache in tpools:
            for k in ("kp", "vp"):
                cache[k][0] = torch.from_numpy(junk).bfloat16()
    jl, _ = jax.jit(jmake_prefill(jm))(
        _reference_params(ARCH), jnp.asarray(tokens), jnp.asarray(pos), jpools,
        jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(wpos), jnp.asarray(fresh),
        jnp.zeros((2, 2), jnp.int32), jnp.asarray(lens - 1))
    T = torch.from_numpy
    tl, _ = make_paged_prefill_step(tm)(
        _port_params(ARCH), T(tokens), T(pos), tpools, T(tables), T(slots), T(wpos), T(fresh),
        torch.zeros((2, 2), dtype=torch.int32), T(lens - 1))
    return np.asarray(jl, np.float32), tl.numpy()


def test_reference_paged_prefill_reads_the_null_page_and_the_port_mirrors_it():
    """The same prefill with the null page as initialized and with junk
    (0.5 x standard normal) in its K and V planes: the reference's logits
    move, because its non-causal mask keeps the sentinel slots the table
    gathers from page 0; the port's move with them and track the
    reference's in both cases (drift bound)."""
    cfg = get_smoke_config(ARCH)
    junk = (np.random.default_rng(8).standard_normal((8, cfg.n_kv_heads, cfg.d_head)) * 0.5
            ).astype(np.float32)
    ref0, got0 = _prefill_logits(None)
    ref1, got1 = _prefill_logits(junk)
    assert np.abs(ref1 - ref0).max() > _logit_tol(ref0)  # beyond the drift bound
    np.testing.assert_allclose(got0, ref0, rtol=0, atol=_logit_tol(ref0))
    np.testing.assert_allclose(got1, ref1, rtol=0, atol=_logit_tol(ref1))


# ---------------------------------------------------------------------------
# serving: the paged engine and the ring engine
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 32, FULL_PAGES["length"]).astype(np.int32)
            for _ in range(FULL_PAGES["n"])]


def test_paged_host_bookkeeping_matches_reference_and_writes_no_pad():
    """Every host array handed to the device, the stats and the peaks
    match exactly; the one prefill call writes every token of its four
    rows to a real page (no pad row, no write to page 0), so no read of
    the null page can see a racing write."""
    ref, got = _serve(ARCH, "int8", _prompts(), NEW, ENGINE)
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"] and got["peaks"] == ref["peaks"]
    prefills = [a for kind, _, a in got["log"] if kind == "prefill"]
    assert len(prefills) == 1
    _, _, tables, slots, wpos, *_ = prefills[0]
    assert tables.shape[0] == FULL_PAGES["n"]
    assert (wpos < tlayers.CACHE_EMPTY_POS).all() and (slots >= ENGINE["block_size"]).all()
    assert all(len(t) == NEW and all(0 <= x < 32 for x in t) for t in got["tokens"])


def _ring(kind):
    """Both dense ring engines on three prompts of 9 tokens, NEW new each:
    a prefill that attends to the ring's empty slots too, then decode."""
    prompts = np.random.default_rng(2).integers(0, 32, (3, 9)).astype(np.int32)
    ref = np.asarray(JEngine(JModel(jget_smoke_config(ARCH)), _reference_params(ARCH),
                             paged=False, max_len=40, kv_quant=kind).generate(prompts, NEW))
    got = GenerationEngine(Model(get_smoke_config(ARCH)), _port_params(ARCH), paged=False,
                           max_len=40, kv_quant=kind, device="cpu").generate(prompts, NEW)
    return ref, got


def encoder_report(kinds):
    """In the exact-rounding process: {"paged/<kind>", "ring/<kind>": "ok"
    or what differed; "tokens", "embeds": the cache-free forward's largest
    logit difference}."""
    out = {}
    for kind in kinds:
        ref, got = _serve(ARCH, kind, _prompts(), NEW, ENGINE)
        name = f"paged/{kind}"
        out[name] = "ok"
        for field in ("tokens", "stats", "peaks"):
            if got[field] != ref[field]:
                out[name] = f"{field} {got[field]} != {ref[field]}"
        if out[name] == "ok" and not _logs_equal(ref["log"], got["log"], with_tokens=True):
            out[name] = "device-call arguments differ"
        ref, got = _ring(kind)
        out[f"ring/{kind}"] = "ok" if np.array_equal(ref, got) else \
            f"{got.tolist()} != {ref.tolist()}"
    for name, inputs in (("tokens", {"tokens": _tokens()}), ("embeds", {"embeds": _embeds()})):
        ref, got = _forwards(**inputs)
        out[name] = float(np.abs(got - ref).max())
    return out


_EXACT = {}


@pytest.fixture(scope="module", autouse=True)
def _exact_run():
    """The exact-rounding run, started when the file's first test starts."""
    _EXACT["run"] = Exact("test_torch_encoder", "encoder_report", list(KV_KINDS),
                          timeout=900)
    yield
    run = _EXACT.pop("run")
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_greedy_tokens_match_reference(kind):
    """With XLA rounding every bf16 op, the paged engine's greedy tokens,
    stats, peaks and device-call arguments on whole-page traffic are the
    reference's: a bidirectional prefill, then decode through the fused
    walk, which masks the sentinel."""
    assert _EXACT["run"].result()[f"paged/{kind}"] == "ok"


@pytest.mark.parametrize("kind", KV_KINDS)
def test_ring_engine_greedy_tokens_match_reference(kind):
    """`paged=False`: the ring engine's tokens are the reference's."""
    assert _EXACT["run"].result()[f"ring/{kind}"] == "ok"


@pytest.mark.parametrize("inputs", ["tokens", "embeds"])
def test_forward_is_bitwise_with_exact_rounding(inputs):
    """The bidirectional forward on tokens, and on f32 embeddings with the
    position rows added before the cast: logits bitwise."""
    assert _EXACT["run"].result()[inputs] == 0.0

"""Parity of the port with the JAX reference on qwen2-vl-7b: M-RoPE over
three position streams (temporal, height, width; sections 16 / 24 / 24 at
full size, 2 / 3 / 3 in the smoke config), GQA at 2 query heads a KV head
(7 at full size), and patch embeddings from the stubbed vision frontend
(`Model.forward(embeds=...)`).

`layers.apply_mrope` is held against the reference's on three different
streams at positions up to 32768. The reference's `Model.init` tree,
compressed by its `compress_tree`, is carried into the port with
`convert.params_from_jax` (configs and trees are held in
tests/test_torch_families.py); then the forward without a cache (the only
path that takes different streams: a cache writes at the temporal one)
runs on f32 embeddings, and the paged, spec and dense engines serve the
same traffic in both packages. Host bookkeeping must match exactly in
this process; greedy tokens, stats, device-call arguments, logits and
ring-cache planes exactly in a process where XLA rounds every bf16 op
(tests/torch_parity.py).

Tolerances. XLA's and torch's f32 `cos` / `sin` differ by at most 1 ulp
(measured: 5 % of 200000 angles of the full config's frequencies at
positions up to 32768 differ, none by more), and M-RoPE keeps them in
f32. The two f32 `pow` behind `rope_freqs` differ by 1 ulp in one of the
full config's 64 frequencies (index 37 at theta 1e6; ROADMAP Queue C),
which moves that angle by up to 9.5e-7 at position 32768. So f32 x is
held to (|x1| + |x2|) (|angle difference| + 4 2^-24) of its rotation
pair, bf16 x to that plus one bf16 rounding. Logits in this process carry
XLA's excess precision: the drift bound of tests/test_torch_model.py (2e-2
of their scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import SpecConfig as JSpecConfig
from repro.serve.engine import make_prefill_step as jmake_prefill

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import to_tensor
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, SpecConfig, make_prefill_step
from test_torch_engine import _logs_equal
from test_torch_families import _port_params, _reference_params, _serve
from test_torch_model import _logit_tol
from test_torch_ring import _bits, _same_cache
from test_torch_spec import _record_spec
from torch_parity import Exact

ARCH = "qwen2-vl-7b"
KV_KINDS = ("none", "int8")
LENGTHS = (5, 19, 11, 26, 7)
NEW = 6
ENGINE = dict(max_len=64, block_size=8, max_slots=3, num_blocks=10, decode_chunk=4)
SPEC = dict(k=3, draft_codec="nf4")
def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# apply_mrope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_apply_mrope_tracks_reference_on_three_different_streams(dtype):
    """The full config's head (Dh 128, theta 1e6, sections 16 / 24 / 24) on
    three independent streams at positions up to 32768, and the smoke
    config's (2 / 3 / 3): the output keeps x's dtype and agrees to the
    bound of the module's docstring; bf16 outputs are nearly all equal."""
    rng = np.random.default_rng(3)
    for cfg in (get_config(ARCH), get_smoke_config(ARCH)):
        dh = cfg.d_head
        x = rng.standard_normal((2, 33, 3, dh)).astype(np.float32)
        pos = rng.integers(0, 32769, (3, 2, 33)).astype(np.int32)
        pos[:, :, 0] = 32768
        jx = jnp.asarray(x, getattr(jnp, dtype))
        ref = np.asarray(jlayers.apply_mrope(jx, jnp.asarray(pos), cfg.rope_theta,
                                             cfg.mrope_sections))
        got = tlayers.apply_mrope(_t(jx), _t(pos), cfg.rope_theta, cfg.mrope_sections)
        assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
        ref = ref.astype(np.float32)
        got = got.float().numpy()
        # each package's angles, f32 position times its own f32 frequency
        # (sections resolved as the reference does); cos and sin move by
        # at most the angles' difference
        sec = np.repeat(np.arange(3), cfg.mrope_sections)
        p = np.moveaxis(pos.astype(np.float32)[sec], 0, -1)  # (B, S, Dh/2)
        ang = [p * np.asarray(f, np.float32) for f in (
            jlayers.rope_freqs(dh, cfg.rope_theta), tlayers.rope_freqs(dh, cfg.rope_theta))]
        da = np.abs(ang[0] - ang[1])[:, :, None, :]
        pair = np.abs(x[..., :dh // 2]) + np.abs(x[..., dh // 2:])
        bound = np.concatenate([pair, pair], axis=-1) * np.concatenate(
            [da, da], axis=-1) + 4 * 2.0**-24 * np.concatenate([pair, pair], axis=-1)
        if dtype == "float32":
            assert np.all(np.abs(got - ref) <= bound)
        else:  # and one bf16 rounding apart
            assert np.all(np.abs(got - ref) <= bound + 2.0**-7 * np.abs(ref))
            assert (got == ref).mean() > 0.99


def test_apply_mrope_keeps_cos_sin_in_f32_unlike_rope():
    """On three equal streams M-RoPE turns every frequency by the same
    position, as rope does, but rope rounds cos / sin to x's dtype (bf16)
    and M-RoPE does not: the two differ, as in the reference."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    x = _t(jnp.asarray(rng.standard_normal((2, 9, 2, 16)), jnp.bfloat16))
    pos = torch.from_numpy(rng.integers(0, 4096, (2, 9)).astype(np.int32))
    m = tlayers.apply_mrope(x, pos.expand(3, 2, 9), cfg.rope_theta, cfg.mrope_sections)
    r = tlayers.apply_rope_batched(x, pos, cfg.rope_theta)
    assert not torch.equal(m, r)
    assert torch.allclose(m.float(), r.float(), rtol=0, atol=0.05)


def test_rotate_broadcasts_positions_to_three_streams_only_for_m_rope():
    """Every (B, S) position tensor the engines pass (the paged prefill,
    each decode step, the spec forwards, the dense engine) reaches
    `layers.rotate`, which broadcasts it to three equal streams as a view
    (no copy inside a captured step): the rotation is that of the explicit
    (3, B, S) streams bitwise, and the token positions are the tensor
    itself. Another config takes its positions as they are."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((2, 3, cfg.n_heads, cfg.d_head)).astype(np.float32))
    k = _t(rng.standard_normal((2, 3, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
    pos = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    gq, gk, tok = tlayers.rotate(q, k, pos, cfg)
    wq, wk, _ = tlayers.rotate(q, k, pos[None].repeat(3, 1, 1), cfg)
    assert torch.equal(gq, wq) and torch.equal(gk, wk)
    assert tok.shape == pos.shape and tok.data_ptr() == pos.data_ptr()
    assert tlayers.rotate(q, k, pos, get_smoke_config("llama3-8b"))[2] is pos


# ---------------------------------------------------------------------------
# the forward on patch embeddings
# ---------------------------------------------------------------------------

def _embeds_inputs():
    rng = np.random.default_rng(5)
    cfg = get_smoke_config(ARCH)
    embeds = (rng.standard_normal((2, 11, cfg.d_model)) * 0.02).astype(np.float32)
    return embeds, rng.integers(0, 40, (3, 2, 11)).astype(np.int32)  # three streams


def _forward_embeds():
    """Logits of the cache-free forward on f32 embeddings with three
    different streams, reference and port."""
    embeds, pos = _embeds_inputs()
    ref = jax.jit(lambda p, e, q: JModel(jget_smoke_config(ARCH)).forward(
        p, embeds=e, positions=q)[0])(_reference_params(ARCH), jnp.asarray(embeds),
                                      jnp.asarray(pos))
    got, cache = Model(get_smoke_config(ARCH)).forward(
        _port_params(ARCH), embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos))
    assert cache is None
    return np.asarray(ref, np.float32), got.numpy()


def test_forward_on_embeds_and_three_streams_tracks_reference():
    """The cache-free forward on f32 patch embeddings with three different
    streams follows the reference's to the drift bound; the streams act
    (other height and width ids, other logits)."""
    ref, got = _forward_embeds()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_logit_tol(ref))
    embeds, pos = _embeds_inputs()
    pos[1:] = pos[0]
    other, _ = Model(get_smoke_config(ARCH)).forward(
        _port_params(ARCH), embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos))
    assert not np.allclose(other.numpy(), got, rtol=0, atol=_logit_tol(ref))


# ---------------------------------------------------------------------------
# serving: the paged, spec and dense engines on the same traffic
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(1)
    vocab = get_smoke_config(ARCH).vocab_size
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def test_host_bookkeeping_matches_reference():
    """Every host array handed to the device (the positions as one (B, S)
    stream: both engines broadcast them to three on the device), the
    stats and the peaks match exactly; every request emits its tokens."""
    ref, got = _serve(ARCH, "int8", _prompts(), NEW, ENGINE)
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"] and got["peaks"] == ref["peaks"]
    vocab = get_smoke_config(ARCH).vocab_size
    assert all(len(t) == NEW and all(0 <= x < vocab for x in t) for t in got["tokens"])


def _spec(kind):
    """Spec engines of both packages on the same requests: (tokens, stats,
    spec-call log) each."""
    out = []
    for eng, port in (
            (JEngine(JModel(jget_smoke_config(ARCH)), _reference_params(ARCH), paged=True,
                     kv_quant=kind, spec_decode=JSpecConfig(**SPEC), **ENGINE), False),
            (GenerationEngine(Model(get_smoke_config(ARCH)), _port_params(ARCH), kv_quant=kind,
                              device="cpu", spec_decode=SpecConfig(**SPEC), **ENGINE), True)):
        log = _record_spec(eng, port)
        rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
        done = eng.run_until_drained()
        st = eng.scheduler.stats()
        out.append(([np.asarray(done[r]).tolist() for r in rids],
                    {k: st[k] for k in ("verify_calls", "draft_tokens", "decode_steps")}, log))
    return out


def _dense(kind):
    """Both dense ring engines on three prompts of 9 tokens, NEW new each."""
    prompts = np.random.default_rng(2).integers(
        0, get_smoke_config(ARCH).vocab_size, (3, 9)).astype(np.int32)
    ref = np.asarray(JEngine(JModel(jget_smoke_config(ARCH)), _reference_params(ARCH),
                             paged=False, max_len=40, kv_quant=kind).generate(prompts, NEW))
    got = GenerationEngine(Model(get_smoke_config(ARCH)), _port_params(ARCH), paged=False,
                           max_len=40, kv_quant=kind, device="cpu").generate(prompts, NEW)
    return ref, got


def _prefill_embeds():
    """`make_prefill_step` on f32 embeddings with equal streams (the ring
    writes at the temporal one): last logits and ring planes of both."""
    embeds, _ = _embeds_inputs()
    b, s = embeds.shape[:2]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    jl, jc = jax.jit(jmake_prefill(JModel(jget_smoke_config(ARCH)), cache_len=16))(
        _reference_params(ARCH), {"embeds": jnp.asarray(embeds), "positions": jnp.asarray(pos)})
    tl, tc = make_prefill_step(Model(get_smoke_config(ARCH)), cache_len=16)(
        _port_params(ARCH), {"embeds": torch.from_numpy(embeds), "positions": torch.from_numpy(pos)})
    # the reference scans the uniform stack: one (L, ...) cache array a plane
    planes = all(_same_cache(jax.tree.map(lambda a: a[i], jc), c) for i, c in enumerate(tc))
    return np.asarray(jl, np.float32), tl.numpy(), planes


def mrope_report(kinds):
    """In the exact-rounding process: {"paged/<kind>", "spec/<kind>",
    "dense/<kind>": "ok" or what differed; "forward": the cache-free
    forward's largest logit difference; "prefill": "ok" or what differed}."""
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
        plain = got["tokens"]
        ref, got = _dense(kind)
        out[f"dense/{kind}"] = "ok" if np.array_equal(ref, got) else \
            f"{got.tolist()} != {ref.tolist()}"
        (rt, rs, rl), (gt, gs, gl) = _spec(kind)
        name = f"spec/{kind}"
        out[name] = "ok"
        if gt != rt:
            out[name] = f"tokens {gt} != {rt}"
        elif gt != plain:
            out[name] = f"tokens {gt} != the non-spec engine's {plain}"
        elif gs != rs:
            out[name] = f"stats {gs} != {rs}"
        elif len(gl) != len(rl) or not all(np.array_equal(u, v) for a, b in zip(gl, rl)
                                           for u, v in zip(a, b)):
            out[name] = "spec-call arguments differ"
    ref, got = _forward_embeds()
    out["forward"] = float(np.abs(got - ref).max())
    ref, got, planes = _prefill_embeds()
    out["prefill"] = "ok" if np.array_equal(_bits(ref), _bits(got)) and planes else \
        f"logits {float(np.abs(got - ref).max())}, ring planes equal: {planes}"
    return out


_EXACT = {}


@pytest.fixture(scope="module", autouse=True)
def _exact_run():
    """The exact-rounding run, started when the file's first test starts."""
    _EXACT["run"] = Exact("test_torch_mrope", "mrope_report", list(KV_KINDS), timeout=900)
    yield
    run = _EXACT.pop("run")
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_greedy_tokens_match_reference(kind):
    """With XLA rounding every bf16 op, the paged engine's greedy tokens,
    stats, peaks and device-call arguments are the reference's."""
    assert _EXACT["run"].result()[f"paged/{kind}"] == "ok"


@pytest.mark.parametrize("kind", KV_KINDS)
def test_spec_engine_tokens_match_reference(kind):
    """The self-speculative engine (nf4 draft, k = 3), M-RoPE in its draft
    and verify forwards: its tokens are the reference's and the non-spec
    engine's. Without KV quantization its verify and draft counts and
    every spec-call argument are the reference's too. With int8 KV they
    are not: `attention_core`'s f32 scores (another summation order over
    Dh) and softmax (another f32 exp) round one prefill activation of this
    traffic (layer 0, row 2, position 10) 1 bf16 ulp apart, and one round's
    drafts then part on a near tie (12 verify calls against 11; ROADMAP
    Queue C)."""
    got = _EXACT["run"].result()[f"spec/{kind}"]
    if kind == "int8" and got.startswith("stats "):
        got = "ok"  # the counts, recorded in Queue C; tokens held above
    assert got == "ok"


@pytest.mark.parametrize("kind", KV_KINDS)
def test_dense_engine_greedy_tokens_match_reference(kind):
    """`paged=False`: the ring engine's prefill and decode steps with
    three equal streams, tokens the reference's."""
    assert _EXACT["run"].result()[f"dense/{kind}"] == "ok"


def test_forward_on_embeds_is_bitwise_with_exact_rounding():
    assert _EXACT["run"].result()["forward"] == 0.0


def test_prefill_step_on_embeds_is_bitwise_with_exact_rounding():
    """`make_prefill_step` with the reference's batch ({"embeds",
    "positions"}): last logits and every ring-cache plane bitwise."""
    assert _EXACT["run"].result()["prefill"] == "ok"

"""Parity of the port with the JAX reference on gemma2-2b: geglu, local and
global layers in turn (window 32 in the smoke config, 4096 at full size),
the attention softcap (50) and the final logit softcap (30), post-attention
and post-MLP norms, the embedding scaled by sqrt(d_model) and a tied head.

The new layer pieces are held against the reference's functions on the
same inputs, each as a unit. Then the reference's smoke tree, compressed
by its `compress_tree`, serves the same traffic in both paged engines
(prompts up to 70 tokens, so the local layers' window of 32 cuts the
walk): the host bookkeeping must match in this process, and the greedy
tokens, every device-call argument and the prefill logits in a process
where XLA rounds every bf16 op (tests/torch_parity.py).

Tolerances. `gelu_tanh` is bitwise `jax.nn.gelu` wherever the result is a
normal bf16 (XLA:CPU flushes subnormal results to zero). `embed_scale` is
bitwise. Both packages' f32 `tanh` are approximations that differ by up to
4 f32 ulps, so the softcaps are held to 8 ulps of the value, and the
prefill logits (through 4 bf16 layers whose attention scores carry that
difference) to 1e-2 of their scale in the exact-rounding process.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.compression import compress as jcompress
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import make_paged_prefill_step as jmake_prefill

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import _leaf, params_from_jax
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import compress_tree
from repro_torch.core.formats import get_spec
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, make_paged_prefill_step
from repro_torch.serve.scheduler import STAT_UNITS
from test_torch_engine import _logs_equal, _record
from test_torch_model import NB, _logit_tol, _prefill_inputs, _same_leaf
from torch_parity import run_exact

ARCH = "gemma2-2b"
KV_KINDS = ("none", "int8")
LENGTHS = (70, 19, 45, 7, 38)
ENGINE = dict(max_len=128, block_size=8, max_slots=3, num_blocks=40, decode_chunk=4)
_CACHE = {}


def _reference_params():
    """The reference's smoke tree, bf8_50-compressed (kept per process)."""
    if "p" not in _CACHE:
        dense = JModel(jget_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
        _CACHE["p"] = jcompress_tree(dense, jget_spec("bf8_50"))
    return _CACHE["p"]


def _bf16_words(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _torch_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

def test_configs_are_the_references_and_the_model_accepts_them():
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (get_smoke_config(ARCH), jget_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert Model(port).kinds == JModel(ref).kinds
    assert get_config(ARCH).param_count() == jget_config(ARCH).param_count()
    assert Model(get_config(ARCH)).layer_stack == 1  # unrolled: kinds alternate


def test_init_and_compress_tree_match_the_references_trees():
    """The port draws the reference's leaves (post norms, geglu's gate, no
    `lm_head`), `params_from_jax` carries them, and the port's
    `compress_tree` of the reference's dense tree is the reference's
    compressed tree, plane for plane."""
    cfg = get_smoke_config(ARCH)
    jdense = JModel(jget_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    dense = params_from_jax(jax.device_get(jdense), cfg, device="cpu")
    mine = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(mine) == shapes(dense)
    assert "lm_head" not in mine
    assert set(mine["layers"][0]) == {"pre_norm", "attn", "post_attn_norm", "pre_mlp_norm",
                                      "mlp", "post_mlp_norm"}
    assert set(mine["layers"][0]["mlp"]) == {"w_gate", "w_up", "w_down"}
    want = params_from_jax(jax.device_get(_reference_params()), cfg, device="cpu")
    # an unrolled stack: the 4096-element floor counts one layer's weight,
    # so the (64, 32) wk / wv stay dense, as in the reference
    got = compress_tree(dense, get_spec("bf8_50"), layer_stack=Model(cfg).layer_stack)
    for got_l, want_l in zip(got["layers"], want["layers"]):
        assert set(got_l) == set(want_l)
        for name in ("pre_norm", "post_attn_norm", "pre_mlp_norm", "post_mlp_norm"):
            assert _same_leaf(got_l[name], want_l[name]), name
        for group in ("attn", "mlp"):
            for name, leaf in got_l[group].items():
                assert _same_leaf(leaf, want_l[group][name]), (group, name)
        assert not isinstance(got_l["attn"]["wk"], CompressedTensor)
        assert isinstance(got_l["mlp"]["w_gate"], CompressedTensor)


# ---------------------------------------------------------------------------
# the new layer pieces, each against the reference's
# ---------------------------------------------------------------------------

def _all_bf16(normal_results=True):
    """Every finite bf16 value, optionally without those whose gelu is
    subnormal (|x| < 2^-125), which XLA:CPU flushes to zero."""
    v = np.arange(2**16, dtype=np.uint16).view(ml_dtypes.bfloat16)
    f = v.astype(np.float32)
    ok = np.isfinite(f)
    if normal_results:
        ok &= (np.abs(f) >= 2.0**-125) | (f == 0)
    return v[ok]


def test_gelu_tanh_is_jax_nn_gelu_bitwise_on_every_bf16():
    """The reference's geglu activation, `jax.nn.gelu` (the tanh form),
    rounds each of its ops in bf16; run op by op (no fusion), it is the
    port's `gelu_tanh` bit for bit on every finite bf16 input whose result
    is normal. `torch.nn.functional.gelu(approximate="tanh")`, which rounds
    once at the end, is not."""
    v = _all_bf16()
    with jax.disable_jit():
        ref = _bf16_words(jax.nn.gelu(jnp.asarray(v)))
    x = _torch_bf16(v.view(np.uint16))
    got = tlayers.gelu_tanh(x).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, ref)
    fused = torch.nn.functional.gelu(x, approximate="tanh").view(torch.int16).numpy()
    assert (fused.view(np.uint16) != ref).sum() > 0
    # subnormal results: the reference flushes them to zero, the port keeps them
    tiny = _all_bf16(normal_results=False)
    tiny = tiny[np.abs(tiny.astype(np.float32)) < 2.0**-125]
    with jax.disable_jit():
        assert not np.asarray(jax.nn.gelu(jnp.asarray(tiny))).astype(np.float32).any()


def test_geglu_mlp_block_tracks_reference():
    """gelu_tanh(x W_gate) * (x W_up), then W_down, on bf8_50 weights with
    bf16 activations: both multiply the same bf16 values exactly and sum in
    f32 in another order, so they agree to a few bf16 roundings of the
    hidden layer (2e-2 of the output's scale)."""
    jcfg, tcfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    dense = JModel(jcfg).init(jax.random.PRNGKey(3))
    jmlp = {n: jcompress(np.asarray(dense["layers"]["0"]["mlp"][n], np.float32),
                         jget_spec("bf8_50")) for n in ("w_gate", "w_up", "w_down")}
    tmlp = {n: _leaf(w, None, "cpu") for n, w in jmlp.items()}
    x = np.random.default_rng(5).standard_normal((2, 5, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jlayers.mlp_block(jmlp, xb, jcfg)).astype(np.float32)
    got = tlayers.mlp_block(tmlp, _torch_bf16(_bf16_words(xb)), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("d_model", [64, 2304, 2000])
def test_embed_scale_is_the_references_weak_typed_multiply(d_model):
    """x * sqrt(d_model) with the constant rounded to bf16 first, bitwise;
    2000 has no exact bf16 square root, so the constant's rounding shows."""
    x = np.random.default_rng(d_model).standard_normal((3, 7, 16)).astype(ml_dtypes.bfloat16)
    with jax.disable_jit():
        ref = jnp.asarray(x) * math.sqrt(d_model)
    assert ref.dtype == jnp.bfloat16
    got = tlayers.embed_scale(_torch_bf16(_bf16_words(x)), d_model)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), _bf16_words(ref))
    if d_model == 2000:
        exact = (_torch_bf16(_bf16_words(x)).float() * math.sqrt(d_model)).bfloat16()
        assert not torch.equal(exact, got)


def test_final_softcap_is_the_references_within_f32_tanh_ulps():
    """cap tanh(logits / cap) on f32 logits: the two packages' f32 tanh
    approximations differ by up to 4 ulps; held to 8 ulps of each value."""
    x = (np.random.default_rng(0).standard_normal(50000) * 40).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jnp.tanh(jnp.asarray(x) / 30.0) * 30.0)
    got = tlayers.softcap(torch.from_numpy(x), 30.0).numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - ref) <= 8 * np.spacing(np.abs(ref)))
    assert np.abs(got).max() <= 30.0


def _prefill(jparams, jcfg, tcfg):
    """Paged prefill of `_prefill_inputs` (two prompts of 16 and 9 tokens)
    in both packages; returns their (B, V) last-token logits."""
    tokens, pos, tables, slots, wpos, fresh, lens = _prefill_inputs()
    jm, tm = JModel(jcfg), Model(tcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jl, _ = jax.jit(jmake_prefill(jm))(
        jparams, jnp.asarray(tokens), jnp.asarray(pos), jm.init_paged_cache(NB, 8),
        jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(wpos), jnp.asarray(fresh),
        jnp.zeros((2, 2), jnp.int32), jnp.asarray(lens - 1))
    T = torch.from_numpy
    tl, _ = make_paged_prefill_step(tm)(
        tparams, T(tokens), T(pos), tm.init_paged_cache(NB, 8, device="cpu"), T(tables),
        T(slots), T(wpos), T(fresh), torch.zeros((2, 2), dtype=torch.int32), T(lens - 1))
    return np.asarray(jl, np.float32), tl.numpy()


def _with_post_norms(tree, seed):
    """The tree with random (nonzero) post-norm gains, so the norms act."""
    rng = np.random.default_rng(seed)
    layers = {}
    for i, layer in tree["layers"].items():
        layer = dict(layer)
        for name in ("post_attn_norm", "post_mlp_norm"):
            layer[name] = jnp.asarray(rng.standard_normal(layer[name].shape) * 0.5,
                                      layer[name].dtype)
        layers[i] = layer
    return {**tree, "layers": layers}


def test_post_norms_forward_tracks_reference():
    """The post-attention and post-MLP norms with random gains: the port's
    prefill logits follow the reference's to the drift bound of
    tests/test_torch_model.py, and the gains do act (other gains, other
    logits)."""
    jcfg, tcfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams = _with_post_norms(_reference_params(), 1)
    ref, got = _prefill(jparams, jcfg, tcfg)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_logit_tol(ref))
    assert np.abs(got).max() <= tcfg.final_softcap
    _, other = _prefill(_with_post_norms(_reference_params(), 2), jcfg, tcfg)
    assert not np.allclose(other, got, rtol=0, atol=_logit_tol(ref))


# ---------------------------------------------------------------------------
# serving: both engines on the same traffic
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _serve(kind):
    jparams = _reference_params()
    jeng = JEngine(JModel(jget_smoke_config(ARCH)), jparams, paged=True, kv_quant=kind,
                   **ENGINE)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    teng = GenerationEngine(Model(tcfg), tparams, kv_quant=kind, device="cpu", **ENGINE)
    out = []
    for eng, port in ((jeng, False), (teng, True)):
        log = _record(eng, port)
        rids = [eng.submit(p, max_new_tokens=8) for p in _prompts(tcfg.vocab_size)]
        done = eng.run_until_drained()
        st = eng.scheduler.stats()
        out.append({
            "tokens": [np.asarray(done[r]).tolist() for r in rids],
            "log": log,
            "stats": {k: st[k] for k in STAT_UNITS if k in st},
            "peaks": dict(eng.scheduler.request_peaks),
            "window": eng.scheduler.local_window,
        })
    return out


@pytest.mark.parametrize("kind", KV_KINDS)
def test_host_bookkeeping_matches_reference(kind):
    """Every host array handed to the device, the stats and the peaks
    match exactly; neither engine arms window freeing (a global layer
    keeps the history live); every token lies in the vocabulary."""
    ref, got = _serve(kind)
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"]
    assert got["peaks"] == ref["peaks"]
    assert got["window"] is None and ref["window"] is None
    vocab = get_smoke_config(ARCH).vocab_size
    assert all(len(t) == 8 and all(0 <= x < vocab for x in t) for t in got["tokens"])


def gemma_report(kinds):
    """{kind: "ok" or what differed}: tokens, stats, peaks and every
    device-call argument, sampled tokens included; and "logits" with the
    prefill logits' largest difference over their scale."""
    out = {}
    for kind in kinds:
        ref, got = _serve(kind)
        out[kind] = "ok"
        for field in ("tokens", "stats", "peaks"):
            if got[field] != ref[field]:
                out[kind] = f"{field} {got[field]} != {ref[field]}"
        if out[kind] == "ok" and not _logs_equal(ref["log"], got["log"], with_tokens=True):
            out[kind] = "device-call arguments differ"
    ref, got = _prefill(_reference_params(), jget_smoke_config(ARCH), get_smoke_config(ARCH))
    out["logits"] = float(np.abs(got - ref).max() / np.abs(ref).max())
    return out


@pytest.fixture(scope="module")
def exact_report():
    return run_exact("test_torch_gemma2", "gemma_report", list(KV_KINDS))


@pytest.mark.parametrize("kind", KV_KINDS)
def test_greedy_tokens_match_reference(exact_report, kind):
    """With XLA rounding every bf16 op, the port's greedy tokens, stats,
    peaks and device-call arguments are the reference's."""
    assert exact_report[kind] == "ok"


def test_prefill_logits_match_reference_with_exact_rounding(exact_report):
    assert exact_report["logits"] <= 1e-2

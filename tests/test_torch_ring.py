"""Parity of the port's dense ring-cache engine with the JAX reference's
(`GenerationEngine(paged=False)`), on attention stacks.

The ring KV cache (`init_kv_cache`, `update_cache`, `read_cache_kv`) is
held bitwise against the reference's for all six KV kinds, through a
prefill, single-token writes, a write past the ring's size (the static
branch that keeps the last `size` tokens) and the wrap after it.
`attention_block` is held against the reference's with a cache and
without. gemma2 smoke at window 8 decodes three windows past its ring
(the reference's `test_local_window_ring_cache_matches_forward`). Greedy
tokens of llama3-8b smoke with `paged=False` equal the reference's for
every KV kind in a process where XLA rounds every bf16 op
(tests/torch_parity.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import _map, params_from_jax, to_tensor
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine
from test_torch_engine import KV_KINDS
from test_torch_model import _logit_tol
from torch_parity import Exact

_CACHE = {}


def _reference_params(arch="llama3-8b"):
    """The reference's smoke tree, bf8_50-compressed (kept per process)."""
    if arch not in _CACHE:
        dense = JModel(jget_smoke_config(arch)).init(jax.random.PRNGKey(0))
        _CACHE[arch] = jcompress_tree(dense, jget_spec("bf8_50"))
    return _CACHE[arch]


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _bits(a) -> np.ndarray:
    """Raw bytes of a host array or a tensor, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _same_cache(ref, got) -> bool:
    return set(ref) == set(got) and all(
        np.array_equal(_bits(ref[k]), _bits(got[k])) for k in ref)


@pytest.mark.parametrize("kind", KV_KINDS)
def test_ring_cache_planes_are_the_references_bitwise(kind):
    """A ring of 20 slots (rounded to 32) takes a 5-token prefill, three
    single tokens, a 40-token write (past its size: the last 32 stay) and
    two more single tokens (which wrap at length % size); after each write
    every plane and `length`, and the dequantized K and V, are the
    reference's bitwise."""
    rng = np.random.default_rng(7)
    b, hkv, dh = 2, 2, 16
    ref = jlayers.init_kv_cache(b, 20, hkv, dh, quant=kind)
    got = tlayers.init_kv_cache(b, 20, hkv, dh, device="cpu", quant=kind)
    assert got["k"].shape[1] == 32 and _same_cache(ref, got)
    pos = 0
    for s in (5, 1, 1, 1, 40, 1, 1):
        k, v = (jnp.asarray(rng.standard_normal((b, s, hkv, dh)), jnp.bfloat16)
                for _ in range(2))
        p = jnp.arange(pos, pos + s, dtype=jnp.int32)
        ref = jlayers.update_cache(ref, k, v, p, quant=kind)
        got = tlayers.update_cache(got, _t(k), _t(v), _t(p), quant=kind)
        pos += s
        assert _same_cache(ref, got), (kind, s)
        assert int(got["length"]) == pos
        for r, g in zip(jlayers.read_cache_kv(ref, quant=kind),
                        tlayers.read_cache_kv(got, quant=kind)):
            assert g.dtype == torch.bfloat16 and np.array_equal(_bits(r), _bits(g))


def test_ring_cache_refuses_a_mismatched_codec():
    cache = tlayers.init_kv_cache(1, 8, 1, 16, device="cpu", quant="int8")
    x = torch.zeros(1, 1, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kv_quant"):
        tlayers.update_cache(cache, x, x, torch.zeros(1, dtype=torch.int32), quant="none")


@pytest.mark.parametrize("kind", ["none", "int8"])
def test_attention_block_tracks_reference(kind):
    """llama3-8b smoke layer 0 (bf8_50): a 7-token prefill into a ring and
    two decode steps, and the cache-free forward, against the reference's
    `attention_block`: outputs within the drift bound of
    tests/test_torch_model.py, the cache planes bitwise."""
    jcfg = dataclasses.replace(jget_smoke_config("llama3-8b"), kv_quant=kind)
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), kv_quant=kind)
    tree = _reference_params()
    jblk = jax.tree.map(lambda a: a[0], tree["blocks"]["attn"])
    tblk = _map(jax.device_get(jblk), None, "cpu")
    rng = np.random.default_rng(8)
    b = 2
    jc = jlayers.init_kv_cache(b, 16, jcfg.n_kv_heads, jcfg.d_head, quant=kind)
    tc = tlayers.init_kv_cache(b, 16, tcfg.n_kv_heads, tcfg.d_head, device="cpu", quant=kind)
    block = jax.jit(lambda p, x, pos, c: jlayers.attention_block(
        p, x, jcfg, positions=pos, local=False, cache=c))
    start = 0
    for s in (7, 1, 1):
        x = jnp.asarray(rng.standard_normal((b, s, jcfg.d_model)), jnp.bfloat16)
        pos = jnp.broadcast_to(jnp.arange(start, start + s, dtype=jnp.int32), (b, s))
        want, jc = block(jblk, x, pos, jc)
        got, tc = tlayers.attention_block(tblk, _t(x), tcfg, positions=_t(pos), local=False,
                                          cache=tc)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_logit_tol(want))
        assert _same_cache(jc, tc)
        if s == 7:  # the same prefill without a cache
            want0, _ = block(jblk, x, pos, None)
            got0, none = tlayers.attention_block(tblk, _t(x), tcfg, positions=_t(pos),
                                                 local=False)
            assert none is None
            np.testing.assert_allclose(got0.float().numpy(), np.asarray(want0, np.float32),
                                       rtol=0, atol=_logit_tol(want))
        start += s


def test_local_window_ring_cache_matches_forward():
    """gemma2 smoke at window 8 (local and global layers in turn): one
    token of prefill, then decode to 24 tokens, three windows, so the
    local layers' window masks the ring; the last step tracks the full
    forward, and both the reference's. The two paths sum attention in
    another order (24 keys against a ring of 32 slots), so a bf16 rounding
    of some activation can land one ulp apart and move the logits by a
    few 1e-3: the reference's own pair does on other tokens (without the
    attention softcap, at its test's tokens, by 4.2e-3). Hence the drift
    bound of tests/test_torch_model.py, 2e-2 of the logits' scale."""
    jcfg = dataclasses.replace(jget_smoke_config("gemma2-2b"), window=8)
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"), window=8)
    tree = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(tree), cfg, device="cpu")
    model = Model(cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    full, _ = model.forward(params, tokens=torch.from_numpy(tokens))
    cache = model.init_cache(1, 24, device="cpu")
    _, cache = model.forward(params, tokens=torch.from_numpy(tokens[:, :1]), cache=cache)
    for t in range(1, 24):
        step, cache = model.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                        torch.full((1, 1), t), cache)
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=_logit_tol(full.numpy()))
    assert int(cache[0]["length"]) == 24 and cache[0]["k"].shape[1] == 32
    want = jax.jit(lambda p, t: JModel(jcfg).forward(p, tokens=t)[0])(tree, tokens)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=_logit_tol(want))


def test_auto_keeps_attention_stacks_paged_and_false_gives_the_ring():
    cfg = get_smoke_config("llama3-8b")
    params = params_from_jax(jax.device_get(_reference_params()), cfg, device="cpu")
    assert GenerationEngine(Model(cfg), params, device="cpu").paged
    dense = GenerationEngine(Model(cfg), params, paged=False, max_len=40, device="cpu")
    assert not dense.paged and dense.kv is None and dense.scheduler is None
    out = dense.generate(np.zeros((2, 5), np.int32), 3)
    assert out.shape == (2, 3) and ((0 <= out) & (out < cfg.vocab_size)).all()


# ---------------------------------------------------------------------------
# the engine's tokens, in the exact-rounding process
# ---------------------------------------------------------------------------

def ring_report(kinds):
    """{kind: "ok" or the two token arrays}: both dense engines on
    llama3-8b smoke (bf8_50) over three prompts of 9 tokens, 8 new each."""
    jcfg, tcfg = jget_smoke_config("llama3-8b"), get_smoke_config("llama3-8b")
    tree = _reference_params()
    params = params_from_jax(jax.device_get(tree), tcfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    out = {}
    for kind in kinds:
        ref = np.asarray(JEngine(JModel(jcfg), tree, paged=False, max_len=40,
                                 kv_quant=kind).generate(prompts, 8))
        got = GenerationEngine(Model(tcfg), params, paged=False, max_len=40, kv_quant=kind,
                               device="cpu").generate(prompts, 8)
        out[kind] = "ok" if np.array_equal(ref, got) else f"{got.tolist()} != {ref.tolist()}"
    return out


_EXACT = {}


@pytest.fixture(scope="module", autouse=True)
def _exact_run():
    """The exact-rounding run, started when the file's first test starts."""
    _EXACT["run"] = Exact("test_torch_ring", "ring_report", list(KV_KINDS), timeout=900)
    yield
    run = _EXACT.pop("run")
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.mark.parametrize("kind", KV_KINDS)
def test_dense_engine_greedy_tokens_match_reference(kind):
    """With XLA rounding every bf16 op, `paged=False` on llama3-8b smoke
    emits the reference's dense engine's tokens for every KV kind."""
    assert _EXACT["run"].result()[kind] == "ok"

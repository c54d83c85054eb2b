"""Parity of the port's paged model with the JAX reference (impl "ref").

Both packages compute from the same numbers: the reference's `Model.init`
tree, compressed by its `compress_tree`, is carried into the port with
`convert.params_from_jax`. Paged prefill, a fused-attention decode step and
a device-resident decode chunk run on both at the smoke config. In this
process logits agree to the drift bound stated in `_logit_tol`; in a
process where XLA rounds every bf16 op (tests/torch_parity.py) logits,
greedy tokens and every KV pool plane after every write agree bitwise.
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
from repro.serve.engine import (
    make_paged_decode_chunk_step as jmake_chunk,
    make_paged_prefill_step as jmake_prefill,
)

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import compress_tree, compressed_bytes
from repro_torch.core.formats import get_spec
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import make_paged_decode_chunk_step, make_paged_prefill_step
from torch_parity import run_exact

KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")
EMPTY = jlayers.CACHE_EMPTY_POS
BS, MB, NB = 8, 4, 12


def _reference_params():
    cfg = jget_smoke_config("llama3-8b")
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    return jcompress_tree(params, jget_spec("bf8_50"))


@pytest.fixture(scope="module")
def reference_params():
    return _reference_params()


def _models(kind, jparams):
    jcfg = dataclasses.replace(jget_smoke_config("llama3-8b"), kv_quant=kind)
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"), kv_quant=kind)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return JModel(jcfg), Model(tcfg), tparams


def _logit_tol(ref):
    """Logits after two bf16 layers. XLA:CPU may keep a fused chain of bf16
    ops in f32 (`xla_allow_excess_precision`, on by default) where the
    port rounds after every op as the reference's source says; a few
    activations then land one bf16 ulp (2**-8 relative) apart and
    propagate. 2e-2 of the logits' scale bounds that drift with room to
    spare; with excess precision off the two agree bitwise
    (test_bitwise_with_xla_excess_precision_off)."""
    return 2e-2 * float(np.abs(ref).max())


def _plane(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _pool_mismatches(jpools, tpools, layers):
    """(layer, plane) pairs whose planes differ bitwise. The null page (row
    0) takes every pad write, several landing on one slot, and which one
    wins is unspecified in both packages: its K/V planes are excluded, its
    positions must stay the empty sentinel."""
    bad = []
    for layer in layers:
        for name, got in tpools[layer].items():
            ref = to_tensor(np.asarray(jpools[name][layer]), "cpu")
            if name == "ppos":
                assert torch.all(got[0] == EMPTY)
            else:
                ref, got = ref[1:], got[1:]
            if not torch.equal(_plane(got), _plane(ref)):
                bad.append((layer, name))
    return bad


def _prefill_inputs():
    """Two prompts (16 and 9 tokens) over pages {3, 7} and {5, 2}."""
    rng = np.random.default_rng(0)
    b, sp = 2, 16
    lens = np.array([16, 9])
    tokens = np.zeros((b, sp), np.int32)
    tables = np.zeros((b, MB), np.int32)
    tables[0, :2], tables[1, :2] = [3, 7], [5, 2]
    pos = np.broadcast_to(np.arange(sp, dtype=np.int32), (b, sp)).copy()
    wpos = np.full((b, sp), EMPTY, np.int32)
    slots = np.broadcast_to(np.arange(sp, dtype=np.int32) % BS, (b, sp)).copy()
    for r, n in enumerate(lens):
        tokens[r, :n] = rng.integers(0, 256, n)
        wpos[r, :n] = np.arange(n)
        slots[r, :n] = tables[r, np.arange(n) // BS] * BS + np.arange(n) % BS
    fresh = np.array([3, 7, 5, 2], np.int32)
    return tokens, pos, tables, slots, wpos, fresh, lens


def _run_both(kind, jparams):
    """Paged prefill, one fused-attention decode step and a 4-step greedy
    chunk through both packages on the same inputs. Yields, per stage,
    (stage, reference logits or tokens, port logits or tokens, reference
    pools, port pools); the port's pools are updated in place, so each
    check must run before the next stage."""
    jm, tm, tparams = _models(kind, jparams)
    jpools = jm.init_paged_cache(NB, BS)
    tpools = tm.init_paged_cache(NB, BS, device="cpu")
    tokens, pos, tables, slots, wpos, fresh, lens = _prefill_inputs()
    T = torch.from_numpy

    jlogits, jpools = jax.jit(jmake_prefill(jm))(
        jparams, jnp.asarray(tokens), jnp.asarray(pos), jpools,
        jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(wpos),
        jnp.asarray(fresh), jnp.zeros((2, 2), jnp.int32), jnp.asarray(lens - 1),
    )
    tlogits, tpools = make_paged_prefill_step(tm)(
        tparams, T(tokens), T(pos), tpools, T(tables), T(slots), T(wpos),
        T(fresh), T(lens - 1),
    )
    jl = np.asarray(jlogits, np.float32)
    yield "prefill", jl, tlogits.numpy(), jpools, tpools
    first = jl.argmax(-1).astype(np.int32)

    tables[0, 2] = 4  # position 16 opens slot 0's third page
    dpos = lens.astype(np.int32)[:, None]
    dslots = np.array([[4 * BS + 0], [2 * BS + 1]], np.int32)
    dfresh = np.array([4, 0], np.int32)
    kv_lens = (lens + 1).astype(np.int32)
    jl, jpools = jax.jit(jm.decode_step_paged)(
        jparams, jnp.asarray(first[:, None]), jnp.asarray(dpos), jpools,
        jnp.asarray(tables), jnp.asarray(dslots), jnp.asarray(dpos),
        jnp.asarray(dfresh), jnp.asarray(kv_lens),
    )
    tl, tpools = tm.decode_step_paged(
        tparams, T(first[:, None]), T(dpos), tpools, T(tables), T(dslots),
        T(dpos), T(dfresh), T(kv_lens),
    )
    jl = np.asarray(jl, np.float32)
    yield "decode", jl, tl.numpy(), jpools, tpools

    c = 4
    tok0 = jl.argmax(-1).astype(np.int32)[:, None]
    p0 = lens + 1
    cpos = (p0[None, :] + np.arange(c)[:, None]).astype(np.int32)[..., None]
    cslots = np.zeros((c, 2, 1), np.int32)
    for r in range(2):
        for j in range(c):
            p = p0[r] + j
            cslots[j, r, 0] = tables[r, p // BS] * BS + p % BS
    cfresh = np.zeros((c, 4), np.int32)
    ckv = (p0[None, :] + 1 + np.arange(c)[:, None]).astype(np.int32)
    max_steps = np.array([c, 2], np.int32)  # slot 1 stops after two tokens
    eos = np.full(2, -1, np.int32)
    active = np.ones(2, bool)
    jtoks, jpools = jmake_chunk(jm)(
        jparams, jpools, jnp.asarray(tok0), jnp.asarray(tables),
        jnp.asarray(cpos), jnp.asarray(cslots), jnp.asarray(cpos),
        jnp.asarray(cfresh), jnp.asarray(ckv), jnp.zeros(2, jnp.uint32),
        jnp.zeros(2, jnp.uint32), jnp.asarray(max_steps), jnp.asarray(eos),
        jnp.asarray(active), jnp.float32(0.0), jax.random.PRNGKey(0),
        greedy=True,
    )
    ttoks, tpools = make_paged_decode_chunk_step(tm)(
        tparams, tpools, T(tok0), T(tables), T(cpos), T(cslots), T(cpos),
        T(cfresh), T(ckv), torch.zeros(2, dtype=torch.int64),
        torch.zeros(2, dtype=torch.int64), T(max_steps), T(eos), T(active),
        torch.tensor(0.0), torch.zeros(2, dtype=torch.int64), greedy=True,
    )
    # tokens past a slot's done point are junk in both packages
    keep = np.arange(c)[:, None] < max_steps[None, :]
    yield ("chunk", np.where(keep, np.asarray(jtoks), -1),
           np.where(keep, ttoks.numpy(), -1), jpools, tpools)


@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_prefill_decode_and_chunk_match_reference(reference_params, kind):
    """In this process: logits to the drift bound; the first layer's pool
    planes (written from identical inputs) and every layer's position plane
    bitwise after each write."""
    for stage, ref, got, jpools, tpools in _run_both(kind, reference_params):
        if stage != "chunk":
            np.testing.assert_allclose(got, ref, rtol=0, atol=_logit_tol(ref))
        assert _pool_mismatches(jpools, tpools, [0]) == [], stage
        assert all(name != "ppos" for _, name in
                   _pool_mismatches(jpools, tpools, range(len(tpools))))


def bitwise_report(kinds):
    """{kind: "ok" or what differed}: every stage's logits, greedy tokens
    and every pool plane of every layer, compared bitwise."""
    params = _reference_params()
    out = {}
    for kind in kinds:
        out[kind] = "ok"
        for stage, ref, got, jpools, tpools in _run_both(kind, params):
            bad = _pool_mismatches(jpools, tpools, range(len(tpools)))
            if not np.array_equal(got, ref) or bad:
                out[kind] = f"{stage}: outputs equal={np.array_equal(got, ref)}, planes {bad}"
                break
    return out


@pytest.fixture(scope="module")
def exact_report():
    return run_exact("test_torch_model", "bitwise_report", list(KV_KINDS))


@pytest.mark.parametrize("kind", KV_KINDS)
def test_bitwise_with_xla_excess_precision_off(exact_report, kind):
    """With XLA rounding every bf16 op (tests/torch_parity.py), the port
    reproduces the reference bitwise: prefill and decode logits, the greedy
    chunk's tokens, and every pool plane of every layer after every write."""
    assert exact_report[kind] == "ok"


def test_paged_update_cache_cow_scrub_scatter_order_bitwise():
    """Copy-on-write clones first, then the fresh scrub, then the scatter,
    on identical K/V: every plane bitwise, the null page included (no
    duplicate slots here)."""
    rng = np.random.default_rng(4)
    for kind in ("none", "int4"):
        jp = jlayers.init_paged_kv_cache(6, 4, 2, 8, quant=kind)
        k = jnp.asarray(rng.standard_normal((1, 6, 2, 8)), jnp.bfloat16)
        v = jnp.asarray(rng.standard_normal((1, 6, 2, 8)), jnp.bfloat16)
        wpos = np.arange(6, dtype=np.int32)[None]
        slots = np.array([[4, 5, 6, 7, 8, 9]], np.int32)
        jp = jlayers.paged_update_cache(jp, k, v, jnp.asarray(wpos), jnp.asarray(slots),
                                        quant=kind)
        tp = {n: to_tensor(np.asarray(a), "cpu") for n, a in jp.items()}
        copies = np.array([[1, 3], [2, 4], [0, 0]], np.int32)
        fresh = np.array([3, 0], np.int32)
        slots2 = np.array([[13, 14, 17, 20, 21, 22]], np.int32)
        wpos2 = wpos + 6
        jp = jlayers.paged_update_cache(
            jp, k, v, jnp.asarray(wpos2), jnp.asarray(slots2),
            fresh_pages=jnp.asarray(fresh), copy_pages=jnp.asarray(copies), quant=kind,
        )
        tp = tlayers.paged_update_cache(
            tp, to_tensor(np.asarray(k), "cpu"), to_tensor(np.asarray(v), "cpu"),
            torch.from_numpy(wpos2), torch.from_numpy(slots2),
            fresh_pages=torch.from_numpy(fresh), copy_pages=torch.from_numpy(copies),
            quant=kind,
        )
        for name, plane in tp.items():
            ref = to_tensor(np.asarray(jp[name]), "cpu")
            assert torch.equal(plane.view(torch.int16) if plane.dtype == torch.bfloat16 else plane,
                               ref.view(torch.int16) if ref.dtype == torch.bfloat16 else ref)


def test_rms_norm_rope_attention_core_track_reference():
    """The layer pieces of the prefill path, on the same bf16 inputs."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal(64) * 0.1, jnp.float32)
    xt, wt = to_tensor(np.asarray(x), "cpu"), to_tensor(np.asarray(w), "cpu")
    r = np.asarray(jlayers.rms_norm(w, x).astype(jnp.float32))
    g = tlayers.rms_norm(wt, xt).float().numpy()
    np.testing.assert_allclose(g, r, rtol=2.0**-7, atol=0)  # one bf16 ulp
    q = x.reshape(2, 5, 4, 16)
    pos = np.array([[0, 3, 9, 100, 2047], [5, 6, 7, 8, 9]], np.int32)
    r = np.asarray(jlayers.apply_rope_batched(q, jnp.asarray(pos), 5e5).astype(jnp.float32))
    g = tlayers.apply_rope_batched(xt.reshape(2, 5, 4, 16), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=2.0**-6 * np.abs(r).max())
    k = jnp.asarray(rng.standard_normal((2, 7, 2, 16)), jnp.bfloat16)
    kpos = np.array([[0, 1, 2, 3, 4, EMPTY, EMPTY]] * 2, np.int32)
    qpos = np.array([[0, 1, 2, 3, 4]] * 2, np.int32)
    r = np.asarray(jlayers.attention_core(
        q, k, k, q_pos=jnp.asarray(qpos), k_pos=jnp.asarray(kpos), causal=True,
        softcap=3.0,
    ).astype(jnp.float32))
    kt = to_tensor(np.asarray(k), "cpu")
    g = tlayers.attention_core(
        xt.reshape(2, 5, 4, 16), kt, kt, q_pos=torch.from_numpy(qpos),
        k_pos=torch.from_numpy(kpos), causal=True, softcap=3.0,
    ).float().numpy()
    np.testing.assert_allclose(g, r, rtol=0, atol=2.0**-7 * np.abs(r).max())


def _same_leaf(a, b) -> bool:
    """Both dense and bitwise equal, or both compressed with the same
    spec, shape and planes."""
    if isinstance(a, CompressedTensor) != isinstance(b, CompressedTensor):
        return False
    if not isinstance(a, CompressedTensor):
        return torch.equal(_plane(a), _plane(b))
    if (a.spec, a.shape) != (b.spec, b.shape):
        return False
    for name in ("codes", "mask", "scales"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            return False
    return True


def test_compress_tree_compresses_fc_weights_on_their_device(reference_params):
    cfg = get_smoke_config("llama3-8b")
    dense = params_from_jax(
        jax.device_get(JModel(jget_smoke_config("llama3-8b")).init(jax.random.PRNGKey(0))),
        cfg, device="cpu")
    comp = compress_tree(dense, get_spec("bf8_50"))
    assert isinstance(comp["lm_head"], CompressedTensor)
    assert not isinstance(comp["embed"], CompressedTensor)
    mlp = comp["layers"][0]["mlp"]
    assert all(isinstance(mlp[n], CompressedTensor) for n in ("w_gate", "w_up", "w_down"))
    # the size floor counts the layer-stacked array, as the reference's
    # does: the smoke config's (64, 32) K/V projections, 2 x 2048 elements
    # stacked, are compressed, and the whole tree is the reference's, leaf
    # for leaf and plane for plane
    assert isinstance(comp["layers"][0]["attn"]["wk"], CompressedTensor)
    want = params_from_jax(jax.device_get(reference_params), cfg, device="cpu")
    assert set(comp) == set(want)
    for name in ("embed", "final_norm", "lm_head"):
        assert _same_leaf(comp[name], want[name]), name
    for got_l, want_l in zip(comp["layers"], want["layers"]):
        for group in ("attn", "mlp"):
            for name, leaf in got_l[group].items():
                assert _same_leaf(leaf, want_l[group][name]), (group, name)
        for name in ("pre_norm", "pre_mlp_norm"):
            assert _same_leaf(got_l[name], want_l[name]), name
    assert compressed_bytes(comp) < compressed_bytes(dense)
    assert comp["layers"][1]["mlp"]["w_up"].device.type == "cpu"
    # a layer that is not part of a stack keeps its own count
    alone = compress_tree(dense, get_spec("bf8_50"), layer_stack=1)
    assert not isinstance(alone["layers"][0]["attn"]["wk"], CompressedTensor)


def test_init_with_spec_matches_compressing_afterwards():
    tm = Model(get_smoke_config("llama3-8b"))
    spec = get_spec("int4_50")
    a = tm.init(torch.Generator().manual_seed(3), device="cpu", spec=spec)
    b = compress_tree(tm.init(torch.Generator().manual_seed(3), device="cpu"), spec)
    for x, y in ((a["lm_head"], b["lm_head"]),
                 (a["layers"][1]["mlp"]["w_down"], b["layers"][1]["mlp"]["w_down"])):
        assert torch.equal(x.codes, y.codes) and torch.equal(x.mask, y.mask)


def test_model_rejects_unported_features():
    cfg = get_smoke_config("llama3-8b")
    for change in ({"n_experts": 4}, {"post_norms": True}, {"pos_emb": "learned"}):
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            Model(dataclasses.replace(cfg, **change))
    with pytest.raises(ValueError):
        Model(dataclasses.replace(cfg, kv_quant="bf16"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tm = Model(get_smoke_config("llama3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_paged_cache(4, 8)

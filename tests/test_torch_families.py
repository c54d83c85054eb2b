"""Parity of the port with the JAX reference on the dense families beyond
llama3-8b: llama2-70b (rope, swiglu, an untied head), opt-66b (learned
positions, a relu MLP, full MHA), llama3.2-1b and granite-3-8b (heads tied
to the embedding; granite's smoke vocab of 259 is no multiple of 16).

The reference's `Model.init` tree, compressed by its `compress_tree`, is
carried into the port with `convert.params_from_jax`. At each smoke config
the same traffic goes through both paged engines: the host bookkeeping
must match exactly in this process, and greedy tokens exactly in a process
where XLA rounds every bf16 op (tests/torch_parity.py). The new layer
pieces (the relu MLP, learned positions with their clip, the tied head's
f32 logits) are held against the reference's functions on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.compression import compress as jcompress
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.decompress import mm as jmm
from repro.core.formats import get_spec as jget_spec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import make_paged_prefill_step as jmake_prefill

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import _leaf, params_from_jax, to_tensor
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import compress_tree
from repro_torch.core.formats import get_spec
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, SpecConfig, make_paged_prefill_step
from repro_torch.serve.scheduler import STAT_UNITS
from test_torch_engine import _logs_equal, _record
from test_torch_model import NB, _logit_tol, _prefill_inputs, _same_leaf
from torch_parity import run_exact

ARCHS = ("llama2-70b", "opt-66b", "llama3.2-1b", "granite-3-8b")
# the recurrent stacks (item 10.6) and the M-RoPE decoder and the encoder
# (10.7): configs and trees here, serving in tests/test_torch_ssm.py (the
# dense engine), tests/test_torch_mrope.py and tests/test_torch_encoder.py
TREE_ARCHS = ARCHS + ("falcon-mamba-7b", "recurrentgemma-9b", "qwen2-vl-7b", "hubert-xlarge")
KV_KINDS = ("none", "int8")
LENGTHS = (4, 19, 11, 26, 7)
ENGINE = dict(max_len=64, block_size=8, max_slots=3, num_blocks=10, decode_chunk=4)
SPEC = dict(k=3, draft_codec="nf4")
_CACHE = {}


def _reference_params(arch):
    """The reference's smoke tree, bf8_50-compressed (kept per process)."""
    if arch not in _CACHE:
        dense = JModel(jget_smoke_config(arch)).init(jax.random.PRNGKey(0))
        _CACHE[arch] = jcompress_tree(dense, jget_spec("bf8_50"))
    return _CACHE[arch]


def _port_params(arch):
    """`_reference_params(arch)` carried into the port on the CPU."""
    return params_from_jax(jax.device_get(_reference_params(arch)), get_smoke_config(arch),
                           device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _serve(arch, kind, prompts=None, new=6, engine=ENGINE):
    """Both paged engines (`engine` their arguments) over the same
    requests, by default `_prompts`, `new` tokens each; returns
    (reference, port) dicts of tokens, call logs, stats and per-request
    page peaks."""
    tcfg = get_smoke_config(arch)
    jeng = JEngine(JModel(jget_smoke_config(arch)), _reference_params(arch), paged=True,
                   kv_quant=kind, **engine)
    teng = GenerationEngine(Model(tcfg), _port_params(arch), kv_quant=kind, device="cpu",
                            **engine)
    prompts = _prompts(tcfg.vocab_size) if prompts is None else prompts
    out = []
    for eng, port in ((jeng, False), (teng, True)):
        log = _record(eng, port)
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done = eng.run_until_drained()
        st = eng.scheduler.stats()
        out.append({
            "tokens": [np.asarray(done[r]).tolist() for r in rids],
            "log": log,
            "stats": {k: st[k] for k in STAT_UNITS},
            "peaks": dict(eng.scheduler.request_peaks),
        })
    return out


@pytest.mark.parametrize("kind", KV_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_host_bookkeeping_matches_reference(arch, kind):
    """Every host array handed to the device, the admission order, the
    peaks and the stats match exactly; every request emits its tokens,
    all inside the vocabulary."""
    ref, got = _serve(arch, kind)
    assert _logs_equal(ref["log"], got["log"], with_tokens=False)
    assert got["stats"] == ref["stats"]
    assert got["peaks"] == ref["peaks"]
    vocab = get_smoke_config(arch).vocab_size
    assert all(len(t) == 6 and all(0 <= x < vocab for x in t) for t in got["tokens"])


def out_key(arch, kind):
    return f"{arch}/{kind}"


def family_report(archs, kinds):
    """{"arch/kind": "ok" or what differed}: tokens, stats, peaks and every
    device-call argument, sampled tokens included."""
    out = {}
    for arch in archs:
        for kind in kinds:
            ref, got = _serve(arch, kind)
            name = out_key(arch, kind)
            out[name] = "ok"
            for field in ("tokens", "stats", "peaks"):
                if got[field] != ref[field]:
                    out[name] = f"{field} {got[field]} != {ref[field]}"
            if out[name] == "ok" and not _logs_equal(ref["log"], got["log"], with_tokens=True):
                out[name] = "device-call arguments differ"
    return out


@pytest.fixture(scope="module")
def exact_report():
    return run_exact("test_torch_families", "family_report", list(ARCHS), list(KV_KINDS))


@pytest.mark.parametrize("kind", KV_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(exact_report, arch, kind):
    """With XLA rounding every bf16 op, the port's greedy tokens, stats,
    peaks and device-call arguments are the reference's."""
    assert exact_report[out_key(arch, kind)] == "ok"


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_configs_are_the_references_and_the_model_accepts_them(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert Model(port).cfg is port
    full = get_config(arch)
    assert full.param_count() == jget_config(arch).param_count()
    if full.mrope_sections:  # qwen2-vl-7b: groups of 7, sections over the rotary half
        assert (full.n_heads // full.n_kv_heads, sum(full.mrope_sections)) == (
            7, full.d_head // 2)
    if not full.causal:  # hubert-xlarge, the bidirectional encoder
        assert (full.pos_table, full.vocab_size, full.d_head, full.mlp_act) == (
            32768, 504, 80, "gelu")


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_init_and_compress_tree_match_the_references_trees(arch):
    """The port's `Model.init` draws the reference's leaves at the
    reference's shapes (`pos_embed` under learned positions, no `lm_head`
    under a tied head, no gate in a relu or gelu MLP, a mamba block and no
    FFN in an ssm layer, an RG-LRU block in a rec one, no leaf for
    M-RoPE), `params_from_jax` carries both trees, and the port's
    `compress_tree` of the reference's dense tree (the floor counting the
    reference's stacked array: `layer_stack`) is the reference's
    compressed tree, leaf for leaf and plane for plane; `Model.init(spec=)`
    compresses the same leaves."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    jdense = JModel(jget_smoke_config(arch)).init(jax.random.PRNGKey(0))
    dense = params_from_jax(jax.device_get(jdense), cfg, device="cpu")
    mine = model.init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(mine) == shapes(dense)
    assert ("pos_embed" in mine) == (cfg.pos_emb == "learned")
    assert ("lm_head" in mine) == (not cfg.tie_embeddings)
    for layer, kind in zip(mine["layers"], model.kinds):
        assert ("mamba" in layer) == (kind == "ssm") and ("rec" in layer) == (kind == "rec")
        assert ("mlp" in layer) == (kind != "ssm")
        if "mlp" in layer:
            assert ("w_gate" in layer["mlp"]) == (cfg.mlp_act in ("swiglu", "geglu"))
    want = _port_params(arch)
    got = compress_tree(dense, get_spec("bf8_50"), layer_stack=model.layer_stack)
    assert set(got) == set(want)
    for name in set(got) - {"layers"}:
        assert _same_leaf(got[name], want[name]), name
    assert not isinstance(got["embed"], CompressedTensor)
    for got_l, want_l in zip(got["layers"], want["layers"]):
        assert set(got_l) == set(want_l)
        for group, leaves in got_l.items():
            if not isinstance(leaves, dict):
                assert _same_leaf(leaves, want_l[group]), group
                continue
            assert set(leaves) == set(want_l[group])
            for name, leaf in leaves.items():
                assert _same_leaf(leaf, want_l[group][name]), (group, name)
    spec_init = model.init(torch.Generator().manual_seed(0), device="cpu",
                           spec=get_spec("bf8_50"))
    assert shapes(spec_init["embed"]) == shapes(mine["embed"])
    for init_l, got_l in zip(spec_init["layers"], got["layers"]):
        for group, leaves in got_l.items():
            if isinstance(leaves, dict):
                assert {n: isinstance(v, CompressedTensor) for n, v in init_l[group].items()} \
                    == {n: isinstance(v, CompressedTensor) for n, v in leaves.items()}, group


_REFUSED = {
    # the FFN routes by n_experts in any family, as the reference's; what is
    # refused is a top-k outside 1..n_experts, where the reference fails too
    "moe": ({"family": "moe", "n_experts": 4, "experts_per_token": 5}, "experts_per_token"),
}
# gemma2-2b's features (item 10.3), the recurrent stacks' (10.6) and the
# encoder's and the multimodal family's (10.7), refused until the port
# took them
_ACCEPTED = {
    "post_norms": {"post_norms": True},
    "embed_scale": {"embed_scale": True},
    "final_softcap": {"final_softcap": 30.0},
    "local_global": {"attn_pattern": "local_global"},
    "geglu": {"mlp_act": "geglu"},
    "attention_free": {"attn_pattern": "none"},
    "gelu": {"mlp_act": "gelu"},
    "mrope": {"mrope_sections": (2, 3, 3)},
    "vlm": {"family": "vlm"},
    "audio": {"family": "audio"},
    "moe": {"family": "moe"},  # without experts: the dense MLP
}


@pytest.mark.parametrize("feature", sorted(_REFUSED))
def test_model_still_refuses_unported_features_with_their_item(feature):
    change, field = _REFUSED[feature]
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), **change)
    with pytest.raises(ValueError, match=field):
        Model(cfg)


@pytest.mark.parametrize("feature", sorted(_ACCEPTED))
def test_model_accepts_ported_features(feature):
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), **_ACCEPTED[feature])
    assert Model(cfg).cfg is cfg


# ---------------------------------------------------------------------------
# the new layer pieces against the reference's functions
# ---------------------------------------------------------------------------

def test_relu_mlp_block_tracks_reference():
    """relu(x W_up) W_down on bf8_50 weights, f32 activations: both
    multiply the same bf16 values exactly and sum in f32, so they agree to
    f32 summation-order error."""
    jcfg, tcfg = jget_smoke_config("opt-66b"), get_smoke_config("opt-66b")
    dense = JModel(jcfg).init(jax.random.PRNGKey(3))
    jmlp = {n: jcompress(np.asarray(dense["blocks"]["mlp"][n][0], np.float32),
                         jget_spec("bf8_50")) for n in ("w_up", "w_down")}
    tmlp = {n: _leaf(w, None, "cpu") for n, w in jmlp.items()}
    x = np.random.default_rng(5).standard_normal((2, 5, 64)).astype(np.float32)
    ref = np.asarray(jlayers.mlp_block(jmlp, jnp.asarray(x), jcfg))
    got = tlayers.mlp_block(tmlp, torch.from_numpy(x), tcfg).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # the relu zeroed part of the hidden layer: not a linear map
    h = np.asarray(jmm(jnp.asarray(x), jmlp["w_up"]))
    assert (h < 0).any()


def _learned_prefill(jparams, jcfg, tcfg, offset):
    """Paged prefill of `_prefill_inputs` in both packages with every
    position (and KV position) shifted by `offset`."""
    tokens, pos, tables, slots, wpos, fresh, lens = _prefill_inputs()
    pos = pos + offset
    wpos = np.where(wpos < tlayers.CACHE_EMPTY_POS, wpos + offset, wpos).astype(np.int32)
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


@pytest.mark.parametrize("offset", [0, 5, 100])
def test_learned_position_forward_tracks_reference_and_clips(offset):
    """opt-66b-smoke with an 8-row position table: the embedding plus the
    clipped position row, no rope. Prompts of 16 and 9 tokens at offset 0
    run past the table; at 100 every position is clipped to its last row.
    Logits agree with the reference's to the drift bound of
    tests/test_torch_model.py."""
    jcfg = dataclasses.replace(jget_smoke_config("opt-66b"), pos_table=8)
    tcfg = dataclasses.replace(get_smoke_config("opt-66b"), pos_table=8)
    jparams = jcompress_tree(JModel(jcfg).init(jax.random.PRNGKey(0)), jget_spec("bf8_50"))
    ref, got = _learned_prefill(jparams, jcfg, tcfg, offset)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_logit_tol(ref))
    if offset == 100:
        # past the table only relative positions remain (the mask), so a
        # further shift changes nothing in the port
        _, again = _learned_prefill(jparams, jcfg, tcfg, 300)
        assert np.array_equal(again, got)
        _, inside = _learned_prefill(jparams, jcfg, tcfg, 0)
        assert not np.array_equal(inside, got)


def test_tied_head_logits_are_the_references_f32_einsum():
    """bf16 final-norm output against the bf16 embedding, products exact
    and summed in f32: within the f32 summation bound K * 2^-24 * sum|x e|
    of the reference's einsum, and f32."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 3, 64)), jnp.bfloat16)
    e = jnp.asarray(rng.standard_normal((259, 64)) * 0.02, jnp.bfloat16)
    ref = np.asarray(jnp.einsum("bsd,vd->bsv", x, e, preferred_element_type=jnp.float32))
    xt, et = to_tensor(np.asarray(x), "cpu"), to_tensor(np.asarray(e), "cpu")
    got = tlayers.tied_logits(xt, et)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 259)
    mag = (xt.float().abs() @ et.float().abs().t()).numpy()
    assert np.all(np.abs(got.numpy() - ref) <= 64 * 2.0**-24 * mag)


def test_spec_engine_on_a_tied_head_equals_sequential():
    """llama3.2-1b-smoke: the draft tree keeps the target's own `embed`
    (the tied head) and no `lm_head`, and the spec engine's greedy tokens
    are the non-spec engine's."""
    cfg = get_smoke_config("llama3.2-1b")
    tparams = params_from_jax(jax.device_get(_reference_params("llama3.2-1b")), cfg,
                              device="cpu")
    model = Model(cfg)
    outs, stats = [], None
    for spec in (None, SpecConfig(**SPEC)):
        eng = GenerationEngine(model, tparams, kv_quant="int8", device="cpu",
                               spec_decode=spec, **dict(ENGINE, max_slots=2))
        rids = [eng.submit(p, max_new_tokens=12) for p in _prompts(cfg.vocab_size)[:3]]
        done = eng.run_until_drained()
        outs.append([done[r].tolist() for r in rids])
        if spec is not None:
            assert eng.draft_params["embed"] is tparams["embed"]
            assert "lm_head" not in eng.draft_params
            stats = eng.scheduler.stats()
    assert outs[1] == outs[0]
    assert stats["verify_calls"] > 0 and stats["accepted_tokens_per_step"] >= 1.0

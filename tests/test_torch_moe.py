"""Parity of the port with the JAX reference on the MoE family: grok-1-314b
(geglu experts, softcaps, G 2 at smoke size) and kimi-k2-1t-a32b (swiglu
experts), top-2 of 4 and of 8 experts.

`layers.moe_block` is held against the reference's `moe_block` on the
same numbers (the reference's tree carried over by `params_from_jax`):
dense and bf8_50 experts, a zero router whose probabilities all tie, and
capacity 1.25 with a skewed router, so tokens drop past their expert's
bin. The expert-stacked leaves (`compress_tree`, `make_draft_tree`,
`compressed_bytes`) are held plane for plane. Then the reference's smoke
trees serve the same traffic in both paged engines, plain and
self-speculative.

Tolerances. In this process XLA may keep a fused chain of bf16 ops in f32
(`xla_allow_excess_precision`): the MoE output is held to 2e-2 of its
scale there (a few bf16 roundings of the hidden layer), and bitwise in a
process where XLA rounds every bf16 op (tests/torch_parity.py), where the
greedy tokens, stats, page peaks and every device-call argument are the
reference's too. The aux loss is a mean over tokens summed in another
order: 1e-6 of its value. Chosen experts, drop counts, planes and bytes
are exact everywhere.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.compression import CompressedTensor as JCT
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.decompress import compressed_bytes as jcompressed_bytes
from repro.core.decompress import make_draft_tree as jmake_draft_tree
from repro.core.formats import get_spec as jget_spec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import SpecConfig as JSpecConfig
from repro.obs import Observability as JObservability

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import CompressedTensor, compress_stacked
from repro_torch.core.decompress import compress_tree, compressed_bytes, make_draft_tree
from repro_torch.core.formats import get_spec
from repro_torch.kernels.ref import CACHE_EMPTY_POS
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.obs import Observability
from repro_torch.serve.engine import GenerationEngine, SpecConfig
from repro_torch.serve.scheduler import STAT_UNITS
from test_torch_engine import _logs_equal, _record
from test_torch_model import _same_leaf
from test_torch_obs import _lens_fields
from torch_parity import Exact

ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
KV_KINDS = ("none", "int8")
LENGTHS = (70, 19, 45, 7, 38)
ENGINE = dict(max_len=128, block_size=8, max_slots=3, num_blocks=40, decode_chunk=4)
SPEC = dict(k=3, draft_codec="nf4")
OUT_TOL = 2e-2   # of the MoE output's scale, in this process
AUX_TOL = 1e-6   # of the aux loss
_CACHE = {}


def _reference_params(arch, target="bf8_50"):
    """The reference's smoke tree, dense or compressed (kept per process)."""
    key = (arch, target)
    if key not in _CACHE:
        dense = JModel(jget_smoke_config(arch)).init(jax.random.PRNGKey(0))
        _CACHE[key] = dense if target == "none" else jcompress_tree(dense, jget_spec(target))
    return _CACHE[key]


def _ref_layer(tree, i):
    """Layer i of the reference's layer-stacked `moe` subtree."""
    def one(a):
        if isinstance(a, JCT):
            return JCT(codes=a.codes[i], mask=None if a.mask is None else a.mask[i],
                       scales=None if a.scales is None else a.scales[i],
                       spec=a.spec, shape=a.shape)
        return a[i]
    return {k: one(v) for k, v in tree["blocks"]["moe"].items()}


def _bf16(x: np.ndarray):
    """The same bf16 values for both packages."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb).view(np.int16)).view(torch.bfloat16)


def _moe_both(arch, target, x, *, cap=None, router=None):
    """`moe_block` of layer 0 in both packages on the same inputs: returns
    (reference out, port out) as f32 arrays, (reference aux, port aux)."""
    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    if cap is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cap)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cap)
    jtree = _reference_params(arch, target)
    jmoe = _ref_layer(jtree, 0)
    tmoe = params_from_jax(jax.device_get(jtree), tcfg, device="cpu")["layers"][0]["moe"]
    if router is not None:
        jmoe["router"] = jnp.asarray(router)
        tmoe["router"] = torch.from_numpy(router)
    xb, xt = _bf16(x)
    ro, ra = jlayers.moe_block(jmoe, xb, jcfg)
    go, ga = tlayers.moe_block(tmoe, xt, tcfg)
    assert go.dtype == torch.bfloat16 and ga.dtype == torch.float32
    return (np.asarray(ro).astype(np.float32), go.float().numpy()), (float(ra), float(ga))


def _x(seed, shape=(3, 5, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _skewed_router(arch, seed=7):
    """A random router plus a pull toward expert 0: with capacity 1.25 its
    bin overflows in the first routing slot."""
    cfg = get_smoke_config(arch)
    r = np.random.default_rng(seed).standard_normal((cfg.d_model, cfg.n_experts)) * 0.05
    r[:, 0] += 0.3
    return r.astype(np.float32)


def _drops(arch, x, router, cap_factor):
    """Tokens each routing slot drops, from the reference's own routing."""
    cfg = get_smoke_config(arch)
    xb, _ = _bf16(x)
    logits = jnp.einsum("td,de->te", xb.reshape(-1, cfg.d_model).astype(jnp.float32),
                        jnp.asarray(router))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.experts_per_token)
    t = idx.shape[0]
    cap = max(4, int(math.ceil(t / cfg.n_experts * cap_factor)))
    counts = [np.bincount(np.asarray(idx[:, s]), minlength=cfg.n_experts)
              for s in range(cfg.experts_per_token)]
    return [int(np.maximum(c - cap, 0).sum()) for c in counts]


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references_and_the_model_builds_them(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert Model(port).kinds == JModel(ref).kinds
    assert Model(get_config(arch)).layer_stack == get_config(arch).n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_compress_tree_match_the_references_trees(arch):
    """The port draws the reference's leaves (an f32 (d, E) router and
    (E, K, N) experts); `params_from_jax` carries the reference's trees
    (each layer's (E, ...) share of the stacked planes); the port's
    `compress_tree` of the reference's dense tree is the reference's
    compressed tree plane for plane (experts compressed slice by slice
    into one stacked leaf), and `compressed_bytes` agrees."""
    cfg = get_smoke_config(arch)
    jdense = _reference_params(arch, "none")
    dense = params_from_jax(jax.device_get(jdense), cfg, device="cpu")
    mine = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(mine) == shapes(dense)
    moe = dense["layers"][0]["moe"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert moe["router"].dtype == torch.float32 and tuple(moe["router"].shape) == (d, e)
    assert tuple(moe["w_down"].shape) == (e, f, d)
    jcomp = _reference_params(arch)
    want = params_from_jax(jax.device_get(jcomp), cfg, device="cpu")
    got = compress_tree(dense, get_spec("bf8_50"), layer_stack=Model(cfg).layer_stack)
    for got_l, want_l in zip(got["layers"], want["layers"]):
        for group in ("attn", "moe"):
            assert set(got_l[group]) == set(want_l[group])
            for name, leaf in got_l[group].items():
                assert _same_leaf(leaf, want_l[group][name]), (group, name)
        assert not isinstance(got_l["moe"]["router"], CompressedTensor)
        for name in ("w_up", "w_down"):
            ct = got_l["moe"][name]
            assert isinstance(ct, CompressedTensor) and ct.lead == (e,)
            assert ct.shape == (tuple(moe[name].shape[1:]))
    assert _same_leaf(got["lm_head"], want["lm_head"])
    assert compressed_bytes(got) == jcompressed_bytes(jcomp)


@pytest.mark.parametrize("arch", ARCHS)
def test_pick_is_the_references_expert_slice(arch):
    """`pick(i)` is expert i's 2-D triplet, the reference's
    `jax.tree.map(lambda a: a[i], ct)` on its layer's share, views of the
    stacked planes."""
    jtree = _reference_params(arch)
    tparams = params_from_jax(jax.device_get(jtree), get_smoke_config(arch), device="cpu")
    for layer in range(2):
        jmoe = _ref_layer(jtree, layer)
        for name in ("w_up", "w_down"):
            ct = tparams["layers"][layer]["moe"][name]
            for i in range(ct.lead[0]):
                one = ct.pick(i)
                assert one.lead == () and one.shape == ct.shape
                assert one.codes.data_ptr() == ct.codes[i].data_ptr()
                assert np.array_equal(one.codes.numpy(), np.asarray(jmoe[name].codes[i]))
                assert np.array_equal(one.mask.numpy().view(np.uint32),
                                      np.asarray(jmoe[name].mask[i]))


def test_compress_stacked_refuses_views_that_would_be_misaligned():
    """A plane slice of a length that is no multiple of 16 bytes would
    start expert 1's view off a 16-byte boundary: refused."""
    w = torch.randn(2, 32, 6)
    with pytest.raises(ValueError, match="misaligned"):
        compress_stacked(lambda i: w[i], 2, get_spec("bf8_50"))
    ct = compress_stacked(lambda i: torch.randn(32, 16), 3, get_spec("int8_50"))
    assert ct.lead == (3,) and ct.shape == (32, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_with_spec_matches_compressing_afterwards(arch):
    """`Model.init` with a spec compresses each expert as it is drawn;
    the planes are those of compressing the dense init afterwards."""
    tm = Model(get_smoke_config(arch))
    spec = get_spec("int4_50")
    a = tm.init(torch.Generator().manual_seed(3), device="cpu", spec=spec)
    b = compress_tree(tm.init(torch.Generator().manual_seed(3), device="cpu"), spec,
                      layer_stack=tm.layer_stack)
    for la, lb in zip(a["layers"], b["layers"]):
        for name, leaf in la["moe"].items():
            assert _same_leaf(leaf, lb["moe"][name]), name
    assert compressed_bytes(a) == compressed_bytes(b)


@pytest.mark.parametrize("draft", ["nf4", "int4_50"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_draft_tree_matches_reference_bitwise(arch, draft):
    """The draft tree re-encodes each expert slice through `ops.decompress`
    and is the reference's, every plane of every stacked leaf."""
    cfg = get_smoke_config(arch)
    jtarget = _reference_params(arch)
    want = params_from_jax(jax.device_get(jmake_draft_tree(jtarget, jget_spec(draft))),
                           cfg, device="cpu")
    got = make_draft_tree(params_from_jax(jax.device_get(jtarget), cfg, device="cpu"),
                          get_spec(draft))
    for got_l, want_l in zip(got["layers"], want["layers"]):
        for name, leaf in got_l["moe"].items():
            assert _same_leaf(leaf, want_l["moe"][name]), name
        assert got_l["moe"]["w_up"].spec == get_spec(draft)
    assert compressed_bytes(got) == jcompressed_bytes(jmake_draft_tree(jtarget,
                                                                       jget_spec(draft)))


# ---------------------------------------------------------------------------
# moe_block against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["none", "bf8_50"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_tracks_reference(arch, target):
    (ref, got), (ra, ga) = _moe_both(arch, target, _x(5))
    np.testing.assert_allclose(got, ref, rtol=0, atol=OUT_TOL * np.abs(ref).max())
    assert abs(ga - ra) <= AUX_TOL * abs(ra)


def test_top_k_puts_the_lower_index_first_among_ties():
    """`layers.top_k` is `jax.lax.top_k` on rows full of ties (values from
    a set of four), indices and values exactly."""
    rng = np.random.default_rng(0)
    probs = rng.choice(np.float32([0.1, 0.2, 0.25, 0.45]), size=(6, 40, 8))
    for k in (1, 2, 3, 8):
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = tlayers.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(gi.numpy(), np.asarray(ri)), k
        assert np.array_equal(gv.numpy(), np.asarray(rv)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_routes_to_the_references_experts(arch):
    """A zero router ties every probability: both packages route every
    token to experts 0 .. k-1 in that order, so the same bins overflow,
    and the outputs agree (kimi-k2's bins of 10 drop; grok's of 20 do not)."""
    cfg = get_smoke_config(arch)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    x = _x(6, (2, 10, 64))
    (ref, got), (ra, ga) = _moe_both(arch, "bf8_50", x, router=router)
    np.testing.assert_allclose(got, ref, rtol=0, atol=OUT_TOL * np.abs(ref).max())
    assert abs(ga - ra) <= AUX_TOL * abs(ra)
    probs = torch.full((20, cfg.n_experts), 1.0 / cfg.n_experts)
    _, idx = tlayers.top_k(probs, cfg.experts_per_token)
    assert (idx == torch.arange(cfg.experts_per_token)).all()
    cap = max(4, math.ceil(20 / cfg.n_experts * cfg.capacity_factor))
    assert sum(_drops(arch, x, router, cfg.capacity_factor)) == 2 * max(0, 20 - cap)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch):
    """Capacity 1.25 with a skewed router: the first slot overflows expert
    0's bin, the dropped tokens go to the pad row and get no share of that
    slot, and the output is the reference's."""
    router = _skewed_router(arch)
    x = _x(8, (2, 16, 64))
    assert _drops(arch, x, router, 1.25)[0] > 0
    (ref, got), (ra, ga) = _moe_both(arch, "bf8_50", x, cap=1.25, router=router)
    np.testing.assert_allclose(got, ref, rtol=0, atol=OUT_TOL * np.abs(ref).max())
    assert abs(ga - ra) <= AUX_TOL * abs(ra)
    # a dropped token differs from the drop-free output of the same inputs
    (_, free), _ = _moe_both(arch, "bf8_50", x, cap=get_smoke_config(arch).n_experts,
                             router=router)
    assert not np.array_equal(free, got)


def _moe_block_report(arch):
    """{arch/case: "ok" or what differed}: each moe_block case of this file
    with the output held bitwise, and a decode-shaped one (4 slots x 1)."""
    cfg = get_smoke_config(arch)
    cases = {target: _moe_both(arch, target, _x(5)) for target in ("none", "bf8_50")}
    cases["zero_router"] = _moe_both(
        arch, "bf8_50", _x(6, (2, 10, 64)),
        router=np.zeros((cfg.d_model, cfg.n_experts), np.float32))
    cases["drops"] = _moe_both(arch, "bf8_50", _x(8, (2, 16, 64)), cap=1.25,
                               router=_skewed_router(arch))
    cases["decode"] = _moe_both(arch, "bf8_50", _x(9, (4, 1, 64)))
    out = {}
    for name, ((ref, got), (ra, ga)) in cases.items():
        key = f"{arch}/{name}"
        out[key] = "ok"
        if not np.array_equal(ref.view(np.uint32), got.view(np.uint32)):
            out[key] = f"out differs at {int((ref != got).sum())} of {ref.size}"
        elif abs(ga - ra) > AUX_TOL * abs(ra):
            out[key] = f"aux {ga} != {ra}"
    return out


# ---------------------------------------------------------------------------
# serving: both engines on the same traffic
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _serve(arch, kind, spec=False):
    """The reference's and the port's paged engines (self-speculative with
    `spec`) on the same requests: per engine its tokens, call log, stats
    and page peaks."""
    jparams = _reference_params(arch)
    tcfg = get_smoke_config(arch)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jkw = {"spec_decode": JSpecConfig(**SPEC)} if spec else {}
    tkw = {"spec_decode": SpecConfig(**SPEC)} if spec else {}
    jeng = JEngine(JModel(jget_smoke_config(arch)), jparams, paged=True, kv_quant=kind,
                   **jkw, **ENGINE)
    teng = GenerationEngine(Model(tcfg), tparams, kv_quant=kind, device="cpu", **tkw,
                            **ENGINE)
    out = []
    for eng, port in ((jeng, False), (teng, True)):
        log = [] if spec else _record(eng, port)
        rids = [eng.submit(p, max_new_tokens=6) for p in _prompts(tcfg.vocab_size)]
        done = eng.run_until_drained()
        st = eng.scheduler.stats()
        out.append({
            "tokens": [np.asarray(done[r]).tolist() for r in rids],
            "log": log,
            "stats": {k: st[k] for k in STAT_UNITS if k in st},
            "peaks": dict(eng.scheduler.request_peaks),
        })
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bind_rooflens_counts_one_slice_of_an_expert_stack(arch):
    """RoofLens bound to an MoE engine: on the reference's unstacked layout
    (`scan_layers=False`, one tree per layer, as the port keeps them) every
    field is the reference's. Its dense-element count sums `shape` of each
    compressed leaf, and an expert-stacked leaf's `shape` is one expert's
    (K, N): the port counts the same, all experts' planes in the stored
    bytes."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), scan_layers=False)
    jm = JModel(jcfg)
    jparams = jcompress_tree(jm.init(jax.random.PRNGKey(0)), jget_spec("bf8_50"))
    cfg = get_smoke_config(arch)
    tparams = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    kw = dict(ENGINE, kv_quant="int8")
    jeng = JEngine(jm, jparams, paged=True, obs=JObservability.default(), **kw)
    teng = GenerationEngine(Model(cfg), tparams, device="cpu", obs=Observability.default(),
                            **kw)
    got, want = _lens_fields(teng.obs.rooflens), _lens_fields(jeng.obs.rooflens)
    assert got == want
    moe = tparams["layers"][0]["moe"]
    assert got["weight_elems"] > cfg.n_layers * sum(
        math.prod(moe[n].shape) for n in moe if n != "router")


def _engine_report(arch):
    """{arch/kind: "ok" or what differed} for the plain engines (tokens,
    stats, peaks, every device-call argument), {arch/spec: ...} for the
    self-speculative engines (tokens and stats against the reference's),
    and {arch/spec_is_plain: whether the port's spec tokens are its plain
    ones}."""
    out, plain = {}, {}
    for kind in KV_KINDS:
        ref, got = _serve(arch, kind)
        plain[kind] = got["tokens"]
        name = f"{arch}/{kind}"
        out[name] = "ok"
        for field in ("tokens", "stats", "peaks"):
            if got[field] != ref[field]:
                out[name] = f"{field} {got[field]} != {ref[field]}"
        if out[name] == "ok" and not _logs_equal(ref["log"], got["log"], with_tokens=True):
            out[name] = "device-call arguments differ"
    ref, got = _serve(arch, "int8", spec=True)
    name = f"{arch}/spec"
    out[name] = "ok"
    if got["tokens"] != ref["tokens"]:
        out[name] = f"spec tokens {got['tokens']} != reference {ref['tokens']}"
    elif got["stats"] != ref["stats"]:
        out[name] = f"stats {got['stats']} != {ref['stats']}"
    elif got["stats"]["verify_calls"] == 0:
        out[name] = "no verify ran"
    out[f"{arch}/spec_is_plain"] = got["tokens"] == plain["int8"]
    return out


def exact_report(arch):
    """Everything this file holds bitwise for one arch, in one process."""
    return {**_moe_block_report(arch), **_engine_report(arch)}


_EXACT = {}


@pytest.fixture(scope="module", autouse=True)
def _exact_runs():
    """Both archs' exact-rounding runs, started at once when the file's
    first test starts, so they run beside its in-process tests; stopped
    if the file ends first."""
    for arch in ARCHS:
        _EXACT[arch] = Exact("test_torch_moe", "exact_report", arch, timeout=900)
    yield
    for run in _EXACT.values():
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.communicate()
    _EXACT.clear()


@pytest.mark.parametrize("case", ["none", "bf8_50", "zero_router", "drops", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bitwise_with_exact_rounding(arch, case):
    assert _EXACT[arch].result()[f"{arch}/{case}"] == "ok"


@pytest.mark.parametrize("kind", KV_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_and_bookkeeping_match_reference(arch, kind):
    """With XLA rounding every bf16 op, the port's greedy tokens, every
    host array handed to the device, the stats and the page peaks are the
    reference's."""
    assert _EXACT[arch].result()[f"{arch}/{kind}"] == "ok"


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_engine_matches_reference_and_plain(arch):
    """The self-speculative engine (nf4 draft, k 3) emits the reference
    spec engine's tokens, with its stats. On grok's smoke config they are
    also the port's own plain tokens: its verify of 3 slots x 4 positions
    has bins of 12, so nothing drops. kimi-k2's has bins of 6 (8 experts):
    its verify drops tokens that single-token decode keeps, so in both
    packages its spec tokens part from its plain ones (ROADMAP Queue C)."""
    report = _EXACT[arch].result()
    assert report[f"{arch}/spec"] == "ok"
    assert report[f"{arch}/spec_is_plain"] == (arch == "grok-1-314b")


# ---------------------------------------------------------------------------
# chip_smoke.py's route log, on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py loaded as a module: its MoE route log runs on any device."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logged_serve(cs, arch, capacity, router=None, new=6):
    """The port's paged engine (int8 pool) on `_prompts` at `capacity`,
    under chip_smoke's RouteLog: (log, model, params, prompts, rids, tokens)."""
    cfg = dataclasses.replace(get_smoke_config(arch), kv_quant="int8",
                              capacity_factor=capacity)
    params = params_from_jax(jax.device_get(_reference_params(arch)), cfg, device="cpu")
    if router is not None:
        for layer in params["layers"]:
            layer["moe"]["router"] = torch.from_numpy(router)
    model, prompts = Model(cfg), _prompts(cfg.vocab_size)
    with cs.RouteLog(torch) as routes:
        eng = GenerationEngine(model, params, kv_quant="int8", device="cpu", **ENGINE)
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done = eng.run_until_drained()
    return routes, model, params, prompts, rids, [np.asarray(done[r]) for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_route_log_replays_the_serves_routes_into_the_teacher_pass(arch):
    """On a drop-free copy, each request's teacher-forced forward on the
    routes its serve chose (every position logged, prefill rows matched by
    prompt, decode slots by request id) has the emitted tokens as its
    argmax and would choose no route otherwise; replaying other experts
    changes its logits, so the replay takes effect."""
    cs = _chip_smoke()
    n_experts = get_smoke_config(arch).n_experts
    routes, model, params, prompts, rids, outs = _logged_serve(cs, arch, float(n_experts))
    chosen = routes.routes_of(model.cfg, prompts, rids, new=6)
    with routes:
        for p, r, out in zip(prompts, rids, outs):
            seq = chosen[r][:len(p) + len(out) - 1]
            assert (seq >= 0).all()
            tokens = torch.as_tensor(np.concatenate([p, out[:-1]]).astype(np.int64))
            rows = {}
            for shift in (0, 1):
                pinned = (seq + shift) % n_experts
                with routes.replay([torch.as_tensor(pinned[:, i][None])
                                    for i in range(model.cfg.n_layers)]):
                    rows[shift] = model.score(params, tokens)[len(p) - 1:]
            np.testing.assert_array_equal(rows[0].argmax(1).numpy(), out)
            assert not torch.equal(rows[0], rows[1])
    assert all(flipped.numel() == 0 for _, flipped in routes.replays[::2])
    assert all(flipped.numel() > 0 for _, flipped in routes.replays[1::2])


@pytest.mark.parametrize("arch", ARCHS)
def test_route_log_counts_the_drops_of_prompt_tokens(arch):
    """At capacity 1.25 with a skewed router the batched prefills drop:
    the route log's counts, of all token-slots and of the prompt tokens'
    alone (padding excluded), equal a count token by token in bin order."""
    cs = _chip_smoke()
    routes, model, *_ = _logged_serve(cs, arch, 1.25, router=_skewed_router(arch))
    cfg = model.cfg
    rows = routes.drops(cfg)
    prefills = [(arrays, a, b) for kind, arrays, a, b in routes.steps if kind == "prefill"]
    assert len(rows) == len(prefills) > 0
    for row, (arrays, a, b) in zip(rows, prefills):
        real = (arrays[4] != CACHE_EMPTY_POS).reshape(-1)
        dropped = ours = 0
        for idx in routes.seen[a:b]:
            for slot in range(cfg.experts_per_token):
                filled = [0] * cfg.n_experts
                for t, e in enumerate(idx[0, :, slot].tolist()):
                    if filled[e] >= row["cap"]:
                        dropped += 1
                        ours += bool(real[t])
                    filled[e] += 1
        assert (row["dropped"], row["prompt_dropped"], row["prompt_tokens"]) == (
            dropped, ours, int(real.sum()))
    assert sum(r["prompt_dropped"] for r in rows) > 0

"""Parity of the port with the JAX reference on the recurrent stacks:
falcon-mamba-7b (Mamba-1 blocks, no attention) and recurrentgemma-9b
(RG-LRU blocks and global MQA attention in the pattern rec, rec, attn),
served by the dense ring-cache engine.

The reference's smoke trees are carried into the port with
`convert.params_from_jax`. The blocks are held against the reference's
functions on the same inputs, with and without a carried state; the
engine's greedy tokens against the reference engine's in a process where
XLA rounds every bf16 op (tests/torch_parity.py).

A compressed recurrent tree the reference cannot serve: its `rglru_scan`
calls `.astype` on `w_a` and `w_x`, and `mamba_block` multiplies by
`dt_proj` with a plain `@`, while its `compress_tree` compresses all three
where they are eligible (`test_reference_cannot_serve_compressed_trees`).
The port takes them through `mm`, the reference's own matmul with
transparent decompression. To compare tokens, the reference runs on its
tree with each of those leaves replaced by bf16(decompress(leaf)), the
values the port's kernels decode; falcon-mamba smoke at d_model 512
(dt_rank 32) makes `dt_proj` and `x_proj` (N = 40) eligible, as at full
width.

Tolerances. The conv is bitwise the reference's ops run one by one (under
jit XLA contracts its multiply-adds into FMAs, one f32 rounding fewer).
The two packages' f32 `exp` differ by up to 1 ulp and `log1p` by up to 2,
so `sigmoid` (1 / (1 + exp(-x)), XLA's own expansion) and `softplus`
(`jnp.logaddexp(x, 0)` op for op) are held to 4 f32 ulps. Through a
block, those differences and the f32 sums of the matmuls and the scan's
C h contraction (summed in another order) move a bf16 output by less
than half a bf16 ulp at the output's scale, 2^-8 max|ref|, and the f32
state by 1e-6 of its scale. The scan's loop over time is bitwise the
reference's materialized form.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.compression import CompressedTensor as JCompressedTensor
from repro.core.decompress import _decompress_leaf
from repro.core.decompress import compress_tree as jcompress_tree
from repro.core.formats import get_spec as jget_spec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serve.engine import GenerationEngine as JEngine

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import _map, params_from_jax, to_tensor
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import compress_tree
from repro_torch.core.formats import get_spec
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine
from test_torch_model import _same_leaf
from torch_parity import Exact

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
WIDE = 512  # falcon-mamba smoke at this d_model: dt_proj and x_proj compress
BLOCKS = {"falcon-mamba-7b": "mamba", "recurrentgemma-9b": "rec"}
# leaves the reference's recurrent blocks cannot take compressed
REPAIRED = ("w_a", "w_x", "dt_proj")
# (arch, codec, d_model, temperature) of the engine token checks
TOKEN_CASES = (
    ("falcon-mamba-7b", "none", None, 0.0),
    ("falcon-mamba-7b", "bf8_50", None, 0.0),
    ("falcon-mamba-7b", "bf8_50", WIDE, 0.0),
    ("recurrentgemma-9b", "none", None, 0.0),
    ("recurrentgemma-9b", "bf8_50", None, 0.0),
    ("recurrentgemma-9b", "bf8_50", None, 0.7),
)
ULPS = 4
_CACHE = {}


def _configs(arch, d_model=None):
    """(reference, port) smoke configs, at `d_model` when given."""
    j, t = jget_smoke_config(arch), get_smoke_config(arch)
    if d_model:
        j, t = dataclasses.replace(j, d_model=d_model), dataclasses.replace(t, d_model=d_model)
    return j, t


def _reference_tree(arch, codec="none", d_model=None):
    """The reference's smoke tree, dense or compressed by its
    `compress_tree` (kept per process)."""
    key = (arch, codec, d_model)
    if key not in _CACHE:
        tree = JModel(_configs(arch, d_model)[0]).init(jax.random.PRNGKey(0))
        _CACHE[key] = tree if codec == "none" else jcompress_tree(tree, jget_spec(codec))
    return _CACHE[key]


def servable(tree):
    """The reference's tree with each compressed `w_a`, `w_x` and `dt_proj`
    replaced by bf16(decompress(leaf)): what its blocks can multiply, and
    the values the port's kernels decode."""
    def one(path, leaf):
        if isinstance(leaf, JCompressedTensor) and getattr(path[-1], "key", None) in REPAIRED:
            return jnp.asarray(_decompress_leaf(leaf), jnp.bfloat16)
        return leaf

    return jax.tree_util.tree_map_with_path(
        one, tree, is_leaf=lambda x: isinstance(x, JCompressedTensor))


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# configs, trees and the engine's regime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build_with_the_references_stacking(arch):
    """The full-size configs are the reference's and build in the port; a
    uniform Mamba stack compresses as the reference's (n_layers, ...)
    array, an unrolled hybrid one layer at a time."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(arch))
    model = Model(cfg)
    assert model.kinds == JModel(jget_config(arch)).kinds
    assert model.layer_stack == (64 if arch == "falcon-mamba-7b" else 1)
    assert not model.attn_only
    if arch == "recurrentgemma-9b":  # block_pattern's "attn": global, as the reference
        assert model.kinds[:3] == ("rec", "rec", "attn")


def test_wide_falcon_mamba_compress_tree_is_the_references():
    """falcon-mamba smoke at d_model 512: dt_rank 32 makes `dt_proj` (K 32)
    and `x_proj` (N = dt_rank + 2 state = 40) eligible, as at full width;
    the port's `compress_tree` of the reference's dense tree is the
    reference's compressed tree, plane for plane."""
    _, cfg = _configs("falcon-mamba-7b", WIDE)
    dense = params_from_jax(jax.device_get(_reference_tree("falcon-mamba-7b", "none", WIDE)),
                            cfg, device="cpu")
    want = params_from_jax(jax.device_get(_reference_tree("falcon-mamba-7b", "bf8_50", WIDE)),
                           cfg, device="cpu")
    got = compress_tree(dense, get_spec("bf8_50"), layer_stack=Model(cfg).layer_stack)
    for got_l, want_l in zip(got["layers"], want["layers"]):
        assert set(got_l["mamba"]) == set(want_l["mamba"])
        for name, leaf in got_l["mamba"].items():
            assert _same_leaf(leaf, want_l["mamba"][name]), name
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            assert isinstance(got_l["mamba"][name], CompressedTensor), name
        assert got_l["mamba"]["x_proj"].shape == (2 * WIDE, 40)


def test_reference_cannot_serve_compressed_trees():
    """The fault the port repairs: the reference's engine fails on the
    compressed recurrentgemma tree (`w_a.astype`) and on falcon-mamba's at
    d_model 512 (`dt_r @ dt_proj`); it serves their servable trees
    (`test_greedy_tokens_match_reference`)."""
    prompts = np.zeros((1, 4), np.int32)
    for arch, d_model, err, leaf in (("recurrentgemma-9b", None, AttributeError, "astype"),
                                     ("falcon-mamba-7b", WIDE, TypeError, "@")):
        jcfg, _ = _configs(arch, d_model)
        tree = _reference_tree(arch, "bf8_50", d_model)
        with pytest.raises(err, match=leaf):
            JEngine(JModel(jcfg), tree, max_len=32).generate(prompts, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_picks_the_dense_engine_and_it_refuses_what_the_reference_does(arch):
    """`paged="auto"` gives the dense engine for a recurrent stack; spec,
    SLA, injector, watchdog and host tier on it raise the reference's
    errors; `paged=True` raises as the reference's pool init does."""
    from repro.dist.fault import FaultInjector as JInjector
    from repro.serve.engine import SpecConfig as JSpec

    from repro_torch.dist.fault import FaultInjector
    from repro_torch.serve.engine import SpecConfig

    jcfg, tcfg = _configs(arch)
    jparams = _reference_tree(arch)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    assert not GenerationEngine(Model(tcfg), tparams, device="cpu").paged
    cases = [({"spec_decode": JSpec()}, {"spec_decode": SpecConfig()}),
             ({"injector": JInjector([])}, {"injector": FaultInjector([])}),
             ({"host_tier": True}, {"host_tier": True})]
    for jkw, tkw in cases:
        with pytest.raises(ValueError) as want:
            JEngine(JModel(jcfg), jparams, **jkw)
        with pytest.raises(ValueError) as got:
            GenerationEngine(Model(tcfg), tparams, device="cpu", **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="attention stack"):
        GenerationEngine(Model(tcfg), tparams, paged=True, device="cpu")
    with pytest.raises(ValueError, match="paged engine"):
        GenerationEngine(Model(tcfg), tparams, device="cpu").submit(
            np.zeros(3, np.int32), max_new_tokens=1)


# ---------------------------------------------------------------------------
# the pieces, each against the reference's
# ---------------------------------------------------------------------------

def test_transcendentals_within_stated_ulps():
    """`sigmoid` (XLA's 1 / (1 + exp(-x))), `silu` and `softplus`
    (`jnp.logaddexp(x, 0)` op for op) on f32 within ULPS f32 ulps of
    `jax.nn`'s; `softplus` keeps NaN and is not torch's thresholded one."""
    x = (np.random.default_rng(0).standard_normal(100000) * 8).astype(np.float32)
    t = torch.from_numpy(x)
    assert _ulps(tlayers.sigmoid(t), jax.nn.sigmoid(x)) <= ULPS
    assert _ulps(tlayers.silu(t), jax.nn.silu(x)) <= ULPS
    assert _ulps(tlayers.softplus(t), jax.nn.softplus(x)) <= ULPS
    assert _ulps(torch.exp(t), jnp.exp(x)) <= 1
    assert torch.isnan(tlayers.softplus(torch.tensor([float("nan")]))).all()
    big = torch.tensor([30.0])  # F.softplus returns x itself past its threshold
    assert tlayers.softplus(big).item() == float(jax.nn.softplus(30.0))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_is_the_references_bitwise(with_state):
    """The depthwise conv as the reference's ck shifted f32 products summed
    in order (`layers.py` `mamba_block` / `rglru_block`), run op by op:
    bitwise, and the new conv buffer is the last ck - 1 inputs."""
    rng = np.random.default_rng(2)
    b, s, r, ck = 2, 9, 64, 4
    u = jnp.asarray(rng.standard_normal((b, s, r)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((ck, r)) * 0.5, jnp.float32)
    buf = jnp.asarray(rng.standard_normal((b, ck - 1, r)), jnp.bfloat16)
    with jax.disable_jit():
        u_ext = (jnp.concatenate([buf.astype(u.dtype), u], axis=1) if with_state
                 else jnp.pad(u, ((0, 0), (ck - 1, 0), (0, 0))))
        want = sum(u_ext[:, i:i + s, :].astype(jnp.float32) * w[i] for i in range(ck))
    got, new = tlayers.causal_conv(_t(u), _t(w), {"conv": _t(buf)} if with_state else None)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert np.array_equal(new.view(torch.int16).numpy(),
                          np.asarray(u_ext[:, -(ck - 1):]).view(np.int16))


def _block_inputs(arch, codec, with_state, seed=4):
    """Layer 0's block leaves (reference and port), x (3, 9, D) bf16 and,
    with a state, a random conv buffer and f32 state."""
    jcfg, tcfg = _configs(arch)
    name = BLOCKS[arch]
    tree = _reference_tree(arch, codec)
    # a stacked compressed leaf is a pytree of (L, ...) planes: [0] slices them
    blk = (jax.tree.map(lambda a: a[0], tree["blocks"][name]) if "blocks" in tree
           else tree["layers"]["0"][name])
    tblk = _map(jax.device_get(blk), None, "cpu")
    rng = np.random.default_rng(seed)
    b, s = 3, 9
    x = jnp.asarray(rng.standard_normal((b, s, jcfg.d_model)), jnp.bfloat16)
    state = None
    if with_state:
        width = jcfg.d_inner if name == "mamba" else jcfg.lru_width
        h = (b, width, jcfg.ssm_state) if name == "mamba" else (b, width)
        state = {"conv": jnp.asarray(rng.standard_normal((b, jcfg.ssm_conv - 1, width)),
                                     jnp.bfloat16),
                 "h": jnp.asarray(rng.standard_normal(h), jnp.float32)}
    return jcfg, tcfg, servable(blk), tblk, x, state


def _assert_block_close(want, got):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0**-8 * np.abs(want).max())


def _assert_state_close(want, got):
    assert np.array_equal(np.asarray(want["conv"]).view(np.int16),
                          got["conv"].view(torch.int16).numpy())
    h = np.asarray(want["h"])
    np.testing.assert_allclose(got["h"].numpy(), h, rtol=0, atol=1e-6 * np.abs(h).max())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("codec", ["none", "bf8_50"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_block_tracks_reference(arch, codec, with_state):
    """`mamba_block` / `rglru_block` on layer 0's leaves against the
    reference's, dense and bf8_50 (the reference on its servable leaves),
    with a carried state and without: the output within half a bf16 ulp
    at its scale, the new conv buffer bitwise, the f32 state within 1e-6
    of its scale."""
    jcfg, tcfg, jblk, tblk, x, state = _block_inputs(arch, codec, with_state)
    jfn = jlayers.mamba_block if BLOCKS[arch] == "mamba" else jlayers.rglru_block
    tfn = tlayers.mamba_block if BLOCKS[arch] == "mamba" else tlayers.rglru_block
    want, want_state = jfn(jblk, x, jcfg, state=state)
    tstate = None if state is None else {k: _t(v) for k, v in state.items()}
    got, got_state = tfn(tblk, _t(x), tcfg, state=tstate)
    assert got.dtype == torch.bfloat16
    _assert_block_close(want, got)
    if state is None:
        assert got_state is None
    else:
        assert got_state is tstate  # carried in place
        _assert_state_close(want_state, got_state)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("codec", ["none", "bf8_50"])
def test_rglru_scan_tracks_reference(codec, with_state):
    """`rglru_scan` on a bf16 u with a zero or a random h0: hs (bf16)
    within half a bf16 ulp at its scale, the last f32 h within 1e-6 of
    its scale; `w_a` / `w_x` compressed go through the DECA matmul."""
    jcfg, _, jblk, tblk, x, state = _block_inputs("recurrentgemma-9b", codec, with_state)
    u = x  # any bf16 (B, S, R) input: lru_width = d_model in the smoke config
    h0 = state["h"] if state is not None else jnp.zeros((3, jcfg.lru_width), jnp.float32)
    want_hs, want_h = jlayers.rglru_scan(jblk, u, h0)
    got_hs, got_h = tlayers.rglru_scan(tblk, _t(u), _t(h0))
    assert got_hs.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    _assert_block_close(want_hs, got_hs)
    want_h = np.asarray(want_h)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=0, atol=1e-6 * np.abs(want_h).max())
    if codec == "bf8_50":
        assert isinstance(tblk["w_a"], CompressedTensor)


def _materialized_scan(dt, a, b_mat, c_mat, u, h0):
    """The reference's scan as it builds it: exp(dt A), dt B and their
    product with u as (B, S, di, st) tensors, every h_t kept, then C h."""
    da = torch.exp(dt[..., None] * a)
    db = dt[..., None] * b_mat[:, :, None, :].float()
    dbu = db * u[..., None].float()
    h, hs = h0, []
    for t in range(dt.shape[1]):
        h = da[:, t] * h + dbu[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1)  # (B, S, di, st)
    return (hs * c_mat.float()[:, :, None, :]).sum(dim=-1), h


@pytest.mark.parametrize("zero_h0", [True, False])
def test_time_loop_scan_is_the_materialized_scan_bitwise(zero_h0):
    """`selective_scan`'s loop over time, which keeps O(B di st) state,
    gives bitwise the materialized form's y and last h."""
    rng = np.random.default_rng(5)
    b, s, di, st = 2, 9, 128, 4
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dt = torch.nn.functional.softplus(f(b, s, di))
    a = -torch.exp(f(di, st) * 0.5)
    b_mat, c_mat, u = f(b, s, st).bfloat16(), f(b, s, st).bfloat16(), f(b, s, di).bfloat16()
    h0 = torch.zeros(b, di, st) if zero_h0 else f(b, di, st)
    y, h = tlayers.selective_scan(dt, a, b_mat, c_mat, u, h0)
    want_y, want_h = _materialized_scan(dt, a, b_mat, c_mat, u, h0)
    assert torch.equal(y.view(torch.int32), want_y.view(torch.int32))
    assert torch.equal(h.view(torch.int32), want_h.view(torch.int32))


# ---------------------------------------------------------------------------
# the reference's invariants (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill of 11 tokens then one decode step equals the full forward's
    last row (the reference's tolerance)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = params_from_jax(jax.device_get(_reference_tree(arch, "bf8_50")), cfg,
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    full, none = model.forward(params, tokens=tokens)
    assert none is None
    cache = model.init_cache(2, 16, device="cpu")
    _, cache = model.forward(params, tokens=tokens[:, :11], cache=cache)
    step, _ = model.decode_step(params, tokens[:, 11:], torch.full((2, 1), 11), cache)
    np.testing.assert_allclose(full[:, -1].numpy(), step.numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_streaming_matches_full_scan(arch):
    """Token-by-token decode from an empty cache equals the full-sequence
    scan (the reference's `test_mamba_state_streaming_matches_forward`),
    and the full forward tracks the reference's logits."""
    jcfg, cfg = _configs(arch)
    model = Model(cfg)
    tree = _reference_tree(arch)
    params = params_from_jax(jax.device_get(tree), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    full, _ = model.forward(params, tokens=torch.from_numpy(tokens))
    cache = model.init_cache(2, 10, device="cpu")
    for t in range(10):
        logits, cache = model.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                          torch.full((2, 1), t), cache)
    np.testing.assert_allclose(full[:, -1].numpy(), logits.numpy(), atol=2e-3)
    want = jax.jit(lambda p, t: JModel(jcfg).forward(p, tokens=t)[0])(tree, tokens)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the engine's tokens, in the exact-rounding process
# ---------------------------------------------------------------------------

def case_key(arch, codec, d_model, temp):
    return f"{arch}/{codec}/{d_model or 'smoke'}/{temp}"


def generate_both(arch, codec, d_model, temp):
    """Both dense engines (`paged="auto"` picks them) over the same three
    prompts of 6 tokens, 6 new tokens each: (reference, port) tokens."""
    jcfg, tcfg = _configs(arch, d_model)
    tree = _reference_tree(arch, codec, d_model)
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (3, 6)).astype(np.int32)
    kw = dict(max_len=32, temperature=temp, seed=3)
    jeng = JEngine(JModel(jcfg), servable(tree), **kw)
    teng = GenerationEngine(Model(tcfg), params_from_jax(jax.device_get(tree), tcfg,
                                                         device="cpu"), device="cpu", **kw)
    assert not jeng.paged and not teng.paged
    return np.asarray(jeng.generate(prompts, 6)), teng.generate(prompts, 6)


def exact_report():
    """{case: "ok" or the two token arrays}."""
    out = {}
    for case in TOKEN_CASES:
        ref, got = generate_both(*case)
        out[case_key(*case)] = "ok" if np.array_equal(ref, got) else (
            f"{got.tolist()} != {ref.tolist()}")
    return out


_EXACT = {}


@pytest.fixture(scope="module", autouse=True)
def _exact_run():
    """The exact-rounding run, started when the file's first test starts,
    so it runs beside the in-process tests; stopped if the file ends
    first."""
    _EXACT["run"] = Exact("test_torch_ssm", "exact_report", timeout=900)
    yield
    run = _EXACT.pop("run")
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.mark.parametrize("case", TOKEN_CASES, ids=lambda c: case_key(*c))
def test_greedy_tokens_match_reference(case):
    """With XLA rounding every bf16 op, the port's dense engine emits the
    reference's tokens: greedy, dense and bf8_50 trees (the reference on
    its servable tree), and one keyed temperature-0.7 case."""
    assert _EXACT["run"].result()[case_key(*case)] == "ok"

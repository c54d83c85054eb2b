"""Parity of the port's distribution layer with the JAX reference: the
sharding rules, the spec trees of every config at full size on the
production meshes, the codec round trip of the compressed gradient
all-reduce, and data-parallel training on a gloo world of two ranks.

Rule-level checks run the reference's spec functions on a context that carries
only axis sizes (as `tests/test_dist.py` does) and the port's on a
`RuleMesh` of the same sizes. The port's trees hold one dict per layer
where the reference stacks a uniform model's layers into `blocks`: a
layer leaf's spec is held to the reference's stacked spec without its
leading None, its local shard shape to the stacked shard's without the
layer dim.

Tolerances. The specs, the round trip (every KV codec) and the shard
shapes are exact. The data-parallel step sums the two ranks' f32
gradients where the single-process step sums all rows in one matmul:
each gradient leaf is held to 1e-2 of its largest magnitude (MICRO_SHARE,
as two microbatches are), the loss to 1e-6. The int8 step is held against
the reference's own 2-device step (run with XLA rounding every bf16 op,
tests/torch_parity.py): the loss to 1e-5 relative, each gradient leaf to
5e-2 of its largest magnitude (GRAD_SHARE, tests/test_torch_train.py's
port-against-reference tolerance), and each element of `err` within one
quantization step of its group plus its gradient's own difference (an
element near a rounding edge lands one step apart). Given the reference's
gradient, the port's round trip gives the reference's `err` bitwise. The
MoE aux loss is a mean of means here and one mean there: 1e-6 relative.
"""
import functools
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.configs.base import shape_applicability as jshape_applicability
from repro.core import codecs as jcodecs
from repro.core.compression import CompressedTensor as JCompressedTensor
from repro.core.compression import compress as jcompress
from repro.core.formats import get_spec as jget_spec
from repro.dist import grad_compression as jgc
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.optim.optimizers import Adafactor as JAdafactor
from repro.optim.optimizers import AdamW as JAdamW

import torch_dist_worker as worker
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import SHAPES, get_config, get_smoke_config, shape_applicability
from repro_torch.convert import params_from_jax
from repro_torch.core import codecs
from repro_torch.core.compression import compress
from repro_torch.core.formats import get_spec
from repro_torch.dist import grad_compression as gc
from repro_torch.dist import sharding as sh
from repro_torch.launch import specs
from repro_torch.launch.mesh import RuleMesh, make_production_mesh, make_test_mesh
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Adafactor, AdamW, tree_map
from repro_torch.train.trainer import device_batch, make_train_step

HERE = pathlib.Path(__file__).resolve().parent
SIZES = {"pod": 2, "data": 4, "model": 8}
MICRO_SHARE = 1e-2
GRAD_SHARE = 5e-2  # port against reference, as tests/test_torch_train.py
LOSS_TOL = 1e-6
REF_LOSS_RTOL = 1e-5
AUX_RTOL = 1e-6
RANK_TIMEOUT = 300


class Ctx:
    """Rule-level context of the reference: axis sizes and policy only."""

    def __init__(self, sizes, fsdp=True, mode="train"):
        self.axis_sizes, self.fsdp, self.mode = dict(sizes), fsdp, mode


def _ctx(sizes=SIZES, fsdp=True):
    """The port's ctx on a RuleMesh and the reference's Ctx, same sizes."""
    mesh = RuleMesh(tuple(sizes.values()), tuple(sizes))
    return sh.ShardingCtx(mesh, fsdp=fsdp), Ctx(sizes, fsdp)


def _ref(spec):
    """A reference spec (or compressed spec) as the port writes it."""
    if isinstance(spec, JCompressedTensor):
        return tuple(None if p is None else tuple(p) for p in (spec.codes, spec.mask, spec.scales))
    return tuple(spec)


def _port(spec):
    return tuple(spec) if isinstance(spec, sh.CompressedSpec) else spec


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# (a) the rules on a rule-level ctx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,roles,fsdp", [
    ((8, 8), ("model", "model"), True),     # an axis is never used twice
    ((16, 16), ("fsdp", "model"), False),   # fsdp is inert when the ctx disables it
    ((16, 16), ("fsdp", "model"), True),
    ((16, 4), ("batch", "model"), True),    # ('pod', 'data') = 8 divides
    ((12, 24), ("batch", "model"), True),   # falls back to 'data' = 4, model 8 divides
    ((2, 3), ("batch", "model"), True),     # pod alone; 3 replicates
    ((3, 5), ("batch", "expert"), True),
    ((16, 16, 64), ("expert", "fsdp", "model"), True),
    ((4, 8), ("seq", "layers"), True),
])
def test_spec_for_matches_reference(shape, roles, fsdp):
    ctx, jctx = _ctx(fsdp=fsdp)
    assert sh.spec_for(shape, roles, ctx) == tuple(jsh.spec_for(shape, roles, jctx))


def test_spec_for_never_reuses_an_axis_and_fsdp_is_inert_without_it():
    ctx, _ = _ctx()
    assert sh.spec_for((8, 8), ("model", "model"), ctx) == ("model", None)
    no_fsdp, _ = _ctx(fsdp=False)
    assert sh.spec_for((16, 16), ("fsdp", "model"), no_fsdp) == (None, "model")
    assert sh.spec_for((16, 16), ("fsdp", "model"), ctx) == ("data", "model")
    assert sh.spec_for((4, 4), ("model", "batch"), None) == (None, None)


@pytest.mark.parametrize("spec_name", ["int8_50", "bf8_100", "mxfp4_100", "nf4_50"])
def test_compressed_leaf_specs_match_reference(spec_name):
    """codes / mask / scales shard along the dense (K, N) axes; at K = 64
    (ng = 2 of data = 4) the K axis falls back to replication."""
    rng = np.random.default_rng(0)
    ws = {"w_up": rng.standard_normal((256, 128)).astype(np.float32),
          "w_gate": rng.standard_normal((64, 128)).astype(np.float32),
          "w_down": rng.standard_normal((128, 256)).astype(np.float32)}
    jtree = {"mlp": {k: jcompress(w, jget_spec(spec_name)) for k, w in ws.items()}}
    tree = {"mlp": {k: compress(torch.from_numpy(w), get_spec(spec_name)) for k, w in ws.items()}}
    ctx, jctx = _ctx()
    got = sh.param_spec_tree(tree, ctx)["mlp"]
    want = jsh.param_spec_tree(jtree, jctx)["mlp"]
    for k in ws:
        assert _port(got[k]) == _ref(want[k]), k
    if spec_name == "int8_50":
        assert got["w_up"] == (("data", None, "model"), ("data", "model"), ("data", "model"))
        assert got["w_gate"] == ((None, None, "model"), (None, "model"), (None, "model"))


def test_data_spec_tree_matches_reference():
    """Batches, the M-RoPE (3, B, S) positions, the ring cache (codes and
    quantized-KV scale planes), the paged pool and its scale planes."""
    shapes = {
        "tokens": (16, 32), "labels": (16, 32), "mask": (16, 32), "embeds": (12, 32, 64),
        "positions": (3, 16, 32), "k": (16, 64, 8, 32), "v": (6, 64, 8, 32),
        "k_scale": (16, 64, 8), "v_scale": (16, 64, 16), "pos": (16, 64), "length": (),
        "kp": (33, 16, 8, 32), "vp": (33, 16, 4, 32), "ks": (33, 16, 8), "vs": (33, 16, 6),
        "ppos": (33, 16), "conv": (16, 3, 64), "h": (16, 64),
    }
    tree = {k: _meta(s) for k, s in shapes.items()}
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    spec = get_spec("bf8_100")
    w = np.random.default_rng(2).standard_normal((256, 64)).astype(np.float32)
    tree["w"], jtree["w"] = compress(torch.from_numpy(w), spec), jcompress(w, jget_spec("bf8_100"))
    for sizes in (SIZES, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
        ctx, jctx = _ctx(sizes)
        got = sh.data_spec_tree(tree, ctx)
        want = jsh.data_spec_tree(jtree, jctx)
        assert {k: _port(v) for k, v in got.items()} == {k: _ref(v) for k, v in want.items()}
    ctx, _ = _ctx()
    got = sh.data_spec_tree(tree, ctx)
    assert got["tokens"] == (("pod", "data"), None)
    assert got["positions"] == (None, ("pod", "data"), None)
    assert got["kp"] == (None, None, "model", None)


def test_opt_spec_trees_match_reference():
    """AdamW's mu / nu / master mirror the params; Adafactor's vr drops the
    last dim, vc the row dim, an unfactored leaf keeps its param's spec;
    the port's stacked Adafactor state gets the reference's stacked specs."""
    shapes = {"w": (64, 128), "norm": (64,), "embed": (256, 64)}
    jp = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    tp = {k: _meta(s) for k, s in shapes.items()}
    tp["layers"] = []  # the port's optimizers walk a "layers" list
    ctx, jctx = _ctx()
    for jopt, opt in ((JAdamW(), AdamW()), (JAdafactor(), Adafactor())):
        want = jsh.opt_spec_tree(jax.eval_shape(jopt.init, jp), jp, jctx)
        got = sh.opt_spec_tree(opt.init(tp), tp, ctx)
        assert sh._flat_specs(got) == {k: _ref(v) for k, v in _ref_flat(want).items()}
    got = sh.opt_spec_tree(Adafactor().init(tp), tp, ctx)
    assert got["v"]["w"] == {"vr": ("data",), "vc": ("model",)}
    assert got["v"]["norm"] == {"v": (None,)}

    # a uniform stack: the port's stacked factors against the reference's blocks
    cfg = get_smoke_config("llama3.2-1b")
    jm = JModel(jget_smoke_config("llama3.2-1b"))
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    model = Model(cfg)
    aparams = specs.abstract_params(model)
    ctx, jctx = _ctx({"data": 2, "model": 4})
    want = jsh.opt_spec_tree(jax.eval_shape(JAdafactor().init, jparams), jparams, jctx,
                             scan_stacked=True)
    got = sh.opt_spec_tree(Adafactor(stacked=True).init(aparams), aparams, ctx)
    assert sh._flat_specs(got) == {k.replace("blocks", "layers"): _ref(v)
                                   for k, v in _ref_flat(want).items()}


def test_constrain_is_the_identity_without_a_mesh_and_for_a_local_tensor():
    x = torch.ones(2, 3, 4)
    assert sh.constrain(x, "bsd") is x
    q = torch.ones(2, 3, 4, 5)
    assert all(o is q for o in sh.constrain_qkv(q, q, q))
    with sh.use_mesh(RuleMesh((2, 2), ("data", "model"))):
        assert sh.constrain(x, "bsd") is x
    assert sh.active_ctx() is None


class _FakeMesh:
    """What the reference's ShardingCtx reads of a mesh: its shape."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 1}, SIZES,
                                   {"pod": 2, "data": 16, "model": 16}])
def test_dispatch_groups_match_reference_under_a_mesh(sizes):
    for t in (1, 6, 8, 12, 64, 96, 4096):
        with jsh.use_mesh(_FakeMesh(sizes)):
            want = jlayers._dispatch_groups(t)
        with sh.use_mesh(RuleMesh(tuple(sizes.values()), tuple(sizes))):
            assert layers._dispatch_groups(t) == want, (sizes, t)
    assert layers._dispatch_groups(64) == 1  # outside a mesh


def test_production_meshes_and_the_missing_backend():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert isinstance(single, RuleMesh) and isinstance(multi, RuleMesh)
    assert sh.ShardingCtx(single).axis_sizes == {"data": 16, "model": 16}
    assert sh.ShardingCtx(multi).axis_sizes == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh(1, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_test_mesh(1, 1)


# ---------------------------------------------------------------------------
# (b) every config at full size, on both production meshes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _trees(arch):
    """(reference model, reference abstract params / bf8_50 tree / opt
    state, port model, the port's)."""
    jm, model = JModel(jget_config(arch)), Model(get_config(arch))
    jp, tp = jspecs.abstract_params(jm), specs.abstract_params(model)
    return (jm, jp, jspecs.abstract_compress_tree(jp, jget_spec("bf8_50")),
            jspecs.abstract_opt_state(jm, jp), model, tp,
            specs.abstract_compress_tree(tp, get_spec("bf8_50"), layer_stack=model.layer_stack),
            specs.abstract_opt_state(model, tp))


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, JCompressedTensor)))[0]
    return {"/".join(jsh._key_str(p) for p in path): v for path, v in leaves}


def _ref_key(key: str, uniform: bool):
    """The reference's path of a port leaf, and whether its spec carries a
    leading layer None: a port layer leaf of a uniform stack is the
    reference's `blocks` leaf; the port's stacked Adafactor state
    (`v/layers/<name>`) already carries the layer dim."""
    parts = key.split("/")
    if "layers" not in parts or not uniform:
        return key, False
    j = parts.index("layers")
    per_layer = parts[j + 1].isdigit()
    rest = parts[j + 2:] if per_layer else parts[j + 1:]
    return "/".join(parts[:j] + ["blocks"] + rest), per_layer


def _without_layer_dim(spec):
    if isinstance(spec, JCompressedTensor):
        return tuple(None if p is None else tuple(p)[1:] for p in (spec.codes, spec.mask,
                                                                     spec.scales))
    return tuple(spec)[1:]


def _replicated(spec) -> bool:
    planes = spec if isinstance(spec, sh.CompressedSpec) else (spec,)
    return all(e is None for p in planes if p is not None for e in p)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_spec_trees_match_reference(arch):
    """Dense params, the bf8_50 tree and the optimizer state, leaf for leaf
    on the 16 x 16 and 2 x 16 x 16 meshes, fsdp as `wants_fsdp` says.

    One difference is the reference's and is held as such: at falcon-mamba's
    full depth the reference compresses the (64, d_inner) layer stacks of
    its 1-D leaves (conv_b, dt_bias, d_skip: K = 64 layers, a multiple of
    the group), whose per-layer leaves in the port are 1-D and stay dense;
    both replicate them."""
    jm, jp, jc, jo, model, tp, tc, to = _trees(arch)
    assert specs.wants_fsdp(model.cfg) == jspecs.wants_fsdp(jm.cfg)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        fsdp = specs.wants_fsdp(model.cfg)
        ctx = sh.ShardingCtx(mesh, fsdp=fsdp)
        jctx = Ctx(sh.ShardingCtx(mesh).axis_sizes, fsdp)
        cases = (
            ("params", jsh.param_spec_tree(jp, jctx, scan_stacked=jm.uniform),
             sh.param_spec_tree(tp, ctx)),
            ("bf8_50", jsh.param_spec_tree(jc, jctx, scan_stacked=jm.uniform),
             sh.param_spec_tree(tc, ctx)),
            ("opt_state", jsh.opt_spec_tree(jo, jp, jctx, scan_stacked=jm.uniform),
             sh.opt_spec_tree(to, tp, ctx)),
        )
        for what, jtree, tree in cases:
            want, got = _ref_flat(jtree), sh._flat_specs(tree)
            seen = set()
            for key, spec in got.items():
                rkey, per_layer = _ref_key(key, jm.uniform)
                assert rkey in want, (what, key)
                seen.add(rkey)
                ref = want[rkey]
                ref = _without_layer_dim(ref) if per_layer else _ref(ref)
                if (what == "bf8_50" and isinstance(want[rkey], JCompressedTensor)
                        and not isinstance(spec, sh.CompressedSpec)):
                    assert arch == "falcon-mamba-7b" and key.rsplit("/", 1)[-1] in (
                        "conv_b", "dt_bias", "d_skip"), key
                    assert _replicated(spec) and all(e is None for p in ref if p for e in p)
                    continue
                assert _port(spec) == ref, (what, multi, key)
            assert seen == set(want), (what, set(want) - seen)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicability_batch_and_decode_specs_match_reference(arch):
    """`attn_free`, `is_encoder`, `shape_applicability` for every SHAPES
    entry, and the abstract inputs: `batch_specs` leaf for leaf, and
    `decode_specs`' tokens, positions and cache (the port's per-layer cache
    against the reference's stacked one)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert (cfg.attn_free, cfg.is_encoder) == (jcfg.attn_free, jcfg.is_encoder)
    assert set(SHAPES) == set(JSHAPES)
    jm, model = JModel(jcfg), Model(cfg)
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        assert shape_applicability(cfg, shape) == jshape_applicability(jcfg, jshape)
        if shape.kind in ("train", "prefill"):
            got = specs.input_specs(cfg, shape, model)["batch"]
            want = jspecs.input_specs(jcfg, jshape, jm)["batch"]
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} \
                == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            continue
        if shape_applicability(cfg, shape):
            continue
        tokens, positions, cache = specs.decode_specs(model, shape)
        jtokens, jpositions, jcache = jspecs.decode_specs(jm, jshape)
        assert tuple(tokens.shape) == jtokens.shape and tuple(positions.shape) == jpositions.shape
        got = {k: (tuple(v.shape), v.dtype) for k, v in flatten({"c": cache}).items()}
        want = flatten(jax.tree.map(lambda x: x, {"c": jcache}))
        for key, (shp, dtype) in got.items():
            parts = key.split("/")
            if jm.uniform:
                ref = want["/".join(["c"] + parts[2:])]
                ref_shape = ref.shape[1:]
            else:
                ref = want[key]
                ref_shape = ref.shape
            assert shp == tuple(ref_shape), key
            assert str(dtype).split(".")[-1] == str(ref.dtype), key


def test_cell_shardings_give_each_kind_its_trees():
    cfg = get_config("llama3.2-1b")
    model = Model(cfg)
    ctx = sh.ShardingCtx(make_production_mesh(), fsdp=specs.wants_fsdp(cfg))
    train = specs.cell_shardings(model, SHAPES["train_4k"], ctx)
    assert set(train) == {"params", "abstract_params", "opt_state", "abstract_opt_state",
                          "batch"}
    assert train["batch"]["tokens"] == ("data", None)
    assert train["params"]["layers"][0]["attn"]["wq"] == (None, "model")
    decode = specs.cell_shardings(model, SHAPES["decode_32k"], ctx)
    assert decode["tokens"] == ("data", None) and decode["positions"] == ("data", None)
    assert decode["cache"][0]["k"] == ("data", None, None, None)


# ---------------------------------------------------------------------------
# (c) the codec round trip and error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", jcodecs.kv_codec_names())
def test_codec_roundtrip_is_the_references_bitwise(method):
    assert codecs.kv_codec_names() == jcodecs.kv_codec_names()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((7, 45)) * np.exp(rng.uniform(-6, 3, (7, 45)))).astype(np.float32)
    x[2, :10] = 0.0  # a zero group's scale
    want = np.asarray(jgc._codec_roundtrip(jnp.asarray(x), jcodecs.get_codec(method), 128))
    got = gc._codec_roundtrip(torch.from_numpy(x), codecs.get_codec(method), 128)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def solo_mesh():
    """A one-rank gloo world in this process, and its (1, 1) mesh."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_error_feedback_telescopes_and_beats_naive_quantization(solo_mesh):
    """Over 5 steps the sent payloads sum to the gradients' sum less the
    last residual; an outlier a group makes the naive sum drift."""
    allreduce, init_err = gc.make_compressed_allreduce(solo_mesh, None, method="int8")
    rng = np.random.default_rng(3)
    gs = []
    for _ in range(5):
        g = np.full((3, 128), 0.03, np.float32) + rng.standard_normal((3, 128)).astype(
            np.float32) * 1e-3
        g[:, 0] = 1.0
        gs.append({"w": torch.from_numpy(g)})
    err = init_err(gs[0])
    sent_sum = torch.zeros(3, 128)
    naive_sum = torch.zeros(3, 128)
    for g in gs:
        avg, err = allreduce(g, err)
        sent_sum += avg["w"]
        naive, _ = allreduce(g, init_err(g))
        naive_sum += naive["w"]
    total = sum(g["w"] for g in gs)
    assert torch.allclose(sent_sum, total - err["w"], rtol=0, atol=1e-6)
    assert (sent_sum - total).abs().max() < (naive_sum - total).abs().max()


def test_cell_shardings_place_specs_on_a_real_mesh(solo_mesh):
    """On a real (1, 1) mesh the cell's spec trees come with their DTensor
    placements: Shard(d) on each mesh dim a dim's entry names."""
    from torch.distributed.tensor import Replicate, Shard

    model = Model(get_smoke_config("llama3.2-1b"))
    out = specs.cell_shardings(model, SHAPES["train_4k"], sh.ShardingCtx(solo_mesh))
    wq = out["params"]["layers"][0]["attn"]["wq"]
    assert wq == (None, "model")
    assert out["placements"]["params"]["layers"][0]["attn"]["wq"] == [Replicate(), Shard(1)]
    assert out["placements"]["batch"]["tokens"] == [Shard(0), Replicate()]
    assert set(out["placements"]) == {"params", "opt_state", "batch"}
    assert "placements" not in specs.cell_shardings(model, SHAPES["train_4k"], _ctx()[0])


def test_allreduce_refuses_what_the_reference_refuses(solo_mesh):
    for bad in ("fp3", "bf16"):
        with pytest.raises(ValueError):
            gc.make_compressed_allreduce(solo_mesh, None, method=bad)
        with pytest.raises(ValueError):
            jgc.make_compressed_allreduce(jax.make_mesh((1,), ("data",)), None, method=bad)
    for method in gc.METHODS:
        allreduce, init_err = gc.make_compressed_allreduce(solo_mesh, None, method=method)
        g = {"w": torch.randn(5, 7, generator=torch.Generator().manual_seed(1))}
        avg, err = allreduce(g, init_err(g))
        sent = gc._codec_roundtrip(g["w"], codecs.get_codec(method), 128)
        assert torch.equal(avg["w"], sent) and torch.equal(err["w"], g["w"] - sent)


# ---------------------------------------------------------------------------
# (d) data parallelism on a gloo world of two ranks
# ---------------------------------------------------------------------------

def _start(code: str, env: dict):
    return subprocess.Popen([sys.executable, "-c", code], cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks of a gloo world and the reference's 2-device run, started
    together once for the module; their results and the inputs."""
    out = tmp_path_factory.mktemp("dp")
    start = {arch: params_from_jax(worker.tree(arch), get_smoke_config(arch), device="cpu")
             for arch in worker.DP_ARCHS}
    with open(out / "params.pkl", "wb") as f:
        pickle.dump(start, f)
    path = os.pathsep.join([str(HERE.parent / "src"), str(HERE)])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [_start(f"import torch_dist_worker as w; w.rank_main({r}, 2, {port}, {str(out)!r})",
                    env) for r in range(2)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                          "--xla_allow_excess_precision=false")
    procs.append(_start(f"import torch_dist_worker as w; w.reference_main({str(out)!r})", jenv))
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    with open(out / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"start": start, "ranks": ranks, "ref": ref}


def _global_step(arch, params):
    """The single-process step on the whole batch: (metrics, f32 grads,
    params after)."""
    cfg = worker.config(arch)
    tap = worker._Tap(AdamW(lr=worker.LR))
    params = tree_map(lambda p: p.clone(), params)
    step = make_train_step(Model(cfg), tap, remat=False)
    params, _, m = step(params, tap.init(params), device_batch(worker.batch(cfg), "cpu"),
                        worker.STEP)
    return {k: float(v) for k, v in m.items()}, tap.grads, worker._flat(params)


def test_data_parallel_step_is_the_global_batch_step(dp):
    """Masks of unequal counts on the two ranks (28 and 13 of 32): the
    ranks' loss, gradients and params equal each other bitwise and the
    single-process step's within the stated tolerance."""
    b = worker.batch(get_smoke_config(worker.DENSE))
    assert b["mask"][:2].sum() != b["mask"][2:].sum()
    r0, r1 = (r["adamw"] for r in dp["ranks"])
    for k in r0["grads"]:
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    assert r0["metrics"] == r1["metrics"]
    metrics, grads, params = _global_step(worker.DENSE, dp["start"][worker.DENSE])
    for k in ("loss", "ce", "z_loss", "aux"):
        assert abs(r0["metrics"][k] - metrics[k]) <= LOSS_TOL * max(1.0, abs(metrics[k])), k
    for k, g in grads.items():
        scale = float(g.abs().max())
        assert float((r0["grads"][k] - g).abs().max()) <= MICRO_SHARE * scale, k
    # AdamW's first step moves each param by ~lr times its gradient's sign:
    # an element whose tiny gradient flips lands 2 lr away
    for k, p in params.items():
        gap = (r0["params"][k] - p).abs()
        assert float(gap.max()) <= 2 * worker.LR + 2.0**-7 * float(p.abs().max()), k


def _residual(g: torch.Tensor):
    sent = gc._codec_roundtrip(g, codecs.get_codec("int8"), 128)
    return sent, g - sent


def _stacked_residuals(flat: dict):
    """(sent, err) of each leaf of DENSE's flat f32 gradient, a path's
    layer leaves quantized as the reference's stacked leaf when they are
    no multiple of the group."""
    out = {}
    n = get_smoke_config(worker.DENSE).n_layers
    for key, g in flat.items():
        if key in out:
            continue
        parts = key.split("/")
        if parts[0] != "layers" or g.numel() % 128 == 0:
            out[key] = _residual(g)
            continue
        keys = ["/".join(["layers", str(i)] + parts[2:]) for i in range(n)]
        sent, err = _residual(torch.stack([flat[k] for k in keys]))
        out.update({k: (sent[i], err[i]) for i, k in enumerate(keys)})
    return out


def test_reference_quantizes_the_reduced_gradient(dp):
    """The reference's int8 residual is bitwise the residual of the
    gradient GSPMD averages over the data axis, computed by the port's
    round trip: the reference quantizes after the reduction."""
    ref = dp["ref"]
    grads, err = flatten(ref["int8_grads"]), flatten(ref["int8_err"])
    assert set(grads) == set(err)
    for key, g in grads.items():
        _, e = _residual(torch.from_numpy(np.asarray(g)))
        assert np.array_equal(e.numpy().view(np.int32), np.asarray(err[key]).view(np.int32)), key


def test_int8_step_sends_the_round_trip_of_the_global_gradient(dp):
    """On both ranks the int8 step hands the optimizer the round trip of
    the data-parallel gradient (the plain step's, bitwise) and keeps its
    residual as err; a norm of 64 elements a layer is grouped across the
    layer stack, as the reference's stacked leaf is."""
    r0, r1 = dp["ranks"]
    want = _stacked_residuals(r0["adamw"]["grads"])
    assert set(want) == set(r0["int8_err"])
    for k, (sent, e) in want.items():
        assert torch.equal(r0["int8_err"][k], r1["int8_err"][k]), k
        assert torch.equal(r0["int8"]["grads"][k], sent), k
        assert torch.equal(r0["int8_err"][k], e), k


def _as_reference(flat: dict, rkey: str) -> torch.Tensor:
    """A port tree's leaves at the reference's leaf `rkey`: the layers'
    leaves stacked for a `blocks` path."""
    if not rkey.startswith("blocks/"):
        return flat[rkey]
    rest = rkey.split("/", 1)[1]
    n = get_smoke_config(worker.DENSE).n_layers
    return torch.stack([flat[f"layers/{i}/{rest}"] for i in range(n)])


def test_int8_step_tracks_the_references_2_device_step(dp):
    """The loss to 1e-5 relative; each gradient leaf to GRAD_SHARE of its
    largest magnitude (the port-against-reference gradient tolerance of
    tests/test_torch_train.py; here the ranks' bf16 halves are summed);
    each element of err within one quantization step of its group (on the
    reference's leaf, a stack's groups) plus its gradient's own difference
    (a value near a rounding edge lands a step apart)."""
    r0, ref = dp["ranks"][0], dp["ref"]
    loss, want = r0["int8"]["metrics"]["loss"], ref["int8"]["loss"]
    assert abs(loss - want) <= REF_LOSS_RTOL * abs(want)
    ref_grads, ref_err = flatten(ref["int8_grads"]), flatten(ref["int8_err"])
    for rkey, e_ref in ref_err.items():
        g = _as_reference(r0["adamw"]["grads"], rkey).reshape(-1)
        g_ref = torch.from_numpy(np.asarray(ref_grads[rkey])).reshape(-1)
        e = _as_reference(r0["int8_err"], rkey).reshape(-1)
        dg = (g - g_ref).abs()
        assert float(dg.max()) <= GRAD_SHARE * float(g_ref.abs().max()), rkey
        pad = (-g.numel()) % 128
        groups = lambda t: torch.nn.functional.pad(t, (0, pad)).reshape(-1, 128)
        step = groups(g_ref).abs().amax(dim=1, keepdim=True) / 127.0
        gap = groups((e - torch.from_numpy(np.asarray(e_ref)).reshape(-1)).abs())
        assert bool((gap <= step * (1 + 2.0**-7) + groups(dg)).all()), rkey


def test_moe_groups_and_aux_loss_match_the_references_2_device_step(dp):
    r0, r1 = (r["moe"] for r in dp["ranks"])
    ref = dp["ref"]
    assert dp["ranks"][0]["groups"] * 2 == ref["groups"] == 2
    assert r0["metrics"] == r1["metrics"]
    assert abs(r0["metrics"]["aux"] - ref["moe"]["aux"]) <= AUX_RTOL * abs(ref["moe"]["aux"])
    assert abs(r0["metrics"]["ce"] - ref["moe"]["ce"]) <= REF_LOSS_RTOL * abs(ref["moe"]["ce"])
    # at this capacity the groups decide which tokens drop: one group differs
    metrics, _, _ = _global_step(worker.MOE, dp["start"][worker.MOE])
    assert metrics["ce"] != r0["metrics"]["ce"]


def test_shard_params_on_mesh_1_by_2_gives_the_references_shards(dp):
    ref = dp["ref"]["shards"]
    for rank, res in enumerate(dp["ranks"]):
        assert res["shards"]["gathered_bitwise"]
        for key, shape in res["shards"]["local"].items():
            rkey, per_layer = _ref_key(key, True)
            want = ref[rkey][rank]
            assert shape == (want[1:] if per_layer else want), key
    assert dp["ranks"][0]["shards"]["local"]["layers/0/attn/wq"] == (64, 32)

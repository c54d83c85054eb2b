"""The dense ring engine of the port on a serving mesh
(`GenerationEngine(mesh=, paged=False)`), held against the JAX reference's
ring engine on the same mesh and against the port's own unsharded engine.

Two gloo ranks run the port at (2, 1) and (1, 2), and a subprocess runs
the reference on two forced XLA host devices with `AxisType.Auto` axes,
XLA rounding every bf16 op (tests/torch_ring_mesh_worker.py); they start
with the module's first test. Each rank computes its rows of the batch
(all of them where `data` does not divide it) on its shards: a Mamba-1 or
RG-LRU block on its channel block of the recurrence, an attention block on
its KV heads (recurrentgemma's one KV head stays whole); the ring caches
and states hold only that.

Tolerances. Tokens and, at (2, 1), every ring plane and state are exact:
splitting the rows changes no sum. At (1, 2) the row-parallel sites
(out_proj, w_out, wo, w_down) sum their partial products over `model` in
another order than one matmul does: the prefill logits are held to one
bf16 ulp of their scale (2**-7 of the largest, the fp32-accumulator rule
of ROADMAP.md). A compressed leaf's f32 partials are rounded once, and on
these trees they round to the unsharded products: the compressed trees'
(1, 2) tokens, states and ring planes are the unsharded engine's
bitwise. A dense tree's partials are summed in bf16, in the reference as
here, so its (1, 2) tokens are held to the reference mesh engine's.
"""
import numpy as np
import pytest
import torch

import torch_ring_mesh_worker as worker
from repro_torch.convert import params_from_jax
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Model
from test_torch_mesh_serve import ULP, Runs, _free_port

ARCHS = worker.ARCHS


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("ring"), work=worker, reference_first=True)
    try:
        yield r
    finally:
        r.stop()


@pytest.fixture(scope="module")
def port_params(runs):
    return {name: params_from_jax(tree, worker.tree_config(name), device="cpu")
            for name, tree in runs.trees.items()}


@pytest.fixture(scope="module")
def unsharded(port_params):
    """The port's unsharded ring engine on every case of the ranks, in this
    process while they run: {arch: {dense, packed, odd, hot}, GQA_ARCH}."""
    out = {}
    for arch in ARCHS:
        model = Model(worker.config(arch))
        out[arch] = {
            "dense": worker.serve(model, port_params[arch], None),
            "packed": worker.serve(model, port_params[f"{arch}:packed"], None),
            "odd": worker.serve(model, port_params[arch], None, rows=worker.ODD_BATCH),
            "hot": worker.serve(model, port_params[arch], None, temperature=worker.HOT),
        }
    out[worker.GQA_ARCH] = worker.serve(Model(worker.config(worker.GQA_ARCH)),
                                        port_params[f"{worker.GQA_ARCH}:packed"], None)
    return out


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


def _rows(planes, block, rows):
    """Rows `block` (a slice) of every plane that has rows: a ring's k / v
    (and scales) and a state's conv / h; a ring's shared pos and length
    whole. `rows` is the batch size."""
    return {name: plane[block] if plane.ndim and plane.shape[0] == rows else plane
            for name, plane in planes.items()}


def _same(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape and np.array_equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# in this process, while the ranks and the reference run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_ring_mesh_is_the_unsharded_engine_bitwise(solo_mesh, port_params,
                                                            unsharded, arch):
    """On a (1, 1) mesh every shard is the whole leaf, every channel block
    all channels and every collective over one rank: the tokens, the
    prefill logits and every ring plane and state are the unsharded
    engine's."""
    got = worker.serve(Model(worker.config(arch)), port_params[arch], solo_mesh)
    want = unsharded[arch]["dense"]
    assert got["tokens"] == want["tokens"]
    assert np.array_equal(got["logits"], want["logits"])
    _same(got["ring"], want["ring"])


def test_channel_blocks_are_views_and_follow_the_column_split(solo_mesh):
    """`channels` cuts a per-channel leaf or a state to the block of the
    axis `channel_axis` names, as a view of it; with no ctx it is the
    tensor itself. On a (1, 1) mesh the block is every channel."""
    ctx = sh.ShardingCtx(solo_mesh, mode="serve")
    conv_w = torch.randn(4, 128)
    assert sh.channel_axis(128, None) is None and sh.channels(conv_w, None) is conv_w
    assert sh.channel_axis(128, ctx) == "model"
    block = sh.channels(conv_w, ctx)
    assert block.shape == (4, 128) and block.data_ptr() == conv_w.data_ptr()
    a_log = torch.randn(128, 16)
    assert sh.channels(a_log, ctx, 0).untyped_storage().data_ptr() == \
        a_log.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the ranks and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", worker.MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_mesh_serving_gives_the_reference_tokens(runs, unsharded, arch, shape):
    """Every rank's greedy tokens are the reference's ring engine's on the
    same mesh, and the port's unsharded engine's are the reference's
    unsharded engine's. At (2, 1) all four are one. At (1, 2) a dense
    tree's row-parallel partials are summed in bf16, in the reference as
    in the port (ROADMAP Queue C), so its mesh tokens may part from its
    unsharded ones, and the port's part with them; a compressed tree sums
    f32 partials (`test_compressed_model_split_...`)."""
    res = runs.result()
    want = res["ref"][arch][shape]["tokens"]
    for rank in res["ranks"]:
        assert rank[arch][shape]["tokens"] == want
    assert unsharded[arch]["dense"]["tokens"] == res["ref"][arch][None]["tokens"]
    if shape == (2, 1):
        assert unsharded[arch]["dense"]["tokens"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_data_split_rings_are_the_unsharded_rows_bitwise(runs, unsharded, arch):
    """At (2, 1) rank r holds rows [2r, 2r + 2) of every conv buffer, f32
    state and (recurrentgemma's attention layer) ring plane, bitwise the
    unsharded engine's, and the ring's shared positions and length
    whole."""
    want = unsharded[arch]["dense"]["ring"]
    half = worker.BATCH // 2
    for r, rank in enumerate(runs.result()["ranks"]):
        got = rank[arch][(2, 1)]["ring"]
        _same(got, _rows(want, slice(r * half, (r + 1) * half), worker.BATCH))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_split_prefill_logits_within_fp32_accumulator_tolerance(runs, unsharded, arch):
    """At (1, 2) the channels split and out_proj / w_out / wo are
    row-parallel: the prefill logits are whole and equal on both ranks,
    and each row lies within one bf16 ulp of the logits' scale of the
    reference's (1, 2) row, beyond the distance between the two packages'
    unsharded rows. That distance is ~1e-5 ulp for falcon-mamba; for
    recurrentgemma it is up to ~2 ulps on a row, since f32 `exp` and
    `log1p` differ by an ulp or two between XLA and torch in the RG-LRU
    gates and can flip a bf16 rounding (ROADMAP Queue C)."""
    res = runs.result()
    ref = res["ref"][arch]
    want = ref[(1, 2)]["logits"]
    a, b = (rank[arch][(1, 2)]["logits"] for rank in res["ranks"])
    assert a.shape == want.shape == (worker.BATCH, worker.config(arch).vocab_size)
    assert np.array_equal(a, b)
    apart = np.abs(unsharded[arch]["dense"]["logits"] - ref[None]["logits"]).max(axis=1)
    bound = apart + ULP * np.abs(want).max()
    assert (np.abs(a - want).max(axis=1) <= bound).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_model_split_runs_the_deca_products_on_local_shards(
        runs, port_params, unsharded, arch):
    """mxfp4_100 trees at (1, 2), which the reference cannot serve: the
    tokens are the port's unsharded engine's and the prefill logits within
    one bf16 ulp of their scale (row-parallel f32 partials, rounded once);
    every compressed leaf's product ran on the rank's shard,
    column-parallel leaves on half their N, row-parallel ones on half
    their K."""
    want = unsharded[arch]["packed"]
    layers = port_params[f"{arch}:packed"]["layers"]
    packed = {(name, tuple(leaf.shape)) for layer in layers for block in layer.values()
              if isinstance(block, dict) for name, leaf in block.items()
              if hasattr(leaf, "codes")}
    row = {"out_proj", "w_out", "wo", "w_down"}
    local = {(k // 2, n) if name in row else (k, n // 2) for name, (k, n) in packed}
    assert packed
    for rank in runs.result()["ranks"]:
        got = rank[arch]["packed"]
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=ULP * np.abs(want["logits"]).max())
        assert set(got["shapes"]) == local


@pytest.mark.parametrize("arch", ARCHS)
def test_model_split_holds_each_ranks_channel_block(runs, unsharded, arch):
    """At (1, 2) rank r's recurrent states hold channels [r w/2, (r + 1)
    w/2) of the layer's width w: on the mxfp4_100 trees every layer's conv
    buffer and f32 state are the unsharded engine's channel block bitwise
    (the conv, the gates and the scan are elementwise over channels, and
    the row-parallel f32 sums round to the unsharded products here)."""
    want = unsharded[arch]["packed"]["ring"]
    states = [name for name in want if name.split("/")[1] in ("conv", "h")]
    assert states
    for r, rank in enumerate(runs.result()["ranks"]):
        got = rank[arch]["packed"]["ring"]
        assert got.keys() == want.keys()
        for name in states:
            dim = 2 if name.endswith("conv") else 1
            w = want[name].shape[dim] // 2
            block = np.take(want[name], range(r * w, (r + 1) * w), axis=dim)
            assert np.array_equal(got[name], block), name


def test_split_kv_heads_hold_each_ranks_head_of_the_ring(runs, unsharded):
    """llama3-8b's smoke stack (2 KV heads, mxfp4_100) on the ring at
    (1, 2): the tokens are the unsharded engine's, and rank i's ring holds
    KV head i: every layer's K / V the unsharded ring's head slice bitwise
    (the row-parallel f32 sums round to the unsharded products here), the
    positions and length whole."""
    want = unsharded[worker.GQA_ARCH]
    for i, rank in enumerate(runs.result()["ranks"]):
        got = rank[worker.GQA_ARCH]
        assert got["tokens"] == want["tokens"]
        assert got["ring"].keys() == want["ring"].keys()
        for name, plane in want["ring"].items():
            if name.split("/")[1] in ("k", "v"):
                plane = plane[:, :, i:i + 1]
            assert got["ring"][name].shape == plane.shape, name
            assert np.array_equal(got["ring"][name], plane), name


@pytest.mark.parametrize("arch", ARCHS)
def test_non_dividing_batch_runs_every_row_on_every_rank(runs, unsharded, arch):
    """B = 3 at (2, 1): `data` does not divide the rows, so each rank
    computes all three: the tokens and every ring plane and state are the
    unsharded engine's, whole."""
    want = unsharded[arch]["odd"]
    for rank in runs.result()["ranks"]:
        got = rank[arch]["odd"]
        assert got["tokens"] == want["tokens"]
        _same(got["ring"], want["ring"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_tokens_on_a_data_split_are_the_unsharded_engines(runs, unsharded, arch):
    """T = 0.7 at (2, 1): every rank samples each row from the whole
    logits under the row's key, so the tokens are the unsharded
    engine's."""
    want = unsharded[arch]["hot"]["tokens"]
    assert want != unsharded[arch]["dense"]["tokens"]
    for rank in runs.result()["ranks"]:
        assert rank[arch]["hot"]["tokens"] == want

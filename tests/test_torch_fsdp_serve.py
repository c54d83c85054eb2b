"""fsdp serving of the port (`GenerationEngine(mesh=, fsdp=True)`) held
against the JAX reference's fsdp engine and against the port's own
unsharded engine.

Under fsdp every FC leaf is split over `data` as well as `model` (the
reference's ZeRO rules: a column-parallel leaf's K, a row-parallel
leaf's N, an expert stack's K inside each expert, the embedding's D), so
between steps a rank holds only its `data` share; each point of use
all-gathers the leaf whole over `data` (a compressed leaf as its codes /
mask / scales planes) and releases it after the product. The products
are then those of the non-fsdp mesh engine.

Two gloo ranks run the port at (2, 1) and (1, 2), and a subprocess runs
the reference's fsdp engines on two forced XLA host devices with
`AxisType.Auto` axes, XLA rounding every bf16 op
(tests/torch_fsdp_serve_worker.py); they start with the module's first
test, and the reference draws its own trees.

Tolerances. Tokens, pool planes and the local leaves are exact. At
(1, 2) the row-parallel sites sum over `model` in another order than one
matmul does: the prefill logits are held to one bf16 ulp of their scale
(2**-7 of the largest, the fp32-accumulator rule of ROADMAP.md).

The dense tree at (2, 1) is the one case where the reference's fsdp
engine is not its unsharded engine: for a prefill call whose one row
does not split over `data`, XLA's partitioner keeps the weights split
and sums the column-parallel products' bf16 partials over `data`
(ROADMAP Queue C). The port gathers the weights in every call, so its
dense (2, 1) fsdp engine is held to its own unsharded engine, bitwise.
"""
import numpy as np
import pytest
import torch

import torch_fsdp_serve_worker as worker
import torch_mesh_serve_worker as mw
import torch_ring_mesh_worker as rw
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine
from test_torch_mesh_serve import ULP, Runs, _same_pools, solo_mesh  # noqa: F401 (a fixture)

DATA = worker.DATA


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("fsdp"), work=worker, reference_first=True)
    try:
        yield r
    finally:
        r.stop()


@pytest.fixture(scope="module")
def port_params(runs):
    return {name: params_from_jax(tree, worker.tree_config(name), device="cpu")
            for name, tree in runs.trees.items()}


def _engine(name, params, mesh=None, **kw):
    """A port engine on the tree `name` with its case's settings."""
    model = Model(worker.tree_config(name))
    settings = mw.MOE_SERVE if name == "moe" else mw.SERVE
    return GenerationEngine(model, params[name], device="cpu", mesh=mesh, **settings, **kw)


def _prompts(name):
    return mw.moe_prompts() if name == "moe" else worker.serve_prompts()


@pytest.fixture(scope="module")
def unsharded(port_params):
    """The port's unsharded engines on the ranks' cases, in this process
    while they run: {tree: {tokens, pools, prefill logits}}, and the ring
    engine's serve."""
    out = {}
    for name in ("served", "dense", "moe"):
        eng = _engine(name, port_params)
        logits = []
        mw._record_logits(eng, logits)
        out[name] = {"tokens": mw._serve(eng, _prompts(name), mw.SERVE_NEW),
                     "pools": mw._pools(eng), "logits": logits}
    out["ring"] = rw.serve(Model(worker.tree_config("ring")), port_params["ring"], None)
    return out


# ---------------------------------------------------------------------------
# in this process, while the ranks and the reference run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["served", "moe"])
def test_one_rank_fsdp_mesh_is_the_unsharded_engine_bitwise(solo_mesh, port_params,
                                                            unsharded, name):
    """On a (1, 1) mesh every `data` entry names one rank: each gather is
    a one-rank all-gather, a copy of the leaf's planes into the gather
    buffer. Tokens, `stats()` and every pool plane are the unsharded
    engine's (`_same_pools`: the null page's K/V left out, its positions
    empty in both), int8 KV."""
    engines = [_engine(name, port_params, mesh, kv_quant="int8", fsdp=True)
               for mesh in (None, solo_mesh)]
    tokens = [mw._serve(eng, _prompts(name), mw.SERVE_NEW) for eng in engines]
    assert tokens[0] == tokens[1]
    assert engines[0].scheduler.stats() == engines[1].scheduler.stats()
    _same_pools(*(mw._pools(eng) for eng in engines))
    buf = engines[1]._ctx.gather_buffer
    assert buf is not None and buf.dtype == torch.uint8


# ---------------------------------------------------------------------------
# the ranks and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", mw.MESHES)
def test_fsdp_serving_gives_the_reference_fsdp_engines_tokens(runs, unsharded, shape):
    """mxfp4_100 weights: every rank's greedy tokens are the reference's
    fsdp engine's on the same mesh, and the unsharded port's."""
    res = runs.result()
    want = res["ref"]["serve"][shape]["tokens"]
    for rank in res["ranks"]:
        assert rank["serve"][shape]["tokens"] == want
    assert unsharded["served"]["tokens"] == want


@pytest.mark.parametrize("case", ["serve", "moe"])
def test_data_split_fsdp_pool_planes_are_the_references_bitwise(runs, unsharded, case):
    """At (2, 1), the mxfp4_100 llama stack and grok's bf8_50 MoE stack:
    each rank's pool, every plane of every layer, is the reference fsdp
    engine's and the unsharded port's (null page left out)."""
    res = runs.result()
    ref = res["ref"][case][DATA]["pools"] if case == "serve" else res["ref"][case]["pools"]
    plain = unsharded["served" if case == "serve" else case]["pools"]
    for rank in res["ranks"]:
        pools = rank[case][DATA]["pools"] if case == "serve" else rank[case]["pools"]
        assert pools.keys() == ref.keys()
        for name, plane in pools.items():
            assert np.array_equal(plane[:, 1:], ref[name][:, 1:]), name
        _same_pools(plain, pools)


def test_model_split_fsdp_logits_within_fp32_accumulator_tolerance(runs):
    """At (1, 2) with fsdp: the prefill logits are whole rows on every rank,
    equal on both ranks, within one bf16 ulp of their scale of the
    reference fsdp engine's."""
    res = runs.result()
    ref = res["ref"]["serve"][(1, 2)]["logits"]
    r0, r1 = (rank["serve"][(1, 2)]["logits"] for rank in res["ranks"])
    assert len(r0) == len(ref) == 2
    for a, b, want in zip(r0, r1, ref):
        assert a.shape == want.shape and np.array_equal(a, b)
        np.testing.assert_allclose(a, want, rtol=0, atol=ULP * np.abs(want).max())


def test_moe_fsdp_serving_gives_the_reference_tokens(runs, unsharded):
    """grok's bf8_50 MoE stack at (2, 1): each expert stack's K is split
    over `data` inside every expert and gathered whole once a layer call;
    the tokens are the reference fsdp engine's and the unsharded port's."""
    res = runs.result()
    want = res["ref"]["moe"]["tokens"]
    for rank in res["ranks"]:
        assert rank["moe"]["tokens"] == want
    assert unsharded["moe"]["tokens"] == want


def test_ring_fsdp_serving_gives_the_reference_tokens(runs, unsharded):
    """falcon-mamba-7b's dense stack through the ring engine at (2, 1):
    in_proj, x_proj, dt_proj and out_proj gathered at their points of use;
    the tokens are the reference's fsdp `generate`'s and the unsharded
    port's."""
    res = runs.result()
    want = res["ref"]["ring"]["tokens"]
    for rank in res["ranks"]:
        assert rank["ring"]["tokens"] == want
    assert unsharded["ring"]["tokens"] == want


def test_dense_data_split_fsdp_is_the_unsharded_engine_bitwise(runs, unsharded):
    """The dense llama3-8b tree at (2, 1): the port's fsdp engine gives its
    unsharded engine's tokens, prefill logits and pool planes bitwise."""
    plain = unsharded["dense"]
    for rank in runs.result()["ranks"]:
        assert rank["dense"]["tokens"] == plain["tokens"]
        assert len(rank["dense"]["logits"]) == len(plain["logits"]) == 2
        for a, want in zip(rank["dense"]["logits"], plain["logits"]):
            assert np.array_equal(a, want)
        _same_pools(plain["pools"], rank["dense"]["pools"])


def test_reference_fsdp_sums_bf16_partials_where_the_rows_do_not_split(runs, unsharded):
    """The mismatch the port does not follow (ROADMAP Queue C), against the
    unsharded port, whose dense logits are the reference's unsharded
    engine's bitwise (tests/test_torch_model.py). The reference's dense
    (2, 1) fsdp engine prefills the 2-row call with the weights gathered
    (no all-reduce in its partitioned program), and its logits are the
    unsharded ones bitwise. The 1-row call, whose row `data` cannot split,
    keeps the weights split over `data`, splits the residual stream's D
    and sums partials over `data` (all-reduces in its program): its logits
    leave the unsharded ones, and so do its tokens."""
    fsdp, plain = runs.result()["ref"]["dense"], unsharded["dense"]
    assert fsdp["programs"][0][0] == 2 and fsdp["programs"][0][1] == 0
    assert fsdp["programs"][1][0] == 1 and fsdp["programs"][1][1] > 0
    assert np.array_equal(fsdp["logits"][0], plain["logits"][0])
    assert not np.array_equal(fsdp["logits"][1], plain["logits"][1])
    assert fsdp["tokens"] != plain["tokens"]


@pytest.mark.parametrize("case", ["shares", "moe"])
def test_each_rank_holds_half_of_every_data_split_leaf(runs, case):
    """At (2, 1) a rank holds half the bytes of every leaf with a `data`
    entry, each plane bitwise its block of the whole leaf's plane: a view
    of it where the block is contiguous in the whole plane (a K split of
    a 2-D leaf's codes, mask or scales: their dim 0), a copy elsewhere (an
    N split, the K split inside each expert of a stack). Only leaves with
    no FC role (norms, routers) are held whole."""
    for rank in runs.result()["ranks"]:
        got = rank[case] if case == "shares" else rank[case]["shares"]
        assert got["leaves"]
        for path, leaf in got["leaves"].items():
            assert 2 * leaf["local"] == leaf["whole"], path
            for dim, view, equal in leaf["planes"]:
                assert equal and view == (dim == 0), (path, dim, view)
        for path in got["kept"]:
            assert "norm" in path or "router" in path, path


def test_fsdp_spec_engine_is_bitwise_the_plain_fsdp_mesh_engine(runs):
    """k = 2 with an nf4 draft re-encoded from each rank's `data` shares
    (their K blocks whole groups of the draft's), at (2, 1): the plain
    fsdp mesh engine's tokens, bitwise."""
    for rank in runs.result()["ranks"]:
        spec = rank["spec"]
        assert spec["spec"] == spec["plain"]
        assert spec["stats"]["draft_tokens"] > 0 and spec["stats"]["verify_calls"] > 0


def test_tied_head_gathers_the_table_whole(runs):
    """llama3.2-1b's tied head at (2, 1): the table's D is split over
    `data`; the lookup gathers its rows and the logits gather the table
    whole (into the gather buffer, which is sized for it). The tokens are
    the unsharded engine's."""
    want = worker.tied_serve(None)
    for rank in runs.result()["ranks"]:
        assert rank["tied"] == want

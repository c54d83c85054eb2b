"""Sharded serving of the port (`GenerationEngine(mesh=)`) held against
the JAX reference's sharded engine and against the port's own unsharded
engine.

Two gloo ranks run the port on meshes (2, 1) and (1, 2) and a subprocess
runs the reference on two forced XLA host devices with `AxisType.Auto`
axes, XLA rounding every bf16 op (tests/torch_mesh_serve_worker.py); they
start with the module's first test and each writes its results once. The
reference's own mesh cases (tests/test_serving.py:159,
tests/test_spec_decode.py:136, tests/test_tiered.py:433) skip in a
one-device run, so they are ported here.

MoE stacks (grok-1-314b's smoke config, bf8_50 weights) are served the
same way: the experts split over `model` at (1, 2), each rank running its
own experts' bins, at (2, 1) each rank its own dispatch group; the
reference's 2-device engine serves them too (jax 0.9, Auto axes).

Tolerances. Tokens, pool planes, expert planes, snapshots and the host
bookkeeping are exact. At (1, 2) the row-parallel sites sum their partial products over
the `model` axis in another order than one matmul does: the logits are held
to one bf16 ulp of their scale (2**-7 of the largest, the fp32-accumulator
rule of ROADMAP.md; they come out bitwise here), and the row-parallel
product itself, elementwise, to one bf16 ulp of each element.
"""
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_serve_worker as worker
from repro_torch.checkpoint.ckpt import load_snapshot
from repro_torch.convert import params_from_jax
from repro_torch.dist import sharding as sh
from repro_torch.kernels.ref import CACHE_EMPTY_POS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine

HERE = pathlib.Path(__file__).resolve().parent
RANK_TIMEOUT = 300
ULP = 2.0**-7  # one bf16 ulp, relative
ITEM = "ROADMAP Queue A item 12"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Runs:
    """The two ranks and the reference of a worker module (`work`: its
    `reference_trees`, `rank_main` and `reference_main`), started once;
    `result()` waits. With `reference_first` the reference draws its own
    trees and starts before this process draws the ranks' trees."""

    def __init__(self, out: pathlib.Path, work=worker, reference_first: bool = False):
        self.out = out
        path = os.pathsep.join([str(HERE.parent / "src"), str(HERE)])
        env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
        start = lambda code, e: subprocess.Popen(
            [sys.executable, "-c", f"import {work.__name__} as w; " + code], cwd=HERE,
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jenv = dict(env, JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                              "--xla_allow_excess_precision=false")
        reference = lambda: start(f"w.reference_main({str(out)!r})", jenv)
        self.procs = [reference()] if reference_first else []
        try:
            self.trees = work.reference_trees()
            with open(out / "trees.pkl", "wb") as f:
                pickle.dump(self.trees, f)
            port = _free_port()
            self.procs += [start(f"w.rank_main({r}, 2, {port}, {str(out)!r})", env)
                           for r in range(2)]
            if not reference_first:
                self.procs.append(reference())
        except BaseException:
            self.stop()
            raise
        self._result = None

    def stop(self):
        """Kill every process still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def result(self):
        if self._result is None:
            try:
                for p in self.procs:
                    _, err = p.communicate(timeout=RANK_TIMEOUT)
                    assert p.returncode == 0, err[-4000:]
            finally:
                self.stop()
            ranks = []
            for r in range(2):
                with open(self.out / f"rank{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            with open(self.out / "reference.pkl", "rb") as f:
                self._result = {"ranks": ranks, "ref": pickle.load(f)}
        return self._result


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("mesh"))
    try:
        yield r
    finally:
        r.stop()


@pytest.fixture(scope="module")
def port_params(runs):
    return {name: params_from_jax(tree, worker.tree_config(name), device="cpu")
            for name, tree in runs.trees.items()}


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


def _serve_prompts():
    return worker.prompts(worker.config().vocab_size, worker.SERVE_LENGTHS, 1)


def _unsharded_tokens(params, model=None):
    eng = GenerationEngine(model or Model(worker.config()), params, device="cpu",
                           **worker.SERVE)
    return worker._serve(eng, _serve_prompts(), worker.SERVE_NEW)


def _same_pools(plain, sharded):
    """Two engines' pools ({plane: (layers, pages, ...)}) are equal on
    pages 1: bitwise, and page 0, the null page, holds the empty position
    in every slot of both. Every pad and inactive row of a call writes its
    K/V into the null page, and the scatter's duplicate indices land in no
    fixed order on the CPU (ROADMAP Queue C: pad writes race on the null
    page in both packages), so its K/V bytes are undefined; its positions
    are always the empty sentinel, which no causal read attends to."""
    assert plain.keys() == sharded.keys()
    for pools in (plain, sharded):
        assert (pools["ppos"][:, 0] == CACHE_EMPTY_POS).all()
    for name in plain:
        assert np.array_equal(plain[name][:, 1:], sharded[name][:, 1:]), name


# ---------------------------------------------------------------------------
# in this process, while the ranks and the reference run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_one_rank_mesh_is_the_unsharded_engine_bitwise(solo_mesh, port_params, kv_quant):
    """On a (1, 1) mesh every shard is the whole leaf and every collective
    sums or gathers one operand: the tokens, `stats()` and every pool
    plane are the unsharded engine's (`_same_pools`: the null page's K/V
    left out, its positions empty in both)."""
    model = Model(worker.config())
    engines = [GenerationEngine(model, port_params["served"], device="cpu", mesh=mesh,
                                kv_quant=kv_quant, **worker.SERVE)
               for mesh in (None, solo_mesh)]
    tokens = [worker._serve(eng, _serve_prompts(), worker.SERVE_NEW) for eng in engines]
    assert tokens[0] == tokens[1]
    assert engines[0].scheduler.stats() == engines[1].scheduler.stats()
    _same_pools(*(worker._pools(eng) for eng in engines))


def test_layout_helpers_are_identities_without_a_mesh(port_params):
    """With no serving ctx `constrain_local` returns its tensor and `tp_mm`
    is `mm`; a training ctx (whole params) leaves them alone too."""
    x = torch.randn(2, 3, 64).bfloat16()
    got, spec = sh.constrain_local(x, "bsd")
    assert got is x and spec == (None, None, None)
    wq = port_params["served"]["layers"][0]["attn"]["wq"]
    from repro_torch.core.decompress import mm

    y, ax = layers.tp_mm(x, wq)
    assert ax is None and torch.equal(y, mm(x, wq))
    assert sh.serve_ctx() is None


# ---------------------------------------------------------------------------
# the ranks and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", worker.MESHES)
def test_mesh_serving_gives_the_reference_tokens(runs, port_params, shape):
    """tests/test_serving.py:159's traffic: every rank's greedy tokens are
    the reference's engine's on the same mesh and the unsharded port's."""
    res = runs.result()
    want = res["ref"]["serve"][shape]["tokens"]
    for rank in res["ranks"]:
        assert rank["serve"][shape]["tokens"] == want
    assert _unsharded_tokens(port_params["served"]) == want


def test_data_split_pool_planes_are_the_references_bitwise(runs):
    """At (2, 1) the pages are replicated over `data`: each rank's pool,
    every plane of every layer, is the reference's (the null page left
    out: several pad writes of one call land on one of its slots)."""
    res = runs.result()
    ref = res["ref"]["serve"][(2, 1)]["pools"]
    for rank in res["ranks"]:
        pools = rank["serve"][(2, 1)]["pools"]
        assert pools.keys() == ref.keys()
        for name, plane in pools.items():
            assert np.array_equal(plane[:, 1:], ref[name][:, 1:]), name


def test_model_split_pools_hold_each_ranks_kv_heads(runs):
    """At (1, 2) rank i holds KV head i of the reference's two, bitwise,
    and the position plane whole."""
    res = runs.result()
    ref = res["ref"]["serve"][(1, 2)]["pools"]
    for i, rank in enumerate(res["ranks"]):
        for name, plane in rank["serve"][(1, 2)]["pools"].items():
            want = ref[name] if name == "ppos" else ref[name][:, :, :, i:i + 1]
            assert np.array_equal(plane[:, 1:], want[:, 1:]), name


def test_model_split_logits_within_fp32_accumulator_tolerance(runs):
    """The prefill logits the sampler sees at (1, 2): whole rows on every
    rank, the two ranks' equal, within one bf16 ulp of the reference's."""
    res = runs.result()
    ref = res["ref"]["serve"][(1, 2)]["logits"]
    r0, r1 = (rank["serve"][(1, 2)]["logits"] for rank in res["ranks"])
    assert len(r0) == len(ref) == 2
    for a, b, want in zip(r0, r1, ref):
        assert a.shape == want.shape and np.array_equal(a, b)
        np.testing.assert_allclose(a, want, rtol=0, atol=ULP * np.abs(want).max())


def test_row_parallel_site_sums_f32_partials_and_rounds_once(runs):
    """Layer 0's wo at (1, 2) is row-parallel (K over `model`). The f32
    partial products summed over the axis and rounded once are within one
    bf16 ulp of the reference's partitioned dot, element by element, and
    all but a few equal; bf16 partials summed miss it on a share of the
    elements that rounding twice explains."""
    res = runs.result()
    row, want = res["ranks"][0]["row"], res["ref"]["row"]
    assert row["k_axis"] == "model" and row["local_shape"] == (32, 64)
    np.testing.assert_array_equal(row["f32_sum"], res["ranks"][1]["row"]["f32_sum"])
    np.testing.assert_allclose(row["f32_sum"], want, rtol=ULP, atol=0)
    f32_off = int((row["f32_sum"] != want).sum())
    bf16_off = int((row["bf16_sum"] != want).sum())
    assert f32_off <= 0.01 * want.size
    assert bf16_off > 0.1 * want.size and bf16_off > f32_off


def test_replicated_kv_heads_on_a_model_split(runs, port_params):
    """One KV head at (1, 2): wk's 16 columns split over `model` while its
    head cannot, so the K/V projections are gathered whole, the query
    heads with them, and wo's K is cut again. Tokens are the reference's
    and the unsharded port's; the prefill logits within one bf16 ulp."""
    res = runs.result()
    ref = res["ref"]["mqa"]
    for rank in res["ranks"]:
        assert rank["mqa"]["tokens"] == ref["tokens"]
        for a, want in zip(rank["mqa"]["logits"], ref["logits"]):
            np.testing.assert_allclose(a, want, rtol=0, atol=ULP * np.abs(want).max())
    assert _unsharded_tokens(port_params["mqa"], Model(worker.config(mqa=True))) == ref["tokens"]


def test_spec_on_a_mesh_is_bitwise_the_plain_engine_on_the_mesh(runs):
    """tests/test_spec_decode.py:136: k = 2 with an nf4 draft tree built
    from the whole params, at (2, 1), gives the plain mesh engine's tokens."""
    for rank in runs.result()["ranks"]:
        spec = rank["spec"]
        assert spec["spec"] == spec["plain"]
        assert spec["stats"]["draft_tokens"] > 0 and spec["stats"]["verify_calls"] > 0


def test_snapshot_restore_on_a_mesh_resumes_bitwise(runs):
    """tests/test_tiered.py:433 at (2, 1), int8 KV, T = 0.7: a fresh mesh
    engine restored from the snapshot, and the original engine after it,
    finish both sessions with the uninterrupted mesh engine's tokens; the
    resume rode the tier."""
    for rank in runs.result()["ranks"]:
        snap = rank["snap"]
        assert snap["restored"] == snap["counts"] and snap["counts"]["requests"] >= 1
        assert snap["resumed"] == snap["want"]
        assert snap["original"] == snap["want"][1]
        assert snap["tier"]["tier_restored_pages"] > 0 and snap["tier"]["tier_hit_tokens"] > 0
        assert snap["tier"]["tier_fallback_recompute"] == 0


def test_data_split_snapshot_is_the_unsharded_engines_bytes(runs, port_params, tmp_path):
    """A snapshot holds whole pages in the reference's format: the (2, 1)
    engine's is the unsharded engine's at the same point, payloads and
    CRCs included."""
    runs.result()
    model = Model(worker.config())
    eng = GenerationEngine(model, port_params["dense"], device="cpu", **worker.SNAP)
    pa, pb = worker.prompts(model.cfg.vocab_size, worker.SNAP_LENGTHS, 3)
    eng.submit(pa, max_new_tokens=worker.SNAP_NEW[0])
    eng.submit(pb, max_new_tokens=worker.SNAP_NEW[1])
    eng.scheduler.step()
    eng.scheduler.step()
    eng.snapshot(str(tmp_path / "snap"))
    arrays, meta = load_snapshot(str(tmp_path / "snap"))
    got_arrays, got_meta = load_snapshot(str(runs.out / "snap21"))
    assert got_meta == meta
    assert got_arrays.keys() == arrays.keys()
    for k in arrays:
        assert np.array_equal(got_arrays[k], arrays[k]), k


def test_model_split_snapshot_restores_in_an_unsharded_engine(runs, port_params):
    """A (1, 2) engine's snapshot (each page's KV heads gathered whole,
    mxfp4_100 weights) restores in an unsharded port engine, every payload
    verifying, and the resumed sessions emit the (1, 2) engine's own
    tokens."""
    res = runs.result()
    model = Model(worker.config())
    eng = GenerationEngine(model, port_params["served"], device="cpu", **worker.SNAP)
    counts = res["ranks"][0]["snap12"]["counts"]
    assert eng.restore(str(runs.out / "snap12")) == counts
    done = eng.run_until_drained()
    rids = sorted(done)
    assert [done[r].tolist() for r in rids] == res["ranks"][0]["snap12"]["tokens"]
    st = eng.scheduler.stats()
    assert st["tier_restored_pages"] > 0 and st["tier_fallback_recompute"] == 0


def test_deferred_cases_raise_naming_their_roadmap_item(runs):
    """sla / injector / watchdog on two ranks raise ValueError naming
    ROADMAP Queue A item 12; none is served unsharded instead. (MoE stacks
    are served: the tests below; the dense ring engine too:
    tests/test_torch_ring_mesh.py; fsdp too: tests/test_torch_fsdp_serve.py.)"""
    for rank in runs.result()["ranks"]:
        assert set(rank["refusals"]) == {"sla", "injector", "watchdog"}
        for case, msg in rank["refusals"].items():
            assert ITEM in msg, (case, msg)


# ---------------------------------------------------------------------------
# MoE stacks: the experts split over `model`
# ---------------------------------------------------------------------------

def test_one_rank_moe_mesh_is_the_unsharded_engine_bitwise(solo_mesh, port_params):
    """grok's smoke stack on a (1, 1) mesh: every expert local, the
    gathers over one rank; tokens, `stats()` and every pool plane are the
    unsharded engine's (`_same_pools`: the null page's K/V left out, its
    positions empty in both), and the local expert planes are the whole
    leaf's planes, not copies."""
    model = Model(worker.tree_config("moe"))
    params = port_params["moe"]
    engines = [GenerationEngine(model, params, device="cpu", mesh=mesh, kv_quant="int8",
                                **worker.MOE_SERVE) for mesh in (None, solo_mesh)]
    tokens = [worker._serve(eng, worker.moe_prompts(), worker.SERVE_NEW) for eng in engines]
    assert tokens[0] == tokens[1]
    assert engines[0].scheduler.stats() == engines[1].scheduler.stats()
    _same_pools(*(worker._pools(eng) for eng in engines))
    experts = worker.expert_planes(engines[1], params)
    assert experts["views"] and experts["ranges"] == [(0, 1, 2, 3)]


@pytest.mark.parametrize("shape", worker.MESHES)
def test_moe_mesh_serving_gives_the_reference_tokens(runs, port_params, shape):
    """MOE's traffic on grok's smoke stack: every rank's greedy tokens are
    the reference's sharded engine's on the same mesh and, bitwise, the
    port's unsharded engine's."""
    res = runs.result()
    want = res["ref"]["moe"][shape]["tokens"]
    for rank in res["ranks"]:
        assert rank["moe"][shape]["tokens"] == want
    eng = GenerationEngine(Model(worker.tree_config("moe")), port_params["moe"], device="cpu",
                           **worker.MOE_SERVE)
    assert worker._serve(eng, worker.moe_prompts(), worker.SERVE_NEW) == want


def test_moe_data_split_pool_planes_are_the_references_bitwise(runs):
    """At (2, 1) each rank routes its own dispatch group, the reference's:
    every pool plane of every layer is the reference's (null page left
    out), the layer after an MoE FFN included."""
    res = runs.result()
    ref = res["ref"]["moe"][(2, 1)]["pools"]
    for rank in res["ranks"]:
        pools = rank["moe"][(2, 1)]["pools"]
        assert pools.keys() == ref.keys()
        for name, plane in pools.items():
            assert np.array_equal(plane[:, 1:], ref[name][:, 1:]), name


def test_moe_model_split_logits_within_fp32_accumulator_tolerance(runs):
    """At (1, 2) the experts are split and the attention's wo is
    row-parallel: the prefill logits are whole and equal on both ranks,
    within one bf16 ulp of their scale of the reference's."""
    res = runs.result()
    ref = res["ref"]["moe"][(1, 2)]["logits"]
    r0, r1 = (rank["moe"][(1, 2)]["logits"] for rank in res["ranks"])
    assert len(r0) == len(ref) == 1  # one prefill call
    for a, b, want in zip(r0, r1, ref):
        assert a.shape == want.shape and np.array_equal(a, b)
        np.testing.assert_allclose(a, want, rtol=0, atol=ULP * np.abs(want).max())


def test_each_rank_holds_only_its_experts_planes(runs, port_params):
    """At (1, 2) rank r's expert leaves are experts [2r, 2r + 1] of the
    whole leaves, bitwise, for every plane the codec has (bf8_50: codes
    and mask; no scales on either side), each plane a view of the whole
    leaf's, and `expert_range` names those experts."""
    whole = port_params["moe"]["layers"]
    held = {f"{i}/{name}/{which}" for i, layer in enumerate(whole)
            for name, leaf in layer["moe"].items() if name != "router"
            for which in ("codes", "mask", "scales") if getattr(leaf, which) is not None}
    assert {k.rsplit("/", 1)[1] for k in held} == {"codes", "mask"}
    for r, rank in enumerate(runs.result()["ranks"]):
        experts = rank["moe"]["experts"]
        assert experts["views"] and experts["ranges"] == [(2 * r, 2 * r + 1)]
        assert set(experts["planes"]) == held
        for key, plane in experts["planes"].items():
            layer, name, which = key.split("/")
            want = getattr(whole[int(layer)]["moe"][name], which)[2 * r:2 * r + 2]
            assert np.array_equal(plane, want.numpy()), key


def test_moe_spec_on_a_model_split_is_bitwise_the_plain_mesh_engine(runs):
    """k = 2 with an nf4 draft re-encoded from each rank's local experts,
    at (1, 2): the plain mesh engine's tokens, bitwise."""
    for rank in runs.result()["ranks"]:
        spec = rank["moe"]["spec"]
        assert spec["spec"] == spec["plain"]
        assert spec["stats"]["draft_tokens"] > 0 and spec["stats"]["verify_calls"] > 0


def test_non_dividing_expert_count_runs_every_expert_on_every_rank(runs):
    """E = 3 at (1, 2): the expert dim of every expert leaf is whole (its
    spec entry None), w_up / w_gate split their N and w_down its K over
    `model`, so every rank runs all three experts' FFNs on its column and
    row shards; the tokens are the unsharded engine's."""
    for rank in runs.result()["ranks"]:
        odd = rank["moe"]["odd"]
        assert odd["mesh"] == odd["plain"]
        assert odd["specs"] == {"w_up": (None, None, None, "model"),
                                "w_gate": (None, None, None, "model"),
                                "w_down": (None, "model", None, None)}


def test_non_dividing_expert_count_replicates_the_expert_dim():
    """E = 3 at `model` = 2: the expert dim cannot split, so its spec
    entry is None and the leaf's K / N take `model` as the dense weight's
    would, entry for entry the reference's `param_spec_tree` (on its
    stacked `blocks` leaves, less their layer dim), dense and bf8_50."""
    import dataclasses

    import jax

    from repro.core.compression import CompressedTensor as JCT
    from repro.core.decompress import compress_tree as jcompress_tree
    from repro.core.formats import get_spec as jget_spec
    from repro.dist import sharding as jsh
    from repro.models.model import Model as JModel
    from repro_torch.core.decompress import compress_tree
    from repro_torch.core.formats import get_spec
    from repro_torch.launch.mesh import RuleMesh

    class Ctx:
        axis_sizes, fsdp, mode = {"data": 1, "model": 2}, False, "serve"

    cfg = dataclasses.replace(worker.tree_config("moe"), n_experts=3)
    jcfg = dataclasses.replace(worker.tree_config("moe", reference=True), n_experts=3)
    jdense = JModel(jcfg).init(jax.random.PRNGKey(0))
    model = Model(cfg)
    dense = model.init(torch.Generator().manual_seed(0), device="cpu")
    ctx = sh.ShardingCtx(RuleMesh((1, 2), ("data", "model")), mode="serve")
    as_tuple = lambda sp: (tuple(None if p is None else tuple(p)[1:]
                                 for p in (sp.codes, sp.mask, sp.scales))
                           if isinstance(sp, JCT) else tuple(sp)[1:])
    for jtree, tree in ((jdense, dense),
                        (jcompress_tree(jdense, jget_spec("bf8_50")),
                         compress_tree(dense, get_spec("bf8_50"), layer_stack=model.layer_stack))):
        want = jsh.param_spec_tree(jtree, Ctx(), scan_stacked=True)["blocks"]["moe"]
        got = sh.param_spec_tree(tree, ctx)["layers"][0]["moe"]
        for name in ("w_up", "w_gate", "w_down"):
            spec = got[name]
            assert as_tuple(want[name]) == (tuple(spec) if isinstance(spec, sh.CompressedSpec)
                                            else spec), name
            assert (spec.codes if isinstance(spec, sh.CompressedSpec) else spec)[0] is None

"""The processes of tests/test_torch_mesh_serve.py.

`rank_main(rank, world, port, out)` is one rank of a gloo world of two on
the CPU (it imports torch and the port only); `reference_main(out)` runs
the reference's engine on two forced XLA host devices with `AxisType.Auto`
axes (jax 0.9's default axes fail the reference's sharded serving with a
`ShardingTypeError` in the embedding gather). Both read the seeded
reference trees the test wrote to `out/trees.pkl` (the port's through
`params_from_jax`); each writes its results once, and the test reads them.

The cases, on llama3-8b's smoke config:
  SERVE  tests/test_serving.py:159's traffic (prompts of 4, 19 and 11
         tokens, 4 new tokens each, 2 slots, 8-token pages) with mxfp4_100
         weights, at (2, 1) and (1, 2): tokens, every pool plane, the
         prefill logits the sampler sees;
  MQA    the same traffic on a copy with one KV head, at (1, 2): wk's N
         divides the mesh while its one head does not;
  ROW    layer 0's wo (row-parallel at (1, 2)) on seeded rows;
  SPEC   tests/test_spec_decode.py:136: plain and spec (k = 2, nf4 draft)
         on the dense tree at (2, 1), 10 new tokens (port only);
  SNAP   tests/test_tiered.py:433's snapshot cycle at (2, 1), int8 KV,
         T = 0.7, on the dense tree, and a (1, 2) engine's snapshot on the
         mxfp4_100 tree for an unsharded restore (port only).
and on grok-1-314b's smoke config (4 experts, top-2, capacity 4.0, 4 q /
2 kv heads) with bf8_50 weights:
  MOE    prompts of 4, 19, 11 and 7 tokens, 4 new tokens each, 4 slots
         (one prefill call and one decode chunk: each compiles once in the
         reference), at (2, 1) and (1, 2): tokens, every pool plane, the
         prefill logits; at (1, 2) each rank's local expert planes;
  MOE_SPEC  SERVE's prompts, plain and spec (k = 2, nf4 draft) at (1, 2),
         SPEC_NEW new tokens (port only);
  ODD    3 experts at (1, 2), which `model` does not divide: MOE's traffic
         on the mesh and unsharded (port only, the port's own seeded tree).
"""
import dataclasses
import pickle

import numpy as np

ARCH = "llama3-8b"
SERVE_FMT = "mxfp4_100"
SERVE = dict(max_len=64, block_size=8, max_slots=2)
SERVE_LENGTHS, SERVE_NEW = (4, 19, 11), 4
SPEC_NEW, SPEC_ENGINE = 10, dict(max_len=64, block_size=8, max_slots=2, decode_chunk=8)
SNAP = dict(max_len=64, block_size=8, max_slots=2, decode_chunk=4, num_blocks=16,
            prefix_cache=True, host_tier=True, kv_quant="int8", temperature=0.7)
SNAP_LENGTHS, SNAP_NEW = (17, 33), (4, 12)
ROW_ROWS = 48
MESHES = ((2, 1), (1, 2))
MOE_ARCH, MOE_FMT = "grok-1-314b", "bf8_50"
MOE_SERVE, MOE_LENGTHS = dict(max_len=64, block_size=8, max_slots=4), (4, 19, 11, 7)


def config(mqa=False, reference=False, arch=ARCH):
    """The smoke config of either package; `mqa` with one KV head."""
    import importlib

    base = importlib.import_module("repro.configs.base" if reference else
                                   "repro_torch.configs.base")
    cfg = base.get_smoke_config(arch)
    return dataclasses.replace(cfg, n_kv_heads=1) if mqa else cfg


def tree_config(name, reference=False):
    """The config a tree of `reference_trees` was drawn for."""
    return config(mqa=name == "mqa", reference=reference,
                  arch=MOE_ARCH if name == "moe" else ARCH)


def prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def moe_prompts():
    return prompts(tree_config("moe").vocab_size, MOE_LENGTHS, 1)


def row_input():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((ROW_ROWS, 64)) * 0.5).astype(np.float32)


def reference_trees():
    """The reference's trees: `dense` (PRNGKey(0), as the reference's
    llama fixtures), `served` (it compressed to SERVE_FMT), `mqa` (the
    one-KV-head copy, compressed) and `moe` (grok's smoke tree compressed
    to MOE_FMT), on the host."""
    import jax

    from repro.core.decompress import compress_tree
    from repro.core.formats import get_spec
    from repro.models.model import Model

    dense = Model(config(reference=True)).init(jax.random.PRNGKey(0))
    mqa = Model(config(mqa=True, reference=True)).init(jax.random.PRNGKey(0))
    moe = Model(tree_config("moe", reference=True)).init(jax.random.PRNGKey(0))
    spec = get_spec(SERVE_FMT)
    return jax.device_get({"dense": dense, "served": compress_tree(dense, spec),
                           "mqa": compress_tree(mqa, spec),
                           "moe": compress_tree(moe, get_spec(MOE_FMT))})


def _record_logits(eng, into):
    """The logits every sampler call of `eng` sees (the prefill rounds')."""
    sched = eng.scheduler
    sample = sched._sample

    def on_sample(logits, *a, **kw):
        into.append(np.asarray(logits, np.float32).copy())
        return sample(logits, *a, **kw)

    sched._sample = on_sample


def _serve(eng, ps, new):
    rids = [eng.submit(p, max_new_tokens=new) for p in ps]
    done = eng.run_until_drained()
    return [done[r].tolist() for r in rids]


def _pools(eng):
    """{plane name: (layers, ...) array} of a port engine's pools."""
    import torch

    names = eng.kv.pools[0]
    return {n: torch.stack([layer[n] for layer in eng.kv.pools]).view(
        torch.int16 if eng.kv.pools[0][n].dtype == torch.bfloat16 else
        eng.kv.pools[0][n].dtype).numpy() for n in names}


def _snapshot_cycle(model, params, mesh, snap_dir):
    """tests/test_tiered.py's cycle on `mesh`: the uninterrupted tokens,
    the restored engine's, the original engine's after its snapshot, and
    the resumed engine's tier stats."""
    from repro_torch.serve.engine import GenerationEngine

    pa, pb = prompts(model.cfg.vocab_size, SNAP_LENGTHS, 3)
    new = lambda: GenerationEngine(model, params, device="cpu", mesh=mesh, **SNAP)
    ref = new()
    ra, rb = (ref.submit(p, max_new_tokens=n) for p, n in ((pa, SNAP_NEW[0]), (pb, SNAP_NEW[1])))
    want = ref.run_until_drained()
    eng = new()
    a, b = (eng.submit(p, max_new_tokens=n) for p, n in ((pa, SNAP_NEW[0]), (pb, SNAP_NEW[1])))
    eng.scheduler.step()
    eng.scheduler.step()  # a finishes (undrained); b is mid-decode
    counts = eng.snapshot(snap_dir)
    fresh = new()
    restored = fresh.restore(snap_dir)
    got = fresh.run_until_drained()
    st = fresh.scheduler.stats()
    fresh.scheduler.check_invariants()
    orig = eng.run_until_drained()
    return {"counts": counts, "restored": restored,
            "want": [want[ra].tolist(), want[rb].tolist()],
            "resumed": [got[a].tolist(), got[b].tolist()],
            "original": orig[b].tolist(),
            "tier": {k: st[k] for k in ("tier_restored_pages", "tier_hit_tokens",
                                        "tier_fallback_recompute")}}


def refusals(model, params, mesh):
    """What each deferred case raises on `mesh` ({case: message}), or
    'served' where it builds."""
    from repro_torch.dist.fault import FaultInjector, StragglerWatchdog
    from repro_torch.serve.engine import GenerationEngine
    from repro_torch.serve.slo import SLAPolicy

    cases = {
        "sla": {"sla": SLAPolicy(max_queue=4)},
        "injector": {"injector": FaultInjector({})},
        "watchdog": {"watchdog": StragglerWatchdog()},
    }
    out = {}
    for name, kw in cases.items():
        try:
            GenerationEngine(model, params, device="cpu", mesh=mesh, max_len=64, block_size=8,
                             **kw)
            out[name] = "served"
        except ValueError as e:
            out[name] = str(e)
    return out


def expert_planes(eng, whole):
    """A (1, 2) MoE engine's local expert leaves: {layer/name/plane: the
    local plane}, and whether each is a view of the whole leaf's plane
    (`whole`: the tree the engine was given), with the experts
    `sharding.expert_range` names."""
    from repro_torch.dist import sharding as sh

    planes, views, ranges = {}, [], set()
    for i, (mine, full) in enumerate(zip(eng.params["layers"], whole["layers"])):
        for name, leaf in mine["moe"].items():
            if name == "router":
                continue
            ranges.add(tuple(sh.expert_range(leaf, eng._ctx)[0]))
            for plane in ("codes", "mask", "scales"):
                t = getattr(leaf, plane)
                if t is not None:
                    planes[f"{i}/{name}/{plane}"] = t.numpy().copy()
                    views.append(t.untyped_storage().data_ptr()
                                 == getattr(full["moe"][name], plane).untyped_storage().data_ptr())
    return {"planes": planes, "views": all(views), "ranges": sorted(ranges)}


def moe_cases(params, meshes, ps):
    """MOE at both meshes and MOE_SPEC at (1, 2) on this rank."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine, SpecConfig

    moe = Model(tree_config("moe"))
    res = {}
    for shape, mesh in meshes.items():
        eng = GenerationEngine(moe, params, device="cpu", mesh=mesh, **MOE_SERVE)
        logits = []
        _record_logits(eng, logits)
        res[shape] = {"tokens": _serve(eng, moe_prompts(), SERVE_NEW), "pools": _pools(eng),
                      "logits": logits}
        if shape == (1, 2):
            res["experts"] = expert_planes(eng, params)
    mesh = meshes[(1, 2)]
    res["spec"] = {"plain": _serve(GenerationEngine(moe, params, device="cpu", mesh=mesh,
                                                    **SPEC_ENGINE), ps, SPEC_NEW)}
    spec_eng = GenerationEngine(moe, params, device="cpu", mesh=mesh,
                                spec_decode=SpecConfig(k=2, draft_codec="nf4"), **SPEC_ENGINE)
    res["spec"]["spec"] = _serve(spec_eng, ps, SPEC_NEW)
    res["spec"]["stats"] = spec_eng.scheduler.stats()
    res["odd"] = odd_experts(mesh)
    return res


def odd_experts(mesh):
    """E = 3 at (1, 2), port only: the expert dim stays whole, so every
    rank runs every expert on column- and row-parallel shards of its
    weights. The tokens of the mesh engine and of the unsharded one, and
    the spec entries of layer 0's expert leaves."""
    import torch

    from repro_torch.core.decompress import compress_tree
    from repro_torch.core.formats import get_spec
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine

    model = Model(dataclasses.replace(tree_config("moe"), n_experts=3))
    params = compress_tree(model.init(torch.Generator().manual_seed(0), device="cpu"),
                           get_spec(MOE_FMT), layer_stack=model.layer_stack)
    out = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        eng = GenerationEngine(model, params, device="cpu", mesh=m, **MOE_SERVE)
        out[name] = _serve(eng, moe_prompts(), SERVE_NEW)
        if m is not None:
            layer = eng.params["layers"][0]["moe"]
            out["specs"] = {n: tuple(eng._ctx.leaf_specs[id(layer[n])][1].codes)
                            for n in ("w_up", "w_gate", "w_down")}
    return out


def rank_main(rank, world, port, out):
    """One rank: SERVE at both meshes, MQA and ROW at (1, 2), SPEC and the
    SNAP cycle at (2, 1), and a (1, 2) engine's snapshot (rank 0 writes it
    to out/snap12) after its first two rounds; then MOE and MOE_SPEC."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import params_from_jax
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine, SpecConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        with open(f"{out}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        model, mqa = Model(config()), Model(config(mqa=True))
        params = {name: params_from_jax(tree, tree_config(name), device="cpu")
                  for name, tree in trees.items()}
        meshes = {shape: make_test_mesh(*shape, device="cpu") for shape in MESHES}
        res = {"serve": {}}
        ps = prompts(model.cfg.vocab_size, SERVE_LENGTHS, 1)
        for shape, mesh in meshes.items():
            eng = GenerationEngine(model, params["served"], device="cpu", mesh=mesh, **SERVE)
            logits = []
            _record_logits(eng, logits)
            res["serve"][shape] = {"tokens": _serve(eng, ps, SERVE_NEW), "pools": _pools(eng),
                                   "logits": logits, "stats": eng.scheduler.stats()}
        eng = GenerationEngine(mqa, params["mqa"], device="cpu", mesh=meshes[(1, 2)], **SERVE)
        logits = []
        _record_logits(eng, logits)
        res["mqa"] = {"tokens": _serve(eng, ps, SERVE_NEW), "logits": logits}

        # ROW: layer 0's wo on this rank's shard of K, summed over `model`
        ctx = sh.ShardingCtx(meshes[(1, 2)], mode="serve")
        wo = sh.local_tree(params["served"], ctx)["layers"][0]["attn"]["wo"]
        x = torch.from_numpy(row_input()).bfloat16()
        with sh.scope(ctx):
            f32_sum, k_ax = layers.tp_mm(x, wo)[0], sh.matmul_axes(wo, ctx)[0]
            part = ops.decompress_gemm(sh.cut(x, k_ax, ctx, 1), wo, out_dtype=torch.bfloat16)
            bf16_sum = sh.all_reduce(part, k_ax, ctx)
        res["row"] = {"k_axis": k_ax, "local_shape": wo.shape,
                      "f32_sum": f32_sum.float().numpy(), "bf16_sum": bf16_sum.float().numpy()}

        mesh21 = meshes[(2, 1)]
        sps = prompts(model.cfg.vocab_size, SERVE_LENGTHS, 1)
        res["spec"] = {
            "plain": _serve(GenerationEngine(model, params["dense"], device="cpu", mesh=mesh21,
                                             **SPEC_ENGINE), sps, SPEC_NEW)}
        spec_eng = GenerationEngine(model, params["dense"], device="cpu", mesh=mesh21,
                                    spec_decode=SpecConfig(k=2, draft_codec="nf4"),
                                    **SPEC_ENGINE)
        res["spec"]["spec"] = _serve(spec_eng, sps, SPEC_NEW)
        res["spec"]["stats"] = spec_eng.scheduler.stats()

        res["snap"] = _snapshot_cycle(model, params["dense"], mesh21, f"{out}/snap21")

        # a (1, 2) engine's snapshot after its first two rounds, and the
        # tokens it goes on to emit; compressed weights, whose row-parallel
        # sums are f32 (a dense tree's bf16 partials give other tokens at
        # (1, 2), in the reference as here)
        pa, pb = prompts(model.cfg.vocab_size, SNAP_LENGTHS, 3)
        eng = GenerationEngine(model, params["served"], device="cpu", mesh=meshes[(1, 2)],
                               **SNAP)
        a, b = (eng.submit(p, max_new_tokens=n) for p, n in ((pa, SNAP_NEW[0]),
                                                              (pb, SNAP_NEW[1])))
        eng.scheduler.step()
        eng.scheduler.step()
        res["snap12"] = {"counts": eng.snapshot(f"{out}/snap12")}
        done = eng.run_until_drained()
        res["snap12"]["tokens"] = [done[a].tolist(), done[b].tolist()]
        res["refusals"] = refusals(model, params["dense"], mesh21)
        res["moe"] = moe_cases(params["moe"], meshes, ps)
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _words(eng):
    """A reference engine's pools, bf16 planes as int16 words."""
    pools = {n: np.asarray(v) for n, v in eng.kv.pools.items()}
    return {n: v.view(np.int16) if v.dtype.itemsize == 2 and v.dtype.kind == "V" or
            str(v.dtype) == "bfloat16" else v for n, v in pools.items()}


def reference_main(out):
    """The reference's SERVE at both meshes (tokens, pools as int16 /
    int32 / uint8 words, the prefill logits), MQA at (1, 2) (tokens,
    logits), MOE at both meshes (as SERVE) and ROW at (1, 2): wo's product
    with x split over `model` along K and wo placed by `shard_params`, so
    the dot is partitioned."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.core.decompress import mm
    from repro.dist import sharding as sh
    from repro.models.model import Model
    from repro.serve.engine import GenerationEngine

    with open(f"{out}/trees.pkl", "rb") as f:
        trees = pickle.load(f)
    auto = (AxisType.Auto, AxisType.Auto)
    meshes = {shape: jax.make_mesh(shape, ("data", "model"), axis_types=auto)
              for shape in MESHES}
    model, mqa = Model(config(reference=True)), Model(config(mqa=True, reference=True))
    ps = prompts(model.cfg.vocab_size, SERVE_LENGTHS, 1)
    res = {"serve": {}}
    for shape, mesh in meshes.items():
        eng = GenerationEngine(model, trees["served"], mesh=mesh, paged=True, **SERVE)
        logits = []
        _record_logits(eng, logits)
        tokens = _serve(eng, ps, SERVE_NEW)
        res["serve"][shape] = {"tokens": tokens, "pools": _words(eng), "logits": logits}
    eng = GenerationEngine(mqa, trees["mqa"], mesh=meshes[(1, 2)], paged=True, **SERVE)
    logits = []
    _record_logits(eng, logits)
    res["mqa"] = {"tokens": _serve(eng, ps, SERVE_NEW), "logits": logits}
    moe = Model(tree_config("moe", reference=True))
    res["moe"] = {}
    for shape, mesh in meshes.items():
        eng = GenerationEngine(moe, trees["moe"], mesh=mesh, paged=True, **MOE_SERVE)
        logits = []
        _record_logits(eng, logits)
        res["moe"][shape] = {"tokens": _serve(eng, moe_prompts(), SERVE_NEW),
                             "pools": _words(eng),
                             "logits": logits}

    mesh = meshes[(1, 2)]
    ctx = sh.ShardingCtx(mesh, mode="serve")
    placed = sh.shard_params(trees["served"], ctx, scan_stacked=True)
    wo = jax.tree.map(lambda a: a[0], placed["blocks"]["attn"]["wo"])
    x = jax.device_put(jnp.asarray(row_input(), jnp.bfloat16), NamedSharding(mesh, P(None, "model")))
    with mesh:
        y = jax.jit(mm)(x, wo)
    res["row"] = np.asarray(y.astype(jnp.float32))
    with open(f"{out}/reference.pkl", "wb") as f:
        pickle.dump(res, f)

"""The processes of tests/test_torch_fsdp_serve.py: `GenerationEngine(mesh=,
fsdp=True)`, each rank holding its `data` share of every FC leaf and
gathering it whole at the point of use.

`rank_main(rank, world, port, out)` is one rank of a gloo world of two on
the CPU (torch and the port only); `reference_main(out)` runs the
reference's fsdp engines on two forced XLA host devices with
`AxisType.Auto` axes. The reference draws its seeded trees itself
(`reference_trees`, as the test process draws them for the ranks), so it
starts first. Each writes its results once. The helpers of
tests/torch_mesh_serve_worker.py and tests/torch_ring_mesh_worker.py are
reused.

The cases, every mesh engine with fsdp=True:
  SERVE  llama3-8b's smoke stack with mxfp4_100 weights and
         tests/test_serving.py's traffic (prompts of 4, 19 and 11 tokens,
         4 new), at (2, 1) and (1, 2): tokens, every pool plane, the
         prefill logits; at (2, 1) each rank's local leaves against the
         whole tree (`shares`);
  DENSE  the dense llama3-8b tree at (2, 1): tokens, pools and prefill
         logits; in the reference also the rows and all-reduces of each
         prefill call's partitioned program;
  MOE    grok-1-314b's smoke stack with bf8_50 weights and the MOE traffic
         of tests/torch_mesh_serve_worker.py, at (2, 1): tokens, pools, the
         local leaves (`shares`);
  RING   falcon-mamba-7b's dense smoke stack through the dense ring engine
         (tests/torch_ring_mesh_worker.py's batch), at (2, 1): tokens;
  SPEC   SERVE's tree, plain and spec (k = 2, nf4 draft) at (2, 1),
         SPEC_NEW new tokens (port only);
  TIED   llama3.2-1b's smoke stack (a tied head: the embedding table
         gathered whole for the logits), the port's own seeded tree, at
         (2, 1): tokens (port only).
"""
import pickle

import numpy as np

import torch_mesh_serve_worker as mw
import torch_ring_mesh_worker as rw

RING_ARCH = rw.ARCHS[0]
TIED_ARCH = "llama3.2-1b"
DATA = (2, 1)


def reference_trees():
    """The seeded trees this file serves, on the host: `dense`, `served`
    and `moe` as `torch_mesh_serve_worker.reference_trees` draws them, and
    falcon-mamba-7b's dense smoke tree (`ring`)."""
    import jax

    from repro.core.decompress import compress_tree
    from repro.core.formats import get_spec
    from repro.models.model import Model

    dense = Model(mw.config(reference=True)).init(jax.random.PRNGKey(0))
    moe = Model(mw.tree_config("moe", reference=True)).init(jax.random.PRNGKey(0))
    return jax.device_get({"dense": dense, "served": compress_tree(dense, get_spec(mw.SERVE_FMT)),
                           "moe": compress_tree(moe, get_spec(mw.MOE_FMT)),
                           "ring": rw.dense_tree(RING_ARCH)})


def tree_config(name, reference=False):
    """The config a tree of `reference_trees` was drawn for."""
    if name == "ring":
        return rw.config(RING_ARCH, reference)
    return mw.tree_config(name, reference)


def serve_prompts():
    return mw.prompts(mw.config().vocab_size, mw.SERVE_LENGTHS, 1)


def tied_serve(mesh):
    """TIED on `mesh` (None: unsharded): the tokens of SERVE's traffic."""
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine

    model = Model(get_smoke_config(TIED_ARCH))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = GenerationEngine(model, params, device="cpu", mesh=mesh, fsdp=mesh is not None,
                           **mw.SERVE)
    ps = mw.prompts(model.cfg.vocab_size, mw.SERVE_LENGTHS, 1)
    return mw._serve(eng, ps, mw.SERVE_NEW)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def shares(eng, whole):
    """Each local leaf of a mesh engine with a `data` entry, against the
    whole tree it was given: {path: {local, whole (bytes), planes: [(the
    plane's `data` dim, a view of the whole plane, equal to its block of
    the whole plane)]}}, and the paths of the leaves held whole."""
    from repro_torch.core.compression import CompressedTensor
    from repro_torch.dist import sharding as sh

    ctx, out, kept = eng._ctx, {}, []
    nbytes = lambda leaf: leaf.nbytes if isinstance(leaf, CompressedTensor) else (
        leaf.numel() * leaf.element_size())
    for (path, mine), (_, full) in zip(_walk(eng.params), _walk(whole)):
        spec = sh.leaf_spec(mine, ctx)
        planes = sh.planes(mine, spec)
        if all(sh.fsdp_dim(p) is None for _, p in planes):
            kept.append(path)
            continue
        fulls = [t for t, _ in sh.planes(full, spec)]
        out[path] = {"local": nbytes(mine), "whole": nbytes(full), "planes": [
            (sh.fsdp_dim(p), t.untyped_storage().data_ptr() == f.untyped_storage().data_ptr(),
             bool((t == sh.local_shard(f, p, ctx)).all()))
            for (t, p), f in zip(planes, fulls)]}
    return {"leaves": out, "kept": kept}


def rank_main(rank, world, port, out):
    """SERVE at both meshes, then DENSE, MOE, RING, SPEC and TIED at (2, 1)."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine, SpecConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        with open(f"{out}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        params = {name: params_from_jax(tree, tree_config(name), device="cpu")
                  for name, tree in trees.items()}
        meshes = {shape: make_test_mesh(*shape, device="cpu") for shape in mw.MESHES}
        model = Model(mw.config())
        fsdp = lambda m, tree, mesh, **kw: GenerationEngine(m, params[tree], device="cpu",
                                                            mesh=mesh, fsdp=True, **kw)
        res = {"serve": {}}
        for shape, mesh in meshes.items():
            eng = fsdp(model, "served", mesh, **mw.SERVE)
            logits = []
            mw._record_logits(eng, logits)
            res["serve"][shape] = {"tokens": mw._serve(eng, serve_prompts(), mw.SERVE_NEW),
                                   "pools": mw._pools(eng), "logits": logits}
            if shape == DATA:
                res["shares"] = shares(eng, params["served"])
        mesh = meshes[DATA]
        eng = fsdp(model, "dense", mesh, **mw.SERVE)
        logits = []
        mw._record_logits(eng, logits)
        res["dense"] = {"tokens": mw._serve(eng, serve_prompts(), mw.SERVE_NEW),
                        "pools": mw._pools(eng), "logits": logits}
        eng = fsdp(Model(tree_config("moe")), "moe", mesh, **mw.MOE_SERVE)
        res["moe"] = {"tokens": mw._serve(eng, mw.moe_prompts(), mw.SERVE_NEW),
                      "pools": mw._pools(eng), "shares": shares(eng, params["moe"])}
        res["ring"] = rw.serve(Model(tree_config("ring")), params["ring"], mesh, fsdp=True)
        res["spec"] = {"plain": mw._serve(fsdp(model, "served", mesh, **mw.SPEC_ENGINE),
                                          serve_prompts(), mw.SPEC_NEW)}
        eng = fsdp(model, "served", mesh, spec_decode=SpecConfig(k=2, draft_codec="nf4"),
                   **mw.SPEC_ENGINE)
        res["spec"]["spec"] = mw._serve(eng, serve_prompts(), mw.SPEC_NEW)
        res["spec"]["stats"] = eng.scheduler.stats()
        res["tied"] = tied_serve(mesh)
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _prefill_programs(eng):
    """Wrap a reference engine's jitted paged prefill: every call's
    arguments are kept, and `programs()` gives, per call, (its rows, the
    all-reduces in its partitioned program)."""
    fn, calls = eng._paged_prefill, []

    def wrap(*args):
        calls.append(args)
        return fn(*args)

    def programs():
        out = []
        for args in calls:
            with eng._mesh_scope():
                text = fn.lower(*args).compile().as_text()
            out.append((int(args[1].shape[0]), text.count(" all-reduce(")))
        return out

    eng._paged_prefill = wrap
    return programs


def reference_main(out):
    """The reference's fsdp engines: SERVE at both meshes, MOE and DENSE at
    (2, 1) (tokens, pools as int16 / int32 / uint8 words, the prefill
    logits; DENSE's prefill programs) and RING at (2, 1) (tokens)."""
    import jax
    from jax.sharding import AxisType

    from repro.models.model import Model
    from repro.serve.engine import GenerationEngine

    trees = reference_trees()
    auto = (AxisType.Auto, AxisType.Auto)
    meshes = {shape: jax.make_mesh(shape, ("data", "model"), axis_types=auto)
              for shape in mw.MESHES}
    model = Model(mw.config(reference=True))

    def served(m, tree, mesh, prompts, **kw):
        eng = GenerationEngine(m, trees[tree], mesh=mesh, fsdp=True, paged=True, **kw)
        logits = []
        mw._record_logits(eng, logits)
        programs = _prefill_programs(eng) if tree == "dense" else None
        got = {"tokens": mw._serve(eng, prompts, mw.SERVE_NEW), "logits": logits,
               "pools": mw._words(eng)}
        if programs is not None:
            got["programs"] = programs()
        return got

    res = {"serve": {shape: served(model, "served", mesh, serve_prompts(), **mw.SERVE)
                     for shape, mesh in meshes.items()}}
    res["dense"] = served(model, "dense", meshes[DATA], serve_prompts(), **mw.SERVE)
    res["moe"] = served(Model(tree_config("moe", reference=True)), "moe", meshes[DATA],
                        mw.moe_prompts(), **mw.MOE_SERVE)
    ring = Model(tree_config("ring", reference=True))
    eng = GenerationEngine(ring, trees["ring"], mesh=meshes[DATA], fsdp=True, **rw.RING)
    res["ring"] = {"tokens": np.asarray(
        eng.generate(rw.batch(ring.cfg.vocab_size), rw.NEW)).tolist()}
    with open(f"{out}/reference.pkl", "wb") as f:
        pickle.dump(res, f)

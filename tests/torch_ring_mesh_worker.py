"""The processes of tests/test_torch_ring_mesh.py: the dense ring engine
(`GenerationEngine(paged=False)`) on a serving mesh.

`rank_main(rank, world, port, out)` is one rank of a gloo world of two on
the CPU; `reference_main(out)` runs the reference's ring engine on two
forced XLA host devices with `AxisType.Auto` axes, and unsharded. The
ranks read the seeded reference trees the test wrote to `out/trees.pkl`
(the port's through `params_from_jax`); the reference draws the same dense
trees itself (`dense_tree`), so it starts at once. Each writes its results
once. The helpers of
tests/torch_mesh_serve_worker.py (prompts, logit recording) are reused.

The cases, on the smoke stacks of falcon-mamba-7b (Mamba-1 blocks) and
recurrentgemma-9b (rec, rec, attn with one KV head), B = 4 prompts of 12
tokens, 6 new tokens, a 32-slot ring:
  SERVE  the dense trees at (2, 1) and (1, 2) in both packages (the
         reference cannot serve a compressed recurrent tree): tokens and
         the prefill logits; on the port each rank's ring caches and
         states after the serve;
  PACKED the same stacks compressed to mxfp4_100 at (1, 2), port only:
         tokens, prefill logits and the (K, N) of every compressed product
         the rank ran (the DECA GeMM / GeMV sites, on the CPU their plain
         versions);
  GQA    llama3-8b's smoke stack (4 q / 2 kv heads, mxfp4_100) with
         paged=False at (1, 2): the KV heads split, tokens and ring planes;
  ODD    B = 3 at (2, 1): rows that `data` does not divide;
  HOT    T = 0.7 at (2, 1): keyed sampling on whole logits.
"""
import pickle

import numpy as np

from torch_mesh_serve_worker import MESHES, prompts

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
GQA_ARCH = "llama3-8b"
PACKED_FMT = "mxfp4_100"
BATCH, ODD_BATCH, LENGTH, NEW = 4, 3, 12, 6
RING = dict(max_len=32, paged=False)
HOT = 0.7


def config(arch, reference=False):
    import importlib

    base = importlib.import_module("repro.configs.base" if reference else
                                   "repro_torch.configs.base")
    return base.get_smoke_config(arch)


def tree_config(name, reference=False):
    """The config a tree of `reference_trees` was drawn for."""
    return config(name.split(":")[0], reference)


def batch(vocab, rows=BATCH):
    """(rows, LENGTH) int32 prompts drawn from `vocab` tokens."""
    return np.stack(prompts(vocab, (LENGTH,) * rows, 5))


def dense_tree(arch):
    """The reference's dense smoke tree of `arch` (PRNGKey(0), as the
    reference's fixtures), on the host: the same bytes in the test's
    process and in `reference_main`'s."""
    import jax

    from repro.models.model import Model

    return jax.device_get(Model(config(arch, reference=True)).init(jax.random.PRNGKey(0)))


def reference_trees():
    """{arch: `dense_tree(arch)`, arch:packed: it compressed to PACKED_FMT}
    for ARCHS, and GQA_ARCH's packed tree: the ranks' trees."""
    from repro.core.decompress import compress_tree
    from repro.core.formats import get_spec

    spec = get_spec(PACKED_FMT)
    trees = {}
    for arch in ARCHS + (GQA_ARCH,):
        dense = dense_tree(arch)
        if arch != GQA_ARCH:
            trees[arch] = dense
        trees[f"{arch}:packed"] = compress_tree(dense, spec)
    return trees


def record_prefill(eng):
    """The logits of every sampler call of a ring engine of either package
    (its first call is the prefill's) appended to the returned list."""
    calls = []
    sample = eng._sample_rows

    def on_sample(logits, *a, **kw):
        calls.append(np.asarray(logits, np.float32).copy())
        return sample(logits, *a, **kw)

    eng._sample_rows = on_sample
    return calls


def ring_planes(eng):
    """{layer/plane: array} of a port ring engine's caches after `generate`
    (bf16 planes as int16 words)."""
    import torch

    out = {}
    for i, cache in enumerate(eng.ring):
        for name, t in cache.items():
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            out[f"{i}/{name}"] = t.numpy().copy()
    return out


def serve(model, params, mesh, rows=BATCH, **kw):
    """One ring serve of `batch(rows)`: {tokens, prefill logits, ring}."""
    from repro_torch.serve.engine import GenerationEngine

    eng = GenerationEngine(model, params, device="cpu", mesh=mesh, **RING, **kw)
    calls = record_prefill(eng)
    tokens = eng.generate(batch(model.cfg.vocab_size, rows), NEW)
    return {"tokens": tokens.tolist(), "logits": calls[0], "ring": ring_planes(eng)}


def _product_shapes(run):
    """(run's result, the (K, N) of every compressed product it ran)."""
    from repro_torch.kernels import ops

    shapes, gemm = [], ops.decompress_gemm

    def on_gemm(x, w, *a, **kw):
        shapes.append(tuple(w.shape))
        return gemm(x, w, *a, **kw)

    ops.decompress_gemm = on_gemm
    try:
        return run(), sorted(set(shapes))
    finally:
        ops.decompress_gemm = gemm


def rank_main(rank, world, port, out):
    """SERVE at both meshes, PACKED and GQA at (1, 2), ODD and HOT at
    (2, 1)."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        with open(f"{out}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        params = {name: params_from_jax(tree, tree_config(name), device="cpu")
                  for name, tree in trees.items()}
        meshes = {shape: make_test_mesh(*shape, device="cpu") for shape in MESHES}
        res = {}
        for arch in ARCHS:
            model = Model(config(arch))
            res[arch] = {shape: serve(model, params[arch], mesh)
                         for shape, mesh in meshes.items()}
            got, shapes = _product_shapes(
                lambda: serve(model, params[f"{arch}:packed"], meshes[(1, 2)]))
            res[arch]["packed"] = dict(got, shapes=shapes)
            res[arch]["odd"] = serve(model, params[arch], meshes[(2, 1)], rows=ODD_BATCH)
            res[arch]["hot"] = serve(model, params[arch], meshes[(2, 1)], temperature=HOT)
        res[GQA_ARCH] = serve(Model(config(GQA_ARCH)), params[f"{GQA_ARCH}:packed"],
                              meshes[(1, 2)])
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def reference_main(out):
    """The reference's ring engine on SERVE's dense trees (drawn here, as
    `reference_trees` draws them, so it starts before the test has them)
    at both meshes and unsharded (shape None): {arch: {shape: {tokens,
    logits}}}."""
    import jax
    from jax.sharding import AxisType

    from repro.models.model import Model
    from repro.serve.engine import GenerationEngine

    auto = (AxisType.Auto, AxisType.Auto)
    res = {}
    for arch in ARCHS:
        model = Model(config(arch, reference=True))
        tree = dense_tree(arch)
        res[arch] = {}
        for shape in MESHES + (None,):
            mesh = None if shape is None else jax.make_mesh(shape, ("data", "model"),
                                                            axis_types=auto)
            eng = GenerationEngine(model, tree, mesh=mesh, **RING)
            calls = record_prefill(eng)
            tokens = eng.generate(batch(model.cfg.vocab_size), NEW)
            res[arch][shape] = {"tokens": np.asarray(tokens).tolist(), "logits": calls[0]}
    with open(f"{out}/reference.pkl", "wb") as f:
        pickle.dump(res, f)

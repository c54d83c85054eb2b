"""The processes of tests/test_torch_dist.py's data-parallel cases.

`rank_main(rank, world, port, out)` is one rank of a gloo world on the CPU
(it imports torch and the port only); `reference_main(out)` runs the
reference's steps on two forced XLA host devices. Each writes its results
to `out` and the test module reads them.

The inputs: `DP_ARCHS`' smoke configs with the seeded reference trees of
`tree(arch)` (`config(arch)`), a `BATCH` batch whose mask drops more of rank 1's rows than
of rank 0's (`batch(cfg)`), AdamW at `LR`, step `STEP`.
"""
import pickle

import numpy as np

DENSE, MOE = "llama3.2-1b", "grok-1-314b"
DP_ARCHS = (DENSE, MOE)
BATCH = (4, 16)  # rows, sequence
LR, STEP = 1e-3, 1
# MOE's smoke config at a capacity that drops tokens, so its loss depends
# on the dispatch groups
CHANGES = {MOE: {"capacity_factor": 0.5}}


def config(arch, reference=False):
    """`arch`'s smoke config with CHANGES, of either package."""
    import dataclasses
    import importlib

    base = importlib.import_module("repro.configs.base" if reference else
                                   "repro_torch.configs.base")
    return dataclasses.replace(base.get_smoke_config(arch), **CHANGES.get(arch, {}))


def tree(arch):
    """The reference's param tree of `arch`'s smoke config (its uniform
    stack as `blocks`), seeded numpy values."""
    import jax

    from repro.configs.base import get_smoke_config
    from repro.models.model import Model

    shapes = jax.eval_shape(Model(get_smoke_config(arch)).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(100)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.02).astype(p.dtype), shapes)


def batch(cfg):
    """A pipeline batch with masks of unequal counts on the two ranks'
    rows: rank 0 (rows 0-1) keeps 28 of 32 positions, rank 1 keeps 13."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline

    b = SyntheticPipeline(cfg, ShapeConfig("t", "train", BATCH[1], BATCH[0]), seed=1).batch(0)
    b["mask"][0, 12:] = 0.0
    b["mask"][2, 5:] = 0.0
    b["mask"][3, :] = 0.0
    return b


def _flat(t):
    from repro_torch.checkpoint.ckpt import flatten

    return {k: v.detach().float().clone() for k, v in flatten(t).items()}


class _Tap:
    """An optimizer that keeps the f32 grads it is handed, then updates."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, step):
        self.grads = _flat(grads)
        return self.opt.update(grads, state, params, step)


def rank_main(rank, world, port, out):
    """One rank: mesh (2, 1): a plain AdamW step of DENSE, an int8 step of
    DENSE, a plain step of MOE and its dispatch groups; mesh (1, 2):
    `shard_params` of DENSE's params (each leaf's local shape, and whether
    the gathered tree is bitwise the input)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import AdamW, tree_map
    from repro_torch.train.trainer import device_batch, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        with open(f"{out}/params.pkl", "rb") as f:
            start = pickle.load(f)
        res = {}
        mesh = make_test_mesh(2, 1, device="cpu")
        for name, arch, method in (("adamw", DENSE, None), ("int8", DENSE, "int8"),
                                   ("moe", MOE, None)):
            cfg = config(arch)
            model = Model(cfg)
            params = tree_map(lambda p: p.clone(), start[arch])
            tap = _Tap(AdamW(lr=LR))
            step = make_train_step(model, tap, remat=False, grad_compression=method, mesh=mesh)
            state = tap.init(params)
            args = (params, state, device_batch(batch(cfg), "cpu"), STEP)
            if method:
                err = tree_map(lambda p: torch.zeros(p.shape), params)
                params, state, metrics, err = step(*args, err)
                res[name + "_err"] = _flat(err)
            else:
                params, state, metrics = step(*args)
            res[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                         "grads": tap.grads, "params": _flat(params)}
        with sh.use_mesh(mesh, batch_axes=("data",)):
            res["groups"] = layers._dispatch_groups(BATCH[0] * BATCH[1] // world)
        ctx = sh.ShardingCtx(make_test_mesh(1, 2, device="cpu"))
        placed = sh.shard_params(start[DENSE], ctx)
        local = {k: tuple(d.to_local().shape) for k, d in flatten(placed).items()}
        whole = tree_map(lambda d: d.full_tensor(), placed)
        same = all(torch.equal(a, b) for a, b in zip(
            _flat(whole).values(), _flat(start[DENSE]).values()))
        res["shards"] = {"local": local, "gathered_bitwise": same}
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def reference_main(out):
    """The reference on two host devices, axes `AxisType.Auto`: an int8
    step of DENSE on mesh (2, 1) (metrics, err, and the batch-sharded
    gradient of the loss, which that step quantizes), a plain step of MOE
    (metrics) with its dispatch groups, and each leaf's shard shape under
    `shard_params` on mesh (1, 2)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.dist import sharding as sh
    from repro.models import layers
    from repro.models.model import Model
    from repro.optim.optimizers import AdamW
    from repro.train.trainer import make_train_step

    auto = (AxisType.Auto, AxisType.Auto)
    mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=auto)
    res = {}
    for name, arch, method in (("int8", DENSE, "int8"), ("moe", MOE, None)):
        cfg = config(arch, reference=True)
        model = Model(cfg)
        opt = AdamW(lr=LR)
        step = make_train_step(model, opt, remat=False, grad_compression=method, mesh=mesh)
        with mesh, sh.use_mesh(mesh) as ctx:
            b = batch(cfg)
            specs = sh.data_spec_tree(b, ctx)
            jb = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
                  for k, v in b.items()}
            params = jax.device_put(tree(arch), NamedSharding(mesh, P()))
            args = (params, opt.init(params), jb, STEP)
            if method:
                err = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                _, _, metrics, err = jax.jit(step)(*args, err)
                res[name + "_err"] = jax.tree.map(np.asarray, err)
                # the gradient GSPMD averages over the data axis, as the step sees it
                grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b, remat=False)[0]))
                res[name + "_grads"] = jax.tree.map(
                    lambda g: np.asarray(g, np.float32), grad(params, jb))
            else:
                _, _, metrics = jax.jit(step)(*args)
            res[name] = {k: float(v) for k, v in metrics.items()}
            res["groups"] = layers._dispatch_groups(BATCH[0] * BATCH[1])
    mesh12 = jax.make_mesh((1, 2), ("data", "model"), axis_types=auto)
    placed = sh.shard_params(tree(DENSE), sh.ShardingCtx(mesh12), scan_stacked=True)
    leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    res["shards"] = {"/".join(sh._key_str(p) for p in path):
                     [tuple(s.data.shape) for s in sorted(leaf.addressable_shards,
                                                          key=lambda s: s.device.id)]
                     for path, leaf in leaves}
    with open(f"{out}/reference.pkl", "wb") as f:
        pickle.dump(res, f)

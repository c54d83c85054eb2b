"""Training of the port: the train step (loss, gradients, optimizer) with
optional activation checkpointing and microbatched gradient accumulation,
and the host loop around it.

Counterpart of `repro/train/trainer.py`. The reference's step is a pure
jitted function; here it is eager PyTorch: the params' leaves are detached
views that require grad, `Model.loss` runs forward (each layer under
`torch.utils.checkpoint` with `remat`), `torch.autograd.grad` returns the
gradients in the params' dtypes, and the optimizer writes the new params
and state into the tensors it was given. Every matrix product of a dense
tree is a plain `torch.matmul`, as the reference's are plain einsums: no
kernel of the port has a backward pass.

Under a `mesh` (a `torch.distributed` DeviceMesh, `launch/mesh.py`) the
step is data-parallel: each rank takes its rows of the global batch as
`dist.sharding.data_spec_tree` shards them over the batch axes (`pod`,
`data`), divides its masked sums by the whole batch's mask count, and the
ranks' f32 gradients are summed: every rank then holds the global batch's
gradient, which GSPMD gives the reference. With `grad_compression` that
replicated gradient goes through the error-feedback quantized all-reduce
(`dist/grad_compression.py`), as the reference's does.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as sh
from repro_torch.models.model import AUX_WEIGHT, Z_WEIGHT, Model
from repro_torch.optim.optimizers import make_optimizer, tree_leaves, tree_map, warmup_cosine

F32 = torch.float32


def build_optimizer(cfg: ModelConfig):
    """`cfg.optimizer` on the reference's schedule (warmup 100, peak 3e-4,
    cosine to 10000 steps). Adafactor runs a uniform stack's layers as the
    reference's (n_layers, ...) arrays (`Model.layer_stack`)."""
    lr = functools.partial(warmup_cosine, peak_lr=3e-4, warmup=100, total=10_000)
    if cfg.optimizer == "adafactor":
        return make_optimizer("adafactor", lr=lr, stacked=Model(cfg).layer_stack > 1)
    return make_optimizer(cfg.optimizer, lr=lr)


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (host numpy arrays) as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def params_device(params: Any) -> torch.device:
    """The device the params live on: a train loop feeds its batches there."""
    return tree_leaves(params)[0].device


def _microbatch(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """Rows [i b / n, (i + 1) b / n) of every batch entry. M-RoPE positions
    (3, B, S) are cut on their batch axis, 1."""
    def cut(k, x):
        axis = 1 if k == "positions" and x.dim() == 3 else 0
        size = x.shape[axis] // n
        return x.narrow(axis, i * size, size)

    return {k: cut(k, x) for k, x in batch.items()}


def _batch_axes(batch: Dict[str, torch.Tensor], mesh) -> Tuple[str, ...]:
    """The mesh axes `data_spec_tree` splits a batch's rows over."""
    specs = sh.data_spec_tree({"labels": batch["labels"]}, sh.ShardingCtx(mesh))
    return sh.entry_axes(specs["labels"][0])


def _rows(batch: Dict[str, torch.Tensor], ctx: sh.ShardingCtx) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, as `data_spec_tree` shards them."""
    specs = sh.data_spec_tree(batch, ctx)
    return {k: sh.local_shard(x, specs[k], ctx) for k, x in batch.items()}


def make_train_step(
    model: Model,
    optimizer=None,
    *,
    n_microbatches: int = 1,
    remat: bool = True,
    grad_compression: Optional[str] = None,
    mesh=None,
    compression_group: int = 128,
) -> Callable:
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): metrics {ce, aux, z_loss, loss} as 0-d tensors.
    With `n_microbatches` > 1 the batch is cut into that many row blocks,
    their gradients summed in f32 and divided by the count, and the
    metrics are the reference's: ce the mean loss, aux and z_loss zero.

    Under `mesh` each rank computes its rows of each (micro)batch and the
    gradients and metrics are summed over the batch axes (module
    docstring). With `grad_compression` (any KV-capable codec name, 'int8'
    / 'bf8' canonically; it needs `mesh`) the step has the reference's
    error-feedback signature train_step(params, opt_state, batch, step,
    err) -> (params, opt_state, metrics, err): the gradient goes through
    the compressed all-reduce over `mesh`, groups of `compression_group`
    elements, and `err` (updated in place) carries the residual to the
    next step."""
    optimizer = optimizer or build_optimizer(model.cfg)
    allreduce = None
    if grad_compression is not None:
        if mesh is None:
            raise ValueError("grad_compression needs the mesh that carries the reduction")
        from repro_torch.dist.grad_compression import make_compressed_allreduce

        allreduce, _ = make_compressed_allreduce(mesh, None, method=grad_compression,
                                                 group=compression_group,
                                                 layer_stack=model.layer_stack)

    def grad_fn(params, batch, denom=None):
        leaves = []

        def track(p):
            p = p.detach().requires_grad_()
            leaves.append(p)
            return p

        tracked = tree_map(track, params)
        loss, metrics = model.loss(tracked, batch, remat=remat, denom=denom)
        # a leaf the loss never reads (the token table under `embeds`) gets
        # a zero gradient, as the reference's
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def parts(batch):
        if n_microbatches == 1:
            return [batch]
        return [_microbatch(batch, i, n_microbatches) for i in range(n_microbatches)]

    def local_step(params, batch):
        if n_microbatches == 1:
            return grad_fn(params, batch)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
        loss = torch.zeros((), dtype=F32, device=params_device(params))
        for part in parts(batch):
            l, _, g = grad_fn(params, part)
            grads = tree_map(lambda a, b: a + b, grads, g)
            loss = loss + l
        grads = tree_map(lambda g: g / n_microbatches, grads)
        loss = loss / n_microbatches
        zero = torch.zeros((), dtype=F32, device=loss.device)
        return loss, {"ce": loss, "aux": zero, "z_loss": zero}, grads

    def parallel_step(params, batch, ctx):
        """Each (micro)batch's rows of this rank, its sums divided by the
        whole (micro)batch's mask count (every rank holds the whole batch),
        then the f32 gradients and the ce and z sums added over the batch
        axes; the aux loss is already the global one on every rank
        (`layers.moe_block`)."""
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
        dev = params_device(params)
        sums = torch.zeros(2, dtype=F32, device=dev)  # ce, z_loss
        aux = torch.zeros((), dtype=F32, device=dev)
        for part in parts(batch):
            mask = part.get("mask")
            count = (mask.sum() if mask is not None else
                     torch.tensor(float(part["labels"].numel()), device=dev))
            _, m, g = grad_fn(params, _rows(part, ctx), torch.clamp(count.to(F32), min=1.0))
            grads = tree_map(lambda a, b: a + b, grads, g)
            sums = sums + torch.stack([m["ce"], m["z_loss"]])
            aux = aux + m["aux"]
        for g in tree_leaves(grads):
            ctx.batch_all_reduce(g)
        ce, zl = ctx.batch_all_reduce(sums) / n_microbatches
        aux = aux / n_microbatches
        grads = tree_map(lambda g: g / n_microbatches, grads)
        loss = ce + AUX_WEIGHT * aux + Z_WEIGHT * zl
        if n_microbatches > 1:
            zero = torch.zeros((), dtype=F32, device=dev)
            return loss, {"ce": loss, "aux": zero, "z_loss": zero}, grads
        return loss, {"ce": ce, "aux": aux, "z_loss": zl}, grads

    def train_step(params, opt_state, batch, step, err=None):
        if mesh is None:
            loss, metrics, grads = local_step(params, batch)
        else:
            # every (micro)batch has the same rows, so the same split
            with sh.use_mesh(mesh, batch_axes=_batch_axes(parts(batch)[0], mesh)) as ctx:
                if ctx.batch_split > 1:
                    loss, metrics, grads = parallel_step(params, batch, ctx)
                else:
                    loss, metrics, grads = local_step(params, batch)
        if allreduce is not None:
            grads, err = allreduce(grads, err)
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        metrics = dict(metrics, loss=loss)
        if allreduce is not None:
            return params, opt_state, metrics, err
        return params, opt_state, metrics

    return train_step


def train_loop(
    model: Model,
    params,
    opt_state,
    pipeline,
    *,
    n_steps: int,
    start_step: int = 0,
    train_step: Optional[Callable] = None,
    checkpointer=None,
    checkpoint_every: int = 0,
    step_timeout_s: float = 0.0,
    on_step=None,
    grad_compression: Optional[str] = None,
    mesh=None,
    compression_group: int = 128,
):
    """Host loop: each step's batch from `pipeline` onto the params'
    device, the step, its metrics as floats (a host sync), a straggler
    flag when the step took longer than `step_timeout_s`, `on_step(step,
    metrics)`, and a checkpoint every `checkpoint_every` steps. Returns
    (params, opt_state, history of (step, metrics, seconds)).

    With `grad_compression` the loop owns the error-feedback state: a
    params-shaped f32 zero tree seeds it and each step's residual goes
    into the next. Every rank of `mesh` feeds the same global batch; the
    step takes its rows."""
    compressed = grad_compression is not None
    step_fn = train_step or make_train_step(model, grad_compression=grad_compression,
                                            mesh=mesh, compression_group=compression_group)
    device = params_device(params)
    err = (tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
           if compressed else None)
    history = []
    for step in range(start_step, start_step + n_steps):
        t0 = time.monotonic()
        batch = device_batch(pipeline.batch(step), device)
        if compressed:
            params, opt_state, metrics, err = step_fn(params, opt_state, batch, step, err)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        if step_timeout_s and dt > step_timeout_s:
            metrics["straggler"] = True  # surfaced to the fault driver
        history.append((step, metrics, dt))
        if on_step:
            on_step(step, metrics)
        if checkpointer and checkpoint_every and (step + 1) % checkpoint_every == 0:
            checkpointer.save(step + 1, params, opt_state)
    return params, opt_state, history

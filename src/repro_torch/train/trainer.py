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

The reference's compressed gradient all-reduce (`grad_compression`, over a
`mesh`) waits for the distribution port (ROADMAP Queue A item 12): asking
for it raises `NotImplementedError`.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
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


def _refuse_distribution(grad_compression, mesh) -> None:
    if grad_compression is not None or mesh is not None:
        raise NotImplementedError(
            "grad_compression and mesh (the compressed gradient all-reduce) wait "
            "for the distribution port, ROADMAP Queue A item 12"
        )


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


def make_train_step(
    model: Model,
    optimizer=None,
    *,
    n_microbatches: int = 1,
    remat: bool = True,
    grad_compression: Optional[str] = None,
    mesh=None,
) -> Callable:
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): metrics {ce, aux, z_loss, loss} as 0-d tensors.
    With `n_microbatches` > 1 the batch is cut into that many row blocks,
    their gradients summed in f32 and divided by the count, and the
    metrics are the reference's: ce the mean loss, aux and z_loss zero."""
    _refuse_distribution(grad_compression, mesh)
    optimizer = optimizer or build_optimizer(model.cfg)

    def grad_fn(params, batch):
        leaves = []

        def track(p):
            p = p.detach().requires_grad_()
            leaves.append(p)
            return p

        tracked = tree_map(track, params)
        loss, metrics = model.loss(tracked, batch, remat=remat)
        # a leaf the loss never reads (the token table under `embeds`) gets
        # a zero gradient, as the reference's
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch, step):
        if n_microbatches == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
            loss = torch.zeros((), dtype=F32, device=params_device(params))
            for i in range(n_microbatches):
                l, _, g = grad_fn(params, _microbatch(batch, i, n_microbatches))
                grads = tree_map(lambda a, b: a + b, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / n_microbatches, grads)
            loss = loss / n_microbatches
            zero = torch.zeros((), dtype=F32, device=loss.device)
            metrics = {"ce": loss, "aux": zero, "z_loss": zero}
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, loss=loss)

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
):
    """Host loop: each step's batch from `pipeline` onto the params'
    device, the step, its metrics as floats (a host sync), a straggler
    flag when the step took longer than `step_timeout_s`, `on_step(step,
    metrics)`, and a checkpoint every `checkpoint_every` steps. Returns
    (params, opt_state, history of (step, metrics, seconds))."""
    _refuse_distribution(grad_compression, mesh)
    step_fn = train_step or make_train_step(model)
    device = params_device(params)
    history = []
    for step in range(start_step, start_step + n_steps):
        t0 = time.monotonic()
        batch = device_batch(pipeline.batch(step), device)
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

"""Optimizers of the port: AdamW (f32 master weights and moments) and
Adafactor (a factored second moment), with the warmup-cosine schedule.

Counterpart of `repro/optim/optimizers.py`, its math in f32 in the
reference's order of operations. Interface, as the reference's:

    init(params) -> opt_state
    update(grads, opt_state, params, step) -> (params, opt_state)

Params and states are trees of dicts and lists of tensors (the port's
layout: one dict per layer in `params["layers"]`). Unlike the reference,
`update` writes the new params and state into the tensors it is given and
returns those same trees: the in-place form of the reference's buffer
donation, so the card never holds two copies of the optimizer state.

Adafactor factors a leaf by its trailing two axes and clips each leaf's
update by its RMS. The reference holds a uniform stack's layers as one
(n_layers, ...) array per weight, so there a stacked norm (n_layers, d) is
factored and the RMS spans all layers. `Adafactor(stacked=True)` (set by
`train.trainer.build_optimizer` when `Model.layer_stack > 1`) runs each
layer leaf on that stacked view, and keeps its state stacked: `state["v"]
["layers"]` is then one dict of (n_layers, ...) factors, the reference's
`blocks` layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List

import torch

F32 = torch.float32


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of a tree of dicts and lists (and of `rest`,
    trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def warmup_cosine(step, *, peak_lr=3e-4, warmup=100, total=10_000, floor=0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine down to floor x peak_lr
    at `total`: an f32 0-d tensor on the CPU."""
    step = torch.as_tensor(step, dtype=F32)
    warm = peak_lr * step / warmup
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt correctly rounded, as XLA's and the card's are. torch's CPU
    kernel is an ulp off for about 0.7 % of inputs, so on the CPU it runs
    in f64, whose one rounding to f32 is then exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf."""
    return _sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads in f32 scaled so their global norm is at most `max_norm`,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _step_f32(step) -> torch.Tensor:
    """(step + 1) as f32, the reference's bias-correction and decay time."""
    return torch.as_tensor(int(step) + 1, dtype=F32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 3e-4           # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params: Any) -> dict:
        return {
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        }

    def update(self, grads, state, params, step):
        """One step, in place: global-norm clipping, then per leaf the
        moments, the bias-corrected update with decoupled weight decay on
        the f32 master, and the param as the master cast to its dtype. The
        clipped f32 grads are made one leaf at a time."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        scale = _clip_scale(global_norm(grads), self.max_grad_norm)
        t = _step_f32(step)
        bc1 = 1.0 - torch.tensor(self.b1, dtype=F32) ** t
        bc2 = 1.0 - torch.tensor(self.b2, dtype=F32) ** t

        def upd(g, mu, nu, master, p):
            g = g.to(F32) * scale
            mu_new = self.b1 * mu + (1 - self.b1) * g
            nu_new = self.b2 * nu + (1 - self.b2) * torch.square(g)
            u = (mu_new / bc1) / (_sqrt(nu_new / bc2) + self.eps)
            master_new = master - lr * (u + self.weight_decay * master)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
            master.copy_(master_new)
            p.copy_(master_new)

        with torch.no_grad():
            tree_map(upd, grads, state["mu"], state["nu"], state["master"], params)
        return params, state


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), beta1 = 0.

    The state of a leaf factored by its last two axes (both > 1) is its row
    and column means of the squared grads, O(n + m) instead of O(n m)."""

    lr: Any = 1e-3
    decay: float = 0.8      # \\hat{beta2}_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    stacked: bool = False   # the layers are one (n_layers, ...) stack a leaf

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def _zeros(self, shape, device) -> dict:
        """The zero state of a leaf of `shape`."""
        shape = tuple(shape)
        if self._factored(shape):
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32, device=device)}
        return {"v": torch.zeros(shape, dtype=F32, device=device)}

    def init(self, params: Any) -> dict:
        one = lambda p: self._zeros(p.shape, p.device)
        v = {k: tree_map(one, leaf) for k, leaf in params.items() if k != "layers"}
        layers = params["layers"]
        if self.stacked:
            # one (n_layers, ...) factor set a leaf, as the reference's blocks
            v["layers"] = tree_map(
                lambda *ps: self._zeros((len(ps),) + tuple(ps[0].shape), ps[0].device), *layers)
        else:
            v["layers"] = [tree_map(one, layer) for layer in layers]
        return {"v": v}

    def update(self, grads, state, params, step):
        """One step, in place, leaf by leaf: the decayed second-moment
        estimate (factored or full), the update g / sqrt(v), clipped to RMS
        <= clip_threshold over the leaf, and the param moved by lr x (u +
        weight_decay x p) in f32, then cast back to its dtype. With
        `stacked`, a layer leaf is updated as the (n_layers, ...) stack of
        its layers."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        beta2 = 1.0 - _step_f32(step) ** (-self.decay)

        def upd(g, v, p):
            g = g.to(F32)
            g2 = torch.square(g) + self.eps
            if self._factored(p.shape):
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = (vr[..., :, None]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True), min=self.eps)[..., None]
                         ) * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                nv = beta2 * v["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(torch.clamp(nv, min=self.eps))
                v["v"].copy_(nv)
            rms = _sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            pf = p.to(F32)
            return pf - lr * (u + self.weight_decay * pf)

        def leaf(g, v, p):
            p.copy_(upd(g, v, p))

        with torch.no_grad():
            for k in params:
                if k != "layers":
                    tree_map(leaf, grads[k], state["v"][k], params[k])
            layers, g_layers = params["layers"], grads["layers"]
            if self.stacked:
                def stacked(v, *pg):
                    n = len(pg) // 2
                    new = upd(torch.stack(pg[n:]), v, torch.stack(pg[:n]))
                    for p, row in zip(pg[:n], new):
                        p.copy_(row)

                _stack_apply(stacked, state["v"]["layers"], layers, g_layers)
            else:
                for g_l, v_l, p_l in zip(g_layers, state["v"]["layers"], layers):
                    tree_map(leaf, g_l, v_l, p_l)
        return params, state


def _stack_apply(fn: Callable, v: Any, layers: List[Any], g_layers: List[Any]) -> None:
    """`fn(state leaf, *layer params, *layer grads)` for each leaf path of
    the per-layer dicts, with the stacked state leaf at that path."""
    if isinstance(layers[0], dict):
        for k in layers[0]:
            _stack_apply(fn, v[k], [p[k] for p in layers], [g[k] for g in g_layers])
    else:
        fn(v, *layers, *g_layers)


def make_optimizer(name: str, **kwargs):
    if name == "adamw":
        return AdamW(**kwargs)
    if name == "adafactor":
        return Adafactor(**kwargs)
    raise ValueError(name)

"""Compressed gradient all-reduce with persistent error feedback
(counterpart of `repro/dist/grad_compression.py`).

`make_compressed_allreduce(mesh, grads_like)` returns an
`allreduce(grads, err) -> (avg_grads, err)` that quantizes the
error-compensated gradient (g + err) per group of `group` elements with any
KV-capable codec of the registry (`core/codecs.py`; int8 and bf8
canonically), sums the dequantized f32 payload over every mesh dim with
`torch.distributed.all_reduce` and divides by the mesh size, and keeps the
quantization residual (g + err) - sent as the next step's error feedback.
The residual makes the transmitted sequence telescope: sum_t sent_t =
sum_t g_t - err_T (Karimireddy et al., "Error Feedback Fixes SignSGD").

What it is handed is the reference's: its step quantizes the gradient
after GSPMD has averaged it over the data axis, so every rank holds the
same gradient, and the sum runs over identical dequantized copies. The
port's data-parallel step (`train/trainer.py`) hands it the same
replicated global-batch gradient.

The reference's groups run along the flat view of each of its leaves,
and a uniform model's leaf is the (n_layers, ...) stack of a layer weight.
Where a layer leaf's size is a multiple of the group, the stack's groups
are the layers' own; where it is not (a norm at a narrow width), a group
spans two layers, and the port quantizes that path's layer leaves stacked
(`layer_stack`), as the reference does.

Unlike the reference, `err` is updated in place and returned: a second f32
copy of a params-sized tree does not fit beside a large model.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import codecs
from repro_torch.optim.optimizers import tree_map

# canonical methods; any name in codecs.kv_codec_names() is accepted
METHODS = ("int8", "bf8")


def _codec_roundtrip(x: torch.Tensor, codec: codecs.Codec, group: int) -> torch.Tensor:
    """x -> dequantize(quantize(x)) in f32: what the wire would carry. Grouped
    along the flat view, padded with zeros to a whole group; a scaled codec
    keeps one scale a group."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % group
    g = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, group)
    codes, scales = codec.kv_encode(g)
    deq = codec.kv_decode(codes, scales).to(torch.float32).reshape(-1)
    return deq[: flat.numel()].reshape(x.shape)


def make_compressed_allreduce(
    mesh,
    grads_like: Any = None,
    *,
    method: str = "int8",
    group: int = 128,
    layer_stack: int = 1,
) -> Tuple[Callable, Callable]:
    """The compressed gradient all-reduce over a DeviceMesh.

    `method` names any KV-capable codec (`codecs.kv_codec_names()`); an
    unknown or non-quantizing one raises ValueError. `layer_stack` is the
    number of layers the reference stacks into one leaf
    (`Model.layer_stack`): above 1, a path of `tree["layers"]` whose
    leaves are no multiple of `group` is quantized as their stack.

    Returns (allreduce, init_err):
      init_err(grads)       -> a zero f32 residual tree
      allreduce(grads, err) -> (avg_grads, err): avg_grads the mean over
                               the mesh's ranks of the quantized payloads
                               (f32), err the residual, written in place.
    """
    codec = codecs.get_codec(method)  # ValueError on an unknown format
    if not codec.kv_capable:
        raise ValueError(f"method {method!r} has no runtime quantizer; choose one of "
                         f"{codecs.kv_codec_names()}")
    axes = tuple(mesh.mesh_dim_names)
    n_dev = mesh.size()

    def init_err(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                        grads)

    def send(grads: List[torch.Tensor], errs: List[torch.Tensor]) -> List[torch.Tensor]:
        """One leaf, or one path's layer leaves grouped as their stack."""
        comps = [g.to(torch.float32) + e for g, e in zip(grads, errs)]
        if len(comps) == 1 or comps[0].numel() % group == 0:
            sents = [_codec_roundtrip(c, codec, group) for c in comps]
        else:
            sents = list(_codec_roundtrip(torch.stack(comps), codec, group).unbind(0))
        out = []
        for c, s, e in zip(comps, sents, errs):
            e.copy_(c - s)
            for a in axes:  # the sum over every mesh dim
                dist.all_reduce(s, group=mesh.get_group(a))
            out.append(s / n_dev)
        return out

    def stacked(grads: List[Any], errs: List[Any]) -> List[Any]:
        """The layer dicts `grads`, path by path across the layers."""
        if isinstance(grads[0], dict):
            per_key = {k: stacked([g[k] for g in grads], [e[k] for e in errs])
                       for k in grads[0]}
            return [{k: v[i] for k, v in per_key.items()} for i in range(len(grads))]
        return send(grads, errs)

    def allreduce(grads: Any, err: Any) -> Tuple[Any, Any]:
        with torch.no_grad():
            if layer_stack > 1 and isinstance(grads, dict) and "layers" in grads:
                out = {k: tree_map(lambda g, e: send([g], [e])[0], v, err[k])
                       for k, v in grads.items() if k != "layers"}
                out["layers"] = stacked(grads["layers"], err["layers"])
                return {k: out[k] for k in grads}, err
            return tree_map(lambda g, e: send([g], [e])[0], grads, err), err

    return allreduce, init_err

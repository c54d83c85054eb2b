"""Online decompression API: compressed-weight model serving.

`compress_tree(params, spec)` walks a model's parameter tree (nested dicts
and lists of tensors) and replaces every eligible FC weight with a
`CompressedTensor`, on the device the weight lies on; `make_draft_tree`
re-encodes a served tree at a cheaper codec for self-speculative decode.
An MoE weight, (E, K, N), becomes one expert-stacked leaf compressed
slice by slice, as the reference stores it; the model's layers `pick`
an expert's 2-D triplet from it.
`mm(x, w)` is the matmul every model layer uses: `x @ w` for a plain
tensor; for a CompressedTensor the DECA decompress-GeMM (`kernels/ops.py`),
so the dense weight never exists in device memory.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.core.compression import CompressedTensor, compress, compress_stacked
from repro_torch.core.formats import CompressionSpec
from repro_torch.kernels import ops


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x (..., K) @ w (K, N) with transparent DECA decompression. A
    compressed product comes back in x's dtype; a dense one in the
    promoted dtype, as `x @ w` in the reference."""
    if isinstance(w, CompressedTensor):
        return ops.decompress_gemm(x, w, out_dtype=x.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# leaves eligible for weight compression: all FC weights; embeddings stay
# dense (gather, not GeMM — paper §3.1), and norms are not GeMM operands
_SKIP = ("embed", "pos_embed", "router", "conv_w", "a_log", "a_param", "norm")


def eligible(name: str, shape, spec: CompressionSpec, stack: int) -> bool:
    """The reference's rule, on a leaf's name and shape: a weight of rank
    2 or more (an (E, K, N) expert stack included) whose K, `shape[-2]`,
    the group divides. Its 4096-element floor counts the array it
    compresses, which for a uniform model is the (n_layers, ...) stack of
    a layer weight: `stack` is that layer count (1 elsewhere)."""
    if any(s in name for s in _SKIP):
        return False
    if len(shape) < 2 or stack * math.prod(shape) < 4096:
        return False
    return shape[-2] % spec.group == 0


def _compress_leaf(t: torch.Tensor, spec: CompressionSpec) -> CompressedTensor:
    """A 2-D weight, or an (E, K, N) expert stack compressed slice by slice
    into one stacked leaf (the reference's `_compress_leaf`)."""
    if t.dim() == 2:
        return compress(t, spec)
    if t.dim() != 3:
        raise ValueError(f"the port stacks one lead dim, got {tuple(t.shape)}")
    return compress_stacked(lambda i: t[i], t.shape[0], spec)


def _map_leaves(tree: Any, fn, layer_stack: Optional[int], path: str = "",
                stack: int = 1) -> Any:
    """`fn(path, leaf, stack)` on every leaf of a tree of dicts/lists; the
    leaves of a `layers` list get `stack` = `layer_stack`, or the list's
    length when that is None."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            s = stack
            if k == "layers" and isinstance(v, (list, tuple)):
                s = len(v) if layer_stack is None else layer_stack
            out[k] = _map_leaves(v, fn, layer_stack, f"{path}/{k}", s)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_leaves(v, fn, layer_stack, f"{path}/{i}", stack)
            for i, v in enumerate(tree)
        )
    return fn(path, tree, stack)


def compress_tree(params: Any, spec: CompressionSpec, *,
                  layer_stack: Optional[int] = None) -> Any:
    """Compress every eligible FC weight in a tree of dicts/lists of
    tensors; each runs on the device its weight lies on. Other leaves are
    returned as they are. `layer_stack` is the number of layers the
    reference stacks into one array (`Model.layer_stack`); by default the
    length of the tree's `layers` list, the reference's uniform stack."""

    def one(path, leaf, stack):
        if isinstance(leaf, torch.Tensor) and eligible(path, leaf.shape, spec, stack):
            return _compress_leaf(leaf, spec)
        return leaf

    return _map_leaves(params, one, layer_stack)


def make_draft_tree(params: Any, draft_spec: CompressionSpec, *,
                    layer_stack: Optional[int] = None) -> Any:
    """Self-speculation draft weights: the tree re-encoded at a cheaper
    codec, with no second checkpoint (the reference's `make_draft_tree`).

    Every `CompressedTensor` leaf is decompressed to f32 through
    `ops.decompress` (the DECA decompression kernel on the card), so the
    draft quantizes the same numbers the target serves, and compressed
    again at `draft_spec` on the leaf's device; eligible dense FC leaves
    compress directly (`layer_stack` as in `compress_tree`). Everything
    else (embeddings, norms, leaves whose K the draft group does not
    divide) is the target's own object: the draft costs only its
    re-encoded FC planes. On a mesh engine's local tree
    (`sharding.local_tree`) it re-encodes this rank's shards, an expert
    stack's local experts only (`sharding.adopt_specs` registers them)."""

    def one(path, leaf, stack):
        if isinstance(leaf, CompressedTensor):
            if leaf.shape[0] % draft_spec.group:
                return leaf
            if leaf.lead:  # an expert stack: one slice through the kernel at a time
                return compress_stacked(
                    lambda i: ops.decompress(leaf.pick(i), out_dtype=torch.float32),
                    leaf.lead[0], draft_spec)
            return compress(ops.decompress(leaf, out_dtype=torch.float32), draft_spec)
        if isinstance(leaf, torch.Tensor) and eligible(path, leaf.shape, draft_spec, stack):
            return _compress_leaf(leaf, draft_spec)
        return leaf

    return _map_leaves(params, one, layer_stack)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def compressed_bytes(params: Any) -> int:
    """Total stored bytes of a (possibly partially) compressed tree."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, CompressedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total

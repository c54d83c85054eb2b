"""Online decompression API: compressed-weight model serving.

`compress_tree(params, spec)` walks a model's parameter tree (nested dicts
and lists of tensors) and replaces every eligible FC weight with a
`CompressedTensor`, on the device the weight lies on; `make_draft_tree`
re-encodes a served tree at a cheaper codec for self-speculative decode.
`mm(x, w)` is the matmul every model layer uses: `x @ w` for a plain
tensor; for a CompressedTensor the DECA decompress-GeMM (`kernels/ops.py`),
so the dense weight never exists in device memory.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.compression import CompressedTensor, compress
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


def _eligible(name: str, t: torch.Tensor, spec: CompressionSpec, stack: int) -> bool:
    """The reference's rule. Its 4096-element floor counts the array it
    compresses, which for a uniform model is the (n_layers, K, N) stack of
    a layer weight: `stack` is that layer count (1 elsewhere)."""
    if any(s in name for s in _SKIP):
        return False
    if t.dim() != 2 or stack * t.numel() < 4096:
        return False
    return t.shape[0] % spec.group == 0


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
        if isinstance(leaf, torch.Tensor) and _eligible(path, leaf, spec, stack):
            return compress(leaf, spec)
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
    re-encoded FC planes."""

    def one(path, leaf, stack):
        if isinstance(leaf, CompressedTensor):
            if leaf.shape[0] % draft_spec.group:
                return leaf
            return compress(ops.decompress(leaf, out_dtype=torch.float32), draft_spec)
        if isinstance(leaf, torch.Tensor) and _eligible(path, leaf, draft_spec, stack):
            return compress(leaf, draft_spec)
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

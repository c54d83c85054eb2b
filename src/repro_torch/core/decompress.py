"""Online decompression API: compressed-weight model serving.

`compress_tree(params, spec)` walks a model's parameter tree (nested dicts
and lists of tensors) and replaces every eligible FC weight with a
`CompressedTensor`, on the device the weight lies on. `mm(x, w)` is the
matmul every model layer uses: `x @ w` for a plain tensor; for a
CompressedTensor the DECA decompress-GeMM (`kernels/ops.py`), so the
dense weight never exists in device memory.
"""
from __future__ import annotations

from typing import Any

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


def _eligible(name: str, t: torch.Tensor, spec: CompressionSpec) -> bool:
    """The reference's rule, applied to each layer's own 2D weight (the
    reference applies the size floor to the layer-stacked array)."""
    if any(s in name for s in _SKIP):
        return False
    if t.dim() != 2 or t.numel() < 4096:
        return False
    return t.shape[0] % spec.group == 0


def compress_tree(params: Any, spec: CompressionSpec, _path: str = "") -> Any:
    """Compress every eligible FC weight in a tree of dicts/lists of
    tensors; each runs on the device its weight lies on. Other leaves are
    returned as they are."""
    if isinstance(params, dict):
        return {
            k: compress_tree(v, spec, f"{_path}/{k}") for k, v in params.items()
        }
    if isinstance(params, (list, tuple)):
        return type(params)(
            compress_tree(v, spec, f"{_path}/{i}") for i, v in enumerate(params)
        )
    if isinstance(params, torch.Tensor) and _eligible(_path, params, spec):
        return compress(params, spec)
    return params


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

"""Model compression (paper Fig. 1, left side).

PyTorch counterpart of `repro/core/compression.py`. ``compress(w, spec)``
sparsifies (per-group top-|w|), then hands the packed nonzero values to the
format's codec (`core/codecs.py`) for quantization into the DECA storage
triplet {codes, mask, scales}. It is plain torch and runs on the device its
input lies on: at llama3-8b width the card compresses a layer in
milliseconds, where the reference's numpy path walks ~7.5 B parameters on
one host core. The planes are bitwise those of the reference's numpy
`compress` for the same f32 input (tests/test_torch_codecs.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.codecs import get_codec
from repro_torch.core.formats import CompressionSpec


@dataclasses.dataclass
class CompressedTensor:
    """Packed compressed weight of logical shape (K, N).

    codes : (ng, k_cap*bits/8, N) uint8   packed quantized nonzeros
            (bf16 codes are stored as 2 bytes little-endian)
    mask  : (ng, N) int32 or None         per-group bitmask holding the
                                          uint32 bits (bit i = row g*G+i)
    scales: (ng, N) uint8 | int16 or None E8M0 (mxfp4) / bf16 bits (int8,
                                          int4, nf4) held in int16

    An expert-stacked leaf (an MoE weight, the reference's (E, K, N) leaf)
    carries one lead dim on every plane, (E, ng, ...), and keeps `shape`
    the (K, N) of one slice, as the reference's stacked leaves do; `pick(i)`
    is expert i as a 2-D triplet.
    """

    codes: torch.Tensor
    mask: Optional[torch.Tensor]
    scales: Optional[torch.Tensor]
    spec: CompressionSpec
    shape: Tuple[int, int]  # logical (K, N)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.codes, self.mask, self.scales)
            if t is not None
        )

    @property
    def lead(self) -> Tuple[int, ...]:
        """Lead (expert) dims: what `codes` carries beyond (ng, ck, N)."""
        return tuple(self.codes.shape[:-3])

    def pick(self, i: int) -> "CompressedTensor":
        """Expert i of an expert-stacked leaf: a 2-D triplet whose planes
        are views into the stacked planes (the reference's `pick`,
        `jax.tree.map(lambda a: a[i], ct)`). A view starts i slices into
        its plane, and the kernels read planes in 16-byte pieces: on the
        card each view must be 16-byte aligned, which `compress_stacked`
        ensures by the stride of every plane and this checks."""
        if len(self.lead) != 1:
            raise ValueError(f"pick takes a leaf with one lead dim, got {self.lead}")
        planes = [None if t is None else t[i] for t in (self.codes, self.mask, self.scales)]
        if self.codes.device.type == "cuda" and any(
                t is not None and t.data_ptr() % 16 for t in planes):
            raise ValueError(f"expert {i}'s planes are not 16-byte aligned")
        return CompressedTensor(*planes, spec=self.spec, shape=self.shape)


def compress_stacked(slices: Callable[[int], torch.Tensor], n: int,
                     spec: CompressionSpec) -> CompressedTensor:
    """An expert-stacked leaf from `n` 2-D slices, `slices(i)` made one at
    a time: each is compressed as `compress` does (the reference's
    `_compress_leaf` of a stacked array, slice by slice) and copied into
    planes allocated once, so no more than one dense slice and the stacked
    planes are alive together. Each plane's per-expert stride must be a
    multiple of 16 bytes, so every `pick` view stays aligned for the
    kernels."""
    planes = None
    for i in range(n):
        ct = compress(slices(i), spec)
        parts = (ct.codes, ct.mask, ct.scales)
        if planes is None:
            for t in parts:
                if t is not None and (t.numel() * t.element_size()) % 16:
                    raise ValueError(f"a plane slice of {tuple(t.shape)} is no multiple of "
                                     "16 bytes: its expert views would be misaligned")
            planes = [None if t is None else t.new_empty((n,) + tuple(t.shape))
                      for t in parts]
        for dst, t in zip(planes, parts):
            if t is not None:
                dst[i] = t
        shape = ct.shape
        del ct, parts
    return CompressedTensor(*planes, spec=spec, shape=shape)


def _sparsify_groups(
    wg: torch.Tensor, k_cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group top-|w| pruning.

    wg: (ng, G, N). Returns (values (ng, k_cap, N), kept values in their
    original row order, and mask (ng, N) int32 holding uint32 bits with bit
    i set iff row i is kept). The stable sort keeps the reference's tie
    order (`np.argsort(kind="stable")`)."""
    order = torch.argsort(-wg.abs(), dim=1, stable=True)  # (ng, G, N)
    kept = order[:, :k_cap, :].sort(dim=1).values  # kept rows, ascending
    vals = torch.gather(wg, 1, kept)
    bits = (torch.ones_like(kept) << kept).sum(dim=1)  # < 2**32, int64
    mask = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return vals, mask


def compress(w: torch.Tensor, spec: CompressionSpec) -> CompressedTensor:
    """Compress a 2D weight (K, N) along K, on the device `w` lies on.
    K must be a multiple of the group."""
    w = torch.as_tensor(w).to(torch.float32)
    if w.dim() != 2:
        raise ValueError(f"compress expects 2D weights, got {tuple(w.shape)}")
    K, N = w.shape
    G = spec.group
    if K % G != 0:
        raise ValueError(f"K={K} not a multiple of group={G}")
    wg = w.reshape(K // G, G, N)

    mask = None
    if spec.is_sparse:
        vals, mask = _sparsify_groups(wg, spec.k_cap)
    else:
        vals = wg  # k_cap == G

    codes, scales = get_codec(spec.quant).encode(vals)
    return CompressedTensor(
        codes=codes.contiguous(),
        mask=None if mask is None else mask.contiguous(),
        scales=None if scales is None else scales.contiguous(),
        spec=spec,
        shape=(K, N),
    )

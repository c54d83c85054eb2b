"""The shared DECA tile decode, host side.

Replaces the tile decode of `repro/kernels/deca_decompress.py`
(`decompress_block`, shared there by the Pallas kernels). On Hopper the
decode is a device function, `csrc/deca_tile.cuh`, that both compressed
matmul kernels inline: for column n of group g it reads the column's
`ck` code bytes (strided by N, so neighbouring threads read neighbouring
bytes), decodes them exactly as `Codec.decode_values`, multiplies by the
decoded group scale in f32, expands the bitmask with
`min(popc(mask & ((1u << i) - 1)), k_cap - 1)` and rounds to bf16 only
after the scale. This module checks a `CompressedTensor` against what
that device function takes and hands over its operands.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import codec_wire_id
from repro_torch.core.compression import CompressedTensor

_SCALE_DTYPES = {"e8m0": torch.uint8, "bf16": torch.int16}


def _ptr(t):
    return None if t is None else t.data_ptr()


def tile_operands(ct: CompressedTensor, device: torch.device) -> tuple:
    """(codes, mask, scales, codec id, k_cap, code bytes per group) for the
    CUDA tile decode; raises on a triplet the kernels do not take."""
    spec = ct.spec
    if spec.group != 32:
        raise ValueError(f"the CUDA tile decode takes group 32, got {spec.group}")
    planes = {"codes": ct.codes, "mask": ct.mask, "scales": ct.scales}
    for name, t in planes.items():
        if t is None:
            continue
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous and 16-byte aligned on {device}"
            )
    if ct.codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {ct.codes.dtype}")
    if spec.is_sparse != (ct.mask is not None):
        raise ValueError("mask presence does not match the spec's density")
    if ct.mask is not None and ct.mask.dtype != torch.int32:
        raise ValueError(f"mask must be int32, got {ct.mask.dtype}")
    codec = spec.codec
    if codec.has_scale != (ct.scales is not None):
        raise ValueError("scales presence does not match the codec")
    if ct.scales is not None and ct.scales.dtype != _SCALE_DTYPES[codec.scale_kind]:
        raise ValueError(f"scales dtype {ct.scales.dtype} does not match the codec")
    k, n = ct.shape
    ck = ct.codes.shape[1]
    if tuple(ct.codes.shape) != (k // 32, ck, n):
        raise ValueError(f"codes shape {tuple(ct.codes.shape)} != ({k // 32}, ck, {n})")
    return (
        ct.codes.data_ptr(), _ptr(ct.mask), _ptr(ct.scales),
        codec_wire_id(spec.quant), spec.k_cap, ck,
    )

"""DECA decompression on Hopper: the shared tile decode and the
standalone decompression kernel, host side.

Replaces `repro/kernels/deca_decompress.py`: `decompress_block`, the tile
decode the Pallas kernels share, and `decompress_pallas`, the standalone
kernel. On Hopper the decode is a device function, `csrc/deca_tile.cuh`,
that the compressed matmul kernels and the decompression kernel inline:
for column n of group g it reads the column's `ck` code bytes (strided by
N, so neighbouring threads read neighbouring bytes), decodes them exactly
as `Codec.decode_values`, multiplies by the decoded group scale in f32 and
expands the bitmask with `min(popc(mask & ((1u << i) - 1)), k_cap - 1)`.
The matmul operand rounds to bf16 only after the scale; the standalone
kernel (`csrc/deca_decompress.cu`) keeps the f32 product for an f32
output and rounds it once for a bf16 one. `tile_operands` checks a
`CompressedTensor` against what the device function takes and hands over
its operands.

`decompress` returns the plain version (`kernels/ref.py`) for CPU tensors
and launches its kernel for CUDA tensors; `decompress.launches` counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.codecs import codec_wire_id
from repro_torch.core.compression import CompressedTensor
from repro_torch.kernels import cuda, ref

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


_P, _I = ctypes.c_void_p, ctypes.c_int
# codes, mask, scales, codec, k_cap, ck, K, N, out, out_f32, stream
_SIGNATURES = {"deca_decompress": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P)}


def decompress(ct: CompressedTensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """CompressedTensor -> dense (K, N) in `out_dtype` (f32 or bf16),
    bitwise the plain version's."""
    if ct.device.type == "cpu":
        return ref.decompress(ct, out_dtype=out_dtype)
    if ct.device.type != "cuda":
        raise ValueError(f"no kernel for device {ct.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out must be f32 or bf16, got {out_dtype}")
    tile = tile_operands(ct, ct.device)
    k, n = ct.shape
    out = torch.empty((k, n), dtype=out_dtype, device=ct.device)
    err = cuda.library("deca_decompress", _SIGNATURES).deca_decompress(
        *tile, k, n, out.data_ptr(), int(out_dtype == torch.float32),
        torch.cuda.current_stream(ct.device).cuda_stream,
    )
    cuda.check(err, "deca_decompress")
    decompress.launches += 1
    return out


decompress.launches = 0

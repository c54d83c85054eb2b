"""Format-codec registry: one object per quantization format (paper §2.2).

PyTorch counterpart of `repro/core/codecs.py`. Every format-specific piece
of the DECA pipeline lives on one `Codec` object:

  * ``encode`` / ``decode``         offline codec of packed nonzero values
                                    (codes + stored scales). Plain torch, so
                                    `core/compression.compress` runs on the
                                    device its input lies on; bitwise equal
                                    to the reference's numpy codec,
  * ``decode_values``               code -> f32 value, the one decoder the
                                    plain kernels (`kernels/ref.py`) use; the
                                    CUDA tile decode (`csrc/deca_tile.cuh`)
                                    repeats the same arithmetic,
  * ``decode_scales``               stored scale -> f32 multiplier
                                    (E8M0 ``exp2(u8-127)``, bf16-bits
                                    ``u16<<16``),
  * ``kv_encode`` / ``kv_decode``   runtime KV-cache quantization over the
                                    head dim with one bf16 scale per
                                    (cache slot, KV head).

Storage dtypes: codes are uint8; E8M0 scales uint8; bf16-bits scales are
int16 tensors holding the uint16 bit pattern (torch has no general uint16).
`torch.round` is half-to-even, as `jnp.round` and `np.rint` are.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# E2M1 magnitude grid (sign handled separately): code 0..7.
FP4_GRID = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32)

# NormalFloat4 (QLoRA): 16 quantiles of N(0,1) normalized to [-1, 1].
NF4_LUT = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# midpoints between adjacent levels: nearest-level quantizers (a tie goes
# to the lower level, as `np.argmin` and `np.searchsorted(side="left")` do)
_FP4_MIDS = (FP4_GRID[1:] + FP4_GRID[:-1]) / 2.0
_NF4_MIDS = (NF4_LUT[1:] + NF4_LUT[:-1]) / 2.0

_SCALE_BITS = {"none": 0, "e8m0": 8, "bf16": 16}


# ---------------------------------------------------------------------------
# bit-twiddling helpers (exact on CPU and CUDA alike: integer ops and views)
# ---------------------------------------------------------------------------

def f32_to_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 bit pattern (int16 holding uint16), round-to-nearest-even
    by integer arithmetic, exactly as the reference's numpy helper."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    b = b & 0xFFFFFFFF
    b = b + 0x7FFF + ((b >> 16) & 1)
    return ((b >> 16) & 0xFFFF).to(torch.int16)


def bf16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int16-held bf16 bit pattern -> f32 (exact)."""
    return bits.to(torch.int16).contiguous().view(torch.bfloat16).to(torch.float32)


def _byte_pair_view(lo: torch.Tensor, hi: torch.Tensor, dtype) -> torch.Tensor:
    """Two uint8 tensors -> 16-bit `dtype` values with `lo` as the low byte
    (little-endian view of the interleaved pair)."""
    return torch.stack([lo, hi], dim=-1).contiguous().view(dtype)[..., 0]


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 2**e for integer e in [-149, 127], built from bits (no
    `exp2`, whose rounding differs between libraries)."""
    e = e.to(torch.int32)
    normal = ((e + 127).clamp(min=1) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    return torch.where(e >= -126, normal, sub)


@functools.lru_cache(maxsize=1)
def _log2_roundup_table() -> Tuple[int, ...]:
    """Smallest 23-bit mantissa per exponent e in [-126, 127] at which the
    correctly rounded f32 `log2(2**e * (1 + m/2**23))` reaches e + 1.

    The reference's mxfp4 encoder takes `floor(np.log2(amax))` in f32; near
    the top of a binade the f32 result rounds up to the next integer. This
    table reproduces that with integer compares on the f32 bits, so the
    encoder gives numpy's bits on CPU and CUDA alike. (numpy's f32 log2 is
    correctly rounded at these points; tests/test_torch_codecs.py pins it.)
    """
    out = []
    for e in range(-126, 128):
        t = np.float32(e + 1)
        lo, hi = 0, 1 << 23  # hi: no mantissa rounds up
        while lo < hi:
            mid = (lo + hi) // 2
            if np.float32(e + math.log2(1 + mid / 2**23)) == t:
                hi = mid
            else:
                lo = mid + 1
        out.append(lo)
    return tuple(out)


def floor_log2_f32(x: torch.Tensor) -> torch.Tensor:
    """`floor(log2(x))` of normal positive f32 `x` as computed in f32 by
    numpy (int32 result), from exponent bits plus the round-up table."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    mant = bits & 0x7FFFFF
    table = torch.tensor(_log2_roundup_table(), dtype=torch.int32, device=x.device)
    return e + (mant >= table[(e + 126).long()]).to(torch.int32)


def pack_nibbles(nib: torch.Tensor, dim: int) -> torch.Tensor:
    """Nibble codes -> packed uint8 along `dim` (even index = low nibble)."""
    pairs = nib.unfold(dim, 2, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.uint8)


def unpack_nibbles(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """Packed uint8 -> nibbles along `dim` (even index = low nibble)."""
    dim = dim % codes.dim()
    stacked = torch.stack([codes & 0xF, codes >> 4], dim=dim + 1)
    shape = list(codes.shape)
    shape[dim] *= 2
    return stacked.reshape(shape)


_LUTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _lut(name: str, values: np.ndarray, device) -> torch.Tensor:
    """The table `values` on `device`, copied there once: a decode graph
    may run the decoder, and no host copy may happen inside a capture."""
    key = (name, torch.device(device))
    if key not in _LUTS:
        _LUTS[key] = torch.as_tensor(values, dtype=torch.float32, device=device)
    return _LUTS[key]


def _fp4_decode(nib: torch.Tensor) -> torch.Tensor:
    """E2M1 nibble -> f32: m/2 if e == 0 else (1 + m/2) * 2**(e-1)."""
    e = ((nib >> 1) & 0x3).to(torch.float32)
    m = (nib & 0x1).to(torch.float32)
    mag = torch.where(e == 0.0, 0.5 * m, (1.0 + 0.5 * m) * torch.exp2(e - 1.0))
    return torch.where((nib >> 3) == 1, -mag, mag)


def _count_above(x: torch.Tensor, mids: np.ndarray) -> torch.Tensor:
    """Index of the nearest level: how many midpoints lie strictly below x."""
    idx = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    for t in mids:
        idx += (x > float(t)).to(torch.uint8)
    return idx


def quantize_bf8(x: torch.Tensor) -> torch.Tensor:
    """f32/bf16 -> E5M2 code (uint8), round-to-nearest-even via fp16 bits;
    a finite value never rounds into inf."""
    h = x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    lower, upper = h & 0xFF, h >> 8
    round_up = (lower > 0x80) | ((lower == 0x80) & ((upper & 1) == 1))
    code = upper + round_up.to(torch.int32)
    overflow = (code & 0x7F) == 0x7C
    code = torch.where(overflow & ((upper & 0x7F) < 0x7C), upper, code)
    return code.to(torch.uint8)


def dequantize_bf8(code: torch.Tensor) -> torch.Tensor:
    """E5M2 code -> fp16 value (the code is fp16's high byte)."""
    return _byte_pair_view(torch.zeros_like(code), code, torch.float16)


# ---------------------------------------------------------------------------
# the Codec interface
# ---------------------------------------------------------------------------

class Codec:
    """One quantization format.

    Weight-path shapes (group-packed along K):
      encode(vals (ng, k_cap, N) f32) -> codes (ng, k_cap*bits/8, N) uint8,
                                         scales (ng, N) or None
      decode_values(codes) -> (ng, k_cap, N) f32 unscaled values
    KV-path shapes (quantize over the head dim):
      kv_encode(x (..., Dh)) -> codes (..., kv_code_width(Dh)) uint8,
                                scales (...,) bf16 or None
    """

    name: str = ""
    bits: int = 0
    scale_kind: str = "none"    # 'none' | 'e8m0' | 'bf16'
    is_identity: bool = False   # no dequant stage
    kv_capable: bool = True

    @property
    def scale_bits(self) -> int:
        return _SCALE_BITS[self.scale_kind]

    @property
    def has_scale(self) -> bool:
        return self.scale_bits > 0

    def kv_code_width(self, dh: int) -> int:
        """Stored code elements per Dh-wide KV head vector."""
        if self.bits == 4:
            if dh % 2:
                raise ValueError(f"{self.name}: head dim {dh} not nibble-packable")
            return dh // 2
        return dh

    # -- offline codec ------------------------------------------------------
    def encode(
        self, vals: torch.Tensor
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError

    def decode(
        self, codes: torch.Tensor, scales: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """Codes (+ scales) -> (ng, k_cap, N) f32 values."""
        vals = self.decode_values(codes)
        if scales is not None:
            vals = vals * self.decode_scales(scales)[:, None, :]
        return vals

    def decode_values(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode_scales(self, scales: torch.Tensor) -> torch.Tensor:
        """(ng, N) stored scales -> (ng, N) f32 multipliers."""
        if self.scale_kind == "e8m0":
            return pow2(scales.to(torch.int32) - 127)
        return bf16_bits_to_f32(scales)

    # -- KV-cache path ------------------------------------------------------
    def kv_encode(
        self, x: torch.Tensor
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError

    def kv_decode(
        self, codes: torch.Tensor, scales: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """Codes (+ scales) -> values: f32 for scaled codecs, fp16 for bf8;
        cache readers cast to bf16."""
        raise NotImplementedError

    def _kv_scale(self, x: torch.Tensor, qmax: float):
        """One bf16 scale per (..., head) vector over the last axis."""
        amax = x.to(torch.float32).abs().amax(dim=-1)
        scale = (amax / qmax).to(torch.bfloat16)  # the *stored* scale
        safe = torch.clamp(scale.to(torch.float32), min=1e-12)
        return scale, safe


class BF16Codec(Codec):
    """No quantization (sparsity only): codes are bf16 bit pairs."""

    name, bits, scale_kind = "bf16", 16, "none"
    is_identity = True
    kv_capable = False

    def encode(self, vals):
        ng, _, n = vals.shape
        b = f32_to_bf16_bits(vals).to(torch.int32) & 0xFFFF
        codes = torch.stack([b & 0xFF, b >> 8], dim=2).reshape(ng, -1, n)
        return codes.to(torch.uint8), None

    def decode_values(self, codes):
        return _byte_pair_view(
            codes[:, 0::2, :], codes[:, 1::2, :], torch.bfloat16
        ).to(torch.float32)


class BF8Codec(Codec):
    """E5M2 — the high byte of IEEE binary16."""

    name, bits, scale_kind = "bf8", 8, "none"

    def encode(self, vals):
        return quantize_bf8(vals), None

    def decode_values(self, codes):
        return dequantize_bf8(codes).to(torch.float32)

    def kv_encode(self, x):
        return quantize_bf8(x), None

    def kv_decode(self, codes, scales):
        return dequantize_bf8(codes)


class MXFP4Codec(Codec):
    """OCP MX FP4 (E2M1) with a shared E8M0 scale per group."""

    name, bits, scale_kind = "mxfp4", 4, "e8m0"

    def encode(self, vals):
        amax = vals.abs().amax(dim=1)  # (ng, N)
        e = floor_log2_f32(torch.clamp(amax, min=2.0 ** -126))
        scale_exp = torch.clamp(e - 2, -127, 127)  # E2M1 emax = 2
        scales = (scale_exp + 127).to(torch.uint8)
        q = vals / pow2(scale_exp)[:, None, :]
        sign = (q < 0).to(torch.uint8)
        codes4 = (sign << 3) | _count_above(q.abs(), _FP4_MIDS)
        return pack_nibbles(codes4, 1), scales

    def decode_values(self, codes):
        return _fp4_decode(unpack_nibbles(codes, 1))

    def kv_encode(self, x):
        scale, safe = self._kv_scale(x, 6.0)  # E2M1 max magnitude
        q = x.to(torch.float32) / safe[..., None]
        sign = (q < 0).to(torch.uint8)
        return pack_nibbles((sign << 3) | _count_above(q.abs(), _FP4_MIDS), -1), scale

    def kv_decode(self, codes, scales):
        vals = _fp4_decode(unpack_nibbles(codes, -1))
        return vals * scales.to(torch.float32)[..., None]


def _int_from_codes(codes: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    if bits == 8:
        return codes.view(torch.int8).to(torch.float32)
    nib = unpack_nibbles(codes, dim).to(torch.int32)
    return (nib - 16 * (nib >= 8).to(torch.int32)).to(torch.float32)


def _int_to_codes(q: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    if bits == 8:
        return (q & 0xFF).to(torch.uint8)
    return pack_nibbles((q & 0xF).to(torch.uint8), dim)


class IntCodec(Codec):
    """Symmetric integer (8 or 4 bit) with a per-group bf16 scale."""

    scale_kind = "bf16"

    def __init__(self, bits: int):
        self.name = f"int{bits}"
        self.bits = bits
        self.qmax = (1 << (bits - 1)) - 1

    def encode(self, vals):
        amax = vals.abs().amax(dim=1)
        scales = f32_to_bf16_bits(torch.clamp(amax / self.qmax, min=1e-12))
        scale = bf16_bits_to_f32(scales)  # quantize with the *stored* scale
        q = torch.clamp(
            torch.round(vals / scale[:, None, :]), -self.qmax, self.qmax
        ).to(torch.int32)
        return _int_to_codes(q, self.bits, 1), scales

    def decode_values(self, codes):
        return _int_from_codes(codes, self.bits, 1)

    def kv_encode(self, x):
        scale, safe = self._kv_scale(x, float(self.qmax))
        q = torch.clamp(
            torch.round(x.to(torch.float32) / safe[..., None]),
            -self.qmax, self.qmax,
        ).to(torch.int32)
        return _int_to_codes(q, self.bits, -1), scale

    def kv_decode(self, codes, scales):
        q = _int_from_codes(codes, self.bits, -1)
        return q * scales.to(torch.float32)[..., None]


class NF4Codec(Codec):
    """NormalFloat4: 16 N(0,1)-quantile levels in [-1, 1] through a LUT,
    with a per-group bf16 absmax scale."""

    name, bits, scale_kind = "nf4", 4, "bf16"

    def encode(self, vals):
        amax = vals.abs().amax(dim=1)
        scales = f32_to_bf16_bits(torch.clamp(amax, min=1e-12))
        scale = bf16_bits_to_f32(scales)
        idx = _count_above(vals / scale[:, None, :], _NF4_MIDS)
        return pack_nibbles(idx, 1), scales

    def decode_values(self, codes):
        nib = unpack_nibbles(codes, 1)
        return _lut("nf4", NF4_LUT, codes.device)[nib.long()]

    def kv_encode(self, x):
        scale, safe = self._kv_scale(x, 1.0)
        q = x.to(torch.float32) / safe[..., None]
        return pack_nibbles(_count_above(q, _NF4_MIDS), -1), scale

    def kv_decode(self, codes, scales):
        vals = _lut("nf4", NF4_LUT, codes.device)[unpack_nibbles(codes, -1).long()]
        return vals * scales.to(torch.float32)[..., None]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    if not codec.name or codec.bits <= 0:
        raise ValueError(f"codec needs a name and positive bits: {codec!r}")
    if codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def codec_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def kv_codec_names() -> Tuple[str, ...]:
    return tuple(n for n in codec_names() if _REGISTRY[n].kv_capable)


# Stable numeric codec ids (a wire format shared with the reference: ids are
# append-only). The CUDA kernels take the same ids (`csrc/deca_tile.cuh`).
_WIRE_IDS: Dict[str, int] = {
    "none": 0, "bf16": 1, "bf8": 2, "mxfp4": 3, "int8": 4, "int4": 5,
    "nf4": 6,
}


_WIRE_NAMES: Dict[int, str] = {v: k for k, v in _WIRE_IDS.items()}


def codec_wire_id(name: str) -> int:
    try:
        return _WIRE_IDS[name]
    except KeyError:
        raise ValueError(
            f"codec {name!r} has no wire id; known: {sorted(_WIRE_IDS)}"
        ) from None


def codec_from_wire_id(wire_id: int) -> str:
    """The codec name of a stable wire id (the inverse of `codec_wire_id`)."""
    try:
        return _WIRE_NAMES[wire_id]
    except KeyError:
        raise ValueError(f"unknown codec wire id {wire_id}") from None


register(BF16Codec())
register(BF8Codec())
register(MXFP4Codec())
register(IntCodec(8))
register(IntCodec(4))
register(NF4Codec())

"""Compression scheme geometry (paper §2.2).

Port-owned copy of `repro/core/formats.py`; unchanged in substance.

A scheme is (quantization format, unstructured density). The paper evaluates
Q16 (BF16, sparsity only), Q8 (BF8 = E5M2), and Q4 (MXFP4, group-32 scaled);
we additionally support INT8/INT4 group-scaled formats (the paper notes Q4
performance is representative of INT4-with-scales schemes like AWQ) and NF4.

The format-specific side (bits, scale encoding, encode/decode) lives in the
codec registry (`core/codecs.py`); this module owns only the *geometry* of a
scheme — density, group length, packed capacity, and the byte accounting the
roofline prices from. `CompressionSpec.quant` is a codec name, so any newly
registered codec parses through `get_spec` with zero changes here.

Storage model (bitmask-based sparse format, paper §2.2):
  - ``codes``   packed nonzero values (exactly ``k_cap`` kept per group of
                ``group`` consecutive elements along the contraction dim K —
                offline sparsification is per-group top-|w|, which realizes
                unstructured sparsity at static shape, a JAX requirement),
  - ``mask``    one bit per element of the original matrix,
  - ``scales``  one scale per (group, column) for group-quantized formats.

Compression factor (paper §2.2): CF = 16 / (Q*d + 1)  [+ scale overhead].
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.codecs import Codec, get_codec

GROUP = 32  # sparsity + scale group along K (matches MXFP4's 32-elem groups)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Static description of a compression scheme."""

    quant: str            # any registered codec name (core/codecs.py)
    density: float = 1.0  # fraction of nonzeros kept (1.0 = dense)
    group: int = GROUP    # group length along K for sparsity & scales

    def __post_init__(self):
        get_codec(self.quant)  # raises ValueError for unregistered formats
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.group % 32 != 0:
            raise ValueError("group must be a multiple of 32 (uint32 bitmask)")

    # -- codec metadata ---------------------------------------------------
    @property
    def codec(self) -> Codec:
        return get_codec(self.quant)

    @property
    def bits(self) -> int:
        return self.codec.bits

    @property
    def has_scale(self) -> bool:
        return self.codec.has_scale

    @property
    def is_sparse(self) -> bool:
        return self.density < 1.0

    @property
    def k_cap(self) -> int:
        """Nonzeros kept per group (static capacity)."""
        k = max(1, round(self.group * self.density))
        if self.bits == 4:
            k += k % 2  # nibble packing needs an even count
        return min(k, self.group)

    @property
    def name(self) -> str:
        d = int(round(self.density * 100))
        return f"{self.quant}_{d}"

    # -- roofline accounting (all format constants come from the codec) ---
    def bits_per_element(self) -> float:
        """Average stored bits per *original* matrix element."""
        bits = self.bits * self.k_cap / self.group
        if self.is_sparse:
            bits += 1.0  # bitmask
        bits += self.codec.scale_bits / self.group
        return bits

    def bytes_for(self, k: int, n: int) -> int:
        """Exact compressed bytes for a (K, N) weight."""
        ng = math.ceil(k / self.group)
        code_bytes = ng * self.k_cap * n * self.bits // 8
        mask_bytes = ng * 4 * n if self.is_sparse else 0
        scale_bytes = ng * n * self.codec.scale_bits // 8
        return code_bytes + mask_bytes + scale_bytes


def get_spec(name: str) -> CompressionSpec:
    """Parse 'bf8_50' style names (density percent suffix optional)."""
    if "_" in name:
        quant, dens = name.rsplit("_", 1)
        return CompressionSpec(quant, int(dens) / 100.0)
    return CompressionSpec(name, 1.0)

"""The Roof-Surface performance model (paper §4), with an H100 profile.

Port-owned copy of `repro/core/roofsurface.py`. Core equation (paper Eq. 2):

    TPS   = min( MBW * AI_XM,  VOS * AI_XV,  MOS )
    FLOPS = 512 * N * TPS

with the kernel signature (AI_XM, AI_XV):
    AI_XM = 1 / bytes_per_tile      [matrix ops per memory byte]
    AI_XV = 1 / vops_per_tile       [matrix ops per vector op]

and the architecture profile (MBW, VOS, MOS). A tile is one matrix-engine
operation's weight operand: 512 BF16 elements (16x32) on SPR/AMX.

This module provides:
  * HardwareProfile       — SPR-DDR, SPR-HBM (paper) and H100-SXM profiles,
  * software AI_XV model  — calibrated AVX decompression cost (libxsmm),
  * DECA AI_XV model      — the paper's vOp + binomial-bubble model (§6.2),
  * BORD classification   — which factor bounds a kernel (paper §4.2),
  * the 4-term extension  — an interconnect collective term for multi-card
    execution: T = max(T_mem, T_vec, T_mtx, T_ici),
  * the KV-decode term    — `paged_attention_point` prices the decode-
    attention KV stream (quantized page bytes, codec-decode vector ops,
    QK/PV matrix ops) on the same surface, so the 3D roofline covers
    attention as well as GeMM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core.codecs import get_codec
from repro_torch.core.formats import CompressionSpec

TILE_ELEMS = 512  # one AMX weight tile = 16 rows x 32 cols
FLOPS_PER_TILE_PER_BATCH = 512  # FMAs per TMUL op per batch row (paper §2.3)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Architecture-side parameters of the Roof-Surface."""

    name: str
    mbw: float        # memory bandwidth, bytes/s
    vos: float        # vector ops/s (decompression domain)
    mos: float        # matrix (tile) ops/s
    n_chips: int = 1  # informational
    ici_bw: float = 0.0  # per-card interconnect bandwidth, bytes/s

    @property
    def peak_flops(self) -> float:
        """FMA/s at saturating batch: the MOS tile rate re-expressed in the
        flops domain (one 512-element tile at batch 16 is 8192 FMAs), so
        time-domain consumers (`surface_step_time`, obs/rooflens) don't
        each re-derive the 512 * 16 tile constant."""
        return self.mos * FLOPS_PER_TILE_PER_BATCH * 16

    def scaled(self, *, vos_mult: float = 1.0, cores_mult: float = 1.0,
               name: Optional[str] = None) -> "HardwareProfile":
        return dataclasses.replace(
            self,
            name=name or self.name,
            mbw=self.mbw * cores_mult if cores_mult != 1.0 else self.mbw,
            vos=self.vos * vos_mult * cores_mult,
            mos=self.mos * cores_mult,
        )


# -- paper's SPR system (§8): 56 cores @ 2.5 GHz --------------------------
_F, _C = 2.5e9, 56
SPR_DDR = HardwareProfile("SPR-DDR", mbw=260e9, vos=_F * _C * 2, mos=_F * _C / 16)
SPR_HBM = HardwareProfile("SPR-HBM", mbw=850e9, vos=_F * _C * 2, mos=_F * _C / 16)

# -- NVIDIA H100 SXM5 (NVIDIA's H100 data sheet, dense rates, 700 W) --------
H100_SMS = 132            # streaming multiprocessors on the SXM5 part
H100_FP32_LANES = 128     # FP32 lanes per SM; INT32 issues at half of that
H100_BOOST_CLOCK = 1.98e9  # boost clock, Hz
H100_SXM = HardwareProfile(
    "H100-SXM",
    mbw=3.35e12,  # HBM3, 80 GB
    # the DECA stages run on the CUDA cores: one lane-op per FP32 lane per
    # clock (the integer unpacking issues at half this rate)
    vos=H100_SMS * H100_FP32_LANES * H100_BOOST_CLOCK,
    # 989 TFLOP/s dense bf16 tensor cores, in 512-element tile ops at N = 16
    mos=989e12 / (FLOPS_PER_TILE_PER_BATCH * 16),
    ici_bw=450e9,  # NVLink 4: 900 GB/s per card, both directions together
)


# ---------------------------------------------------------------------------
# kernel signatures: AI_XM and AI_XV
# ---------------------------------------------------------------------------

def bytes_per_tile(spec: CompressionSpec) -> float:
    """Compressed bytes fetched from memory per 512-element weight tile.

    `bits_per_element` is codec-metadata-driven (value bits + bitmask +
    scale bits all come from the registered codec), so a newly registered
    format is priced on the 3D roofline with no changes here."""
    return TILE_ELEMS * spec.bits_per_element() / 8.0


def ai_xm(spec: CompressionSpec) -> float:
    return 1.0 / bytes_per_tile(spec)


def software_vops_per_tile(spec: CompressionSpec) -> float:
    """AVX decompression cost model for the libxsmm software path (§2.4).

    Per 32-element tile row (one cache line of BF16 output) the AVX sequence
    performs: nonzero loads, a mask load + bookkeeping, masked expand ops,
    dequantization converts, and a store. Constants are calibrated so the
    model reproduces the paper's measurements (Figs. 3-5): e.g. the 4.94x
    Optimal/Observed gap for BF8_5% on HBM and the VEC/MEM region boundaries.
    """
    rows = 16
    d, q = spec.density, spec.bits
    load_ops = (32 * d * q / 8.0) / 64.0          # nonzero bytes / 64B line
    mask_ops = 1.0 if spec.is_sparse else 0.0     # bitmask load + popcnt path
    expand_ops = 3.0 if spec.is_sparse else 0.0   # expand + permute + blend
    if get_codec(spec.quant).is_identity:         # no dequant stage at all
        dequant_ops = 0.0
    elif spec.bits >= 8:
        dequant_ops = 3.0                          # cvt + shift + pack
    else:
        dequant_ops = 4.0                          # + nibble unpack
    scale_ops = 2.0 if spec.has_scale else 0.0     # broadcast + multiply
    store_ops = 2.0                                # store + loop overhead
    per_row = load_ops + mask_ops + expand_ops + dequant_ops + scale_ops + store_ops
    return rows * per_row


def software_ai_xv(spec: CompressionSpec) -> float:
    return 1.0 / software_vops_per_tile(spec)


# -- DECA vOp model (paper §6.2) -------------------------------------------

def _binom_cdf(i: float, n: int, p: float) -> float:
    """P[X <= i] for X ~ Binomial(n, p). Exact via math.comb."""
    if i < 0:
        return 0.0
    i = min(int(math.floor(i)), n)
    return sum(math.comb(n, k) * p**k * (1 - p) ** (n - k) for k in range(i + 1))


def deca_bubbles_per_vop(spec: CompressionSpec, w: int, l: int) -> float:
    """Expected pipeline bubbles per vOp (paper's binomial model).

    L_q = elements dequantizable per cycle: L for 8-bit, 2L for 7-bit,
    4L for <=6-bit.
    """
    if spec.bits >= 8:
        lq = l
    elif spec.bits == 7:
        lq = 2 * l
    else:
        lq = 4 * l
    if get_codec(spec.quant).is_identity:
        lq = 4 * l  # no dequantization needed: LUT stage is bypassed
    if lq >= w:
        return 0.0
    d = spec.density
    if not spec.is_sparse:
        return math.ceil(w / lq) - 1.0
    total = 0.0
    for k in range(0, math.ceil(w / lq)):
        p = _binom_cdf((k + 1) * lq, w, d) - _binom_cdf(k * lq, w, d)
        total += k * p
    return total


def deca_vops_per_tile(spec: CompressionSpec, w: int = 32, l: int = 8) -> float:
    n_vops = TILE_ELEMS / w
    bpv = deca_bubbles_per_vop(spec, w, l)
    return n_vops * (1.0 + bpv)


def deca_ai_xv(spec: CompressionSpec, w: int = 32, l: int = 8) -> float:
    return 1.0 / deca_vops_per_tile(spec, w, l)


def deca_profile(base: HardwareProfile, *, cores: Optional[int] = None,
                 f: float = _F) -> HardwareProfile:
    """DECA VOS = one vOp per cycle per PE (paper §6.2): VOS = c * f."""
    c = cores if cores is not None else _C
    return dataclasses.replace(
        base, name=base.name + "+DECA", vos=f * c,
        mos=base.mos * (c / _C), mbw=base.mbw,
    )


# ---------------------------------------------------------------------------
# the Roof-Surface evaluation and BORD classification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SurfacePoint:
    """One kernel evaluated on one profile."""

    name: str
    ai_xm: float
    ai_xv: float
    tps: float            # tiles/s (paper Eq. 1)
    flops: float          # FMA/s (paper Eq. 2)
    bound: str            # 'MEM' | 'VEC' | 'MTX'
    rates: Dict[str, float]


def _select_bound(rates: Dict[str, float]) -> Tuple[str, float]:
    """BORD pick over {MEM, MTX, VEC} rates. Tie-break order MEM > MTX >
    VEC (with a 0.1% tolerance): a balanced design (e.g. DECA {32,8},
    whose PE ties the TMUL at one tile/16 cycles up to a vanishing bubble
    expectation) counts as *not* VEC-bound, matching the paper's §9.2
    saturation criterion. Shared by the GeMM surface (`evaluate`) and the
    KV-decode surface (`paged_attention_point`) so the two can never
    classify bounds inconsistently."""
    floor = min(rates.values())
    bound = next(k for k, v in rates.items() if v <= floor * 1.001)
    return bound, rates[bound]


def evaluate(
    spec: CompressionSpec,
    profile: HardwareProfile,
    *,
    ai_xv: Optional[float] = None,
    batch_n: int = 4,
) -> SurfacePoint:
    """Evaluate the Roof-Surface for one kernel signature."""
    xm = ai_xm(spec)
    xv = ai_xv if ai_xv is not None else software_ai_xv(spec)
    rates = {
        "MEM": profile.mbw * xm,
        "MTX": profile.mos,
        "VEC": profile.vos * xv,
    }
    bound, tps = _select_bound(rates)
    n_eff = min(batch_n, 16)
    return SurfacePoint(
        name=spec.name, ai_xm=xm, ai_xv=xv, tps=tps,
        flops=FLOPS_PER_TILE_PER_BATCH * n_eff * tps, bound=bound, rates=rates,
    )


def roofline_flops(spec: CompressionSpec, profile: HardwareProfile,
                   *, batch_n: int = 4) -> float:
    """Classic 2D roofline prediction (no VEC term) — paper's 'Optimal'."""
    tps = min(profile.mbw * ai_xm(spec), profile.mos)
    return FLOPS_PER_TILE_PER_BATCH * min(batch_n, 16) * tps


def bord_regions(profile: HardwareProfile) -> Dict[str, float]:
    """BORD separating lines (paper Fig. 5): y=(MBW/VOS)x, x=MOS/MBW,
    y=MOS/VOS."""
    return {
        "vec_mem_slope": profile.mbw / profile.vos,
        "mem_mtx_x": profile.mos / profile.mbw,
        "vec_mtx_y": profile.mos / profile.vos,
    }


# ---------------------------------------------------------------------------
# KV-decode traffic: attention on the Roof-Surface
# ---------------------------------------------------------------------------

def kv_bytes_per_token(kv_quant: str, hkv: int, dh: int) -> float:
    """Device-memory bytes one cached token costs the decode-attention read
    stream: K + V code planes, codec scale planes (one bf16 per (slot,
    head), K and V), and the int32 position plane. Codec-metadata-driven
    like `bytes_per_tile`, so a newly registered format is priced with no
    changes here."""
    if kv_quant in ("none", "", None):
        per = 2 * hkv * dh * 2  # bf16 K + V
    else:
        codec = get_codec(kv_quant)
        per = 2 * hkv * codec.kv_code_width(dh)
        if codec.has_scale:
            per += 2 * hkv * 2
    return float(per + 4)


def kv_decode_vops_per_token(kv_quant: str, hkv: int, dh: int) -> float:
    """Vector element-ops to dequantize one token's K and V head vectors on
    read. Byte-wide codes decode in ~1 op/element (shift + bitcast or
    int cast), nibble-packed formats add the unpack (~2), and scaled
    codecs one broadcast multiply — mirroring `software_vops_per_tile`'s
    accounting for the weight stream."""
    if kv_quant in ("none", "", None):
        return 0.0
    codec = get_codec(kv_quant)
    per_elem = 1.0 if codec.bits >= 8 else 2.0
    if codec.has_scale:
        per_elem += 1.0
    return 2.0 * hkv * dh * per_elem


def paged_attention_point(
    name: str,
    *,
    kv_quant: str,
    hq: int,
    hkv: int,
    dh: int,
    kv_len: int,
    profile: HardwareProfile,
    batch_n: int = 4,
) -> SurfacePoint:
    """Price one fused paged-attention decode step on the Roof-Surface.

    The KV stream is the third traffic term next to the compressed-weight
    stream (§4) and the interconnect term: per decoded token a layer reads
    `kv_len` quantized KV tokens (AI_XM over their bytes), spends
    `kv_decode_vops_per_token` vector ops dequantizing them (AI_XV), and
    performs the QK^T + PV contractions (2 * kv_len * Hq * Dh FMAs,
    expressed in 512-element tile ops so the same MOS applies). The
    returned BORD bound says what the decode-attention kernel is limited
    by — MEM for every format at production shapes, which is exactly why
    dequantize-on-read (smaller codes = proportionally faster) wins."""
    flops = 2.0 * kv_len * hq * dh  # QK^T + PV FMAs per decoded token
    tiles = flops / TILE_ELEMS
    kv_bytes = kv_len * kv_bytes_per_token(kv_quant, hkv, dh)
    vops = kv_len * kv_decode_vops_per_token(kv_quant, hkv, dh)
    xm = tiles / kv_bytes
    xv = tiles / vops if vops else math.inf
    rates = {
        "MEM": profile.mbw * xm,
        "MTX": profile.mos,
        "VEC": profile.vos * xv if vops else math.inf,
    }
    bound, tps = _select_bound(rates)
    return SurfacePoint(
        name=name, ai_xm=xm, ai_xv=xv, tps=tps,
        flops=FLOPS_PER_TILE_PER_BATCH * min(batch_n, 16) * tps,
        bound=bound, rates=rates,
    )


def surface_step_time(
    profile: HardwareProfile,
    *,
    flops: float,
    hbm_bytes: float,
    vector_ops: float = 0.0,
    collective_bytes: float = 0.0,
    n_chips: int = 1,
) -> float:
    """Predicted wall seconds for one step's traffic on the Roof-Surface:
    the time-domain max over the same terms `evaluate` rates —
    max(T_mtx, T_mem, T_vec, T_ici). This is the single conversion point
    from counted traffic to predicted latency; `obs/rooflens.py` builds its
    per-step serving predictions on it and validates them against measured
    wall time."""
    t = max(
        flops / (n_chips * profile.peak_flops),
        hbm_bytes / (n_chips * profile.mbw),
        vector_ops / (n_chips * profile.vos) if vector_ops else 0.0,
    )
    if collective_bytes and profile.ici_bw:
        t = max(t, collective_bytes / (n_chips * profile.ici_bw))
    return t


# ---------------------------------------------------------------------------
# 4-term extension: time-domain surface with an interconnect term
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-step time decomposition of a program on one or more cards:
    seconds per term, per card."""

    name: str
    t_compute: float
    t_memory: float
    t_vector: float
    t_collective: float

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_vector, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {
            "MTX": self.t_compute,
            "MEM": self.t_memory,
            "VEC": self.t_vector,
            "ICI": self.t_collective,
        }
        return max(terms, key=terms.get)


def device_terms(
    name: str,
    *,
    flops: float,
    hbm_bytes: float,
    collective_bytes: float = 0.0,
    vector_ops: float = 0.0,
    n_chips: int = 1,
    profile: HardwareProfile = H100_SXM,
) -> RooflineTerms:
    """The 4-term surface from counted traffic (the reference's
    `tpu_terms`), the compute term at `profile.peak_flops`."""
    return RooflineTerms(
        name=name,
        t_compute=flops / (n_chips * profile.peak_flops),
        t_memory=hbm_bytes / (n_chips * profile.mbw),
        t_vector=vector_ops / (n_chips * profile.vos) if vector_ops else 0.0,
        t_collective=(
            collective_bytes / (n_chips * profile.ici_bw) if profile.ici_bw else 0.0
        ),
    )

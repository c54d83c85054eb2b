"""Design-space exploration with the Roof-Surface model (paper §9.2).

Port-owned copy of the paper's {W, L} sweep of `repro/core/dse.py`: pick
the smallest DECA PE (datapath width W, LUT lanes L) for which no kernel
of the scheme grid is VEC-bound (best = {32, 8}). The reference's second
sweep, over Pallas block shapes under a TPU VMEM budget, has its Hopper
counterpart in `kernels/autotune.py`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core import roofsurface as rs
from repro_torch.core.formats import PAPER_SCHEMES, CompressionSpec


@dataclasses.dataclass(frozen=True)
class DSEResult:
    w: int
    l: int
    n_vec_bound: int
    mean_tps: float
    cost: float  # relative hardware cost proxy


def _deca_cost(w: int, l: int) -> float:
    """Area proxy: W scales the datapath/XBAR, L the LUT array (22% of area
    at L=8 per paper §8)."""
    return w / 32.0 * 0.78 + l / 8.0 * 0.22


def sweep_wl(
    schemes: Sequence[CompressionSpec] = tuple(PAPER_SCHEMES),
    profile: rs.HardwareProfile = rs.SPR_HBM,
    ws: Sequence[int] = (8, 16, 32, 64),
    ls: Sequence[int] = (4, 8, 16, 32, 64),
) -> List[DSEResult]:
    results = []
    for w in ws:
        for l in ls:
            if l > w:
                continue
            prof = rs.deca_profile(profile)
            pts = [
                rs.evaluate(s, prof, ai_xv=rs.deca_ai_xv(s, w, l)) for s in schemes
            ]
            n_vec = sum(p.bound == "VEC" for p in pts)
            mean_tps = sum(p.tps for p in pts) / len(pts)
            results.append(DSEResult(w, l, n_vec, mean_tps, _deca_cost(w, l)))
    return results


def best_wl(results: Optional[List[DSEResult]] = None) -> DSEResult:
    """Smallest-cost {W, L} with all kernels out of the VEC region."""
    results = results if results is not None else sweep_wl()
    ok = [r for r in results if r.n_vec_bound == 0]
    if not ok:
        return min(results, key=lambda r: (r.n_vec_bound, r.cost))
    return min(ok, key=lambda r: r.cost)

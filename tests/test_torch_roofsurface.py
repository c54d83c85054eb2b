"""Parity of the port's Roof-Surface model and {W, L} design-space sweep
with the JAX package's (`repro/core/roofsurface.py`, `repro/core/dse.py`).

Both are host-side float arithmetic in the same order, so every ported
function is held equal exactly (`==`) on the same inputs: every scheme of
the paper's grid on the paper's SPR profiles, on a profile built from the
reference's TPU-v5e fields (the port carries no TPU profile) and on the
port's H100 profile rebuilt in the reference. The port's versions of the
paper-claim tests of `tests/test_roofsurface.py` follow.
"""
import dataclasses
import math

import pytest

from repro.core import dse as jdse
from repro.core import roofsurface as jrs
from repro.core.formats import PAPER_SCHEMES as JPAPER_SCHEMES
from repro.core.formats import get_spec as jget_spec

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import dse, roofsurface as rs
from repro_torch.core.formats import PAPER_SCHEMES, CompressionSpec, get_spec

SCHEMES = [s.name for s in PAPER_SCHEMES] + ["int8_100", "int4_50", "nf4_100", "bf8_5"]
KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")
WL = [(w, l) for w in (8, 16, 32, 64) for l in (4, 8, 16, 32, 64) if l <= w]


def _pair(name: str):
    """(port profile, reference profile) with the same fields."""
    if name == "TPU-v5e":
        ref = jrs.TPU_V5E
        return rs.HardwareProfile(**dataclasses.asdict(ref)), ref
    if name == "H100-SXM":
        return rs.H100_SXM, jrs.HardwareProfile(**dataclasses.asdict(rs.H100_SXM))
    return getattr(rs, name.replace("-", "_")), getattr(jrs, name.replace("-", "_"))


PROFILES = ("SPR-DDR", "SPR-HBM", "TPU-v5e", "H100-SXM")


def _point(p) -> dict:
    return dataclasses.asdict(p)


def test_paper_scheme_grid_is_the_reference_grid():
    assert [s.name for s in PAPER_SCHEMES] == [s.name for s in JPAPER_SCHEMES]
    assert [(s.quant, s.density) for s in PAPER_SCHEMES] == [
        (s.quant, s.density) for s in JPAPER_SCHEMES
    ]


@pytest.mark.parametrize("name", PROFILES)
def test_profiles_equal(name):
    port, ref = _pair(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.peak_flops == ref.peak_flops
    for kw in (dict(vos_mult=4.0), dict(cores_mult=2.0), dict(vos_mult=0.5, name="x")):
        assert dataclasses.asdict(port.scaled(**kw)) == dataclasses.asdict(ref.scaled(**kw))
    assert dataclasses.asdict(rs.deca_profile(port)) == dataclasses.asdict(jrs.deca_profile(ref))
    assert dataclasses.asdict(rs.deca_profile(port, cores=8, f=1.5e9)) == dataclasses.asdict(
        jrs.deca_profile(ref, cores=8, f=1.5e9))
    assert rs.bord_regions(port) == jrs.bord_regions(ref)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_kernel_signatures_equal(scheme):
    s, js = get_spec(scheme), jget_spec(scheme)
    assert rs.bytes_per_tile(s) == jrs.bytes_per_tile(js)
    assert rs.ai_xm(s) == jrs.ai_xm(js)
    assert rs.software_vops_per_tile(s) == jrs.software_vops_per_tile(js)
    assert rs.software_ai_xv(s) == jrs.software_ai_xv(js)
    for w, l in WL:
        assert rs.deca_bubbles_per_vop(s, w, l) == jrs.deca_bubbles_per_vop(js, w, l)
        assert rs.deca_vops_per_tile(s, w, l) == jrs.deca_vops_per_tile(js, w, l)
        assert rs.deca_ai_xv(s, w, l) == jrs.deca_ai_xv(js, w, l)


@pytest.mark.parametrize("name", PROFILES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_surface_points_equal(scheme, name):
    s, js = get_spec(scheme), jget_spec(scheme)
    port, ref = _pair(name)
    for batch_n in (1, 4, 16, 64):
        assert _point(rs.evaluate(s, port, batch_n=batch_n)) == _point(
            jrs.evaluate(js, ref, batch_n=batch_n))
        assert rs.roofline_flops(s, port, batch_n=batch_n) == jrs.roofline_flops(
            js, ref, batch_n=batch_n)
    for w, l in WL:
        xv = rs.deca_ai_xv(s, w, l)
        assert _point(rs.evaluate(s, rs.deca_profile(port), ai_xv=xv)) == _point(
            jrs.evaluate(js, jrs.deca_profile(ref), ai_xv=xv))


@pytest.mark.parametrize("kind", KV_KINDS)
def test_kv_terms_and_attention_points_equal(kind):
    for arch in (get_smoke_config("llama3-8b"), get_config("llama3-8b")):
        hq, hkv, dh = arch.n_heads, arch.n_kv_heads, arch.d_head
        assert rs.kv_bytes_per_token(kind, hkv, dh) == jrs.kv_bytes_per_token(kind, hkv, dh)
        assert rs.kv_decode_vops_per_token(kind, hkv, dh) == jrs.kv_decode_vops_per_token(
            kind, hkv, dh)
        for name in PROFILES:
            port, ref = _pair(name)
            for kv_len in (1, 64, 777, 2048):
                kw = dict(kv_quant=kind, hq=hq, hkv=hkv, dh=dh, kv_len=kv_len)
                assert _point(rs.paged_attention_point("a", profile=port, **kw)) == _point(
                    jrs.paged_attention_point("a", profile=ref, **kw))


@pytest.mark.parametrize("name", PROFILES)
def test_step_time_and_terms_equal(name):
    port, ref = _pair(name)
    for flops, nbytes, vops, coll, chips in (
        (1e15, 1e12, 1e12, 5e11, 256), (3.3e13, 5.7e9, 8.7e9, 0.0, 1),
        (0.0, 1.0, 0.0, 0.0, 1), (1e9, 1e6, 0.0, 1e8, 4),
    ):
        assert rs.surface_step_time(
            port, flops=flops, hbm_bytes=nbytes, vector_ops=vops,
            collective_bytes=coll, n_chips=chips,
        ) == jrs.surface_step_time(
            ref, flops=flops, hbm_bytes=nbytes, vector_ops=vops,
            collective_bytes=coll, n_chips=chips,
        )
        # `device_terms` is the reference's `tpu_terms` at the profile's peak
        got = rs.device_terms("x", flops=flops, hbm_bytes=nbytes, collective_bytes=coll,
                              vector_ops=vops, n_chips=chips, profile=port)
        want = jrs.tpu_terms("x", hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
                             vector_ops=vops, n_chips=chips, profile=ref,
                             peak_flops=ref.peak_flops)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.t_bound, got.bottleneck) == (want.t_bound, want.bottleneck)


@pytest.mark.parametrize("name", PROFILES)
def test_dse_sweep_equal(name):
    port, ref = _pair(name)
    got = dse.sweep_wl(profile=port)
    want = jdse.sweep_wl(profile=ref)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert dataclasses.asdict(dse.best_wl(got)) == dataclasses.asdict(jdse.best_wl(want))
    for w, l in WL:
        assert dse._deca_cost(w, l) == jdse._deca_cost(w, l)


def test_param_counts_equal_the_reference():
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import get_smoke_config as jget_smoke_config

    for port, ref in ((get_config("llama3-8b"), jget_config("llama3-8b")),
                      (get_smoke_config("llama3-8b"), jget_smoke_config("llama3-8b"))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        # the branches llama does not reach, on the same field values
        for kw in (dict(family="ssm", ssm_state=16), dict(block_pattern=("rec", "attn")),
                   dict(n_experts=8, experts_per_token=2), dict(tie_embeddings=True,
                                                                pos_emb="learned")):
            p, r = dataclasses.replace(port, **kw), dataclasses.replace(ref, **kw)
            assert (p.param_count(), p.active_param_count()) == (
                r.param_count(), r.active_param_count()), kw
    assert get_config("llama3-8b").param_count() == 8030257152


# ---------------------------------------------------------------------------
# the paper's claims, on the port (tests/test_roofsurface.py)
# ---------------------------------------------------------------------------

def test_surface_is_min_of_rates():
    pt = rs.evaluate(get_spec("bf8_50"), rs.SPR_HBM)
    assert math.isclose(pt.tps, min(pt.rates.values()), rel_tol=1e-9)
    assert pt.flops == 512 * 4 * pt.tps  # batch_n = 4 default


@pytest.mark.parametrize("mult", [0.1, 0.5, 1.0, 2.0, 4.0, 10.0])
def test_monotone_in_vector_throughput(mult):
    """More VOS can never hurt (the surface is monotone per axis)."""
    for s in PAPER_SCHEMES:
        base = rs.evaluate(s, rs.SPR_HBM)
        scaled = rs.evaluate(s, rs.SPR_HBM.scaled(vos_mult=mult))
        if mult >= 1.0:
            assert scaled.tps >= base.tps - 1e-9
        else:
            assert scaled.tps <= base.tps + 1e-9


def test_roofline_never_below_roofsurface():
    for prof in (rs.SPR_HBM, rs.H100_SXM):
        for s in PAPER_SCHEMES:
            assert rs.roofline_flops(s, prof) >= rs.evaluate(s, prof).flops - 1e-6


def test_paper_bf8_5_divergence_on_hbm():
    """Paper Fig. 3b: Optimal/Observed = 4.94x for BF8_5% on HBM (4.0-6.0:
    the software AVX cost model is calibrated, not simulated)."""
    s = get_spec("bf8_5")
    ratio = rs.roofline_flops(s, rs.SPR_HBM) / rs.evaluate(s, rs.SPR_HBM).flops
    assert 4.0 <= ratio <= 6.0


def test_paper_bord_regions_hbm():
    """Paper Fig. 4a/5a: MXFP4, BF16_10%, BF8_5% are VEC-bound on HBM;
    BF16_100/50/30 and BF8_100 are MEM-bound."""
    vec = {"mxfp4_100", "bf16_10", "bf8_5"}
    mem = {"bf16_100", "bf16_50", "bf16_30", "bf8_100"}
    for s in PAPER_SCHEMES:
        pt = rs.evaluate(s, rs.SPR_HBM)
        if s.name in vec:
            assert pt.bound == "VEC", s.name
        if s.name in mem:
            assert pt.bound == "MEM", s.name


def test_paper_bord_regions_ddr():
    """Paper Fig. 5b: on DDR only the highest compression factors stay
    VEC-bound."""
    for s in PAPER_SCHEMES:
        pt = rs.evaluate(s, rs.SPR_DDR)
        if s.name in {"bf16_100", "bf16_50", "bf16_30", "bf8_100", "bf8_50"}:
            assert pt.bound == "MEM", s.name
    assert rs.evaluate(get_spec("bf8_5"), rs.SPR_DDR).bound == "VEC"


def test_paper_4x_vos_not_enough():
    """Paper Fig. 6: even 4x VOS leaves some kernels VEC-bound on HBM."""
    prof = rs.SPR_HBM.scaled(vos_mult=4.0)
    assert [s.name for s in PAPER_SCHEMES if rs.evaluate(s, prof).bound == "VEC"]


def test_paper_dse_best_is_32_8():
    """Paper §9.2: {W=32, L=8} is the smallest pair with no VEC-bound kernel;
    {8,4} is ~2x slower; {64,64} is <3% faster."""
    res = dse.sweep_wl()
    best = dse.best_wl(res)
    assert (best.w, best.l) == (32, 8)
    by = {(r.w, r.l): r for r in res}
    assert 1.7 <= by[(32, 8)].mean_tps / by[(8, 4)].mean_tps <= 2.3
    assert by[(64, 64)].mean_tps / by[(32, 8)].mean_tps <= 1.03


def test_deca_bubble_model_limits():
    """Dense 8-bit with W=32, L=8 stalls ceil(32/8)-1 = 3 cycles; fully
    provisioned (L_q >= W) never stalls; sparse in between."""
    assert rs.deca_bubbles_per_vop(get_spec("bf8_100"), 32, 8) == 3.0
    assert rs.deca_bubbles_per_vop(get_spec("bf8_100"), 32, 32) == 0.0
    b = rs.deca_bubbles_per_vop(get_spec("bf8_50"), 32, 8)
    assert 0.0 < b < 3.0


@pytest.mark.parametrize("d", [0.05, 0.2, 0.5, 0.8, 1.0])
def test_bubbles_monotone_in_density(d):
    """Sparser tiles never produce more bubbles (paper §6.1)."""
    lo = rs.deca_bubbles_per_vop(CompressionSpec("bf8", max(d - 0.04, 0.01)), 32, 8)
    hi = rs.deca_bubbles_per_vop(CompressionSpec("bf8", d), 32, 8)
    assert lo <= hi + 1e-9


def test_h100_profile_constants():
    """The H100 SXM data sheet's dense rates: 3.35 TB/s, 989 TFLOP/s bf16;
    132 SMs x 128 FP32 lanes x 1.98 GHz; NVLink 4 at 450 GB/s a direction."""
    p = rs.H100_SXM
    assert p.mbw == 3.35e12 and p.peak_flops == 989e12
    assert p.vos == 132 * 128 * 1.98e9 and p.ici_bw == 450e9
    terms = rs.device_terms("decode", flops=2 * 4 * 8e9, hbm_bytes=5.742e9)
    assert terms.bottleneck == "MEM" and terms.t_bound == 5.742e9 / 3.35e12
    assert not hasattr(rs, "TPU_V5E")

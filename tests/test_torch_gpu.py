"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one: the kernels have no
CPU mode. They import only torch, numpy and the port, so they run on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: the kernels and their plain versions multiply the same bf16
values exactly and sum in f32 in another order (matmuls: K <= 512 here,
and the paper models' K of 28672 and 36864; attention: an online
softmax over another grouping), so they agree to 1e-4 of the output's
scale. Decompression has no accumulation and is
bitwise. A spec engine's tokens are held against teacher-forced logits of
the target to 5e-2 of their scale, the kernel-path tolerance of PERF.md.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.compression import CompressedTensor, compress
from repro_torch.core.decompress import make_draft_tree
from repro_torch.core.formats import CompressionSpec, get_spec
from repro_torch.kernels import autotune, deca_decompress, deca_gemm, ops, paged_attention, ref
from repro_torch.kernels.ref import CACHE_EMPTY_POS
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine, SpecConfig

KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _close(got, want):
    return float((got.float() - want.float()).abs().max()) <= TOL * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 32, 33, 200])
@pytest.mark.parametrize("spec", ["bf16_100", "bf8_50", "mxfp4_100", "int8_50", "int4_100",
                                  "nf4_50", "int4_5"])
def test_gemv_and_gemm_kernels_match_plain(card, spec, m):
    quant, dens = spec.rsplit("_", 1)
    g = torch.Generator(device=card).manual_seed(m)
    w = torch.randn(512, 320, generator=g, device=card) * 0.05
    ct = compress(w, CompressionSpec(quant, int(dens) / 100))
    x = torch.randn(m, 512, generator=g, device=card)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ops.decompress_gemm(x, ct, out_dtype=out_dtype)
        plain = ref.decompress_gemv if m <= ops.GEMV_MAX_M else ref.decompress_gemm
        want = plain(x, ct, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        if out_dtype == torch.float32:
            assert _close(got, want)
        else:  # one more rounding: one bf16 ulp
            assert torch.all((got.float() - want).abs() <= 2.0**-7 * want.abs() + 1e-6)


# (N, K) of the GeMV edge cases: N = 259 is no multiple of 16 (the ragged
# staging path), 320 a partial 128-column block, 1024 and 4096 many splits,
# 33792 = 264 blocks one split (the kernel stores out itself); K = 480 is an
# odd group count, and at N = 259 each of its 15 splits owns one group
_GEMV_SHAPES = [(259, 480), (259, 4096), (320, 480), (320, 4096), (1024, 480),
                (1024, 4096), (4096, 480), (4096, 4096), (33792, 480)]
_GEMV_M = (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32)  # every MB bucket and its edges


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", _GEMV_SHAPES)
@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_gemv_kernel_edges_match_plain(card, quant, density, n, k):
    """The GeMV at every M bucket edge, with x in f32 and bf16 and out in
    f32 and bf16, against the plain version: 1e-4 of max abs(plain) in f32,
    and one bf16 ulp more in bf16."""
    splits = autotune.gemv_splits(n, k // 32)
    assert (splits == 1) == (n == 33792)
    if (n, k) == (259, 480):
        assert splits == 15  # one group a split
    g = torch.Generator(device=card).manual_seed(n + k)
    ct = compress(torch.randn(k, n, generator=g, device=card) * 0.05,
                  CompressionSpec(quant, density))
    for m in _GEMV_M:
        x32 = torch.randn(m, k, generator=g, device=card)
        want = ref.decompress_gemv(x32, ct, out_dtype=torch.float32)
        scale = TOL * float(want.abs().max())
        for x in (x32, x32.bfloat16()):
            for out_dtype in (torch.float32, torch.bfloat16):
                got = deca_gemm.decompress_gemv(x, ct, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert got.dtype == out_dtype and got.shape == (m, n)
                ulp = 0.0 if out_dtype == torch.float32 else 2.0**-7
                err = (got.float() - want).abs() - ulp * want.abs()
                assert float(err.max()) <= scale, (m, x.dtype, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4096, 4096), (33792, 480)])
@pytest.mark.parametrize("m", [4, 16])
def test_gemv_kernel_is_deterministic(card, n, k, m):
    """Two launches give the same bits, with split-K (each split summed in
    a fixed order by the second pass) and with one split (no second pass);
    both halves of a column meet in one fixed order too."""
    assert (autotune.gemv_splits(n, k // 32) > 1) == (n == 4096)
    g = torch.Generator(device=card).manual_seed(n + m)
    ct = compress(torch.randn(k, n, generator=g, device=card) * 0.05,
                  CompressionSpec("bf8", 0.5))
    x = torch.randn(m, k, generator=g, device=card)
    for out_dtype in (torch.float32, torch.bfloat16):
        a, b = (deca_gemm.decompress_gemv(x, ct, out_dtype=out_dtype) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_kernels_count_their_launches_and_reject_bad_operands(card):
    ct = compress(torch.randn(64, 64, device=card), CompressionSpec("int8", 1.0))
    before = deca_gemm.decompress_gemv.launches
    ops.decompress_gemm(torch.randn(2, 64, device=card), ct)
    assert deca_gemm.decompress_gemv.launches == before + 1
    with pytest.raises(ValueError):
        deca_gemm.decompress_gemv(torch.randn(2, 64, device=card).half(), ct)
    with pytest.raises(ValueError):
        deca_gemm.decompress_gemv(torch.randn(40, 64, device=card), ct)


def _pools(kind, device, seed=0, b=3, hq=8, hkv=2, dh=64, bs=16, mb=8, lens=(100, 7, 128)):
    """Ragged slots over a shuffled, quantized pool (block size 16)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    pools = layers.init_paged_kv_cache(b * mb + 1, bs, hkv, dh, device=device, quant=kind)
    perm = torch.randperm(b * mb, generator=g, device=device).reshape(b, mb) + 1
    used = torch.arange(mb, device=device)[None] < (kv_lens[:, None] + bs - 1) // bs
    tables = torch.where(used, perm, torch.zeros_like(perm)).to(torch.int32)
    s = mb * bs
    pos = torch.arange(s, device=device)[None].expand(b, s)
    live = pos < kv_lens[:, None].long()
    slots = torch.where(live, tables.long().gather(1, pos // bs) * bs + pos % bs, pos % bs)
    wpos = torch.where(live, pos, torch.full_like(pos, CACHE_EMPTY_POS))
    k = torch.randn(b, s, hkv, dh, generator=g, device=device).bfloat16()
    v = torch.randn(b, s, hkv, dh, generator=g, device=device).bfloat16()
    layers.paged_update_cache(pools, k, v, wpos, slots, quant=kind)
    q = torch.randn(b, hq, dh, generator=g, device=device)
    return q, pools, tables, kv_lens, kv_lens - 1


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["plain", "window", "softcap"])
@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_attention_kernel_matches_plain(card, kind, variant):
    args = _pools(kind, card)
    kw = {"window": 40} if variant == "window" else {}
    if variant == "softcap":
        kw["softcap"] = 5.0
    got = paged_attention.paged_attention(*args, quant=kind, **kw)
    want = ref.paged_decode_attention(*args, quant=kind, **kw)
    torch.cuda.synchronize()
    assert got.dtype == args[0].dtype and _close(got, want)
    # bf16 queries come back in bf16: the combine's store is the f32 result
    # rounded once, bit for bit a cast of it
    qb = args[0].bfloat16()
    got_b = paged_attention.paged_attention(qb, *args[1:], quant=kind, **kw)
    got_f = paged_attention.paged_attention(qb.float(), *args[1:], quant=kind, **kw)
    assert got_b.dtype == torch.bfloat16
    assert torch.equal(_bits(got_b), _bits(got_f.bfloat16()))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [320, 4096])
@pytest.mark.parametrize("m", [33, 64, 129, 200, 2048])
@pytest.mark.parametrize("density", [1.0, 0.05])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_gemm_kernel_ragged_shapes_match_plain(card, quant, density, m, n):
    """The wgmma GeMM on ragged M (TMA zero fill past M), N = 320 (a partial
    128-column tile) with K = 480 (an odd group count), N = 4096 with
    K = 512; bf16 dense is the widest code stage (64 bytes a group)."""
    k = 480 if n == 320 else 512
    g = torch.Generator(device=card).manual_seed(m + n)
    w = torch.randn(k, n, generator=g, device=card) * 0.05
    ct = compress(w, CompressionSpec(quant, density))
    assert quant != "bf16" or density < 1 or ct.codes.shape[1] == 64
    x32 = torch.randn(m, k, generator=g, device=card)
    want = ref.decompress_gemm(x32, ct, out_dtype=torch.float32)
    for x in (x32, x32.bfloat16()):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = deca_gemm.decompress_gemm(x, ct, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype and got.shape == (m, n)
            if out_dtype == torch.float32:
                assert _close(got, want), (x.dtype, out_dtype)
            else:  # the f32 tolerance, then one more rounding: half a bf16 ulp
                bound = 2.0**-8 * want.abs() + TOL * want.abs().max()
                assert torch.all((got.float() - want).abs() <= bound), (x.dtype, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [28672, 36864])
@pytest.mark.parametrize("spec", ["bf8_50", "bf16_100"])
def test_gemv_at_the_paper_models_long_k_matches_plain(card, spec, k):
    """The down projections of llama2-70b (K = 28672) and opt-66b (K = 36864),
    at a cut N: f32 sums two and a half times longer than llama3-8b's, held
    to the same tolerance."""
    quant, dens = spec.rsplit("_", 1)
    g = torch.Generator(device=card).manual_seed(k)
    ct = compress(torch.randn(k, 1024, generator=g, device=card) / k**0.5,
                  CompressionSpec(quant, int(dens) / 100))
    for m in (1, 4, 16):
        x = torch.randn(m, k, generator=g, device=card)
        got = deca_gemm.decompress_gemv(x, ct, out_dtype=torch.float32)
        want = ref.decompress_gemv(x, ct, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert _close(got, want), m


# (B, Hq, Hkv, Dh) of the paper models' decode attention: llama2-70b's 8
# query heads a KV head, opt-66b's full MHA over 72 KV heads, llama3.2-1b's
# head dim 64 (a lane holds two dims), gemma2-2b's head dim 256 at G 2
_FAMILY_ATTENTION = {"llama2-70b": (4, 64, 8, 128), "opt-66b": (4, 72, 72, 128),
                     "llama3.2-1b": (4, 32, 8, 64), "gemma2-2b": (4, 8, 4, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "int8", "nf4"])
@pytest.mark.parametrize("arch", sorted(_FAMILY_ATTENTION))
def test_paged_attention_at_the_paper_models_shapes_matches_plain(card, arch, kind):
    b, hq, hkv, dh = _FAMILY_ATTENTION[arch]
    args = _pools(kind, card, seed=3, b=b, hq=hq, hkv=hkv, dh=dh, bs=32, mb=32,
                  lens=(1024, 700, 333, 17))
    for window in (0, 100):
        got = paged_attention.paged_attention(*args, quant=kind, window=window)
        want = ref.paged_decode_attention(*args, quant=kind, window=window)
        torch.cuda.synchronize()
        assert got.shape == (b, hq, dh) and _close(got, want), window


# (Hq, Hkv, Dh) past the kernel's first limits: gemma2-2b's Dh 256 at G 2,
# recurrentgemma-9b's Dh 256 at G 16, grok-1's G 6 and qwen2-vl-7b's G 7
# (at both head-dim tiers); G 6 and 7 leave 2 and 4 lanes of a score
# butterfly idle, so a wrong split shows as wrong rows of one slot
_NEW_ATTENTION = {"dh256_g2": (8, 4, 256), "dh256_g16": (16, 1, 256),
                  "dh128_g6": (12, 2, 128), "dh128_g7": (14, 2, 128),
                  "dh256_g6": (6, 1, 256), "dh256_g7": (7, 1, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KV_KINDS)
@pytest.mark.parametrize("case", sorted(_NEW_ATTENTION))
def test_paged_attention_at_head_dim_256_and_any_group_matches_plain(card, case, kind):
    """Every (slot, head) row of the kernel's output against the plain
    version's, with and without a window and gemma2's softcap of 50."""
    hq, hkv, dh = _NEW_ATTENTION[case]
    args = _pools(kind, card, seed=11, b=4, hq=hq, hkv=hkv, dh=dh, bs=16, mb=24,
                  lens=(380, 257, 100, 3))
    for window, softcap in ((0, 0.0), (100, 0.0), (0, 50.0), (100, 50.0)):
        got = paged_attention.paged_attention(*args, quant=kind, window=window,
                                              softcap=softcap)
        want = ref.paged_decode_attention(*args, quant=kind, window=window,
                                          softcap=softcap)
        torch.cuda.synchronize()
        assert got.shape == (4, hq, dh)
        err = (got.float() - want.float()).abs().amax(dim=-1)
        bad = (err > TOL * float(want.float().abs().max())).nonzero().tolist()
        assert not bad, (window, softcap, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_attention_bidirectional_at_hubert_heads_matches_plain(card, kind):
    """hubert-xlarge's decode attention: 16 heads at Dh 80 (G 1), causal=0,
    with and without a window. Each slot's query sits at a third of its
    length, so the keys after it count (a causal walk would drop them);
    empty slots stay masked (the sentinel). Every (slot, head) row against
    the plain version's."""
    q, pools, tables, kv_lens, _ = _pools(kind, card, seed=13, b=4, hq=16, hkv=16, dh=80,
                                          bs=16, mb=24, lens=(380, 257, 100, 3))
    args = (q, pools, tables, kv_lens, kv_lens // 3)
    for window in (0, 100):
        got = paged_attention.paged_attention(*args, quant=kind, causal=False, window=window)
        want = ref.paged_decode_attention(*args, quant=kind, causal=False, window=window)
        causal = ref.paged_decode_attention(*args, quant=kind, causal=True, window=window)
        torch.cuda.synchronize()
        assert got.shape == (4, 16, 80)
        err = (got.float() - want.float()).abs().amax(dim=-1)
        bad = (err > TOL * float(want.float().abs().max())).nonzero().tolist()
        assert not bad, (window, bad)
        assert not _close(causal, want), window  # the flag changes the answer


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5120, 504])
def test_gemm_at_hubert_long_pass_rows_matches_plain(card, n):
    """hubert-xlarge's 32768-token encoder pass: M = 32768 rows (128 row
    tiles), K = 1280, N = 5120 (the TMA path; 167.8 M outputs) and N = 504
    (lm_head, the direct path), bf8_50, f32 and bf16 outputs."""
    k, m = 1280, 32768
    g = torch.Generator(device=card).manual_seed(n)
    ct = compress(torch.randn(k, n, generator=g, device=card) * 0.05, get_spec("bf8_50"))
    x = torch.randn(m, k, generator=g, device=card).bfloat16()
    launches = deca_gemm.decompress_gemm.launches
    want = ref.decompress_gemm(x, ct, out_dtype=torch.float32)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = deca_gemm.decompress_gemm(x, ct, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        if out_dtype == torch.float32:
            assert _close(got, want)
        else:
            bound = 2.0**-8 * want.abs() + TOL * want.abs().max()
            assert torch.all((got.float() - want).abs() <= bound)
        del got
    assert deca_gemm.decompress_gemm.launches == launches + 2


@pytest.mark.gpu
@pytest.mark.parametrize("n", [504, 259])
@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_gemm_and_gemv_at_an_n_that_is_no_multiple_of_16_match_plain(card, quant, density, n):
    """hubert-xlarge's lm_head width N = 504 (code rows of 504 bytes: no TMA
    box) and an odd N = 259 (the epilogue stores one by one), at K = 1280:
    the GeMM's direct path on ragged M and the GeMV, every weight codec."""
    k = 1280
    g = torch.Generator(device=card).manual_seed(n + int(density * 100))
    ct = compress(torch.randn(k, n, generator=g, device=card) * 0.05,
                  CompressionSpec(quant, density))
    for m in (4, 33, 300):
        x = torch.randn(m, k, generator=g, device=card)
        kernel = deca_gemm.decompress_gemv if m <= ops.GEMV_MAX_M else deca_gemm.decompress_gemm
        plain = ref.decompress_gemv if m <= ops.GEMV_MAX_M else ref.decompress_gemm
        want = plain(x, ct, out_dtype=torch.float32)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = kernel(x, ct, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype and got.shape == (m, n)
            if out_dtype == torch.float32:
                assert _close(got, want), m
            else:
                bound = 2.0**-8 * want.abs() + TOL * want.abs().max()
                assert torch.all((got.float() - want).abs() <= bound), m


@pytest.mark.gpu
def test_tied_head_f32_logits_match_the_plain_f32_product(card):
    """llama3.2-1b's tied head at full width: one bf16 GEMM with f32 output
    against the plain product of f32 copies, both summing exact products
    in f32: within 2 K 2^-24 sum|x e| of each other, f32, no bf16 rounding
    of the logits."""
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(4, 1, 2048, generator=g, device=card).bfloat16()
    embed = (torch.randn(128256, 2048, generator=g, device=card) * 0.02).bfloat16()
    got = layers.tied_logits(x, embed)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = x.float() @ embed.float().t()
        mag = x.float().abs() @ embed.float().abs().t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (4, 1, 128256)
    assert torch.all((got - want).abs() <= 2 * 2048 * 2.0**-24 * mag)
    assert not torch.equal(got, got.bfloat16().float())


# (pool shape, kv_lens, window): more pages than one split, a window that
# leaves the leading splits empty, a padding slot with kv_len 0, B Hkv = 1
_SPLIT_CASES = {
    "multi_page_splits": (dict(b=4, hq=32, hkv=8, dh=128, mb=64, lens=(1024, 700, 333, 17)), 0),
    "window_skips_splits": (dict(b=4, hq=32, hkv=8, dh=128, mb=64, lens=(1024, 700, 333, 17)),
                            100),
    "empty_slot": (dict(b=3, hq=8, hkv=2, dh=64, mb=8, lens=(100, 0, 128)), 0),
    "one_head_one_slot": (dict(b=1, hq=4, hkv=1, dh=128, mb=16, lens=(250,)), 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "int8", "int4"])
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_kv_attention_edges_match_plain(card, case, kind):
    shape, window = _SPLIT_CASES[case]
    q, pools, tables, kv_lens, q_pos = _pools(kind, card, seed=7, **shape)
    splits, pps = autotune.attention_splits(shape["mb"], shape["b"], shape["hkv"])
    assert splits > 1
    if case.startswith("multi") or case.startswith("window"):
        assert pps > 1  # several pages in a split
    if case.startswith("window"):
        assert (1023 - window + 1) // 16 >= pps  # split 0 of slot 0 sees no page
    args = (q, pools, tables, kv_lens, q_pos)
    got = paged_attention.paged_attention(*args, quant=kind, window=window)
    want = ref.paged_decode_attention(*args, quant=kind, window=window)
    torch.cuda.synchronize()
    assert _close(got, want)
    for slot in range(shape["b"]):
        if shape["lens"][slot] == 0:
            assert torch.all(got[slot] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_gemm_kernel_operand_is_the_plain_bf16_weight(card, quant, density):
    """x = the identity picks each weight row out of the product in one
    exact f32 term, so the GeMM's output is its decoded bf16 operand, which
    must equal the plain version's bf16 weight value for value (the sparse
    groups' set-bit walk against the plain prefix-sum gather)."""
    g = torch.Generator(device=card).manual_seed(len(quant) + int(10 * density))
    w = torch.randn(480, 320, generator=g, device=card) * 0.05
    ct = compress(w, CompressionSpec(quant, density))
    got = deca_gemm.decompress_gemm(torch.eye(480, device=card), ct)
    want = ref.decompress(ct, torch.bfloat16).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_gemm_and_attention_kernels_are_deterministic(card):
    """Two launches on the same inputs give the same bits: the GeMM sums
    each output in one fixed order, and the split-KV combine merges the
    splits in split order without atomics."""
    g = torch.Generator(device=card).manual_seed(11)
    ct = compress(torch.randn(512, 4096, generator=g, device=card) * 0.05,
                  CompressionSpec("bf8", 0.5))
    x = torch.randn(200, 512, generator=g, device=card)
    a, b = (deca_gemm.decompress_gemm(x, ct) for _ in range(2))
    assert torch.equal(_bits(a), _bits(b))
    shape, _ = _SPLIT_CASES["multi_page_splits"]
    args = _pools("int8", card, seed=3, **shape)
    a, b = (paged_attention.paged_attention(*args, quant="int8") for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_compress_on_the_card_matches_the_cpu_bitwise(card):
    w = torch.randn(256, 192, generator=torch.Generator().manual_seed(5)) * 0.05
    w[7, :] = 0.0
    for name in ("bf16", "bf8", "mxfp4", "int8", "int4", "nf4"):
        for dens in (1.0, 0.5, 0.05):
            spec = CompressionSpec(name, dens)
            a, b = compress(w.to(card), spec), compress(w, spec)
            for plane in ("codes", "mask", "scales"):
                x, y = getattr(a, plane), getattr(b, plane)
                assert (x is None) == (y is None)
                if x is not None:
                    assert np.array_equal(x.cpu().numpy(), y.numpy()), (spec.name, plane)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_decompress_kernel_matches_plain_bitwise(card, quant, density):
    """Every codec, density and output type, compared as integer views so
    that -0.0 and +0.0 count; N = 200 leaves a partial CTA."""
    g = torch.Generator(device=card).manual_seed(len(quant))
    w = torch.randn(256, 200, generator=g, device=card) * 0.05
    w[3, :] = 0.0
    w[4, :] = -0.0
    ct = compress(w, CompressionSpec(quant, density))
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ops.decompress(ct, out_dtype=out_dtype)
        want = ref.decompress(ct, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want)), (quant, density, out_dtype)


@pytest.mark.gpu
def test_decompress_kernel_counts_launches_and_rejects_bad_operands(card):
    ct = compress(torch.randn(64, 64, device=card), CompressionSpec("int4", 0.5))
    before = deca_decompress.decompress.launches
    ops.decompress(ct, out_dtype=torch.float32)
    assert deca_decompress.decompress.launches == before + 1
    bad = [
        dataclasses.replace(ct, mask=ct.mask.cpu()),  # a plane on another device
        dataclasses.replace(ct, codes=torch.empty(ct.codes.numel() + 1, dtype=torch.uint8,
                                                  device=card)[1:].view(ct.codes.shape)),
        dataclasses.replace(ct, scales=ct.scales.t().contiguous().t()),  # not contiguous
        compress(torch.randn(64, 64, device=card), CompressionSpec("int4", 0.5, group=64)),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            deca_decompress.decompress(b, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        deca_decompress.decompress(ct, out_dtype=torch.float16)
    assert deca_decompress.decompress.launches == before + 1


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, CompressedTensor):
        return dataclasses.replace(tree, **{
            n: None if getattr(tree, n) is None else getattr(tree, n).to(device)
            for n in ("codes", "mask", "scales")})
    return tree.to(device)


def _smoke(device, spec="bf8_50", arch="llama3-8b"):
    model = Model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), device="cpu", spec=get_spec(spec))
    return model, _to(params, device)


@pytest.mark.gpu
def test_make_draft_tree_on_the_card_equals_the_cpu(card):
    """The draft tree built through the decompression kernel is the CPU's,
    every plane of every leaf, with one launch per compressed leaf."""
    model, params = _smoke("cpu")
    on_cpu = make_draft_tree(params, get_spec("nf4"), layer_stack=model.layer_stack)
    before = deca_decompress.decompress.launches
    on_card = make_draft_tree(_to(params, card), get_spec("nf4"),
                              layer_stack=model.layer_stack)
    leaves = 1 + 7 * len(params["layers"])
    assert deca_decompress.decompress.launches == before + leaves
    pairs = [(on_card["lm_head"], on_cpu["lm_head"])] + [
        (a[grp][n], b[grp][n]) for a, b in zip(on_card["layers"], on_cpu["layers"])
        for grp in ("attn", "mlp") for n in a[grp]]
    for a, b in pairs:
        assert isinstance(a, CompressedTensor) and a.spec == b.spec
        for plane in ("codes", "mask", "scales"):
            x, y = getattr(a, plane), getattr(b, plane)
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
def test_spec_engine_on_the_card_emits_tokens_within_logit_tolerance(card):
    """Each emitted token's teacher-forced target logit lies within 5e-2 of
    the position's scale of its largest logit."""
    model, params = _smoke(card)
    eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                           decode_chunk=8, kv_quant="int8", device=card,
                           spec_decode=SpecConfig(k=3, draft_codec="nf4"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (4, 19, 11)]
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    done = eng.run_until_drained()
    assert eng.scheduler.stats()["verify_calls"] > 0
    for p, r in zip(prompts, rids):
        out = done[r]
        assert len(out) == 12
        seq = torch.as_tensor(np.concatenate([p, out[:-1]]), device=card)
        rows = eng.model.score(params, seq, block_size=8)[len(p) - 1:]
        picked = rows.gather(1, torch.as_tensor(out, device=card).long()[:, None])[:, 0]
        gap = (rows.max(dim=1).values - picked).max()
        assert float(gap) <= 5e-2 * float(rows.abs().max())


# ---------------------------------------------------------------------------
# the GeMV with non-finite x (the set-bit walk's positional fallback)
# ---------------------------------------------------------------------------

def _same_nonfinite(got, want):
    """NaN, +inf and -inf where the plain version has them; finite values
    to the kernel tolerance."""
    got, want = got.float(), want.float()
    for probe in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(probe(got), probe(want)):
            return False
    fin = torch.isfinite(want)
    return not fin.any() or _close(got[fin], want[fin])


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.5, 0.05])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_gemv_nonfinite_x_at_a_masked_out_position_matches_plain(card, quant, density):
    """An inf and a NaN in x where a sparse column's bit is clear: the
    plain version's x * +0 gives NaN there, and the kernel's set-bit walk
    (M <= 8), which skips clear positions, must give it too."""
    k, n = 512, 320
    g = torch.Generator(device=card).manual_seed(17)
    ct = compress(torch.randn(k, n, generator=g, device=card) * 0.05,
                  CompressionSpec(quant, density))
    dense = ref.decompress(ct, torch.float32)
    # a position with clear bits in some columns and set bits in others
    zeros = (dense == 0).sum(dim=1)
    pos = int(torch.nonzero((zeros > 0) & (zeros < n))[0])
    for m in (1, 2, 4, 8, 16):
        x = torch.randn(m, k, generator=g, device=card)
        x[0, pos] = float("inf")
        if m > 1:
            x[1, (pos + 40) % k] = float("nan")
        if m > 2:
            x[2, pos] = -float("inf")
        want = ref.decompress_gemv(x, ct, out_dtype=torch.float32)
        assert torch.isnan(want[0]).any() and torch.isinf(want[0]).any()
        for xx in (x, x.bfloat16()):
            got = deca_gemm.decompress_gemv(xx, ct, out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert _same_nonfinite(got, want), (m, xx.dtype)


# ---------------------------------------------------------------------------
# captured decode: graphs against the uncaptured steps, and the sampler
# ---------------------------------------------------------------------------

def _served_engine(card, kind, spec=None, arch="llama3-8b", **kw):
    """A smoke-config engine on the card that has served requests whose
    chunks took every length C in 8, 4, 2, 1 (each length its own graph)."""
    model, params = _smoke(card, arch=arch)
    eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                           decode_chunk=8, kv_quant=kind, device=card, spec_decode=spec, **kw)
    rng = np.random.default_rng(5)
    for new in (9, 5, 3, 2):  # one request each: remaining 8, 4, 2, 1 after prefill
        eng.submit(rng.integers(0, 256, 11).astype(np.int32), max_new_tokens=new)
        eng.run_until_drained()
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_decode_graph_replay_is_bitwise_the_uncaptured_chunk(card, kind):
    """For C in 1, 2, 4, 8: the replayed chunk's tokens and every pool
    plane (the null page excluded) are the uncaptured chunk's, bitwise."""
    from repro_torch.serve.graphs import replay_check

    eng = _served_engine(card, kind)
    graphs = eng._chunk_graphs.graphs
    assert sorted(key[2][0] for key in graphs) == [1, 2, 4, 8]  # positions (C, M, 1)
    for key in graphs:
        assert replay_check(eng._chunk_graphs, key, eng.kv.pools) == [], key


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["opt-66b", "llama3.2-1b", "granite-3-8b"])
def test_decode_graphs_of_the_new_families_replay_bitwise(card, arch):
    """Learned positions and the relu MLP (opt-66b), a tied head (llama3.2-1b;
    granite-3-8b with a vocab of 259) inside the captured chunk: every
    replay is the uncaptured chunk bitwise, with 6 GeMVs a layer for relu
    and 7 for swiglu, plus one for an untied head, each step."""
    from repro_torch.serve.graphs import replay_check

    eng = _served_engine(card, "int8", arch=arch)
    cfg = eng.cfg
    graphs = eng._chunk_graphs.graphs
    assert sorted(key[2][0] for key in graphs) == [1, 2, 4, 8]
    per_step = (6 if cfg.mlp_act == "relu" else 7) * cfg.n_layers + (not cfg.tie_embeddings)
    for key, g in graphs.items():
        assert g.launches[0] == key[2][0] * per_step
        assert replay_check(eng._chunk_graphs, key, eng.kv.pools) == [], key


@pytest.mark.gpu
def test_mrope_decode_graphs_replay_bitwise(card):
    """qwen2-vl-7b smoke: each decode step broadcasts its positions to
    M-RoPE's three streams (a view) and rotates q and k in f32 inside the
    captured chunk; every replay is the uncaptured chunk bitwise, with 7
    GeMVs a layer plus the head each step."""
    from repro_torch.serve.graphs import replay_check

    eng = _served_engine(card, "int8", arch="qwen2-vl-7b")
    graphs = eng._chunk_graphs.graphs
    assert sorted(key[2][0] for key in graphs) == [1, 2, 4, 8]
    for key, g in graphs.items():
        assert g.launches[0] == key[2][0] * (7 * eng.cfg.n_layers + 1)
        assert replay_check(eng._chunk_graphs, key, eng.kv.pools) == [], key


@pytest.mark.gpu
@pytest.mark.parametrize("kind,temperature", [("int8", 0.0), ("nf4", 0.7)])
def test_spec_graph_replay_is_bitwise_the_uncaptured_round(card, kind, temperature):
    """A replayed spec launch, greedy and sampled, is the uncaptured one:
    the verify's gather decodes the pool inside the capture (nf4 through
    its table, which lives on the card)."""
    from repro_torch.serve.graphs import replay_check

    eng = _served_engine(card, kind, spec=SpecConfig(k=3, draft_codec="nf4"),
                         temperature=temperature)
    assert eng._spec_graphs.graphs and not eng._chunk_graphs.graphs
    for key in eng._spec_graphs.graphs:
        assert replay_check(eng._spec_graphs, key, eng.kv.pools) == [], key


@pytest.mark.gpu
def test_replays_count_the_launches_of_uncaptured_chunks(card):
    """N replays add to each wrapper's counter what N uncaptured runs of
    the same chunk do: 15 GeMV (7 FC matmuls in each of 2 layers, and
    lm_head) and 2 attention launches a step."""
    from repro_torch.serve.graphs import launch_counters

    eng = _served_engine(card, "int8")
    steps = eng._chunk_graphs
    key = max(steps.graphs, key=lambda k: k[2][0])  # C = 8
    g = steps.graphs[key]
    counts = lambda: [fn.launches for fn in launch_counters()]
    before = counts()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    replayed = [a - b for a, b in zip(counts(), before)]
    before = counts()
    for _ in range(3):
        steps.fn(*g.inputs)
    torch.cuda.synchronize()
    eager = [a - b for a, b in zip(counts(), before)]
    assert replayed == eager == [3 * 8 * 15, 0, 3 * 8 * 2, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_single_step_graph_replays_bitwise_with_a_chunk_steps_launches(card, kind):
    """decode_chunk=1 is the single-step loop: one graph, of the (M, 1)
    step; its replay is the uncaptured step bitwise (logits and every pool
    plane, the null page excluded); a replay launches what a chunk's step
    does, 15 GeMVs and 2 attention calls; and its greedy tokens are the
    chunked engine's, one host sync a step beside the prefill calls."""
    from repro_torch.serve.graphs import launch_counters, replay_check

    model, params = _smoke(card)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (4, 19, 11)]
    outs, engines = {}, {}
    for chunk in (1, 8):
        eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                               kv_quant=kind, decode_chunk=chunk, device=card)
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        done = eng.run_until_drained()
        outs[chunk], engines[chunk] = [done[r].tolist() for r in rids], eng
    assert outs[1] == outs[8]
    single = engines[1]
    assert not single._chunk_graphs.graphs and len(single._decode_graphs.graphs) == 1
    key, g = next(iter(single._decode_graphs.graphs.items()))
    assert key[0] == (2, 1)
    counts = lambda: [fn.launches for fn in launch_counters()]
    before = counts()
    g.replay()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == list(g.launches) == [15, 0, 2, 0]
    assert replay_check(single._decode_graphs, key, single.kv.pools) == []
    st = single.scheduler.stats()
    assert st["decode_chunks"] == st["decode_steps"]
    assert st["host_syncs"] == st["prefill_calls"] + st["decode_steps"]


@pytest.mark.gpu
def test_engine_on_the_card_samples_with_temperature(card):
    """At T = 0.7 the card's engine serves: chunked decode equals single
    steps token for token (the same kernels at the same shapes), and the
    tokens are not the greedy ones."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (4, 19, 11)]
    outs = {}
    for name, kw in (("chunked", dict(decode_chunk=8, temperature=0.7)),
                     ("single", dict(decode_chunk=1, temperature=0.7)),
                     ("greedy", dict(decode_chunk=8))):
        model, params = _smoke(card)
        eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                               kv_quant="int8", device=card, seed=3, **kw)
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        done = eng.run_until_drained()
        outs[name] = [done[r].tolist() for r in rids]
    assert outs["chunked"] == outs["single"]
    assert outs["chunked"] != outs["greedy"]


@pytest.mark.gpu
def test_sampler_on_the_card_is_the_cpu_sampler(card):
    """Random bits and uniforms bitwise the CPU's; gumbel within 2 ulp at
    the scale max(|g|, 1) (each device's log its own); tokens the CPU's on
    the same logits but at a near tie of the CPU's perturbed scores."""
    from repro_torch.serve import sampling

    rng = np.random.default_rng(9)
    n, v, temp = 16, 128256, 0.7
    logits = torch.from_numpy((rng.standard_normal((n, v)) * 3).astype(np.float32))
    rids = torch.from_numpy(rng.integers(0, 1000, n))
    steps = torch.from_numpy(rng.integers(0, 5000, n))
    keys = sampling.fold_in(sampling.fold_in(sampling.prng_key(4, "cpu").expand(n, 2), rids), steps)
    assert torch.equal(sampling.random_bits(keys.to(card), v).cpu(),
                       sampling.random_bits(keys, v))
    assert torch.equal(sampling.uniform(keys.to(card), v).cpu(), sampling.uniform(keys, v))
    g_cpu, g_card = sampling.gumbel(keys, v), sampling.gumbel(keys.to(card), v).cpu()
    scale = torch.clamp_min(g_cpu.abs(), 1.0)
    ulp = torch.nextafter(scale, torch.tensor(float("inf"))) - scale
    assert bool(((g_card - g_cpu).abs() <= 2 * ulp).all())
    t = torch.tensor(temp)
    want = sampling.sample_rows_keyed(sampling.prng_key(4, "cpu"), rids, steps, logits, t)
    got = sampling.sample_rows_keyed(sampling.prng_key(4, card), rids.to(card),
                                     steps.to(card), logits.to(card), t.to(card)).cpu()
    s = g_cpu + logits / t
    tol = 2 * ulp + (torch.nextafter(s.abs(), torch.tensor(float("inf"))) - s.abs())
    for i in torch.nonzero(got != want)[:, 0].tolist():
        a, b = int(want[i]), int(got[i])
        assert float(s[i, a] - s[i, b]) <= float(tol[i, a] + tol[i, b]), i


@pytest.mark.gpu
def test_pools_that_move_after_a_capture_are_refused(card):
    eng = _served_engine(card, "int8")
    eng.kv.pools[0]["ppos"] = eng.kv.pools[0]["ppos"].clone()
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(RuntimeError, match="reallocated"):
        eng.run_until_drained()


@pytest.mark.gpu
def test_garbage_is_collected_before_a_capture_not_inside_it(card):
    """Destroying a CUDA graph (a dead engine's, freed by the cyclic
    garbage collector) inside another capture invalidates that capture. A
    capture first collects what is garbage, and records with the collector
    off: the step's uncaptured run sees it on, its capture off."""
    import gc
    import weakref

    from repro_torch.serve.graphs import StepGraphs

    class Cycle:
        pass

    junk = Cycle()
    junk.me = junk
    dead = weakref.ref(junk)
    del junk
    seen = []
    steps = StepGraphs(lambda x: (seen.append(gc.isenabled()), x + 1)[1], device=card,
                       pools=lambda: [])
    out = steps([np.arange(4, dtype=np.int32)])
    assert dead() is None and gc.isenabled()
    assert seen == [True, False]
    assert out.tolist() == [1, 2, 3, 4]


@pytest.mark.gpu
def test_a_failed_capture_raises(card):
    """A step that waits on the host cannot be captured: the capture
    raises, and no graph is kept to fall back on."""
    from repro_torch.serve.graphs import StepGraphs

    steps = StepGraphs(lambda x: x + int(x.sum().item()), device=card, pools=lambda: [])
    with pytest.raises(RuntimeError):
        steps([np.arange(4, dtype=np.int32)])
    assert steps.graphs == {}
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the prefix cache, copy-on-write clones and chunked prefill on the card
# ---------------------------------------------------------------------------

def _within_logit_tolerance(model, params, prompts, outs, card):
    """Every emitted token's teacher-forced logit within 5e-2 of the
    position's scale of its largest (PERF.md section 2)."""
    for p, out in zip(prompts, outs):
        seq = torch.as_tensor(np.concatenate([p, out[:-1]]), device=card)
        rows = model.score(params, seq, block_size=8)[len(p) - 1:]
        picked = rows.gather(1, torch.as_tensor(out, device=card).long()[:, None])[:, 0]
        if float((rows.max(dim=1).values - picked).max()) > 5e-2 * float(rows.abs().max()):
            return False
    return True


def _shared_prompts(vocab, seed=3):
    """Two system prompts (19 tokens, and 16 = two whole pages) with mixed
    tails; the page-aligned one comes back verbatim last (a clone)."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(1, vocab, 19).tolist(), rng.integers(1, vocab, 16).tolist()
    t = [rng.integers(1, vocab, k).tolist() for k in (3, 9, 1, 5, 13)]
    return [np.asarray(p, np.int32) for p in
            (a + t[0], a + t[1], b, b + t[2], a + t[3], b + t[4], a, b)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_cow_never_mutates_shared_pages_on_the_card(card, kind):
    """A verbatim re-submission of a page-aligned donor recomputes its last
    token (a one-token prefill: the GeMV) into a clone made on the card;
    every plane of the donor's cached pages is bitwise what it was."""
    model, params = _smoke(card)
    rng = np.random.default_rng(5)
    donor = rng.integers(1, 256, 16).astype(np.int32)
    eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=1,
                           num_blocks=24, decode_chunk=2, kv_quant=kind, device=card,
                           prefix_cache=True)
    eng.submit(donor, max_new_tokens=3)
    eng.run_until_drained()
    dev = torch.as_tensor([p + 1 for p in eng.kv.prefix.lookup(donor)], device=card)
    assert len(dev) == 2
    before = [{n: t[dev].clone() for n, t in layer.items()} for layer in eng.kv.pools]
    gemv = deca_gemm.decompress_gemv.launches
    rid = eng.submit(donor.copy(), max_new_tokens=3)
    out = eng.run_until_drained()[rid]
    st = eng.scheduler.stats()
    assert st["prefix_hit_tokens"] == 15 and st["cow_copies"] == 1
    assert deca_gemm.decompress_gemv.launches > gemv
    for layer, old in zip(eng.kv.pools, before):
        for name, t in layer.items():
            assert torch.equal(t[dev], old[name]), name
    assert _within_logit_tolerance(eng.model, params, [donor], [out], card)


@pytest.mark.gpu
def test_chunked_prefill_interleaves_with_replayed_decode_graphs(card):
    """A long prompt that arrives while two requests decode prefills in
    chunks between their replayed decode chunks: no decode graph is
    captured while it does (mid-prefill slots ride as inactive slots), and
    every token, chunked or not, is within the logit tolerance."""
    model, params = _smoke(card)
    rng = np.random.default_rng(6)
    residents = [rng.integers(0, 256, 11).astype(np.int32) for _ in range(2)]
    long = rng.integers(0, 256, 40).astype(np.int32)
    outs = {}
    for chunk in (None, 8):
        eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=3,
                               decode_chunk=4, kv_quant="int8", device=card,
                               prefill_chunk=chunk)
        sched, calls = eng.scheduler, []
        prefill, decode = sched._prefill, sched._decode_chunk
        sched._prefill = lambda *a: (calls.append("P"), prefill(*a))[1]
        sched._decode_chunk = lambda *a: (calls.append("D"), decode(*a))[1]
        rids = [eng.submit(p, max_new_tokens=24) for p in residents]
        while sched.stats()["decode_chunks"] < 2:
            sched.step()
        graphs = len(eng._chunk_graphs.graphs)
        rids.append(eng.submit(long, max_new_tokens=4))
        req = sched.queue[-1]
        start = len(calls)
        while not req.out:
            sched.step()
        if chunk is not None:
            assert len(eng._chunk_graphs.graphs) == graphs == 1
            assert calls[start:].count("P") == 5 and "P" in calls[start:][-2:]
            assert calls[start:].index("D") < len(calls[start:]) - 2  # interleaved
        done = eng.run_until_drained()
        outs[chunk] = [done[r] for r in rids]
        assert len(eng._chunk_graphs.graphs) <= 4
    st = sched.stats()
    assert st["prefill_chunk_calls"] == 7  # 2 residents, then 5 chunks of the long one
    for out in outs.values():
        assert _within_logit_tolerance(model, params, residents + [long], out, card)


@pytest.mark.gpu
def test_prefix_cache_on_the_card_keeps_tokens_within_logit_tolerance(card):
    """Shared and cold prefills run the matmuls at other M (GeMV or GeMM)
    and so sum in other orders: tokens with the cache on and off are held
    against teacher-forced logits, and the shared pages are used."""
    model, params = _smoke(card)
    prompts = _shared_prompts(256)
    for kw in ({}, {"prefix_cache": True}, {"prefix_cache": True, "prefill_chunk": 5}):
        eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                               num_blocks=24, decode_chunk=4, kv_quant="int8", device=card,
                               **kw)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        done = eng.run_until_drained()
        outs = [done[r] for r in rids]
        assert all(len(o) == 4 for o in outs)
        assert _within_logit_tolerance(eng.model, params, prompts, outs, card)
        st, occ = eng.scheduler.stats(), eng.kv.occupancy()
        if kw:
            assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] >= 1
            assert occ["used"] == occ["cached"] > 0
        else:
            assert occ["used"] == 0


# ---------------------------------------------------------------------------
# overload resilience and the host tier on the card
# ---------------------------------------------------------------------------

def _host_copy_counter():
    """A dispatch mode counting the aten ops that bring a CUDA tensor's
    data to the host: copies to the CPU and scalar reads."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Copies(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            if name == "_local_scalar_dense" and ins[0].is_cuda:
                self.n += 1
            elif name == "_to_copy" and ins[0].is_cuda and not out.is_cuda:
                self.n += 1
            elif name == "copy_" and not ins[0].is_cuda and ins[1].is_cuda:
                self.n += 1
            return out

    return Copies()


@pytest.mark.gpu
def test_guarded_prefill_makes_one_host_copy_like_an_unguarded_one(card):
    """With the SLA policy armed, each prefill's finite flags ride the
    sampled tokens' copy: one device-to-host copy a prefill call, as
    without the guard, the same host_syncs and the same tokens."""
    from repro_torch.serve.slo import SLAPolicy

    model, params = _smoke(card)
    prompts = _shared_prompts(256)[:4]
    seen = {}
    for name, kw in (("plain", {}), ("guarded", {"sla": SLAPolicy(max_queue=8)})):
        eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                               decode_chunk=4, kv_quant="int8", device=card, **kw)
        sched, copies = eng.scheduler, []
        inner = sched._prefill_rows

        def counted(*a, _inner=inner, _copies=copies, **k):
            with _host_copy_counter() as mode:
                _inner(*a, **k)
            _copies.append(mode.n)

        sched._prefill_rows = counted
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        done = eng.run_until_drained()
        seen[name] = ([done[r].tolist() for r in rids], copies,
                      sched.stats()["host_syncs"])
    assert sched._guard_nonfinite
    assert seen["guarded"] == seen["plain"]
    assert seen["plain"][1] and set(seen["plain"][1]) == {1}


@pytest.mark.gpu
def test_poison_prefill_fails_exactly_its_row_on_the_card(card):
    """The chaos fault NaNs one completing row's logits on the card: that
    request ends FAILED with no token and no index entry; its batch-mates
    finish within logit tolerance."""
    from repro_torch.dist.fault import FaultInjector
    from repro_torch.serve.slo import RequestStatus

    model, params = _smoke(card)
    prompts = [np.arange(200, 217, dtype=np.int32)] + _shared_prompts(256)[:3]
    inj = FaultInjector({0: "poison_prefill"})
    eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                           decode_chunk=4, kv_quant="int8", device=card, prefix_cache=True,
                           injector=inj)
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    done = eng.run_until_drained()
    assert [eng.statuses[r] for r in rids] == [RequestStatus.FAILED] + [RequestStatus.OK] * 3
    assert len(done[rids[0]]) == 0 and inj.fired == {(0, "poison_prefill")}
    assert eng.kv.prefix.lookup(prompts[0]) == []
    assert _within_logit_tolerance(model, params, prompts[1:], [done[r] for r in rids[1:]],
                                   card)
    eng.scheduler.check_invariants()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "int8", "nf4"])
def test_page_planes_round_trip_bitwise_on_the_card(card, kind):
    """`extract_page_planes` gathers a page on the card in one copy (the
    CPU's result bitwise), and `apply_page_planes` writes it back into
    other pages bitwise, in place."""
    from repro_torch.serve.host_tier import apply_page_planes, extract_page_planes

    model, params = _smoke(card)
    eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                           num_blocks=8, decode_chunk=4, kv_quant=kind, device=card)
    eng.submit(np.arange(1, 18, dtype=np.int32), max_new_tokens=3)
    eng.run_until_drained()
    pools = eng.kv.pools
    planes = extract_page_planes(pools, 1)
    on_cpu = extract_page_planes([{n: t.cpu() for n, t in layer.items()} for layer in pools], 1)
    assert all(torch.equal(planes[n], on_cpu[n]) for n in planes)
    ptrs = [t.data_ptr() for layer in pools for t in layer.values()]
    apply_page_planes(pools, np.asarray([4, 7]), [planes, planes])
    torch.cuda.synchronize()
    assert ptrs == [t.data_ptr() for layer in pools for t in layer.values()]
    for layer in pools:
        for t in layer.values():
            assert torch.equal(t[4], t[1]) and torch.equal(t[7], t[1])


@pytest.mark.gpu
def test_tier_restore_keeps_pool_addresses_and_graphs_replay_bitwise(card):
    """Spill every cached page and serve the same prompt again: the restore
    writes into the pools in place (their addresses do not move, so the
    captured decode graphs replay without a new capture), the tokens are
    those of a resident prefix hit, and every graph replays bitwise
    against the uncaptured chunk."""
    from repro_torch.serve.graphs import replay_check

    model, params = _smoke(card)
    prompt = np.arange(1, 26, dtype=np.int32)
    outs = {}
    for tier in (False, True):
        eng = GenerationEngine(model, params, max_len=64, block_size=8, max_slots=2,
                               num_blocks=16, decode_chunk=4, kv_quant="int8", device=card,
                               prefix_cache=True, host_tier=tier)
        first = eng.submit(prompt, max_new_tokens=6)
        done = eng.run_until_drained()
        ptrs = [t.data_ptr() for layer in eng.kv.pools for t in layer.values()]
        graphs = set(eng._chunk_graphs.graphs)
        if tier:
            assert eng.kv.spill_all() == 3
        second = eng.submit(prompt, max_new_tokens=6)
        done.update(eng.run_until_drained())
        outs[tier] = [done[first].tolist(), done[second].tolist()]
        assert ptrs == [t.data_ptr() for layer in eng.kv.pools for t in layer.values()]
        assert set(eng._chunk_graphs.graphs) == graphs
        st = eng.scheduler.stats()
        assert st["prefix_hit_tokens"] == 24
        if tier:
            assert st["tier_restored_pages"] == 3 and st["tier_hit_tokens"] == 24
        for key in eng._chunk_graphs.graphs:
            assert replay_check(eng._chunk_graphs, key, eng.kv.pools) == [], key
        eng.scheduler.check_invariants()
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# gemma2-2b (geglu, softcaps, post norms, local and global layers) and
# engine snapshots on the card
# ---------------------------------------------------------------------------

def _teacher_forced_gap(model, params, prompt, out, card, block_size=8):
    """The largest gap, over the emitted tokens, between a position's top
    teacher-forced logit and the emitted token's, over max|logit|."""
    seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]), device=card)
    rows = model.score(params, seq, block_size=block_size)[len(prompt) - 1:]
    picked = rows.gather(1, torch.as_tensor(out, device=card).long()[:, None])[:, 0]
    return float((rows.max(dim=1).values - picked).max()) / float(rows.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "int8"])
def test_gemma2_smoke_on_the_card_keeps_tokens_within_logit_tolerance(card, kind):
    """gemma2-2b-smoke served on the card with prompts past its local window
    of 32: each emitted token's teacher-forced logit lies within 5e-2 of
    the position's scale of its largest; every captured chunk replays
    bitwise; the decode steps launch the attention kernel and the GeMV."""
    from repro_torch.serve.graphs import replay_check

    model, params = _smoke(card, arch="gemma2-2b")
    eng = GenerationEngine(model, params, max_len=128, block_size=8, max_slots=2,
                           decode_chunk=8, kv_quant=kind, device=card)
    assert eng.scheduler.local_window is None
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (60, 9, 41)]
    att0, gemv0 = paged_attention.paged_attention.launches, deca_gemm.decompress_gemv.launches
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    done = eng.run_until_drained()
    assert paged_attention.paged_attention.launches > att0
    assert deca_gemm.decompress_gemv.launches > gemv0
    for p, r in zip(prompts, rids):
        assert len(done[r]) == 12
        assert _teacher_forced_gap(eng.model, params, p, done[r], card) <= 5e-2
    for key in eng._chunk_graphs.graphs:
        assert replay_check(eng._chunk_graphs, key, eng.kv.pools) == [], key


@pytest.mark.gpu
def test_snapshot_round_trip_on_the_card(card, tmp_path):
    """A tiered llama3-8b-smoke engine on the card snapshots in mid-serve; a
    fresh engine restores it (every page in the tier, none on the card),
    resumes through the tier and emits every token, each within the
    teacher-forced tolerance; the snapshotted engine finishes too."""
    model, params = _smoke(card)
    kw = dict(max_len=64, block_size=8, max_slots=2, decode_chunk=4, kv_quant="int8",
              num_blocks=16, prefix_cache=True, host_tier=True, device=card)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (17, 33)]
    eng = GenerationEngine(model, params, **kw)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, (4, 12))]
    eng.scheduler.step()
    eng.scheduler.step()
    counts = eng.snapshot(str(tmp_path / "snap"))
    assert counts["nodes"] > 0 and counts["requests"] >= 1
    fresh = GenerationEngine(model, params, **kw)
    assert fresh.restore(str(tmp_path / "snap")) == counts
    occ = fresh.kv.occupancy()
    assert occ["used"] == 0 and occ["tiered"] == counts["nodes"]
    got = fresh.run_until_drained()
    st = fresh.scheduler.stats()
    assert st["tier_restored_pages"] > 0 and st["tier_fallback_recompute"] == 0
    fresh.scheduler.check_invariants()
    for p, r, n in zip(prompts, rids, (4, 12)):
        assert len(got[r]) == n
        assert _teacher_forced_gap(model, params, p, got[r], card) <= 5e-2
    again = eng.run_until_drained()
    assert len(again[rids[1]]) == 12


# ---------------------------------------------------------------------------
# the MoE family: expert views of stacked leaves, kimi-k2's heads, graphs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("density", [1.0, 0.5])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_kernels_on_expert_views_of_a_stacked_leaf_match_plain(card, quant, density):
    """Each expert of an expert-stacked leaf, through its `pick` view (its
    planes start i slices into the stack): the GeMV (M = 4) and the GeMM (M
    = 160) against their plain versions, and the decompression kernel
    bitwise, the view's planes being those of the expert compressed alone."""
    from repro_torch.core.compression import compress_stacked

    spec = CompressionSpec(quant, density)
    g = torch.Generator(device=card).manual_seed(31)
    w = torch.randn(5, 512, 384, generator=g, device=card) * 0.05
    stacked = compress_stacked(lambda i: w[i], 5, spec)
    xs = {m: torch.randn(m, 512, generator=g, device=card) for m in (4, 160)}
    for i in range(5):
        ct = stacked.pick(i)
        alone = compress(w[i], spec)
        for plane in ("codes", "mask", "scales"):
            a, b = getattr(ct, plane), getattr(alone, plane)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
            assert a is None or a.data_ptr() % 16 == 0
        for m, x in xs.items():
            got = ops.decompress_gemm(x, ct, out_dtype=torch.float32)
            plain = ref.decompress_gemv if m <= ops.GEMV_MAX_M else ref.decompress_gemm
            want = plain(x, ct, out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert _close(got, want), (i, m)
        for dt in (torch.float32, torch.bfloat16):
            got = deca_decompress.decompress(ct, out_dtype=dt)
            assert torch.equal(_bits(got), _bits(ref.decompress(ct, dt))), (i, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_attention_at_kimi_k2_head_dim_112_matches_plain(card, kind):
    """kimi-k2's decode attention (Dh 112: the last lanes of each head row
    idle under the kernel's d < Dh guards; G 8), every (slot, head) row,
    with and without a window and a softcap."""
    args = _pools(kind, card, seed=13, b=4, hq=16, hkv=2, dh=112, bs=16, mb=24,
                  lens=(380, 257, 100, 3))
    for window, softcap in ((0, 0.0), (100, 0.0), (0, 30.0)):
        got = paged_attention.paged_attention(*args, quant=kind, window=window,
                                              softcap=softcap)
        want = ref.paged_decode_attention(*args, quant=kind, window=window, softcap=softcap)
        torch.cuda.synchronize()
        assert got.shape == (4, 16, 112)
        err = (got.float() - want.float()).abs().amax(dim=-1)
        bad = (err > TOL * float(want.float().abs().max())).nonzero().tolist()
        assert not bad, (window, softcap, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_moe_decode_graphs_replay_bitwise(card, arch):
    """An MoE smoke config served on the card: every captured decode chunk
    replays bitwise (the router's sorts, the capacity scatters and every
    expert's FFN inside the graph), with E x k x 3 expert GeMVs and 4
    attention GeMVs a layer, plus the head's, each step; the tokens lie
    within 5e-2 of the teacher-forced logits' scale, on a drop-free copy
    (capacity = n_experts: a teacher-forced pass routes other tokens
    together than the serve's prefill and decode do)."""
    from repro_torch.serve.graphs import replay_check

    model, params = _smoke(card, arch=arch)
    cfg = dataclasses.replace(model.cfg, capacity_factor=float(model.cfg.n_experts))
    eng = GenerationEngine(Model(cfg), params, max_len=64, block_size=8, max_slots=2,
                           decode_chunk=8, kv_quant="int8", device=card)
    rng = np.random.default_rng(5)
    for new in (9, 5, 3, 2):  # chunks of every length C in 8, 4, 2, 1
        eng.submit(rng.integers(0, 256, 11).astype(np.int32), max_new_tokens=new)
        eng.run_until_drained()
    graphs = eng._chunk_graphs.graphs
    assert sorted(key[2][0] for key in graphs) == [1, 2, 4, 8]
    per_step = (4 + 3 * cfg.n_experts * cfg.experts_per_token) * cfg.n_layers + 1
    for key, g in graphs.items():
        assert g.launches[0] == key[2][0] * per_step
        assert replay_check(eng._chunk_graphs, key, eng.kv.pools) == [], key
    prompt = np.random.default_rng(6).integers(0, 256, 21).astype(np.int32)
    rid = eng.submit(prompt, max_new_tokens=10)
    out = eng.run_until_drained()[rid]
    assert _teacher_forced_gap(eng.model, eng.params, prompt, out, card) <= 5e-2


@pytest.mark.gpu
def test_moe_spec_launch_replays_bitwise(card):
    """grok-1-314b-smoke's self-speculative engine on the card: the draft
    tree re-encodes every expert through the decompression kernel (one
    launch an expert), and the captured spec launch replays bitwise."""
    from repro_torch.serve.graphs import replay_check

    before = deca_decompress.decompress.launches
    eng = _served_engine(card, "int8", spec=SpecConfig(k=3, draft_codec="nf4"),
                         arch="grok-1-314b")
    cfg = eng.cfg
    experts = cfg.n_layers * cfg.n_experts * 3  # w_up, w_down, w_gate
    assert deca_decompress.decompress.launches - before == experts + 4 * cfg.n_layers + 1
    for key in eng._spec_graphs.graphs:
        assert replay_check(eng._spec_graphs, key, eng.kv.pools) == [], key


# the recurrent stacks' shapes the kernels had not met: falcon-mamba-7b's
# dt_proj (K 256: 8 groups, the GeMV's split-K plan and the GeMM's TMA
# ring over 4 stages) and x_proj (N 288, a partial column block),
# recurrentgemma-9b's MQA wk / wv (N 256), and its gates' 4096 x 4096
# w_a / w_x, which take f32 x
_RECURRENT_SHAPES = [(256, 8192), (8192, 288), (4096, 256), (4096, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _RECURRENT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("density", [1.0, 0.5])
@pytest.mark.parametrize("quant", ["bf16", "bf8", "mxfp4", "int8", "int4", "nf4"])
def test_gemv_and_gemm_at_the_recurrent_shapes_match_plain(card, quant, density, shape):
    k, n = shape
    g = torch.Generator(device=card).manual_seed(k + n)
    ct = compress(torch.randn(k, n, generator=g, device=card) / k ** 0.5,
                  CompressionSpec(quant, density))
    for m in (1, 4, 256):  # decode rows, and the 4 x 64 prefill
        x = torch.randn(m, k, generator=g, device=card)  # f32, not bf16-valued
        got = ops.decompress_gemm(x, ct, out_dtype=torch.float32)
        plain = ref.decompress_gemv if m <= ops.GEMV_MAX_M else ref.decompress_gemm
        want = plain(x, ct, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.shape == (m, n) and _close(got, want), (m, shape)


def _plain_matmuls(monkeypatch):
    monkeypatch.setattr(deca_gemm, "decompress_gemv", ref.decompress_gemv)
    monkeypatch.setattr(deca_gemm, "decompress_gemm", ref.decompress_gemm)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "falcon-mamba-7b@512",
                                  "recurrentgemma-9b", "llama3-8b"])
def test_dense_engine_steps_on_the_card_match_the_plain_path(card, arch, monkeypatch):
    """A smoke config's dense-engine prefill (2 prompts of 12 tokens) and
    three decode steps on the card, bf8_50 weights compressed there: the
    kernel path's logits against the plain path's on the same tokens, to
    5e-2 of their scale; every decode step launched the GeMV. At d_model
    512 falcon-mamba's x_proj and dt_proj are compressed too."""
    from repro_torch.serve.engine import make_prefill_step

    name, _, width = arch.partition("@")
    cfg = dataclasses.replace(get_smoke_config(name), kv_quant="int8")
    if width:
        cfg = dataclasses.replace(cfg, d_model=int(width))
    model = Model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0), device=card,
                        spec=get_spec("bf8_50"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator(device=card).manual_seed(1), device=card)
    outs = {}
    for path in ("kernel", "plain"):
        if path == "plain":
            _plain_matmuls(monkeypatch)
        else:
            deca_gemm.decompress_gemv.launches = 0
        logits, cache = make_prefill_step(model, cache_len=16)(params, {"tokens": tokens})
        rows = [logits]
        for j in range(3):
            tok = outs["kernel"][j].argmax(-1)[:, None] if path == "plain" else (
                rows[-1].argmax(-1)[:, None])
            pos = torch.full((2, 1), 12 + j, dtype=torch.int32, device=card)
            rows.append(model.decode_step(params, tok.to(torch.int32), pos, cache)[0])
        torch.cuda.synchronize()
        outs[path] = rows
        if path == "kernel":
            assert deca_gemm.decompress_gemv.launches >= 3
    for got, want in zip(outs["kernel"], outs["plain"]):
        assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())


@pytest.fixture
def nccl_mesh(card):
    """A one-rank NCCL world on the card and its (1, 1) mesh, closed after
    the test."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_compressed_allreduce_on_the_card_is_the_cpus_bitwise(nccl_mesh):
    """On a one-rank NCCL mesh the compressed all-reduce's sent payload and
    residual are the CPU port's round trip of the same g + err, bitwise,
    for every KV-capable codec, at sizes a whole number of groups and not,
    across a stacked norm too (`layer_stack`)."""
    from repro_torch.core import codecs
    from repro_torch.dist import grad_compression as gc

    g = torch.Generator().manual_seed(3)
    def tree():
        return {"w": torch.randn(300, 257, generator=g) * 1e-2,
                "layers": [{"norm": torch.randn(64, generator=g),
                            "wq": torch.randn(128, 64, generator=g)} for _ in range(2)]}
    grads, err = tree(), tree()
    for method in codecs.kv_codec_names():
        allreduce, _ = gc.make_compressed_allreduce(nccl_mesh, None, method=method,
                                                    layer_stack=2)
        cpu_ar, _ = gc.make_compressed_allreduce(_CpuMesh(), None, method=method,
                                                 layer_stack=2)
        e_card = {k: _tree_to(v, "cuda") for k, v in err.items()}
        e_cpu = {k: _tree_to(v, "cpu") for k, v in err.items()}
        sent_card, e_card = allreduce({k: _tree_to(v, "cuda") for k, v in grads.items()},
                                      e_card)
        sent_cpu, e_cpu = cpu_ar(grads, e_cpu)
        torch.cuda.synchronize()
        for a, b in ((sent_card, sent_cpu), (e_card, e_cpu)):
            for x, y in zip(_leaves(a), _leaves(b)):
                assert torch.equal(_bits(x.cpu()), _bits(y)), method


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b@512", "recurrentgemma-9b"])
def test_ring_engine_on_a_one_rank_nccl_mesh_is_the_plain_engine_bitwise(nccl_mesh, arch):
    """The dense ring engine (`paged=False`) of a recurrent smoke config on
    a one-rank NCCL mesh, bf8_50 weights compressed on the card (at
    d_model 512 falcon-mamba's x_proj and dt_proj too): the greedy tokens
    and every ring plane and recurrent state after the serve are the plain
    ring engine's, bitwise, and the mesh serve launches the plain serve's
    GeMVs and GeMMs: every compressed product ran the DECA kernels on its
    shard, the whole leaf on one rank."""
    from repro_torch.serve.engine import GenerationEngine

    name, _, width = arch.partition("@")
    cfg = get_smoke_config(name)
    if width:
        cfg = dataclasses.replace(cfg, d_model=int(width))
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        spec=get_spec("bf8_50"))
    prompts = torch.randint(0, cfg.vocab_size, (4, 12),
                            generator=torch.Generator().manual_seed(1)).numpy()
    runs = {}
    for which, mesh in (("plain", None), ("mesh", nccl_mesh)):
        eng = GenerationEngine(model, params, max_len=32, paged=False, mesh=mesh)
        deca_gemm.decompress_gemv.launches = deca_gemm.decompress_gemm.launches = 0
        tokens = eng.generate(prompts, 8)
        torch.cuda.synchronize()
        runs[which] = (tokens, eng.ring, (deca_gemm.decompress_gemv.launches,
                                          deca_gemm.decompress_gemm.launches))
    (t0, ring0, n0), (t1, ring1, n1) = runs["plain"], runs["mesh"]
    assert (t0 == t1).all() and n0 == n1 and n0[0] > 0 and n0[1] > 0
    for a, b in zip(ring0, ring1):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class _CpuMesh:
    """A one-rank mesh with no axes: the CPU side of the comparison runs the
    same code with no collective."""

    mesh_dim_names = ()

    @staticmethod
    def size():
        return 1


def _tree_to(t, dev):
    if isinstance(t, dict):
        return {k: _tree_to(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_to(v, dev) for v in t]
    return t.to(dev, copy=True)


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]

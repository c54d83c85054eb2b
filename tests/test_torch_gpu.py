"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one: the kernels have no
CPU mode. They import only torch, numpy and the port, so they run on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: the kernels and their plain versions multiply the same bf16
values exactly and sum in f32 in another order (matmuls: K <= 512 here;
attention: an online softmax over another grouping), so they agree to
1e-4 of the output's scale. Decompression has no accumulation and is
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


def _smoke(device, spec="bf8_50"):
    model = Model(get_smoke_config("llama3-8b"))
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

def _served_engine(card, kind, spec=None, **kw):
    """A smoke-config engine on the card that has served requests whose
    chunks took every length C in 8, 4, 2, 1 (each length its own graph)."""
    model, params = _smoke(card)
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
    keys = sampling.fold_in(sampling.fold_in(sampling.prng_key(4).expand(n, 2), rids), steps)
    assert torch.equal(sampling.random_bits(keys.to(card), v).cpu(),
                       sampling.random_bits(keys, v))
    assert torch.equal(sampling.uniform(keys.to(card), v).cpu(), sampling.uniform(keys, v))
    g_cpu, g_card = sampling.gumbel(keys, v), sampling.gumbel(keys.to(card), v).cpu()
    scale = torch.clamp_min(g_cpu.abs(), 1.0)
    ulp = torch.nextafter(scale, torch.tensor(float("inf"))) - scale
    assert bool(((g_card - g_cpu).abs() <= 2 * ulp).all())
    t = torch.tensor(temp)
    want = sampling.sample_rows_keyed(sampling.prng_key(4), rids, steps, logits, t)
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

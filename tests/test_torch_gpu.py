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

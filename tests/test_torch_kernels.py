"""Parity of the port's kernel modules with the JAX reference on CPU.

On CPU tensors every kernel wrapper returns its plain version
(`repro_torch/kernels/ref.py`); those are held against `repro.kernels.ref`
(the reference's Pallas entries do not run on this jax, ROADMAP Queue C).
Decompression is bitwise; matmuls and attention hold to the f32
accumulation bound stated in each test. The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import compress as jcompress
from repro.core.formats import CompressionSpec as JSpec
from repro.kernels import ref as jref
from repro.models import layers as jlayers

from repro_torch.convert import _leaf, to_tensor
from repro_torch.core.formats import CompressionSpec as TSpec
from repro_torch.kernels import autotune, deca_gemm, ops, ref
from repro_torch.models import layers as tlayers

CODECS = ("bf16", "bf8", "mxfp4", "int8", "int4", "nf4")
KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")


def _ct_pair(quant, density, k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jct = jcompress(w, JSpec(quant, density))
    return jct, _leaf(jct, None, "cpu")


@pytest.mark.parametrize("density", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("quant", CODECS)
def test_decompress_bitwise(quant, density):
    jct, tct = _ct_pair(quant, density, 96, 40, seed=len(quant))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        r = np.asarray(jref.decompress(jct, out_dtype=jdt).astype(jnp.float32))
        g = ref.decompress(tct, out_dtype=tdt).float().numpy()
        assert np.array_equal(r.view(np.uint32), g.view(np.uint32))


def test_expand_mask_bitwise():
    rng = np.random.default_rng(1)
    mask = rng.integers(0, 2**32, (4, 9), dtype=np.uint64).astype(np.uint32)
    mask[0, 0] = 0xFFFFFFFF
    r = np.asarray(jref.expand_mask(jnp.asarray(mask), 32))
    g = ref.expand_mask(to_tensor(mask, "cpu"), 32).numpy()
    assert np.array_equal(r, g)


def _accumulation_bound(x, w, k):
    """Two f32 sums of the same exact bf16 products, in different orders,
    differ by at most 2 (K-1) 2**-24 sum|x w| per output."""
    xb = np.abs(np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))
    return 2 * (k - 1) * 2.0**-24 * (xb @ np.abs(w)) + 1e-30


@pytest.mark.parametrize("m", [1, 5, 32, 33, 64])
@pytest.mark.parametrize("spec", ["bf8_50", "mxfp4_100", "int4_25", "nf4_100", "bf16_50", "int8_5"])
def test_compressed_matmul_to_f32_bound(spec, m):
    quant, dens = spec.rsplit("_", 1)
    k, n = 128, 48
    jct, tct = _ct_pair(quant, int(dens) / 100, k, n, seed=m)
    rng = np.random.default_rng(m + 7)
    x = rng.standard_normal((m, k)).astype(np.float32)
    r_fn = jref.decompress_gemv if m <= ops.GEMV_MAX_M else jref.decompress_gemm
    r = np.asarray(r_fn(jnp.asarray(x), jct, out_dtype=jnp.float32))
    g = ops.decompress_gemm(torch.from_numpy(x), tct, out_dtype=torch.float32).numpy()
    w = np.asarray(jref.decompress(jct, out_dtype=jnp.float32))
    bound = _accumulation_bound(x, w, k)
    assert np.all(np.abs(g - r) <= bound)
    # bf16 outputs: the same sums rounded once more, so at most one bf16
    # ulp (2**-8 relative, 2**-7 near a binade edge) beyond the f32 bound
    rb = np.asarray(r_fn(jnp.asarray(x).astype(jnp.bfloat16), jct,
                         out_dtype=jnp.bfloat16).astype(jnp.float32))
    gb = ops.decompress_gemm(torch.from_numpy(x).bfloat16(), tct,
                             out_dtype=torch.bfloat16).float().numpy()
    assert np.all(np.abs(gb - rb) <= 2.0**-7 * np.abs(rb) + 2 * bound)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    _, tct = _ct_pair("bf8", 0.5, 64, 32, seed=0)
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    before = (deca_gemm.decompress_gemv.launches, deca_gemm.decompress_gemm.launches)
    assert torch.equal(deca_gemm.decompress_gemv(x, tct), ref.decompress_gemv(x, tct))
    x40 = torch.randn(40, 64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(deca_gemm.decompress_gemm(x40, tct), ref.decompress_gemm(x40, tct))
    after = (deca_gemm.decompress_gemv.launches, deca_gemm.decompress_gemm.launches)
    assert before == after


def test_ref_gemv_tiles_columns_without_changing_results():
    """The plain GeMV walks column tiles; each output stays one full-K dot,
    so any tiling gives the same bits."""
    _, tct = _ct_pair("int4", 0.5, 64, 48, seed=2)
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(3))
    a = ref.decompress_gemv(x, tct, block_n=8)
    b = ref.decompress_gemv(x, tct, block_n=24)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ref.decompress_gemv(x, tct, block_n=7)


def _paged_pools(kind, seed):
    """A JAX-built paged pool with ragged per-slot lengths, and the port's
    copy of it. Slot pages are a random permutation; unused table entries
    read the null page."""
    rng = np.random.default_rng(seed)
    b, bs, mb, hkv, hq, dh = 3, 8, 6, 2, 4, 16
    nb = b * mb + 1
    kv_lens = np.array([37, 5, 48], np.int32)
    perm = rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32)
    tables = np.where(np.arange(mb)[None] < -(-kv_lens[:, None] // bs), perm, 0)
    s = int(kv_lens.max())
    pos = np.arange(s, dtype=np.int32)
    wpos = np.where(pos[None] < kv_lens[:, None], pos[None], jref.CACHE_EMPTY_POS)
    wslots = np.where(
        pos[None] < kv_lens[:, None],
        np.take_along_axis(tables, np.minimum(pos // bs, mb - 1)[None].repeat(b, 0), 1)
        * bs + pos % bs,
        pos % bs,
    ).astype(np.int32)
    k = jnp.asarray(rng.standard_normal((b, s, hkv, dh)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, hkv, dh)), jnp.bfloat16)
    jpools = jlayers.init_paged_kv_cache(nb, bs, hkv, dh, quant=kind)
    jpools = jlayers.paged_update_cache(
        jpools, k, v, jnp.asarray(wpos), jnp.asarray(wslots), quant=kind
    )
    tpools = {n: to_tensor(np.asarray(a), "cpu") for n, a in jpools.items()}
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    return jpools, tpools, tables, kv_lens, q


@pytest.mark.parametrize("ppb", [1, 4])
@pytest.mark.parametrize("variant", ["plain", "window", "softcap"])
@pytest.mark.parametrize("kind", KV_KINDS)
def test_paged_attention_matches_reference(kind, variant, ppb):
    """Online softmax in f32 over another page grouping and another sum
    order: agreement to 2e-5 of the output's scale. Four pages per step
    over a 6-page table also pads the walk with the null page."""
    jpools, tpools, tables, kv_lens, q = _paged_pools(kind, seed=len(kind))
    kw = {"window": 16} if variant == "window" else {}
    if variant == "softcap":
        kw["softcap"] = 5.0
    q_pos = kv_lens - 1
    r = np.asarray(jref.paged_decode_attention(
        jnp.asarray(q), jpools, jnp.asarray(tables), jnp.asarray(kv_lens),
        jnp.asarray(q_pos), quant=kind, **kw,
    ))
    g = ref.paged_decode_attention(
        torch.from_numpy(q), tpools, torch.from_numpy(tables),
        torch.from_numpy(kv_lens), torch.from_numpy(q_pos), quant=kind,
        pages_per_block=ppb, **kw,
    ).numpy()
    np.testing.assert_allclose(g, r, rtol=0, atol=2e-5 * np.abs(r).max())
    if ppb == 1:  # the wrapper takes the plain version on CPU tensors
        w = ops.paged_attention(
            torch.from_numpy(q), tpools, torch.from_numpy(tables),
            torch.from_numpy(kv_lens), torch.from_numpy(q_pos), quant=kind, **kw,
        ).numpy()
        assert np.array_equal(w, g)


@pytest.mark.parametrize("kind", ["none", "int4"])
def test_paged_attention_agrees_with_gathered_prefill_path(kind):
    """The decode walk and the prefill path (gather + attention_core) read
    the same pool: one query row each, same answer to f32 tolerance."""
    _, tpools, tables, kv_lens, q = _paged_pools(kind, seed=5)
    q_pos = torch.from_numpy(kv_lens - 1)
    walk = ref.paged_decode_attention(
        torch.from_numpy(q), tpools, torch.from_numpy(tables),
        torch.from_numpy(kv_lens), q_pos, quant=kind,
    )
    k, v, k_pos = tlayers.paged_gather_kv(tpools, torch.from_numpy(tables), kind)
    core = tlayers.attention_core(
        torch.from_numpy(q)[:, None], k, v, q_pos=q_pos[:, None], k_pos=k_pos,
        causal=True,
    )[:, 0]
    torch.testing.assert_close(walk, core, rtol=0, atol=2e-5 * float(core.abs().max()))


def test_gemv_splits_cover_every_group_once():
    for n, ng in [(1024, 128), (4096, 128), (14336, 128), (4096, 448), (128256, 128), (48, 3)]:
        s = autotune.gemv_splits(n, ng)
        per = -(-ng // s)
        assert 1 <= s <= ng and -(-ng // per) == s  # every split owns >= 1 group
    assert autotune.gemv_splits(128256, 128) == 1
    assert autotune.gemv_splits(1024, 128) * 8 >= autotune.SM_COUNT  # >= one CTA per SM


# llama3-8b FC shapes as (N, groups): q/o, k/v, gate/up, down, lm_head
_LLAMA_FC = [(4096, 128), (1024, 128), (14336, 128), (4096, 448), (128256, 128)]


@pytest.mark.parametrize("quant", CODECS)
def test_gemv_plan_covers_every_group_and_fits_shared_memory(quant):
    """For llama3-8b's FC shapes and a sweep of (N, groups), at every
    density and M in 1..32: the splits partition the groups, none empty;
    the grid gives each SM a CTA wherever the (column block, group) pairs
    and the split cap allow it; a ring stage keeps to its code budget and
    its x to two 16-byte quads a thread; and the CTA's shared bytes fit
    the 227 KB a CTA can opt in to."""
    shapes = _LLAMA_FC + [(n, ng) for n in (1, 100, 259, 320, 1024, 33792)
                          for ng in (1, 2, 15, 128)]
    for dens in (1.0, 0.5, 0.25, 0.05):
        spec = TSpec(quant, dens)
        ck, sb = spec.k_cap * spec.bits // 8, spec.codec.scale_bits // 8
        for n, ng in shapes:
            blocks = -(-n // autotune.GEMV_COLS)
            for m in range(1, 33):
                splits, chunk, smem = autotune.gemv_plan(n, ng, m, ck, spec.is_sparse, sb)
                per = -(-ng // splits)
                owned = [range(s * per, min((s + 1) * per, ng)) for s in range(splits)]
                assert all(len(r) > 0 for r in owned)
                assert [g for r in owned for g in r] == list(range(ng))
                assert blocks * splits >= min(
                    autotune.SM_COUNT, blocks * min(ng, autotune.GEMV_MAX_SPLITS))
                mb = autotune.gemv_mb(m)
                assert m <= mb <= 32 and 1 <= chunk <= 8
                assert chunk * 32 * mb // 4 <= 2 * 256  # x quads: two a thread
                assert chunk == 1 or chunk * ck * autotune.GEMV_COLS <= 16384
                assert smem <= 227 * 1024, (spec.name, n, m, smem)
    for n, ng in _LLAMA_FC:  # a CTA per SM at every full-width FC shape
        assert -(-n // autotune.GEMV_COLS) * autotune.gemv_splits(n, ng) >= autotune.SM_COUNT


@pytest.mark.parametrize("n,target,want", [(48, 20, 16), (1024, 256, 256), (97, 50, 1), (12, 8, 6)])
def test_select_block_largest_divisor(n, target, want):
    assert autotune.select_block(n, target) == want


@pytest.mark.parametrize("mb,batch,kv_heads", [
    (64, 4, 8), (64, 1, 8), (64, 16, 8), (8, 3, 2), (16, 1, 1), (1, 4, 8), (7, 2, 2),
    (64, 64, 8), (64, 2, 8)])
def test_attention_split_plan_covers_each_page_once(mb, batch, kv_heads):
    """The splits' page ranges [s pps, (s + 1) pps) partition the block
    table's [0, MB), none empty, so the kernel's clip of each range to the
    pages a slot can see, [lo_page, n_pages), folds each of those pages
    exactly once. The plan depends on the shapes alone."""
    splits, pps = autotune.attention_splits(mb, batch, kv_heads)
    assert splits >= 1 and pps >= 1
    ranges = [range(s * pps, min((s + 1) * pps, mb)) for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [p for r in ranges for p in r] == list(range(mb))
    # at least two CTAs an SM, or a split per page
    assert splits * batch * kv_heads >= min(mb * batch * kv_heads, 2 * autotune.SM_COUNT)


def test_attention_split_plan_at_llama3_8b():
    """4 slots x 8 KV heads over 64-page tables: 32 splits of 2 pages, 1024
    CTAs for 132 SMs."""
    assert autotune.attention_splits(64, 4, 8) == (32, 2)
    assert autotune.attention_splits(64, 1, 1) == (64, 1)

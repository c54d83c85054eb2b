"""Plain PyTorch versions of DECA decompression, the compressed GeMM/GeMV
and the fused paged-attention decode.

Counterpart of `repro/kernels/ref.py`, stage for stage (paper Fig. 11):
  1. Dequantization  — code -> value, the registered codec's decoder,
  2. Expansion       — de-sparsification: prefix-sum over the bitmask and a
                       gather (POPCNT + prefix + crossbar in hardware),
  3. Scaling         — per-group scale multiply.

These run on whatever device their inputs lie on. The kernel wrappers
(`kernels/deca_gemm.py`, `kernels/paged_attention.py`) take them for CPU
tensors; `chip_smoke.py` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.codecs import get_codec
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.formats import CompressionSpec
from repro_torch.kernels.autotune import select_block

# Empty KV-cache slots carry this position: causal masking drops it, and the
# paged walk also drops it explicitly.
CACHE_EMPTY_POS = 1 << 30


def expand_mask(mask: torch.Tensor, group: int) -> torch.Tensor:
    """(ng, N) int32 bitmask -> (ng, G, N) {0,1} int32 per-element bits."""
    shifts = torch.arange(group, dtype=torch.int32, device=mask.device)
    return (mask[:, None, :] >> shifts[None, :, None]) & 1


def _decompress_tile(codes, mask, scales, spec: CompressionSpec) -> torch.Tensor:
    """(ng, ck, bn) codes -> (K, bn) f32 dense. Every stage is column-local,
    so a column tile is bitwise the matching slice of the full matrix."""
    codec = get_codec(spec.quant)
    vals = codec.decode_values(codes)  # (ng, k_cap, bn)
    if scales is not None:
        vals = vals * codec.decode_scales(scales)[:, None, :]
    ng, _, bn = vals.shape
    if mask is None:
        return vals.reshape(ng * spec.group, bn)
    bits = expand_mask(mask, spec.group)
    prefix = torch.cumsum(bits, dim=1) - bits
    idx = torch.clamp(prefix, 0, spec.k_cap - 1).long()
    gathered = torch.gather(vals, 1, idx)
    dense = torch.where(bits == 1, gathered, torch.zeros((), device=vals.device))
    return dense.reshape(ng * spec.group, bn)


def decompress(ct: CompressedTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full DECA pipeline: CompressedTensor -> dense (K, N)."""
    return _decompress_tile(ct.codes, ct.mask, ct.scales, ct.spec).to(out_dtype)


def _bf16_dot(x: torch.Tensor, w_bf16: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and f32 accumulation."""
    return torch.matmul(x.to(torch.bfloat16).float(), w_bf16.float())


def decompress_gemm(
    x: torch.Tensor, ct: CompressedTensor, out_dtype=torch.float32
) -> torch.Tensor:
    """x (M, K) @ decompress(ct) (K, N) -> (M, N). Unfused reference."""
    return _bf16_dot(x, decompress(ct, torch.bfloat16)).to(out_dtype)


def decompress_gemv(
    x: torch.Tensor,
    ct: CompressedTensor,
    *,
    block_n: Optional[int] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Decode-shaped compressed GeMV: x (M, K) @ W (K, N), walking column
    tiles so no dense (K, N) intermediate exists. Each output element stays
    one full-K dot."""
    K, N = ct.shape
    if x.shape[1] != K:
        raise ValueError(f"x K dim {x.shape[1]} != weight K {K}")
    if block_n is None:
        block_n = select_block(N, max(1, min(128, N // 2)))
    if N % block_n:
        raise ValueError(f"block_n={block_n} does not divide N={N}")

    def col(a, i):
        return None if a is None else a[..., i * block_n:(i + 1) * block_n]

    tiles = [
        _bf16_dot(x, _decompress_tile(
            col(ct.codes, i), col(ct.mask, i), col(ct.scales, i), ct.spec
        ).to(torch.bfloat16))
        for i in range(N // block_n)
    ]
    return torch.cat(tiles, dim=1).to(out_dtype)


# ---------------------------------------------------------------------------
# fused paged-attention decode
# ---------------------------------------------------------------------------

def kv_decode_page(
    codes: torch.Tensor, scales: Optional[torch.Tensor], quant: str
) -> torch.Tensor:
    """Dequantize KV codes via the codec registry, rounded to bf16
    (identity for unquantized pools)."""
    if quant in ("none", "", None):
        return codes
    return get_codec(quant).kv_decode(codes, scales).to(torch.bfloat16)


def resolve_page_walk(
    block_tables: torch.Tensor, pages_per_block: int
) -> Tuple[int, torch.Tensor]:
    """Clamp the pages folded per walk step to [1, MB] and pad the block
    tables to a whole number of steps with the null page (whose sentinel
    positions mask to zero weight)."""
    mb = block_tables.shape[1]
    ppb = max(1, min(pages_per_block, mb))
    pad = -(-mb // ppb) * ppb - mb
    if pad:
        block_tables = torch.nn.functional.pad(block_tables, (0, pad))
    return ppb, block_tables


def paged_softmax_update(
    q: torch.Tensor,      # (B, Hkv, G, Dh)
    k: torch.Tensor,      # (B, T, Hkv, Dh)
    v: torch.Tensor,      # (B, T, Hkv, Dh)
    k_pos: torch.Tensor,  # (B, T) int32; CACHE_EMPTY_POS marks empty slots
    q_pos: torch.Tensor,  # (B,) int32
    m: torch.Tensor,      # (B, Hkv, G) f32 running max
    l: torch.Tensor,      # (B, Hkv, G) f32 running exp-sum
    acc: torch.Tensor,    # (B, Hkv, G, Dh) f32 running weighted-V sum
    *,
    scale: float,
    causal: bool,
    window: int,
    softcap: float,
):
    """Fold one block of KV into the online-softmax state: bf16 q·k with
    f32 accumulation times `scale`, then tanh softcap, then the
    sentinel/causal/window mask, then the f32 online softmax."""
    s = torch.einsum(
        "bhgd,bthd->bhgt",
        q.to(torch.bfloat16).float(), k.to(torch.bfloat16).float(),
    ) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    ok = k_pos != CACHE_EMPTY_POS
    if causal:
        ok = ok & (k_pos <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos > q_pos[:, None] - window)
    zero = torch.zeros((), device=s.device)
    s = s + torch.where(ok, zero, zero - 1e30)[:, None, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    # an all-masked block leaves m at the -1e30 init, where exp(s - m) is 1
    # for masked entries — their mass is therefore zeroed explicitly
    p = torch.exp(s - m_new[..., None]) * ok[:, None, None, :]
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return m_new, l_new, acc * alpha[..., None] + pv


def paged_decode_attention(
    q: torch.Tensor,                 # (B, Hq, Dh) one query token per slot
    pools: Dict[str, torch.Tensor],  # kp/vp/ppos (+ks/vs for scaled codecs)
    block_tables: torch.Tensor,      # (B, MB) int32 device page ids
    kv_lens: torch.Tensor,           # (B,) int32 valid KV tokens per slot
    q_pos: torch.Tensor,             # (B,) int32 query positions
    *,
    quant: str = "none",
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    pages_per_block: int = 1,
) -> torch.Tensor:
    """Paged-attention decode with dequantize-on-read inside the walk.

    Walks the batch's page range `pages_per_block` pages at a time (one
    page, the CUDA kernel's step, by default): from the first page any
    slot's window can see up to the largest used page count. Pages past a
    slot's length, scrubbed pages and null-page reads carry the position
    sentinel and fold in with exactly zero weight."""
    kp = pools["kp"]
    bs, hkv = kp.shape[1], kp.shape[2]
    b, hq, dh = q.shape
    g = hq // hkv
    mb = block_tables.shape[1]
    ppb, tables = resolve_page_walk(block_tables.long(), pages_per_block)
    has_scale = "ks" in pools
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hkv, g, dh)
    pages_needed = torch.clamp(-(-kv_lens.long() // bs), 0, mb)
    bound = -(-int(pages_needed.max()) // ppb)
    start = 0
    if window > 0:
        first_page = torch.clamp((q_pos.long() - window + 1) // bs, 0, mb)
        start = int(first_page.min()) // ppb

    def grab(name, tbl):
        x = pools[name][tbl]  # (B, ppb, bs, ...)
        return x.reshape((b, ppb * bs) + x.shape[3:])

    dev = q.device
    m = torch.full((b, hkv, g), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, dh), dtype=torch.float32, device=dev)
    for i in range(start, bound):
        tbl = tables[:, i * ppb:(i + 1) * ppb]
        ks = grab("ks", tbl) if has_scale else None
        vs = grab("vs", tbl) if has_scale else None
        k = kv_decode_page(grab("kp", tbl), ks, quant)
        v = kv_decode_page(grab("vp", tbl), vs, quant)
        m, l, acc = paged_softmax_update(
            qg, k, v, grab("ppos", tbl), q_pos, m, l, acc,
            scale=scale, causal=causal, window=window, softcap=softcap,
        )
    out = torch.where(
        l[..., None] > 0,
        acc / torch.clamp(l, min=1e-30)[..., None],
        torch.zeros((), device=dev),
    )
    return out.reshape(b, hq, dh).to(q.dtype)

"""Entry points of the DECA kernels.

Counterpart of `repro/kernels/ops.py`. `decompress` is the standalone
decompression (the draft-tree build of self-speculative decode). Regime
split of the matmul: at or below `GEMV_MAX_M` rows the matmul is the
decode GeMV regime, bandwidth-bound on the compressed weight stream, and
goes to the GeMV kernel; above it (the prefill) to the tensor-core GeMM
kernel. Each wrapper takes its plain
version for CPU tensors and launches its CUDA kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.compression import CompressedTensor
from repro_torch.kernels import deca_decompress, deca_gemm
from repro_torch.kernels import paged_attention as _paged_attention

# Rows at or below which the decode-shaped GeMV kernel is used: the decode
# step's M is the continuous-batching slot count.
GEMV_MAX_M = 32


def decompress(ct: CompressedTensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Decompress to a dense (K, N) tensor in `out_dtype`."""
    return deca_decompress.decompress(ct, out_dtype=out_dtype)


def decompress_gemm(
    x: torch.Tensor, ct: CompressedTensor, *, out_dtype=torch.float32
) -> torch.Tensor:
    """x (..., K) @ decompress(ct) (K, N) -> (..., N) in `out_dtype`, with
    bf16 operands and f32 accumulation. Leading dims of x flatten to M."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] <= GEMV_MAX_M:
        out = deca_gemm.decompress_gemv(x2, ct, out_dtype=out_dtype)
    else:
        out = deca_gemm.decompress_gemm(x2, ct, out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


def paged_attention(
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
) -> torch.Tensor:
    """Fused paged-attention decode over the quantized KV pool."""
    return _paged_attention.paged_attention(
        q, pools, block_tables, kv_lens, q_pos,
        quant=quant, causal=causal, window=window, softcap=softcap,
    )

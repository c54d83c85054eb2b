"""Fused decompress + matmul on Hopper: the decode GeMV and prefill GeMM.

Replaces `repro/kernels/deca_gemm.py` (`decompress_gemv_pallas`,
`decompress_gemm_pallas`, body `_gemm_kernel`). Both compute
out (M, N) = bf16(x) @ bf16(decompress(W)) with f32 accumulation, stored
once in `out_dtype`; the decompressed weight exists only in registers or
shared memory (csrc/deca_gemm.cu).

  decompress_gemv  M <= 32, every decode-step FC matmul. Bound by the bytes
                   of the compressed weight stream: a CTA owns 128 output
                   columns, two threads each, and streams their codes,
                   masks and scales through a two-stage cp.async ring with
                   x beside them (bf16-rounded f32); each value is decoded
                   in registers, a sparse group walking only its set mask
                   bits at small M. Narrow N splits K over more CTAs
                   (autotune.gemv_plan) into an f32 workspace that a second
                   pass sums in a fixed order; one split stores out itself.
  decompress_gemm  M > 32, every prefill FC matmul
                   (csrc/deca_gemm_sm90.cu). At prefill sizes the tensor
                   cores would bound it, but each weight tile is decoded on
                   the vector units first, once per 256 rows of x, and that
                   decode sets its pace. One producer thread streams x
                   (bf16, 128-byte swizzle) and the compressed triplet
                   through a TMA ring, two decoder warpgroups write each
                   decoded bf16 tile into a second ring in the swizzled
                   K-major layout wgmma reads, and two consumer warpgroups
                   accumulate m64n128k16 wgmmas in f32 registers. x is rounded to bf16 once, here, as the
                   kernel's bf16(x). Any N: where N is no multiple of 16
                   (a TMA row stride must be), the decoders read the
                   triplet's planes from device memory instead.

On CPU tensors each wrapper returns its plain version from
`kernels/ref.py`; on CUDA tensors it launches its kernel or raises.
`decompress_gemv.launches` / `decompress_gemm.launches` count launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.compression import CompressedTensor
from repro_torch.kernels import autotune, cuda, ref
from repro_torch.kernels.deca_decompress import tile_operands

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, x_f32, codes, mask, scales, codec, k_cap, ck, M, K, N, splits,
    # chunk groups, shared bytes, workspace, out, out_f32, stream
    "deca_gemv": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P),
}
_GEMM_SIGNATURES = {
    # x (bf16), codes, mask, scales, codec, k_cap, ck, scale bytes, M, K, N,
    # out, out_f32, stream
    "deca_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P),
}
_FLOATS = (torch.bfloat16, torch.float32)


def _launch_args(x: torch.Tensor, ct: CompressedTensor, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 2 or x.shape[1] != ct.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match weight {ct.shape}")
    if x.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"x / out must be bf16 or f32, got {x.dtype} / {out_dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels load x in 16-byte pieces
        x = x.clone()
    return x, tile_operands(ct, x.device)


def _lib():
    return cuda.library("deca_gemm", _SIGNATURES)


def decompress_gemv(
    x: torch.Tensor, ct: CompressedTensor, *, out_dtype=torch.float32
) -> torch.Tensor:
    """x (M <= 32, K) @ decompress(ct) (K, N) -> (M, N)."""
    if x.device.type == "cpu":
        return ref.decompress_gemv(x, ct, out_dtype=out_dtype)
    x, tile = _launch_args(x, ct, out_dtype)
    m, (k, n) = x.shape[0], ct.shape
    if not 1 <= m <= 32:
        raise ValueError(f"the GeMV kernel takes 1 <= M <= 32, got {m}")
    scale_bytes = 0 if ct.scales is None else ct.scales.element_size()
    splits, chunk, smem = autotune.gemv_plan(
        n, k // 32, m, tile[-1], ct.mask is not None, scale_bytes)
    ws = None  # one split: the kernel stores out, no second pass
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _lib().deca_gemv(
        x.data_ptr(), int(x.dtype == torch.float32), *tile, m, k, n, splits, chunk, smem,
        None if ws is None else ws.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda.check(err, "deca_gemv")
    decompress_gemv.launches += 1
    return out


def decompress_gemm(
    x: torch.Tensor, ct: CompressedTensor, *, out_dtype=torch.float32
) -> torch.Tensor:
    """x (M, K) @ decompress(ct) (K, N) -> (M, N), wgmma tiles."""
    if x.device.type == "cpu":
        return ref.decompress_gemm(x, ct, out_dtype=out_dtype)
    x, tile = _launch_args(x, ct, out_dtype)
    x = x.to(torch.bfloat16)  # the kernel's bf16(x): one TMA dtype
    m, (k, n) = x.shape[0], ct.shape
    ck = tile[-1]
    if ck > 64:
        raise ValueError(f"the GeMM kernel takes at most 64 code bytes a group, got {ck}")
    scale_bytes = 0 if ct.scales is None else ct.scales.element_size()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = cuda.library("deca_gemm_sm90", _GEMM_SIGNATURES).deca_gemm(
        x.data_ptr(), *tile, scale_bytes, m, k, n, out.data_ptr(),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda.check(err, "deca_gemm")
    decompress_gemm.launches += 1
    return out


decompress_gemv.launches = 0
decompress_gemm.launches = 0

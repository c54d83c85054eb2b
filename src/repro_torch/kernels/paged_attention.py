"""Split-KV paged-attention decode on Hopper.

Replaces `repro/kernels/paged_attention.py` (`paged_attention_pallas`,
body `_paged_attn_kernel`). The walk over a slot's pages is split
(flash-decoding, csrc/paged_attention.cu): a CTA per (KV head, slot,
split) serves the head's g query heads over its share of the pages,
from the first page its window can see up to ceil(kv_len / block_size).
Pages arrive by cp.async into two buffers; K and V are decoded from the
stored bytes into registers with the pool codec's `kv_decode` arithmetic,
rounded to bf16 as `kv_decode_page` does, and folded into an f32
(m, l, acc) online softmax in the order of `ref.paged_softmax_update`.
Each split writes its partial to a workspace, and a second kernel merges
the splits in split order, so the result is deterministic, and stores it
in q's dtype. The split count comes from the shapes alone
(`autotune.attention_splits`), never from `kv_lens`, so no host sync is
added. The gathered dense KV view never exists in device memory. It takes
head dims up to 256 and the query groups in `GROUPS`, one instance each.

Bound by the bytes of the quantized pages it reads.

On CPU tensors the wrapper returns `ref.paged_decode_attention`; on CUDA
tensors it launches the kernels or raises. `paged_attention.launches`
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.codecs import codec_wire_id, get_codec
from repro_torch.kernels import autotune, cuda, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
# query heads a KV head the kernel is instantiated for (csrc/paged_attention.cu)
GROUPS = (1, 2, 4, 6, 7, 8, 16)
_SIGNATURES = {
    # q, q_f32, kp, vp, ppos, ks, vs, tables, kv_lens, q_pos, workspace,
    # out, out_bf16, B, Hq, Hkv, Dh, bytes per stored head vector,
    # block_size, MB, splits, pages per split, codec, causal, window,
    # softcap, stream
    "deca_paged_attention": (
        _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ),
}


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def paged_attention(
    q: torch.Tensor,                 # (B, Hq, Dh) one query token per slot
    pools: Dict[str, torch.Tensor],  # kp/vp/ppos (+ks/vs for scaled codecs)
    block_tables: torch.Tensor,      # (B, MB) device page ids (0 = null page)
    kv_lens: torch.Tensor,           # (B,) valid KV tokens per slot
    q_pos: torch.Tensor,             # (B,) query positions
    *,
    quant: str = "none",
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Decode attention of one query per slot over the paged pool."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(
            q, pools, block_tables, kv_lens, q_pos,
            quant=quant, causal=causal, window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    kp, vp, ppos = pools["kp"], pools["vp"], pools["ppos"]
    b, hq, dh = q.shape
    _, bs, hkv, w = kp.shape
    mb = block_tables.shape[1]
    quantized = quant not in ("none", "", None)
    codec = get_codec(quant) if quantized else None
    want = torch.uint8 if quantized else torch.bfloat16
    if kp.dtype != want or vp.dtype != want:
        raise ValueError(f"pool dtype {kp.dtype} does not match quant={quant!r}")
    if q.dtype not in (torch.bfloat16, torch.float32) or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} does not fit the pool")
    if w != (codec.kv_code_width(dh) if quantized else dh):
        raise ValueError(f"pool width {w} does not match head dim {dh}")
    scaled = quantized and codec.has_scale
    for t in (kp, vp, ppos) + ((pools["ks"], pools["vs"]) if scaled else ()):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError("pool planes must be contiguous and word-aligned on q's device")
    row_bytes = w * kp.element_size()
    if row_bytes % 4:
        raise ValueError(f"a stored head vector of {row_bytes} bytes is not whole words")
    if dh > 256 or hq // hkv not in GROUPS:
        raise ValueError(f"the kernel takes head dim <= 256 and {GROUPS} query heads "
                         f"a KV head, got {dh} and {hq // hkv}")
    splits, pps = autotune.attention_splits(mb, b, hkv)
    q = q.contiguous()
    tables, lens, qpos = _int32(block_tables), _int32(kv_lens), _int32(q_pos)
    # per (slot, KV head, split, query head): m, l and the Dh sums
    ws = torch.empty((b, hkv, splits, hq // hkv, dh + 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty((b, hq, dh), dtype=q.dtype, device=q.device)
    err = cuda.library("paged_attention", _SIGNATURES).deca_paged_attention(
        q.data_ptr(), int(q.dtype == torch.float32), kp.data_ptr(),
        vp.data_ptr(), ppos.data_ptr(),
        pools["ks"].data_ptr() if scaled else None,
        pools["vs"].data_ptr() if scaled else None,
        tables.data_ptr(), lens.data_ptr(), qpos.data_ptr(), ws.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv, dh, row_bytes, bs, mb,
        splits, pps, codec_wire_id(quant) if quantized else 0, int(causal), int(window),
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda.check(err, "deca_paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

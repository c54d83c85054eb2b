"""Layer library of the paged dense-attention decoder.

Counterpart of the subset of `repro/models/layers.py` that compressed-
weight paged serving of a dense GQA decoder runs: RMS norm, rotary
embeddings with per-request positions, grouped-query attention with f32
probabilities in the PV product, the block-paged quantized KV pool, and the
swiglu MLP. Functions take and return tensors; the paged pool is a dict of
tensors per layer and is updated in place (the reference returns a new pool
per write; in place saves a copy of every layer's pool per step).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.codecs import get_codec
from repro_torch.core.decompress import mm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import CACHE_EMPTY_POS

Params = Dict[str, object]


def dense_init(generator: torch.Generator, shape, device, dtype) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan_in), drawn in f32 on `device`."""
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w / math.sqrt(shape[0])).to(dtype)


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mixed-precision RMS norm: the sum of squares in f32, the per-row
    scale applied in the input dtype, gemma-style (1 + w) gain."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    ssq = (xf * xf).sum(dim=-1)
    scale = torch.rsqrt(ssq / d + eps)[..., None]
    return (x * scale.to(x.dtype)) * (1.0 + w).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head // 2, dtype=torch.float32, device=device) * 2 / d_head
    return 1.0 / (theta ** exps)


def apply_rope_batched(
    x: torch.Tensor,          # (B, S, H, Dh)
    positions: torch.Tensor,  # (B, S) int32 per-request positions
    theta: float,
) -> torch.Tensor:
    """RoPE with per-request positions; cos/sin computed in f32 and
    applied in the input dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[:, :, None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _scores_mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """Additive f32 mask (B, Sq, Sk) for per-request positions."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    # all True at the broadcast shape; torch.broadcast_shapes would import
    # sympy at its first call, some 3 s of a process's first prefill
    ok = torch.ones_like(dq, dtype=torch.bool) & torch.ones_like(dk, dtype=torch.bool)
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dk > dq - window)
    zero = torch.zeros((), device=q_pos.device)
    return torch.where(ok, zero, zero - 1e30)


def attention_core(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,  # (B, Sk, Hkv, Dh)
    *,
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Grouped-query attention, chunked over queries so peak memory is
    O(q_chunk * Sk). Scores in f32 from bf16 operands; the PV product
    accumulates f32 probabilities, the discipline of the fused decode
    kernel, so the prefill and decode paths agree to f32 tolerance."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    kf = k.to(torch.bfloat16).float()
    vf = v.float()
    outs = []
    for c0 in range(0, sq, q_chunk):
        qc = q[:, c0:c0 + q_chunk].reshape(b, -1, hkv, group, dh)
        scores = torch.einsum(
            "bqhgd,bkhd->bhgqk", qc.to(torch.bfloat16).float(), kf
        ) * scale
        if softcap > 0:
            scores = torch.tanh(scores / softcap) * softcap
        mask = _scores_mask(q_pos[:, c0:c0 + q_chunk], k_pos, causal, window)
        probs = torch.softmax(scores + mask[:, None, None], dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", probs, vf))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def kv_codec(quant: str):
    """KV-cache codec for a `kv_quant` name ('none' -> unquantized)."""
    if quant in ("none", "", None):
        return None
    codec = get_codec(quant)
    if not codec.kv_capable:
        raise ValueError(f"codec {quant!r} does not support KV-cache quantization")
    return codec


def _check_cache_quant(stored_dtype, codec, quant: str) -> None:
    if (codec is None) != stored_dtype.is_floating_point:
        raise ValueError(
            f"cache stores {stored_dtype} but quant={quant!r}; the cache "
            "must be initialized with the same kv_quant it is accessed with"
        )


def init_paged_kv_cache(
    num_blocks: int,
    block_size: int,
    hkv: int,
    dh: int,
    *,
    device,
    dtype=torch.bfloat16,
    quant: str = "none",
) -> Dict[str, torch.Tensor]:
    """Block-paged KV pool: `num_blocks` pages of `block_size` tokens.
    Page 0 is the null page (pad and inactive writes land there, masked by
    the position sentinel). Scaled codecs add `ks`/`vs` bf16 planes, one
    scale per (page, slot, head)."""
    codec = kv_codec(quant)
    if codec is None:
        kv_dtype, width = dtype, dh
    else:
        kv_dtype, width = torch.uint8, codec.kv_code_width(dh)
    shape = (num_blocks, block_size, hkv, width)
    pools = {
        "kp": torch.zeros(shape, dtype=kv_dtype, device=device),
        "vp": torch.zeros(shape, dtype=kv_dtype, device=device),
        "ppos": torch.full((num_blocks, block_size), CACHE_EMPTY_POS,
                           dtype=torch.int32, device=device),
    }
    if codec is not None and codec.has_scale:
        for name in ("ks", "vs"):
            pools[name] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=device)
    return pools


def paged_update_cache(
    cache: Dict[str, torch.Tensor],
    k: torch.Tensor,            # (B, S, Hkv, Dh)
    v: torch.Tensor,            # (B, S, Hkv, Dh)
    write_pos: torch.Tensor,    # (B, S) int32; CACHE_EMPTY_POS for pad tokens
    write_slots: torch.Tensor,  # (B, S) flat slot ids (page * bs + offset)
    fresh_pages: Optional[torch.Tensor] = None,  # (F,) page ids, 0 = none
    copy_pages: Optional[torch.Tensor] = None,   # (C, 2) (src, dst) page ids
    quant: str = "none",
) -> Dict[str, torch.Tensor]:
    """Scatter S tokens per request into the shared pool, in place.

    In the reference's order: copy-on-write clones (every plane of page src
    into page dst) first, then the fresh-page scrub of the position plane
    (a recycled page never leaks its old tenant's entries), then the
    scatter. Quantized pools encode on write."""
    codec = kv_codec(quant)
    _check_cache_quant(cache["kp"].dtype, codec, quant)
    ks = vs = None
    if codec is not None:
        k, ks = codec.kv_encode(k)
        v, vs = codec.kv_encode(v)
    if copy_pages is not None:
        src, dst = copy_pages[:, 0].long(), copy_pages[:, 1].long()
        for pool in cache.values():
            pool[dst] = pool[src]
    nb, bs = cache["kp"].shape[:2]
    flat = write_slots.reshape(-1).long()

    def scatter(name, updates):
        pool = cache[name]
        rows = pool.view((nb * bs,) + pool.shape[2:])
        rows[flat] = updates.reshape((-1,) + pool.shape[2:]).to(pool.dtype)

    scatter("kp", k)
    scatter("vp", v)
    if fresh_pages is not None:
        cache["ppos"].index_fill_(0, fresh_pages.long(), CACHE_EMPTY_POS)
    cache["ppos"].view(-1)[flat] = write_pos.reshape(-1).to(torch.int32)
    if ks is not None:
        scatter("ks", ks)
        scatter("vs", vs)
    return cache


def paged_gather_kv(
    cache: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,  # (B, MB) device page ids (0 = null page)
    quant: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each request's pages into a (B, MB*bs, Hkv, Dh) KV view plus
    per-request key positions; quantized pools decode on read."""
    codec = kv_codec(quant)
    _check_cache_quant(cache["kp"].dtype, codec, quant)
    tables = block_tables.long()
    b, mb = tables.shape
    k = cache["kp"][tables]  # (B, MB, bs, Hkv, W)
    v = cache["vp"][tables]
    pos = cache["ppos"][tables]  # (B, MB, bs)
    bs = pos.shape[2]
    k = k.reshape(b, mb * bs, *k.shape[3:])
    v = v.reshape(b, mb * bs, *v.shape[3:])
    if codec is not None:
        ks = vs = None
        if codec.has_scale:
            ks = cache["ks"][tables].reshape(b, mb * bs, -1)
            vs = cache["vs"][tables].reshape(b, mb * bs, -1)
        k = codec.kv_decode(k, ks).to(torch.bfloat16)
        v = codec.kv_decode(v, vs).to(torch.bfloat16)
    return k, v, pos.reshape(b, mb * bs)


def init_attention(generator, cfg: ModelConfig, device, dtype) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": dense_init(generator, (d, hq * dh), device, dtype),
        "wk": dense_init(generator, (d, hkv * dh), device, dtype),
        "wv": dense_init(generator, (d, hkv * dh), device, dtype),
        "wo": dense_init(generator, (hq * dh, d), device, dtype),
    }


def paged_attention_block(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,     # (B, S) per-request positions
    local: bool,
    cache: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,  # (B, MB)
    write_slots: torch.Tensor,   # (B, S)
    write_pos: torch.Tensor,     # (B, S)
    fresh_pages: Optional[torch.Tensor] = None,  # (F,)
    kv_lens: Optional[torch.Tensor] = None,      # (B,) valid KV tokens per slot
    copy_pages: Optional[torch.Tensor] = None,   # (C, 2)
    window_override: Optional[int] = None,       # cap the window (spec draft)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention layer against the paged pool: projections -> per-request
    rope -> write into the pool -> attention -> output projection.

    Decode shapes (S == 1 with a `kv_lens` vector) go through the fused
    paged-attention kernel, which decodes the quantized pages inside its
    walk; prefill and the spec verify (S = k+1) read a gathered view
    through `attention_core`. `window_override` caps the attention window
    of the spec-decode draft passes, so their walk is O(window); verify
    never sets it, so acceptance stays exact."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = mm(x, params["wq"]).reshape(b, s, hq, dh)
    k = mm(x, params["wk"]).reshape(b, s, hkv, dh)
    v = mm(x, params["wv"]).reshape(b, s, hkv, dh)
    q = apply_rope_batched(q, positions, cfg.rope_theta)
    k = apply_rope_batched(k, positions, cfg.rope_theta)

    cache = paged_update_cache(
        cache, k, v, write_pos, write_slots, fresh_pages, copy_pages,
        quant=cfg.kv_quant,
    )
    window = cfg.window if local else 0
    if window_override:
        window = min(window, window_override) if window else window_override
    if kv_lens is not None and s == 1:
        out = ops.paged_attention(
            q[:, 0], cache, block_tables, kv_lens, positions[:, 0],
            quant=cfg.kv_quant, causal=cfg.causal, window=window,
            softcap=cfg.attn_softcap,
        )[:, None]
    else:
        k_all, v_all, k_pos = paged_gather_kv(cache, block_tables, cfg.kv_quant)
        out = attention_core(
            q, k_all, v_all, q_pos=positions, k_pos=k_pos,
            causal=cfg.causal, window=window, softcap=cfg.attn_softcap,
        )
    return mm(out.reshape(b, s, hq * dh), params["wo"]), cache


def init_mlp(generator, cfg: ModelConfig, device, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(generator, (d, f), device, dtype),
        "w_up": dense_init(generator, (d, f), device, dtype),
        "w_down": dense_init(generator, (f, d), device, dtype),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as `jax.nn.silu` computes it, each op rounded in the
    input dtype: x * (1 / (1 + exp(-x)))."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_block(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """swiglu FFN: silu(x Wg) * (x Wu), then W_down."""
    h = silu(mm(x, params["w_gate"])) * mm(x, params["w_up"])
    return mm(h, params["w_down"])

"""Layer library of the port's decoders.

Counterpart of the subset of `repro/models/layers.py` that compressed-
weight serving runs: RMS norm, rotary embeddings with per-request
positions (off under learned positions) and Qwen2-VL's M-RoPE on three
position streams, grouped-query attention (causal or bidirectional) with f32
probabilities in the PV product over the block-paged quantized KV pool
(the paged engine) or the quantized ring cache (the dense engine), the
swiglu, geglu, gelu and relu MLPs, the top-k MoE FFN with capacity dispatch,
the RG-LRU recurrent block (Griffin, recurrentgemma), the Mamba-1 block
(falcon-mamba), and the tied head's logits. Functions take and return
tensors; the paged pool, the ring cache and the recurrent state are dicts
of tensors per layer and are updated in place (the reference returns new
ones per write; in place saves a copy of every layer's cache per step).

Under a serving mesh (`dist.sharding.serve_ctx`) the attention blocks
(paged and ring), the MLP, the MoE experts, the Mamba-1 and RG-LRU blocks
(on this rank's channel block), the embedding lookup and the logits run on
this rank's shards:
the reference's `constrain` sites become `sharding.constrain_local` on
local tensors, and `tp_mm` is the matmul of a column-parallel weight
(local columns out), a row-parallel one (f32 partial products summed over
the mesh axis and rounded once) or a replicated one. Under fsdp every FC
leaf holds its `data` share between steps and is gathered whole at its
point of use (`sharding.gathered`: in `tp_mm`, once a call for an expert
stack, for the tied head); the embedding gathers the rows it looked up.
With no mesh every one of them is the plain computation.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.codecs import get_codec
from repro_torch.core.compression import CompressedTensor, compress_stacked
from repro_torch.core.decompress import eligible, mm
from repro_torch.core.formats import CompressionSpec
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import active_ctx
from repro_torch.kernels import ops
from repro_torch.kernels.ref import CACHE_EMPTY_POS

Params = Dict[str, object]


def dense_init(generator: torch.Generator, shape, device, dtype) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan_in), drawn in f32 on `device`.
    On the meta device only the shape and dtype exist: no draw (a meta
    draw costs ~0.2 ms, 70 000 of them at kimi-k2's experts)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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


def apply_mrope(
    x: torch.Tensor,          # (B, S, H, Dh)
    positions: torch.Tensor,  # (3, B, S) temporal / height / width ids
    theta: float,
    sections: Tuple[int, ...],
) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: frequency i of the rotary half-dim
    turns by the position stream of its section (`repeat(arange(3),
    sections)`, cut or padded with the last id to Dh/2, as
    `jnp.repeat(total_repeat_length=)`). x is rotated in f32 with f32
    cos / sin and cast back to its dtype; `apply_rope_batched` rounds cos
    / sin to x's dtype instead, so the two differ even on equal streams.
    The angles gather their streams as views, not through an index
    tensor, so nothing is copied from the host inside a captured step."""
    half = x.shape[-1] // 2
    ids = [i for i, n in enumerate(sections) for _ in range(n)][:half]
    ids += ids[-1:] * (half - len(ids))
    pos = positions.to(torch.float32)  # (3, B, S)
    angles = torch.stack([pos[i] for i in ids], dim=-1) * rope_freqs(
        2 * half, theta, x.device)  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rotate(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """q and k rotated for `cfg` at `positions` (B, S) or (3, B, S), and
    the token positions (B, S) that the cache, the mask and the kernel
    read. M-RoPE (`mrope_sections`) broadcasts (B, S) to three equal
    streams and takes the temporal one, stream 0, as the token's
    position; rope rotates by the positions themselves (stream 0 of three);
    learned or no positions leave q and k as they are."""
    if cfg.mrope_sections:
        mpos = positions if positions.dim() == 3 else positions.expand(3, *positions.shape)
        return (apply_mrope(q, mpos, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, mpos, cfg.rope_theta, cfg.mrope_sections), mpos[0])
    tok_pos = positions if positions.dim() == 2 else positions[0]
    if cfg.pos_emb == "rope":  # learned positions were added to the embedding
        q = apply_rope_batched(q, tok_pos, cfg.rope_theta)
        k = apply_rope_batched(k, tok_pos, cfg.rope_theta)
    return q, k, tok_pos


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


def init_kv_cache(
    b: int,
    size: int,
    hkv: int,
    dh: int,
    *,
    device,
    dtype=torch.bfloat16,
    quant: str = "none",
) -> Dict[str, torch.Tensor]:
    """Ring KV cache of the dense engine: `size` rounded up to a multiple
    of 32 slots per row, a position plane shared by the batch (empty slots
    carry the sentinel) and the tokens written so far, `length`, a device
    scalar. Quantized caches store codes (packed for 4-bit codecs); scaled
    codecs add `k_scale`/`v_scale`, one bf16 scale per (row, slot, head)."""
    size = (size + 31) // 32 * 32
    codec = kv_codec(quant)
    if codec is None:
        kv_dtype, width = dtype, dh
    else:
        kv_dtype, width = torch.uint8, codec.kv_code_width(dh)
    shape = (b, size, hkv, width)
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "pos": torch.full((size,), CACHE_EMPTY_POS, dtype=torch.int32, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
    if codec is not None and codec.has_scale:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=device)
    return cache


def update_cache(
    cache: Dict[str, torch.Tensor],
    k: torch.Tensor,    # (B, S, Hkv, Dh)
    v: torch.Tensor,    # (B, S, Hkv, Dh)
    pos: torch.Tensor,  # (S,) positions shared by the batch
    quant: str = "none",
) -> Dict[str, torch.Tensor]:
    """Append S tokens to the ring, in place. Masking is by position, so
    the slot order is free and a windowed cache wraps. S at or past the
    ring's size keeps the last `size` tokens (the reference's static
    prefill branch); otherwise the tokens land at `length % size`, the
    start clamped so the S slots fit (`dynamic_update_slice`), from a
    device index: nothing waits on the host. Quantized caches encode on
    write."""
    codec = kv_codec(quant)
    _check_cache_quant(cache["k"].dtype, codec, quant)
    ks = vs = None
    if codec is not None:
        k, ks = codec.kv_encode(k)
        v, vs = codec.kv_encode(v)
    size, s = cache["k"].shape[1], k.shape[1]
    new = {"k": k, "v": v, "pos": pos, "k_scale": ks, "v_scale": vs}
    if s >= size:
        for name, t in new.items():
            if t is not None:
                cache[name].copy_(t[-size:] if name == "pos" else t[:, -size:])
    else:
        start = torch.clamp(cache["length"] % size, max=size - s)
        idx = start + torch.arange(s, device=start.device)
        for name, t in new.items():
            if t is not None:
                cache[name].index_copy_(0 if name == "pos" else 1, idx,
                                        t.to(cache[name].dtype))
    cache["length"].add_(s)
    return cache


def read_cache_kv(
    cache: Dict[str, torch.Tensor], quant: str = "none"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantize-on-read of the ring cache, to bf16 (the planes
    themselves when unquantized)."""
    codec = kv_codec(quant)
    _check_cache_quant(cache["k"].dtype, codec, quant)
    if codec is None:
        return cache["k"], cache["v"]
    return (codec.kv_decode(cache["k"], cache.get("k_scale")).to(torch.bfloat16),
            codec.kv_decode(cache["v"], cache.get("v_scale")).to(torch.bfloat16))


def tp_mm(x: torch.Tensor, w, have: Optional[str] = None, axes=None):
    """x (..., K) @ w (K, N) -> (y, the mesh axis y's last dim is split
    over). Under a serving mesh, `have` is the axis x's last dim is split
    over (None: whole); x is first gathered or cut to w's K layout, which
    `axes` (K axis, N axis) gives for a weight `local_tree` did not
    register (an expert's `pick` of a stacked leaf, which the caller
    gathered). A weight `local_tree` registered is gathered whole over
    `data` first under fsdp (`sharding.gathered`) and released after the
    product. A K
    split over an axis is a row-parallel weight whose partial products are
    summed over the axis as the reference's partitioned dot sums them: a
    compressed product's in f32 (its accumulator type), rounded once to
    x's dtype after the sum (a bf16 partial would round twice); a dense
    one's in the product's own dtype. With no mesh it is `mm(x, w)`."""
    ctx = sh.serve_ctx()
    if ctx is None:
        return mm(x, w), None
    if axes is None:
        with sh.gathered(w, ctx) as whole:
            return _tp_mm(x, whole, have, sh.matmul_axes(whole, ctx), ctx)
    return _tp_mm(x, w, have, axes, ctx)


def _tp_mm(x: torch.Tensor, w, have: Optional[str], axes, ctx):
    k_ax, n_ax = axes
    if have != k_ax:
        last = (None,) * (x.dim() - 1)
        x = sh.relayout(x, last + (have,), last + (k_ax,), ctx)
    if k_ax is None or not isinstance(w, CompressedTensor):
        y = mm(x, w)
        return (y if k_ax is None else sh.all_reduce(y, k_ax, ctx)), n_ax
    part = ops.decompress_gemm(x, w, out_dtype=torch.float32)
    return sh.all_reduce(part, k_ax, ctx).to(x.dtype), n_ax


def _heads(x: torch.Tensor, w, n_heads: int, dh: int, row_ax: Optional[str]):
    """A column-parallel projection of x as per-head vectors (B, S, H, Dh)
    in the `bshd` layout: (local block, its spec). Under a mesh a product
    whose N split cuts a head is gathered whole first: a rank never
    reads half a head."""
    y, n_ax = tp_mm(x, w)
    ctx = sh.serve_ctx()
    if n_ax is not None and n_heads % ctx.axis_sizes[n_ax]:
        y, n_ax = sh.all_gather(y, n_ax, ctx, -1), None
    b, s = y.shape[:2]
    y = y.reshape(b, s, -1, dh)
    return sh.constrain_local(y, "bshd", (row_ax, None, n_ax, None))


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
    positions: torch.Tensor,     # (B, S) or (3, B, S) per-request positions
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
    rope (M-RoPE on three streams: the pool, the mask and the kernel take
    the temporal one) -> write into the pool -> attention -> output
    projection.

    Decode shapes (S == 1 with a `kv_lens` vector) go through the fused
    paged-attention kernel, which decodes the quantized pages inside its
    walk; prefill and the spec verify (S = k+1) read a gathered view
    through `attention_core`. `window_override` caps the attention window
    of the spec-decode draft passes, so their walk is O(window); verify
    never sets it, so acceptance stays exact."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    ctx = sh.serve_ctx()
    rows = write_slots.shape[0]  # the whole batch; x holds this rank's rows
    row_ax = sh.batch_axis(rows, ctx)
    q, q_spec = _heads(x, params["wq"], hq, dh, row_ax)
    k, kv_spec = _heads(x, params["wk"], hkv, dh, row_ax)
    v, _ = _heads(x, params["wv"], hkv, dh, row_ax)
    if q_spec[2] != kv_spec[2]:
        # the KV heads stay whole where the mesh does not divide them:
        # every query head then attends on every rank
        q_spec, q = kv_spec, sh.relayout(q, q_spec, kv_spec, ctx)
    q, k, tok_pos = rotate(q, k, positions, cfg)

    # every rank's pool is a replica over the batch axis: it takes the new
    # K/V of every row (its own heads of them)
    if ctx is not None:
        whole = (None,) + kv_spec[1:]
        k, v = sh.relayout(k, kv_spec, whole, ctx), sh.relayout(v, kv_spec, whole, ctx)
    cache = paged_update_cache(
        cache, k, v, write_pos, write_slots, fresh_pages, copy_pages,
        quant=cfg.kv_quant,
    )
    block_tables = sh.local_rows(block_tables, rows, ctx)
    window = cfg.window if local else 0
    if window_override:
        window = min(window, window_override) if window else window_override
    if kv_lens is not None and s == 1:
        out = ops.paged_attention(
            q[:, 0], cache, block_tables, sh.local_rows(kv_lens, rows, ctx), tok_pos[:, 0],
            quant=cfg.kv_quant, causal=cfg.causal, window=window,
            softcap=cfg.attn_softcap,
        )[:, None]
    else:
        k_all, v_all, k_pos = paged_gather_kv(cache, block_tables, cfg.kv_quant)
        out = attention_core(
            q, k_all, v_all, q_pos=tok_pos, k_pos=k_pos,
            causal=cfg.causal, window=window, softcap=cfg.attn_softcap,
        )
    return tp_mm(out.reshape(b, s, -1), params["wo"], q_spec[2])[0], cache


def attention_block(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S), or (3, B, S) for M-RoPE
    local: bool,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    rows: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention layer of the dense engine: projections -> rope ->
    (ring-cache write and dequantize-on-read) -> attention -> output
    projection. The batch shares one row of token positions, as the
    reference's synthetic batches do; `attention_core` takes them per row,
    broadcast. Rope rotates by that shared row, M-RoPE by each row's own
    three streams (the reference's `apply_rope` and `apply_mrope`), and the
    ring and the mask take the temporal stream of row 0. With no cache, the
    queries attend to their own keys.

    Under a serving mesh (`rows`: the whole batch's rows, of which x holds
    this rank's share over `data`) it is the paged block's layout: q, k
    and v in this rank's heads, the KV heads whole where the mesh does not
    divide them (every query head then attends on every rank), and the
    ring holds this rank's rows and KV heads (`Model.init_cache`); wo is
    row-parallel over the heads q came in."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    ctx = sh.serve_ctx()
    row_ax = sh.batch_axis(b if rows is None else rows, ctx)
    q, q_spec = _heads(x, params["wq"], hq, dh, row_ax)
    k, kv_spec = _heads(x, params["wk"], hkv, dh, row_ax)
    v, _ = _heads(x, params["wv"], hkv, dh, row_ax)
    if q_spec[2] != kv_spec[2]:
        q_spec, q = kv_spec, sh.relayout(q, q_spec, kv_spec, ctx)
    if not cfg.mrope_sections:
        positions = (positions if positions.dim() == 2 else positions[0])[:1].expand(b, s)
    q, k, tok_pos = rotate(q, k, positions, cfg)
    q_pos = tok_pos[:1].expand(b, s)
    if cache is not None:
        cache = update_cache(cache, k, v, tok_pos[0], quant=cfg.kv_quant)
        k, v = read_cache_kv(cache, quant=cfg.kv_quant)
        k_pos = cache["pos"][None].expand(b, -1)
    else:
        k_pos = q_pos
    out = attention_core(
        q, k, v, q_pos=q_pos, k_pos=k_pos, causal=cfg.causal,
        window=cfg.window if local else 0, softcap=cfg.attn_softcap,
    )
    return tp_mm(out.reshape(b, s, -1), params["wo"], q_spec[2])[0], cache


_GATED = ("swiglu", "geglu")


def init_mlp(generator, cfg: ModelConfig, device, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act not in _GATED:  # relu and gelu have no gate
        return {
            "w_up": dense_init(generator, (d, f), device, dtype),
            "w_down": dense_init(generator, (f, d), device, dtype),
        }
    return {
        "w_gate": dense_init(generator, (d, f), device, dtype),
        "w_up": dense_init(generator, (d, f), device, dtype),
        "w_down": dense_init(generator, (f, d), device, dtype),
    }


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA expands it, each op rounded in the input
    dtype: 1 / (1 + exp(-x)). `torch.sigmoid` is another formula."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as `jax.nn.silu` computes it, each op rounded in the
    input dtype: x * (1 / (1 + exp(-x)))."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, which is `jnp.logaddexp(x, 0)`, op for op:
    max(x, 0) + log1p(exp(-|x|)), and x itself where x is NaN.
    `torch.nn.functional.softplus` returns x above a threshold instead."""
    body = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, body)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def _const(value: float, like: torch.Tensor) -> float:
    """A scalar rounded to `like`'s dtype first, as JAX rounds a weakly
    typed Python float (or a numpy scalar cast with `astype`) to the
    array's dtype before the op. It stays a Python float, exact in that
    dtype (torch computes `tensor op scalar` in f32 and rounds once, as
    an op of two bf16 operands), so no device tensor is made inside a
    captured decode step."""
    return _rounded(float(value), like.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of gelu as `jax.nn.gelu` (approximate=True,
    its default) computes it, each op rounded in the input dtype with its
    constants rounded to that dtype first:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * (x * (x * x)))))).
    `torch.nn.functional.gelu(approximate="tanh")` rounds a bf16 input only
    once, at the end, so it differs in the last bf16 bit; on f32 the two
    agree to f32 rounding."""
    cube = x * (x * x)  # lax.integer_pow(x, 3): x times its square
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * cube)
    cdf = _const(0.5, x) * (_const(1.0, x) + torch.tanh(inner))
    return x * cdf


# the reference's `_act`: silu for swiglu, gelu (tanh) for geglu and gelu, relu
_ACTS = {"swiglu": silu, "geglu": gelu_tanh, "gelu": gelu_tanh, "relu": torch.relu}


def mlp_block(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """swiglu FFN: silu(x Wg) * (x Wu), then W_down; geglu: gelu_tanh(x Wg)
    * (x Wu), then W_down; the ungated gelu and relu FFNs: act(x Wu), then
    W_down. Each op rounds in the product's dtype, as the reference's.
    Under a serving mesh the hidden (B, S, F) keeps w_up's column split
    (the reference's `bsf`), and `tp_mm` brings it to w_down's K layout."""
    if cfg.mlp_act in _GATED:
        gate, _ = tp_mm(x, params["w_gate"])
        up, ax = tp_mm(x, params["w_up"])
        h = _ACTS[cfg.mlp_act](gate) * up
    else:
        up, ax = tp_mm(x, params["w_up"])
        h = _ACTS[cfg.mlp_act](up)
    return tp_mm(h, params["w_down"], ax)[0]


def init_moe(generator, cfg: ModelConfig, device, dtype, *,
             spec: Optional[CompressionSpec] = None, stack: int = 1) -> Params:
    """The reference's `init_moe` leaves: an f32 (d, E) router and (E, K,
    N) expert weights, each expert drawn as `dense_init` draws a (K, N)
    weight, in the reference's leaf order (router, w_up, w_down, w_gate).
    With `spec`, an eligible expert weight (`decompress.eligible`, `stack`
    the layers the reference stacks) is compressed one expert at a time as
    it is drawn, into one expert-stacked leaf: at grok-1 width a dense
    (E, K, N) weight is 3.2 GB of bf16, and it never exists whole."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(name, k, n):
        draw = lambda _: dense_init(generator, (k, n), device, dtype)
        if spec is not None and eligible(f"moe/{name}", (e, k, n), spec, stack):
            return compress_stacked(draw, e, spec)
        return torch.stack([draw(i) for i in range(e)])

    p = {"router": dense_init(generator, (d, e), device, torch.float32),
         "w_up": experts("w_up", d, f), "w_down": experts("w_down", f, d)}
    if cfg.mlp_act in _GATED:
        p["w_gate"] = experts("w_gate", d, f)
    return p


def _dispatch_groups(t: int, split: Optional[int] = None) -> int:
    """Group-local dispatch shards of this process's `t` tokens. The
    reference takes the active mesh's batch sharding (pod x data), halved
    until it divides the tokens, so routing sorts stay shard-local, and 1
    outside a mesh. A process that holds only its block of the batch's
    rows (`split` blocks: `ShardingCtx.batch_split` by default, the
    data-parallel trainer's; a serving rank's rows over `data`) holds a
    run of whole reference groups: it takes its share of them, so a token
    sees the reference's group."""
    ctx = active_ctx()
    if ctx is None:
        return 1
    sizes = ctx.axis_sizes
    split = ctx.batch_split if split is None else split
    g = sizes.get("pod", 1) * sizes.get("data", 1)
    while g > 1 and (t * split) % g:
        g //= 2
    g = max(1, g)
    if g % split:
        raise ValueError(f"{g} dispatch groups do not split into {split} row blocks")
    return g // split


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` along the last axis: the k largest, in descending
    order, the lower index first among equal values. `torch.topk` promises
    no order among ties; a stable descending sort keeps the input order of
    equal values, and its first k are the reference's."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert(w, i: int):
    """Expert i's (K, N) weight: a 2-D triplet of a stacked compressed
    leaf (its planes are views) or a slice of a dense (E, K, N) one."""
    return w.pick(i) if isinstance(w, CompressedTensor) else w[i]


def _stack_mm(w, xs, serve, have: Optional[str] = None):
    """Every local expert's product with one stacked leaf: xs[slot][j] @
    expert j of `w` for each routing slot, through `tp_mm` (the DECA GeMV
    at G cap <= 32 rows, else the GeMM) on the leaf's (K, N) axes:
    (None, None) with no mesh or an expert dim split over `model`; where E
    does not divide `model`, every rank holds every expert as column- and
    row-parallel shards, whose hidden stays split as the MLP's does.
    Under fsdp the stack is gathered whole over `data` once for all slots
    and released before the next stack's gather. Returns (the products
    per slot, the axis their last dim is split over)."""
    with sh.gathered(w, serve) as whole:
        axes = sh.matmul_axes(whole, serve)
        ys = [[tp_mm(x, _expert(whole, j), have, axes=axes)[0] for j, x in enumerate(row)]
              for row in xs]
    return ys, axes[1]


def _expert_ffns(params: Params, xs, cfg: ModelConfig, serve) -> list:
    """The local experts' FFNs on their capacity bins, xs[slot][j] (G,
    cap, D) for local expert j: one (E local, G, cap, D) output per slot.
    Each stacked leaf's products run together (`_stack_mm`), so each
    stack is read, and under fsdp gathered, once a call."""
    act = _ACTS[cfg.mlp_act]
    up, ax = _stack_mm(params["w_up"], xs, serve)
    if "w_gate" in params:
        gate, _ = _stack_mm(params["w_gate"], xs, serve)
        h = [[act(g) * u for g, u in zip(gs, us)] for gs, us in zip(gate, up)]
    else:
        h = [[act(u) for u in us] for us in up]
    ys, _ = _stack_mm(params["w_down"], h, serve, ax)
    return [torch.stack(row) for row in ys]


def moe_block(params: Params, x: torch.Tensor, cfg: ModelConfig,
              rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice MoE with capacity dispatch: the reference's
    `moe_block`, op for op, returning (out (B, S, D), aux).

    f32 router logits, softmax, top-k (ties to the lower expert) and the
    gates renormalised; the Switch-style load-balancing aux over all
    tokens. Per routing slot, in slot order: a stable sort of the tokens
    by expert, each token's rank in its expert's bin by `searchsorted`
    (side left), a bin of `cap` rows per expert and one pad row (E cap)
    that takes every token past its bin's capacity and is thrown away;
    each expert's FFN on its whole bin, empty rows and empty bins included,
    so every shape is fixed by (B, S) and nothing waits on the host (a
    decode chunk captures whole; the slots' bins are made first, and each
    stacked leaf's products run for every slot together); then each
    token's output times its gate
    (zero when dropped), cast to x's dtype, and added to the running
    output in x's dtype. `cap = max(4, ceil(tokens / E * capacity_factor))`
    is host arithmetic on the static shape. The only scatter with repeated
    indices writes the pad row, whose value is never read, so the output
    does not depend on which write wins.

    Under a serving mesh (`rows`: the whole batch's rows, of which x
    holds this rank's share over `data`) the routing runs on tokens that
    are whole over `model`, the same on every `model` rank, in the
    reference's dispatch groups; each rank runs the FFNs of its own
    experts only (`sharding.expert_range`) and gathers the (E, G, cap, D)
    outputs over `model` before the combine. Each expert runs whole on
    one rank, so the output is the unsharded block's for the same groups:
    no sum crosses ranks. Under fsdp each stack's K over `data` is
    gathered whole once a call (`_stack_mm`). The aux loss is not read
    there, and a serving ctx has no batch axes: it sums nothing across
    ranks."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    serve = sh.serve_ctx()
    row_split = None
    if serve is not None:
        row_ax = sh.batch_axis(b if rows is None else rows, serve)
        row_split = 1 if row_ax is None else serve.axis_sizes[row_ax]
    g = _dispatch_groups(t, row_split)
    tl = t // g  # tokens per dispatch group
    dev = x.device
    xf = x.reshape(g, tl, d)

    logits = torch.matmul(xf.to(torch.float32), params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)  # (G, Tl, E)
    gate_vals, expert_idx = top_k(probs, k)  # (G, Tl, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))  # (E,)
    ones = torch.ones(expert_idx.numel(), dtype=torch.float32, device=dev)
    counts = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, expert_idx.reshape(-1), ones)
    ctx = active_ctx()
    split = 1 if ctx is None else ctx.batch_split
    if split > 1:
        # the reference's aux is over every group: sum the counts and
        # average the equal-sized blocks' means over the ranks; the value
        # is the global one, the gradient this rank's share of it (the
        # step sums the ranks' gradients)
        counts = ctx.batch_all_reduce(counts)
        me_all = ctx.batch_all_reduce(me.detach().clone()) / split
        me = me_all + (me - me.detach()) / split
    ce = counts / (t * split * k)
    aux = e * torch.sum(me * ce)

    # capacity floor of 4 keeps tiny decode batches drop-free
    cap = max(4, int(math.ceil(tl / e * cfg.capacity_factor)))
    gi = torch.arange(g, device=dev)[:, None]
    rank = torch.arange(tl, device=dev)[None, :]
    pad = torch.zeros((g, 1, d), dtype=x.dtype, device=dev)
    out = torch.zeros((g, tl, d), dtype=x.dtype, device=dev)
    mine, e_ax = sh.expert_range(params["w_up"], serve)
    bins = []
    for slot in range(k):
        eid = expert_idx[:, :, slot]  # (G, Tl)
        order = torch.sort(eid, dim=1, stable=True).indices
        sorted_eid = torch.gather(eid, 1, order)
        seg_start = torch.searchsorted(sorted_eid, sorted_eid, side="left")
        pos = rank - seg_start  # rank within the expert's bin
        keep = pos < cap
        dest = torch.where(keep, sorted_eid * cap + pos, e * cap)  # drop -> pad row
        xg = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=dev)
        xg[gi, dest] = xf[gi, order]
        xe = xg[:, :-1].reshape(g, e, cap, d).transpose(0, 1)  # (E, G, cap, D)
        bins.append((order, keep, dest, [xe[i] for i in mine]))
    outs = _expert_ffns(params, [b[3] for b in bins], cfg, serve)
    for slot, ((order, keep, dest, _), ye) in enumerate(zip(bins, outs)):
        gates = gate_vals[:, :, slot]
        if e_ax is not None:  # every rank's experts: the reference's `egcd`
            ye = sh.all_gather(ye, e_ax, serve, 0)
        yflat = torch.cat([ye.transpose(0, 1).reshape(g, e * cap, d), pad], dim=1)
        y_tok = yflat[gi, dest]  # (G, Tl, D)
        gathered = torch.gather(gates, 1, order)
        weighted = (y_tok * (gathered * keep)[:, :, None]).to(x.dtype)
        contrib = torch.zeros((g, tl, d), dtype=x.dtype, device=dev)
        contrib[gi, order] = weighted
        out = out + contrib
    return out.reshape(b, s, d), aux


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `table` (V, D) for `tokens`. Under a serving mesh the
    table is row-parallel, split over the vocab: each rank looks up the
    tokens its block holds, zeros elsewhere, and the blocks are summed
    over the axis, one nonzero row each, so the sum is the row itself in
    the table's dtype (the reference's bf16 result). Under fsdp D is split
    over `data` too: the rows of the local D block are looked up and
    gathered whole, the same bytes as a lookup in the gathered table.
    `tokens` must be the same on every rank (the whole batch)."""
    ctx = sh.serve_ctx()
    v_ax, d_ax = sh.matmul_axes(table, ctx)
    if v_ax is None:
        rows = table[tokens.long()]
    else:
        n = table.shape[0]
        idx = tokens.long() - sh.block_start(n, v_ax, ctx)
        hit = (idx >= 0) & (idx < n)
        rows = table[torch.clamp(idx, 0, n - 1)] * hit[..., None].to(table.dtype)
        rows = sh.all_reduce(rows, v_ax, ctx)
    return rows if d_ax is None else sh.all_gather(rows, d_ax, ctx, -1)


def embed_scale(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """Gemma's embedding scale: the gathered rows times sqrt(d_model) in
    the embedding's dtype, the constant rounded to that dtype first, as
    the reference's multiply by a weakly typed Python float."""
    return x * _const(math.sqrt(d_model), x)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """cap * tanh(logits / cap) in the logits' dtype (f32 for the final
    logits): the reference's final logit softcap."""
    return torch.tanh(logits / cap) * cap


def _tied_mm(x2: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    if x2.device.type == "cuda":
        return torch.mm(x2, embed.t(), out_dtype=torch.float32)
    return x2.float() @ embed.float().t()


class _TiedHead(torch.autograd.Function):
    """The tied head with the reference's gradients: its einsum's transpose
    rules multiply the f32 cotangent by the operands in f32 and round each
    gradient once to its operand's dtype."""

    @staticmethod
    def forward(ctx, x2, embed):
        ctx.save_for_backward(x2, embed)
        return _tied_mm(x2, embed)

    @staticmethod
    def backward(ctx, g):
        x2, embed = ctx.saved_tensors
        gx = (g @ embed.float()).to(x2.dtype) if ctx.needs_input_grad[0] else None
        ge = (g.t() @ x2.float()).to(embed.dtype) if ctx.needs_input_grad[1] else None
        return gx, ge


def tied_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Logits of a tied head: x (..., D) bf16 against `embed` (V, D) bf16,
    the products exact and summed in f32 into an f32 result (the
    reference's einsum with `preferred_element_type=f32`). On the card one
    cuBLAS GEMM reads the bf16 table and writes f32; on the CPU the same
    sum runs over f32 copies of the operands. Under autograd the
    gradients are the reference's (`_TiedHead`)."""
    out = _TiedHead.apply(x.reshape(-1, x.shape[-1]), embed)
    return out.reshape(*x.shape[:-1], embed.shape[0])


# ---------------------------------------------------------------------------
# the recurrent blocks: RG-LRU (Griffin / recurrentgemma) and Mamba-1
# ---------------------------------------------------------------------------

def _softplus_inverse(value: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.expm1(value))


def init_rglru(generator, cfg: ModelConfig, device, dtype) -> Params:
    """The reference's `init_rglru` leaves: bf16 projections, an f32
    depthwise conv, zero f32 gate biases and `a_param` = softplus^-1 of
    linspace(0.9, 0.999) ** (1 / 8), so a = sigmoid-gated decay starts
    near 0.9-0.999 (Griffin's c = 8)."""
    d, r = cfg.d_model, cfg.lru_width or cfg.d_model
    f32 = torch.float32
    lin = torch.linspace(0.9, 0.999, r, dtype=f32, device=device)
    return {
        "w_in": dense_init(generator, (d, r), device, dtype),
        "w_gate_branch": dense_init(generator, (d, r), device, dtype),
        "conv_w": dense_init(generator, (cfg.ssm_conv, r), device, f32),
        "w_a": dense_init(generator, (r, r), device, dtype),
        "w_x": dense_init(generator, (r, r), device, dtype),
        "b_a": torch.zeros(r, device=device),
        "b_x": torch.zeros(r, device=device),
        "a_param": _softplus_inverse(lin ** (1 / 8.0)),
        "w_out": dense_init(generator, (r, d), device, dtype),
    }


def init_mamba(generator, cfg: ModelConfig, device, dtype) -> Params:
    """The reference's `init_mamba` leaves: bf16 in/x/dt/out projections,
    an f32 depthwise conv with its bias, `dt_bias` = softplus^-1(0.01),
    `a_log` = log(1..state) per channel (S4D-real) and a unit D skip."""
    d, di, st, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    f32 = torch.float32
    a_init = torch.arange(1, st + 1, dtype=f32, device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(generator, (d, 2 * di), device, dtype),
        "conv_w": dense_init(generator, (cfg.ssm_conv, di), device, f32),
        "conv_b": torch.zeros(di, device=device),
        "x_proj": dense_init(generator, (di, dr + 2 * st), device, dtype),
        "dt_proj": dense_init(generator, (dr, di), device, dtype),
        "dt_bias": _softplus_inverse(torch.full((di,), 0.01, device=device)),
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(di, device=device),
        "out_proj": dense_init(generator, (di, d), device, dtype),
    }


def causal_conv(u: torch.Tensor, conv_w: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]]):
    """Depthwise causal conv1d along time as the reference's ck shifted
    f32 products summed in its order (no (B, S, ck, R) tensor): u (B, S,
    R) after the state's last ck - 1 inputs (zeros without a state).
    Returns (f32 sum (B, S, R), the new conv buffer: the last ck - 1
    inputs)."""
    ck, s = conv_w.shape[0], u.shape[1]
    if state is not None:
        head = state["conv"].to(u.dtype)
    else:
        head = torch.zeros((u.shape[0], ck - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    u_ext = torch.cat([head, u], dim=1)
    acc = sum(u_ext[:, i:i + s].to(torch.float32) * conv_w[i] for i in range(ck))
    return acc, u_ext[:, -(ck - 1):]


def _channel_mm(x: torch.Tensor, w, ch: Optional[str], have: Optional[str] = None):
    """x @ w for a column-parallel weight as this rank's channel block
    (`ch`, `sharding.channel_axis`): the product's own N split relaid to
    the block (the same split wherever both divide). `have` is the axis x's
    last dim is split over; x is gathered whole for the contraction."""
    y, n_ax = tp_mm(x, w, have)
    if n_ax == ch:
        return y
    last = (None,) * (y.dim() - 1)
    return sh.relayout(y, last + (n_ax,), last + (ch,), sh.serve_ctx())


def _keep_state(state, conv: torch.Tensor, h: torch.Tensor):
    """Write the new conv buffer and recurrent state into `state` in place;
    None without a state (the reference returns none then)."""
    if state is None:
        return None
    state["conv"].copy_(conv)
    state["h"].copy_(h)
    return state


def rglru_scan(
    params: Params,
    u: torch.Tensor,   # (B, S, R) conv output
    h0: torch.Tensor,  # (B, R)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t), the reference's
    formulas op for op: a_t = exp(r_t * -8 softplus(a_param)), the gates
    r_t and i_t sigmoids of u_t W_a + b_a and u_t W_x + b_x on the f32 u.
    Both gate weights go through `mm`: on a dense tree f32 u times the
    f32 weight, as the reference; on a compressed one the DECA GeMV/GeMM,
    whose bf16(x) is exact on the bf16-valued u. Returns (hs in u's dtype,
    the last f32 h).

    Under a serving mesh u and h0 hold this rank's channel block
    (`sharding.channels`): u is gathered whole for the W_a / W_x
    contractions, whose column shards give the gates of the local
    channels, and the recurrence runs on those."""
    c = 8.0
    ctx = sh.serve_ctx()
    ch = sh.channel_axis(params["a_param"].shape[-1], ctx)
    local = lambda name: sh.channels(params[name], ctx)
    log_a_base = -c * softplus(local("a_param"))  # (R,) negative
    u32 = u.to(torch.float32)
    r_gate = sigmoid(_channel_mm(u32, params["w_a"], ch, ch) + local("b_a"))
    i_gate = sigmoid(_channel_mm(u32, params["w_x"], ch, ch) + local("b_x"))
    a = torch.exp(r_gate * log_a_base)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * u32)
    hs, h = linear_recurrence(a, gated, h0.to(torch.float32))
    return hs.to(u.dtype), h


def linear_recurrence(a: torch.Tensor, x: torch.Tensor,
                      h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + x_t over axis 1 of a and x (B, S, ...), the
    reference's `lax.scan`: (every h_t stacked on axis 1, the last h)."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_block(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Griffin's recurrent block: gelu_tanh(x W_gate_branch) times the
    RG-LRU of the causal conv of x W_in, then W_out. `state` {conv (B,
    ck - 1, R), h (B, R) f32} carries a request across calls, in place.

    Under a serving mesh x holds this rank's rows, and the R channels split
    over `model` where they divide (`sharding.channel_axis`): W_in and
    W_gate_branch give the local channels, the conv, the gates, the
    recurrence and the state (`Model.init_cache`) run on them, and W_out
    is row-parallel over them (`tp_mm`)."""
    b = x.shape[0]
    r = cfg.lru_width or cfg.d_model
    ctx = sh.serve_ctx()
    ch = sh.channel_axis(r, ctx)
    gate = gelu_tanh(_channel_mm(x, params["w_gate_branch"], ch))  # (B, S, R)
    u = _channel_mm(x, params["w_in"], ch)
    acc, conv = causal_conv(u, sh.channels(params["conv_w"], ctx), state)
    u = acc.to(x.dtype)
    h0 = state["h"] if state is not None else torch.zeros(
        (b, u.shape[-1]), dtype=torch.float32, device=x.device)
    hs, h = rglru_scan(params, u, h0)
    return tp_mm(hs * gate, params["w_out"], ch)[0], _keep_state(state, conv, h)


def selective_scan(
    dt: torch.Tensor,     # (B, S, di) f32
    a: torch.Tensor,      # (di, st) f32, negative
    b_mat: torch.Tensor,  # (B, S, st)
    c_mat: torch.Tensor,  # (B, S, st)
    u: torch.Tensor,      # (B, S, di)
    h0: torch.Tensor,     # (B, di, st) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1's scan h_t = exp(dt_t A) h_{t-1} + (dt_t B_t) u_t, y_t =
    C_t h_t, as a loop over time. The reference builds exp(dt A), dt B,
    their product with u and every h_t as (B, S, di, st) f32 tensors (2.1
    GB each at batch 4 of 1024 falcon-mamba tokens); each step here makes
    step t's slice by the same elementwise ops, so the values are the
    same and the memory is O(B di st). Returns (y (B, S, di) f32, the
    last h)."""
    b32, c32, u32 = (t.to(torch.float32) for t in (b_mat, c_mat, u))
    h, ys = h0, []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t, :, None]
        da = torch.exp(dt_t * a)
        dbu = (dt_t * b32[:, t, None, :]) * u32[:, t, :, None]
        h = da * h + dbu
        ys.append((h * c32[:, t, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1), h


def mamba_block(
    params: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Selective SSM (falcon-mamba): x W_in splits into u and the gate z;
    u goes through the causal conv with its bias and silu, then sets the
    input-dependent dt = softplus(dt_r W_dt + dt_bias), B and C (u W_x
    split at dt_rank and dt_rank + state); the scan's y plus D u, times
    silu(z), goes out through W_out. All four projections go through
    `mm`, so a compressed `x_proj` or `dt_proj` (eligible at full width)
    runs the DECA kernels. `state` {conv (B, ck - 1, di), h (B, di, st)
    f32} carries a request across calls, in place.

    Under a serving mesh x holds this rank's rows, and the di channels
    split over `model` where they divide (`sharding.channel_axis`). W_in's
    column split runs over [u | z] (at `model` = 2 rank 0 would hold all of
    u), so its product is gathered whole and each half cut to the rank's
    channel block. W_x contracts the whole u, and its column split crosses
    the dt_r | B | C boundaries, so its product is gathered whole too; W_dt
    gives the local channels. The conv, the scan and the state
    (`Model.init_cache`) run on the local channels, and W_out is
    row-parallel over them (`tp_mm`)."""
    b = x.shape[0]
    di, st, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    ctx = sh.serve_ctx()
    ch = sh.channel_axis(di, ctx)
    local = lambda name, dim=-1: sh.channels(params[name], ctx, dim)
    xz = _channel_mm(x, params["in_proj"], None)
    u, z = (sh.channels(t, ctx) for t in torch.chunk(xz, 2, dim=-1))
    acc, conv = causal_conv(u, local("conv_w"), state)
    u = silu(acc + local("conv_b")).to(x.dtype)
    proj = _channel_mm(u, params["x_proj"], None, ch)  # (B, S, dr + 2 st)
    dt_r, b_mat, c_mat = torch.split(proj, [dr, st, st], dim=-1)
    dt = softplus(_channel_mm(dt_r, params["dt_proj"], ch).to(torch.float32)
                  + local("dt_bias"))
    a = -torch.exp(local("a_log", 0))  # (di, st)
    h0 = state["h"] if state is not None else torch.zeros(
        (b, u.shape[-1], st), dtype=torch.float32, device=x.device)
    y, h = selective_scan(dt, a, b_mat, c_mat, u, h0)
    y = (y + local("d_skip") * u.to(torch.float32)).to(x.dtype)
    return tp_mm(y * silu(z), params["out_proj"], ch)[0], _keep_state(state, conv, h)

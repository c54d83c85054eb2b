"""Config-driven model assembly of the port.

Counterpart of `repro/models/model.py`. One `Model` serves the families
the port has taken: dense attention stacks (llama3-8b, llama2-70b,
llama3.2-1b and granite-3-8b with rope and swiglu, the last two with a
tied head; opt-66b with learned positions, a relu MLP and full MHA;
gemma2-2b with geglu, local and global layers in turn, attention and
final logit softcaps, post norms, an embedding scaled by sqrt(d_model)),
the MoE family (grok-1-314b, kimi-k2-1t-a32b: a top-k MoE FFN in every
layer, `layers.moe_block`), the ssm family (falcon-mamba-7b: a Mamba-1
block a layer, no FFN), the hybrid family (recurrentgemma-9b: RG-LRU
and attention blocks in the pattern rec, rec, attn, each with an FFN),
the vlm family (qwen2-vl-7b: M-RoPE over three position streams,
`layers.apply_mrope`, and patch embeddings from a stubbed frontend as
`forward(embeds=...)`) and the audio family (hubert-xlarge: a
bidirectional encoder, `causal=False`, with learned positions and an
ungated gelu MLP; the engines serve it as the reference's do). The FFN is
the MoE one exactly when `n_experts` is set, in any family.

`loss` is the training objective (the reference's `Model.loss`), on the
full-sequence forward; `forward(remat=True)` checkpoints each layer for
it, and `forward(with_aux=True)` also returns the summed MoE aux loss.

Two cache regimes, as in the reference. `forward(paged=...)` runs an
attention stack over the block-paged KV pool (`init_paged_cache`):
`decode_chunk_paged` runs its C steps and `spec_decode_chunk` its
draft/verify rounds as Python loops with the done flags on the device and
no host sync inside, so only the sampled tokens cross to the host, once
per chunk, and on the card the engine captures each loop whole as one
CUDA graph (`serve/graphs.py`). Without `paged`, `forward(cache=...)` runs
any stack over the dense engine's per-layer caches (`init_cache`): a ring
KV cache per attention layer, the conv buffer and f32 state per
recurrent one; `decode_step` is one token of it, and `cache=None` is the
full-sequence forward. Layers are kept per layer in a list rather than
stacked for `lax.scan`. Every FC matmul goes through `core.decompress.mm`
(the DECA GeMM/GeMV kernels for compressed weights) and paged decode
attention through the fused paged-attention kernel.

Params are a dict of tensors: {"embed", "final_norm", "lm_head" (absent
when the head is tied to `embed`), "pos_embed" (learned positions only),
"layers": [{"pre_norm", then "attn": {wq, wk, wv, wo} and "post_attn_norm"
(post norms only), or "mamba": {in_proj, conv_w, conv_b, x_proj, dt_proj,
dt_bias, a_log, d_skip, out_proj}, or "rec": {w_in, w_gate_branch,
conv_w, w_a, w_x, b_a, b_x, a_param, w_out}; then, except after a mamba
block, "pre_mlp_norm", "mlp": {w_gate (swiglu and geglu), w_up, w_down}
or, with experts, "moe": {router (D, E) f32, w_up, w_down, w_gate: (E, K,
N) each, or one expert-stacked compressed leaf}, and "post_mlp_norm"
(post norms only)}, ...]}.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decompress import compress_tree
from repro_torch.core.formats import CompressionSpec
from repro_torch.device import resolve
from repro_torch.dist import sharding as sh
from repro_torch.models import layers as L

Params = Dict[str, Any]
AUX_WEIGHT, Z_WEIGHT = 0.01, 1e-4  # the loss's weights of the MoE aux and z terms
Pools = List[Dict[str, torch.Tensor]]
_ATTN = ("attn", "attn_local")


def _check_experts(cfg: ModelConfig) -> None:
    """The FFN routes by `n_experts` alone, in any family, as the
    reference's: experts give the MoE FFN, none the dense MLP. A config
    with experts must pick 1..n_experts of them a token, where the
    reference's top-k fails (k > E) or its aux loss is NaN (k = 0)."""
    if cfg.n_experts and not 0 < cfg.experts_per_token <= cfg.n_experts:
        raise ValueError(
            f"{cfg.name}: experts_per_token={cfg.experts_per_token} must lie in "
            f"1..n_experts={cfg.n_experts}"
        )


class Model:
    def __init__(self, cfg: ModelConfig):
        _check_experts(cfg)
        L.kv_codec(cfg.kv_quant)  # fail fast on a non-KV codec
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        # the reference scans a uniform stack over one (n_layers, ...)
        # array per weight, and its compression floor counts that array
        uniform = len(set(self.kinds)) == 1 and cfg.scan_layers
        self.layer_stack = cfg.n_layers if uniform else 1
        # only attention stacks page; recurrent state is O(1) a request
        self.attn_only = all(k in _ATTN for k in self.kinds)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init_block(self, generator: torch.Generator, kind: str = "attn", *, device,
                   dtype, spec: Optional[CompressionSpec] = None) -> Params:
        """One layer's leaves for its `kind` (attn, attn_local, ssm, rec),
        as the reference's `_init_block`: a mamba block has no FFN. With
        `spec`, MoE expert weights come back compressed, one expert at a
        time (`L.init_moe`); the rest dense."""
        cfg = self.cfg
        norm = lambda: torch.zeros(cfg.d_model, device=device)
        p = {"pre_norm": norm()}
        if kind in _ATTN:
            p["attn"] = L.init_attention(generator, cfg, device, dtype)
            if cfg.post_norms:
                p["post_attn_norm"] = norm()
        elif kind == "ssm":
            p["mamba"] = L.init_mamba(generator, cfg, device, dtype)
        elif kind == "rec":
            p["rec"] = L.init_rglru(generator, cfg, device, dtype)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if cfg.d_ff and kind != "ssm":
            p["pre_mlp_norm"] = norm()
            if cfg.n_experts:
                p["moe"] = L.init_moe(generator, cfg, device, dtype, spec=spec,
                                      stack=self.layer_stack)
            else:
                p["mlp"] = L.init_mlp(generator, cfg, device, dtype)
            if cfg.post_norms:
                p["post_mlp_norm"] = norm()
        return p

    def init(
        self,
        generator: torch.Generator,
        *,
        device="cuda",
        dtype=torch.bfloat16,
        spec: Optional[CompressionSpec] = None,
    ) -> Params:
        """Random weights from `generator` (which must live on `device`).
        With `spec`, each layer's FC weights are compressed on the device as
        soon as the layer is drawn, so the dense model never exists whole."""
        cfg = self.cfg
        device = resolve(device)

        def shrink(tree):
            if spec is None:
                return tree
            return compress_tree({"layers": [tree]}, spec,
                                 layer_stack=self.layer_stack)["layers"][0]

        def table(rows):
            return (torch.randn((rows, cfg.d_model), generator=generator,
                                device=device) * 0.02).to(dtype)

        params: Params = {
            "embed": table(cfg.vocab_size),
            "final_norm": torch.zeros(cfg.d_model, device=device),
        }
        if cfg.pos_emb == "learned":
            params["pos_embed"] = table(cfg.pos_table)
        if not cfg.tie_embeddings:
            lm_head = {"lm_head": L.dense_init(
                generator, (cfg.d_model, cfg.vocab_size), device, dtype
            )}
            if spec is not None:
                lm_head = compress_tree(lm_head, spec)
            params["lm_head"] = lm_head["lm_head"]
        params["layers"] = [
            shrink(self.init_block(generator, kind, device=device, dtype=dtype, spec=spec))
            for kind in self.kinds
        ]
        return params

    # ------------------------------------------------------------------
    # the dense engine's caches
    # ------------------------------------------------------------------
    def _block_cache(self, kind: str, b: int, max_len: int, device, dtype):
        cfg = self.cfg
        ctx = sh.serve_ctx()
        # this rank's block of n over `axis` (all of n with no mesh)
        mine = lambda n, axis: n if axis is None else n // ctx.axis_sizes[axis]
        b = mine(b, sh.batch_axis(b, ctx))
        if kind in _ATTN:
            size = min(max_len, cfg.window) if kind == "attn_local" else max_len
            hkv = mine(cfg.n_kv_heads, sh.kv_head_axis(cfg.n_kv_heads, ctx))
            return L.init_kv_cache(b, size, hkv, cfg.d_head, device=device,
                                   dtype=dtype, quant=cfg.kv_quant)
        width = cfg.d_inner if kind == "ssm" else cfg.lru_width or cfg.d_model
        width = mine(width, sh.channel_axis(width, ctx))
        h = (b, width, cfg.ssm_state) if kind == "ssm" else (b, width)
        return {"conv": torch.zeros((b, cfg.ssm_conv - 1, width), dtype=dtype, device=device),
                "h": torch.zeros(h, dtype=torch.float32, device=device)}

    def init_cache(self, batch: int, max_len: int, *, device="cuda",
                   dtype=torch.bfloat16) -> Pools:
        """One cache per layer for `batch` rows: a ring KV cache of
        `max_len` slots (a local layer's at most its window), rounded up
        to 32, quantized with `cfg.kv_quant`; a recurrent layer's conv
        buffer (its last ck - 1 inputs) and f32 state h. Under a serving
        mesh (`GenerationEngine(mesh=, paged=False)`) each holds this
        rank's block: its rows where `data` divides the batch, its KV heads
        where `model` divides them, a recurrent layer's channel block
        (`sharding.channel_axis`)."""
        device = resolve(device)
        return [self._block_cache(k, batch, max_len, device, dtype) for k in self.kinds]

    # ------------------------------------------------------------------
    # paged KV pools
    # ------------------------------------------------------------------
    def init_paged_cache(
        self, num_blocks: int, block_size: int, *, device="cuda",
        dtype=torch.bfloat16, kv_heads: Optional[int] = None,
    ) -> Pools:
        """One pool per layer: `num_blocks` allocatable pages plus the null
        page (device row 0), quantized with `cfg.kv_quant`, of `kv_heads`
        heads (all of them by default; a sharded engine's rank holds its
        slice). Only attention stacks page: recurrent state is O(1) a
        request."""
        cfg = self.cfg
        if not self.attn_only:
            bad = sorted(set(self.kinds) - set(_ATTN))
            raise NotImplementedError(f"paged KV serving needs an attention stack, got {bad}")
        device = resolve(device)
        return [
            L.init_paged_kv_cache(
                num_blocks + 1, block_size, kv_heads or cfg.n_kv_heads, cfg.d_head,
                device=device, dtype=dtype, quant=cfg.kv_quant,
            )
            for _ in self.kinds
        ]

    def paged_scrub(self, pools: Pools, pages: torch.Tensor) -> Pools:
        """Scrub the position plane of `pages` (0 = the null page, a no-op)
        to the empty sentinel in every layer, in place: the out-of-step form
        of the fresh-page scrub, for rounds that recycle more pages than a
        step's fixed fresh-page width carries."""
        idx = pages.long()
        for cache in pools:
            cache["ppos"].index_fill_(0, idx, L.CACHE_EMPTY_POS)
        return pools

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _block_apply(self, p, x, kind, positions, cache, paged, rows=None):
        """One layer: (x, its cache, its MoE aux loss: f32 0-d, None
        without an MoE FFN). `rows` is the whole batch's row count, of
        which x holds this rank's share under a serving mesh."""
        cfg = self.cfg
        aux = None
        h = L.rms_norm(p["pre_norm"], x, cfg.norm_eps)
        if kind in _ATTN and paged is not None:
            out, cache = L.paged_attention_block(
                p["attn"], h, cfg, positions=positions,
                local=(kind == "attn_local"), cache=cache,
                block_tables=paged["block_tables"],
                write_slots=paged["write_slots"],
                write_pos=paged["write_pos"],
                fresh_pages=paged.get("fresh_pages"),
                kv_lens=paged.get("kv_lens"),
                copy_pages=paged.get("copy_pages"),
                window_override=paged.get("window_override"),
            )
        elif kind in _ATTN:
            out, cache = L.attention_block(p["attn"], h, cfg, positions=positions,
                                           local=(kind == "attn_local"), cache=cache,
                                           rows=rows)
        elif kind == "ssm":
            out, cache = L.mamba_block(p["mamba"], h, cfg, state=cache)
        else:
            out, cache = L.rglru_block(p["rec"], h, cfg, state=cache)
        if cfg.post_norms and kind in _ATTN:
            out = L.rms_norm(p["post_attn_norm"], out, cfg.norm_eps)
        x = x + out
        if not cfg.d_ff or kind == "ssm":
            return x, cache, aux
        h = L.rms_norm(p["pre_mlp_norm"], x, cfg.norm_eps)
        if cfg.n_experts:
            out, aux = L.moe_block(p["moe"], h, cfg, rows=rows)
        else:
            out = L.mlp_block(p["mlp"], h, cfg)
        if cfg.post_norms:
            out = L.rms_norm(p["post_mlp_norm"], out, cfg.norm_eps)
        return x + out, cache, aux

    def _remat_block(self, p, x, kind, positions):
        """One cache-less layer under activation checkpointing (the
        reference's `jax.checkpoint` around `_block_apply`): only its input
        is kept, and its activations are recomputed in the backward pass."""
        def run(p, x):
            x, _, aux = self._block_apply(p, x, kind, positions, None, None)
            return x, aux

        return checkpoint(run, p, x, use_reentrant=False)

    def forward(
        self,
        params: Params,
        *,
        tokens: Optional[torch.Tensor] = None,     # (B, S) int
        embeds: Optional[torch.Tensor] = None,     # (B, S, D) frontend stub
        positions: Optional[torch.Tensor] = None,  # (B, S) or (3, B, S)
        cache: Optional[Pools] = None,
        paged: Optional[Dict[str, torch.Tensor]] = None,
        remat: bool = False,
        with_aux: bool = False,
    ):
        """Returns (logits (B, S, V) f32, caches updated in place), and with
        `with_aux` also the MoE aux loss summed over the layers (f32 0-d,
        zero without experts) as a third item: the reference's triple.

        The input is `tokens`, or `embeds` (the stubbed vision or audio
        frontend's output, any float dtype) in their place. Under learned
        positions the position rows are added before the cast to bf16, as
        the reference adds them: f32 `embeds` add in f32 and round once.
        `positions` may be (3, B, S) for an M-RoPE config (temporal,
        height and width ids); the token positions are then the temporal
        stream.

        With `paged`, `cache` is an `init_paged_cache` pool list and
        `positions` the per-request positions; `paged` holds {block_tables
        (B, MB), write_slots (B, S), write_pos (B, S)} and optionally
        fresh_pages (F,), copy_pages (C, 2), a kv_lens (B,) vector that
        routes S == 1 steps through the fused paged-attention kernel and a
        window_override that caps its attention window (the spec-decode
        draft). Without it, `cache` is an `init_cache` list (the dense
        engine) or None (the full-sequence forward, caches None), and the
        batch shares the positions of row 0, by default 0 .. S - 1.

        `remat` checkpoints each layer of the full-sequence forward
        (`torch.utils.checkpoint`, non-reentrant): training's backward pass
        then holds one layer's activations at a time. It needs no cache.

        Under a serving mesh (`GenerationEngine(mesh=)`: `params` this
        rank's shards, `cache` its pools' head slices or its ring caches'
        rows, heads and channels, `init_cache`) the inputs are whole; each
        rank computes the rows of the batch the rules split over `data`
        (all of them where they do not divide), and the logits come back
        whole on every rank, gathered over both axes."""
        cfg = self.cfg
        if paged is not None and cache is None:
            raise ValueError("a paged forward needs an init_paged_cache pool")
        if remat and cache is not None:
            raise ValueError("remat is for the cache-less training forward")
        ctx = sh.serve_ctx()
        if ctx is not None and cache is None:
            raise NotImplementedError(
                "a serving mesh runs the forward over a paged pool or a ring cache; the "
                "cache-less forward under one is not ported (ROADMAP Queue A item 12)")
        inp = tokens if embeds is None else embeds
        b, s = inp.shape[:2]
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=inp.device)[None].expand(b, s)
        row_ax = sh.batch_axis(b, ctx)
        positions = sh.local_rows(positions, b, ctx, dim=positions.dim() - 2)
        # every rank looks up every row (under fsdp each holds a D block of
        # the table and gathers the rows whole over `data`), then keeps its own
        x = sh.local_rows(L.embed(params["embed"], inp) if embeds is None else inp, b, ctx)
        if cfg.embed_scale:
            x = L.embed_scale(x, cfg.d_model)
        if cfg.pos_emb == "learned":
            tok_pos = positions if positions.dim() == 2 else positions[0]
            idx = torch.clamp(tok_pos.long(), 0, cfg.pos_table - 1)
            x = x + params["pos_embed"][idx]
        x = x.to(torch.bfloat16)
        caches = cache if cache is not None else [None] * len(self.kinds)
        new_cache = []
        # the aux sum is made only when asked for, so a captured serving
        # step launches no kernel for it
        aux = torch.zeros((), dtype=torch.float32, device=x.device) if with_aux else None
        for p, kind, cache_l in zip(params["layers"], self.kinds, caches):
            if remat:
                x, aux_l = self._remat_block(p, x, kind, positions)
            else:
                x, cache_l, aux_l = self._block_apply(p, x, kind, positions, cache_l, paged,
                                                      rows=b)
            if with_aux and aux_l is not None:
                aux = aux + aux_l
            new_cache.append(cache_l)
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            with sh.gathered(params["embed"], ctx) as table:  # D whole under fsdp
                logits = L.tied_logits(x, table)
            v_ax = sh.matmul_axes(params["embed"], ctx)[0]  # the table's rows
        else:
            logits, v_ax = L.tp_mm(x.to(torch.float32), params["lm_head"])
        if cfg.final_softcap:
            logits = L.softcap(logits, cfg.final_softcap)
        if ctx is not None:  # `btv`, then whole rows for the sampler on every rank
            logits, spec = sh.constrain_local(logits, "btv", (row_ax, None, v_ax))
            logits = sh.relayout(logits, spec, (None,) * 3, ctx)
        new_cache = new_cache if cache is not None else None
        return (logits, new_cache, aux) if with_aux else (logits, new_cache)

    def loss(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        *,
        remat: bool = True,
        aux_weight: float = AUX_WEIGHT,
        z_weight: float = Z_WEIGHT,
        denom: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training objective (the reference's `Model.loss`): masked
        next-token cross-entropy from f32 logits through their logsumexp,
        plus `aux_weight` times the MoE aux loss and `z_weight` times the
        z-loss (the squared log-partition), both sums over
        max(mask.sum(), 1). `batch` holds "labels" (B, S), "tokens" or
        "embeds", and optionally "positions" and "mask" (B, S) f32.
        `denom` replaces that divisor: a data-parallel rank divides its
        rows' sums by the whole batch's (`train/trainer.py`).
        Returns (total, {ce, aux, z_loss})."""
        logits, _, aux = self.forward(
            params, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
            positions=batch.get("positions"), remat=remat, with_aux=True,
        )
        labels = batch["labels"].long()
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0] - logz
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
        if denom is None:
            denom = torch.clamp(mask.sum(), min=1.0)
        ce = -(ll * mask).sum() / denom
        zl = ((logz * mask) ** 2).sum() / denom
        total = ce + aux_weight * aux + z_weight * zl
        return total, {"ce": ce, "aux": aux, "z_loss": zl}

    def decode_step(
        self,
        params: Params,
        tokens: torch.Tensor,     # (B, 1)
        positions: torch.Tensor,  # (B, 1)
        cache: Pools,
    ) -> Tuple[torch.Tensor, Pools]:
        """One next-token step of the dense engine against its filled
        `init_cache` caches: (logits (B, V) f32, caches). An M-RoPE config
        takes (B, 1) positions as three equal streams (`layers.rotate`)."""
        logits, cache = self.forward(params, tokens=tokens,
                                     positions=positions, cache=cache)
        return logits[:, -1, :], cache

    def score(self, params: Params, tokens: torch.Tensor, *,
              block_size: int = 32) -> torch.Tensor:
        """Teacher-forced logits (S, V) f32 of one token sequence (S,),
        through a paged pool of its own on the tokens' device for an
        attention stack, or the full-sequence forward (the full scan) for a
        recurrent one: row i is the next-token distribution after
        tokens[: i + 1]. An M-RoPE config reads the positions 0 .. S - 1
        as three equal streams (`layers.rotate`), as its engines serve them."""
        if not self.attn_only:
            return self.forward(params, tokens=tokens[None])[0][0]
        s, bs = tokens.shape[0], block_size
        pages = -(-s // bs)
        dev = tokens.device
        pools = self.init_paged_cache(pages, bs, device=dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
        tables = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
        logits, _ = self.forward(
            params, tokens=tokens[None], positions=pos, cache=pools,
            paged={"block_tables": tables, "write_slots": pos + bs, "write_pos": pos},
        )
        return logits[0]

    def decode_step_paged(
        self,
        params: Params,
        tokens: torch.Tensor,        # (B, 1)
        positions: torch.Tensor,     # (B, 1) or (3, B, 1)
        cache: Pools,
        block_tables: torch.Tensor,  # (B, MB)
        write_slots: torch.Tensor,   # (B, 1)
        write_pos: torch.Tensor,     # (B, 1)
        fresh_pages: torch.Tensor,   # (F,) pages newly allocated this step
        kv_lens: Optional[torch.Tensor] = None,  # (B,)
    ) -> Tuple[torch.Tensor, Pools]:
        """One next-token step over the continuous-batching slots."""
        logits, cache = self.forward(
            params, tokens=tokens, positions=positions, cache=cache,
            paged={
                "block_tables": block_tables,
                "write_slots": write_slots,
                "write_pos": write_pos,
                "fresh_pages": fresh_pages,
                "kv_lens": kv_lens,
            },
        )
        return logits[:, -1, :], cache

    def decode_chunk_paged(
        self,
        params: Params,
        tokens0: torch.Tensor,       # (B, 1) last sampled token per slot
        cache: Pools,
        block_tables: torch.Tensor,  # (B, MB), static for the whole chunk
        positions: torch.Tensor,     # (C, B, 1)
        write_slots: torch.Tensor,   # (C, B, 1)
        write_pos: torch.Tensor,     # (C, B, 1)
        fresh_pages: torch.Tensor,   # (C, F) pages to scrub (row 0 real)
        kv_lens: torch.Tensor,       # (C, B)
        *,
        sample_fn: Callable[[torch.Tensor, int], torch.Tensor],
        max_steps: torch.Tensor,     # (B,) steps this slot may still take
        eos_ids: torch.Tensor,       # (B,) eos token, -1 = none
        active: torch.Tensor,        # (B,) bool, slot holds a live request
    ) -> Tuple[torch.Tensor, Pools]:
        """C decode steps with sampling, token feedback and the per-slot
        done flags (EOS / length cap) all on the device. A finished or
        inactive slot writes to the null page under the empty sentinel, so
        the pool ends bitwise as C single steps would leave it. Returns
        (tokens (C, B), pools); tokens past a slot's done point are junk
        the host discards. An M-RoPE config takes each step's positions as
        three equal streams (`layers.rotate`, a view: no kernel added)."""
        done = ~active
        tok = tokens0
        toks = []
        for j in range(positions.shape[0]):
            wslot = torch.where(done[:, None], torch.zeros_like(write_slots[j]),
                                write_slots[j])
            wpos = torch.where(done[:, None],
                               torch.full_like(write_pos[j], L.CACHE_EMPTY_POS),
                               write_pos[j])
            logits, cache = self.decode_step_paged(
                params, tok, positions[j], cache, block_tables, wslot, wpos,
                fresh_pages[j], kv_lens[j],
            )
            t = sample_fn(logits, j).to(torch.int32)
            done = done | (j + 1 >= max_steps) | (t == eos_ids)
            tok = t[:, None]
            toks.append(t)
        return torch.stack(toks), cache

    def spec_decode_chunk(
        self,
        params: Params,
        draft_params: Params,
        tokens0: torch.Tensor,       # (M, 1) pending token per slot (KV unwritten)
        cache: Pools,
        block_tables: torch.Tensor,  # (M, TW) device page ids, bounded width
        p0: torch.Tensor,            # (M,) position of the pending token
        fresh: torch.Tensor,         # (F,) device pages to pre-scrub (0 = none)
        *,
        sample_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        max_steps: torch.Tensor,     # (M,) emissions this slot may still take
        eos_ids: torch.Tensor,       # (M,) eos token, -1 = none
        active: torch.Tensor,        # (M,) bool, slot holds a live request
        k: int,
        rounds: int,
        block_size: int,
        draft_window: int = 0,
        out_cap: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Pools]:
        """Self-speculative decode: `rounds` draft-k / verify-once rounds,
        the state of every slot on the device (the reference's
        `spec_decode_chunk`, DESIGN.md §16).

        Between rounds a slot has its committed positions (< pos) and a
        pending token at `pos` whose KV is unwritten. A round drafts k
        tokens through `draft_params`, k fused S=1 steps (window-capped by
        `draft_window`) that write draft KV, then runs one target forward
        over the k+1 positions [pending, d_1..d_k] through the gather path,
        which overwrites every draft entry with target KV. Acceptance is
        the longest prefix of drafts the verify samples match, plus the
        verify's next row, clamped at the first EOS and at the slot's
        budget. Rejected entries stay in place: their positions exceed
        every later query's until the next round overwrites them. Writes
        at or past `p0 + max_steps` go to the null page under the empty
        sentinel, so a slot never writes past its page reservation.

        `sample_fn(logits (M, S, V), idx (M, S))` samples every row; idx is
        the chunk-local output index. Returns (out (out_cap, M) emitted
        tokens packed from row 0, e_rounds (rounds, M) emissions per round,
        pools). Nothing in the rounds waits on the host: the emissions land
        by an unmasked scatter whose rejected rows go to a spare row of
        `out` that is cut off at the end."""
        m = tokens0.shape[0]
        bs, tw = block_size, block_tables.shape[1]
        dev = tokens0.device
        if out_cap is None:
            out_cap = rounds * (k + 1)
        limit = p0 + max_steps  # first write position past the slot's budget
        cache = self.paged_scrub(cache, fresh)
        offs = torch.arange(k + 1, dtype=torch.int32, device=dev)
        tables = block_tables.long()
        cols = torch.arange(m, device=dev)[:, None].expand(m, k + 1)

        def fwd(pp, pools, toks, wpos, ok, klen, wov):
            # flat slot ids from the bounded table; a write that must not
            # land goes to the null page under the empty sentinel
            idx = torch.clamp(wpos // bs, 0, tw - 1).long()
            page = torch.where(ok, torch.gather(tables, 1, idx), 0)
            logits, pools = self.forward(
                pp, tokens=toks, positions=wpos, cache=pools,
                paged={
                    "block_tables": block_tables,
                    "write_slots": (page * bs + wpos % bs).to(torch.int32),
                    "write_pos": torch.where(ok, wpos, L.CACHE_EMPTY_POS),
                    "kv_lens": klen,
                    "window_override": wov,
                },
            )
            return logits, pools

        tok = tokens0.to(torch.int32)
        pos = p0.to(torch.int32)
        emitted = torch.zeros(m, dtype=torch.int32, device=dev)
        done = ~active
        out = torch.zeros((out_cap + 1, m), dtype=torch.int32, device=dev)
        e_rounds = []
        for _ in range(rounds):
            live = ~done
            # draft: k proposals through the draft weights, fused S=1 walks
            d, drafts = tok, []
            for j in range(k):
                wpos = (pos + j)[:, None]
                logits, cache = fwd(
                    draft_params, cache, d, wpos, live[:, None] & (wpos < limit[:, None]),
                    torch.minimum(pos + j + 1, limit), draft_window or None,
                )
                d = sample_fn(logits, (emitted + j)[:, None]).to(torch.int32)
                drafts.append(d[:, 0])
            drafts = torch.stack(drafts, dim=1)  # (M, k)

            # verify: one target forward over the k+1 positions
            wpos_v = pos[:, None] + offs[None, :]
            logits_v, cache = fwd(
                params, cache, torch.cat([tok, drafts], dim=1), wpos_v,
                live[:, None] & (wpos_v < limit[:, None]), None, None,
            )
            s = sample_fn(logits_v, emitted[:, None] + offs[None, :]).to(torch.int32)

            # acceptance: the longest matched draft prefix plus the next row
            span = torch.clamp(torch.minimum(max_steps - emitted - 1,
                                             torch.full_like(emitted, k)), 0, k)
            match = (s[:, :k] == drafts) & (offs[None, :k] < span[:, None])
            e = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32) + 1
            is_eos = (s == eos_ids[:, None]) & (offs[None, :] < e[:, None])
            has_eos = is_eos.any(dim=1)
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32) + 1
            e = torch.where(has_eos, first_eos, e)
            e = torch.where(live, e, 0)

            # emit and advance: accepted rows land at the slot's running
            # output index; the last accepted sample is the next pending
            rows = emitted[:, None] + offs[None, :]
            keep = (offs[None, :] < e[:, None]) & (rows < out_cap)
            out.index_put_((torch.where(keep, rows, out_cap).long(), cols), s)
            last = torch.gather(s, 1, torch.clamp(e - 1, 0, k)[:, None].long())
            tok = torch.where(live[:, None], last, tok)
            pos = pos + e
            emitted = emitted + e
            done = done | has_eos | (emitted >= max_steps)
            e_rounds.append(e)
        return out[:out_cap], torch.stack(e_rounds), cache

"""The dense GQA decoder over the block-paged KV pool.

Counterpart of `repro/models/model.py` for the paged serving path of a
dense attention stack: llama3-8b, llama2-70b, llama3.2-1b and granite-3-8b
(rope, swiglu; the last two with a tied head), opt-66b (learned
positions, a relu MLP, full MHA) and gemma2-2b (geglu, local and global
layers in turn, attention and final logit softcaps, post-attention and
post-MLP norms, an embedding scaled by sqrt(d_model), a tied head), and
the MoE family: grok-1-314b (geglu experts, softcaps) and kimi-k2-1t-a32b
(swiglu experts), a top-k MoE FFN in every layer (`layers.moe_block`).
Layers are kept per layer in a list
rather than stacked for `lax.scan`; `decode_chunk_paged` runs its C steps
and `spec_decode_chunk` its draft/verify rounds as Python loops with the
done flags on the device and no host sync inside, so only the sampled
tokens cross to the host, once per chunk, and on the card the engine
captures each loop whole as one CUDA graph (`serve/graphs.py`). Every FC matmul goes through `core.decompress.mm` (the
DECA GeMM/GeMV kernels for compressed weights) and decode attention
through the fused paged-attention kernel.

Params are a dict of tensors: {"embed", "final_norm", "lm_head" (absent
when the head is tied to `embed`), "pos_embed" (learned positions only),
"layers": [{"pre_norm", "attn": {wq, wk, wv, wo}, "post_attn_norm"
(post norms only), "pre_mlp_norm", "mlp": {w_gate (swiglu and geglu),
w_up, w_down} or, with experts, "moe": {router (D, E) f32, w_up, w_down,
w_gate: (E, K, N) each, or one expert-stacked compressed leaf},
"post_mlp_norm" (post norms only)}, ...]}.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decompress import compress_tree, mm
from repro_torch.core.formats import CompressionSpec
from repro_torch.device import resolve
from repro_torch.models import layers as L

Params = Dict[str, Any]
Pools = List[Dict[str, torch.Tensor]]


def _unsupported(cfg: ModelConfig) -> List[str]:
    """Config features outside the port so far, each with the step of
    ROADMAP Queue A item 10 (remaining model families) that ports it. The
    MoE family (grok-1-314b, kimi-k2-1t-a32b: an MoE FFN in every layer of
    an attention stack) is ported; experts in a dense family, or an MoE
    family without them, are not."""
    experts = cfg.n_experts > 0
    checks = {
        "family": (cfg.family not in ("dense", "moe"), "10.6-10.7"),
        # experts only in an MoE family, an MoE family only with them, and
        # 1 <= experts_per_token <= n_experts
        "n_experts": ((cfg.family == "moe") != experts or (experts and not (
            0 < cfg.experts_per_token <= cfg.n_experts)), "10.5"),
        "attn_pattern": (cfg.attn_pattern not in ("global", "local_global"), "10.6"),
        "mrope_sections": (bool(cfg.mrope_sections), "10.7"),
        "mlp_act": (cfg.mlp_act not in ("swiglu", "geglu", "relu"), "10.7"),
    }
    return [f"{name} (step {step})" for name, (bad, step) in checks.items() if bad]


class Model:
    def __init__(self, cfg: ModelConfig):
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: {bad} are not ported yet (ROADMAP Queue A item 10)"
            )
        L.kv_codec(cfg.kv_quant)  # fail fast on a non-KV codec
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        # the reference scans a uniform stack over one (n_layers, ...)
        # array per weight, and its compression floor counts that array
        uniform = len(set(self.kinds)) == 1 and cfg.scan_layers
        self.layer_stack = cfg.n_layers if uniform else 1

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init_block(self, generator: torch.Generator, *, device, dtype,
                   spec: Optional[CompressionSpec] = None) -> Params:
        """One layer's leaves. With `spec`, MoE expert weights come back
        compressed, one expert at a time (`L.init_moe`); the rest dense."""
        cfg = self.cfg
        norm = lambda: torch.zeros(cfg.d_model, device=device)
        p = {"pre_norm": norm(), "attn": L.init_attention(generator, cfg, device, dtype)}
        if cfg.post_norms:
            p["post_attn_norm"] = norm()
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
            shrink(self.init_block(generator, device=device, dtype=dtype, spec=spec))
            for _ in range(cfg.n_layers)
        ]
        return params

    # ------------------------------------------------------------------
    # paged KV pools
    # ------------------------------------------------------------------
    def init_paged_cache(
        self, num_blocks: int, block_size: int, *, device="cuda",
        dtype=torch.bfloat16,
    ) -> Pools:
        """One pool per layer: `num_blocks` allocatable pages plus the null
        page (device row 0), quantized with `cfg.kv_quant`."""
        cfg = self.cfg
        device = resolve(device)
        return [
            L.init_paged_kv_cache(
                num_blocks + 1, block_size, cfg.n_kv_heads, cfg.d_head,
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
    def _block_apply(self, p, x, kind, positions, cache, paged):
        cfg = self.cfg
        h = L.rms_norm(p["pre_norm"], x, cfg.norm_eps)
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
        if cfg.post_norms:
            out = L.rms_norm(p["post_attn_norm"], out, cfg.norm_eps)
        x = x + out
        h = L.rms_norm(p["pre_mlp_norm"], x, cfg.norm_eps)
        if cfg.n_experts:
            out, _ = L.moe_block(p["moe"], h, cfg)  # aux: a training loss term
        else:
            out = L.mlp_block(p["mlp"], h, cfg)
        if cfg.post_norms:
            out = L.rms_norm(p["post_mlp_norm"], out, cfg.norm_eps)
        return x + out, cache

    def forward(
        self,
        params: Params,
        *,
        tokens: torch.Tensor,     # (B, S) int
        positions: torch.Tensor,  # (B, S) per-request positions
        cache: Pools,
        paged: Dict[str, torch.Tensor],
    ) -> Tuple[torch.Tensor, Pools]:
        """Returns (logits (B, S, V) f32, pools updated in place).

        `paged` holds {block_tables (B, MB), write_slots (B, S), write_pos
        (B, S)} and optionally fresh_pages (F,), copy_pages (C, 2), a
        kv_lens (B,) vector that routes S == 1 steps through the fused
        paged-attention kernel and a window_override that caps its
        attention window (the spec-decode draft)."""
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        if cfg.embed_scale:
            x = L.embed_scale(x, cfg.d_model)
        x = x.to(torch.bfloat16)
        if cfg.pos_emb == "learned":
            idx = torch.clamp(positions.long(), 0, cfg.pos_table - 1)
            x = x + params["pos_embed"][idx].to(torch.bfloat16)
        new_cache = []
        for p, kind, cache_l in zip(params["layers"], self.kinds, cache):
            x, cache_l = self._block_apply(p, x, kind, positions, cache_l, paged)
            new_cache.append(cache_l)
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = L.tied_logits(x, params["embed"])
        else:
            logits = mm(x.to(torch.float32), params["lm_head"])
        if cfg.final_softcap:
            logits = L.softcap(logits, cfg.final_softcap)
        return logits, new_cache

    def score(self, params: Params, tokens: torch.Tensor, *,
              block_size: int = 32) -> torch.Tensor:
        """Teacher-forced logits (S, V) f32 of one token sequence (S,),
        through a paged pool of its own on the tokens' device: row i is the
        next-token distribution after tokens[: i + 1]."""
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
        positions: torch.Tensor,     # (B, 1)
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
        the host discards."""
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

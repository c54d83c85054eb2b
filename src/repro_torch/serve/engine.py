"""Serving: the prefill / decode steps and the generation engine.

Counterpart of `repro/serve/engine.py`, with its two cache regimes:

  paged (the default for attention stacks)
      continuous batching over a block-paged, quantized KV pool with
      DECA-compressed weights. Requests go in through `submit()` and come
      out of `run_until_drained()`; `generate()` submits one request per
      prompt row.
  dense (`paged=False`, and what `paged="auto"` picks for ssm and hybrid
  stacks, whose recurrent state is O(1) a request)
      the fixed-slot ring cache: `generate()` prefills one (B, S) batch
      and decodes it to the end one `Model.decode_step` a token
      (`make_prefill_step`, `make_decode_step`), uncaptured.

Both regimes serve every config of the reference, the bidirectional
encoder (hubert-xlarge) too, as the reference's engines do; an M-RoPE
config (qwen2-vl-7b) gets three equal position streams wherever the
reference broadcasts them (the paged prefill, each decode step, the spec
forwards, the dense engine's prefill and steps): `layers.rotate` expands
every (B, S) position tensor it is given.

At temperature 0 sampling is greedy: the token with the largest logit
(the first on ties, as `jnp.argmax`). Above it every row is sampled with
the reference's keyed stream (`serve/sampling.py`): the key of a token is
(seed, request id, output index), so a request's tokens depend neither on
its batch nor on how decode is chunked. `spec_decode=SpecConfig(...)`
turns on self-speculative decoding: a draft tree re-encoded from the
served weights proposes k tokens per round and one target forward
verifies them with the same keyed samples, so the output is the
non-speculative engine's.

`decode_chunk=1` is the reference's single-step loop: one
`decode_step_paged` a token, sampled right after it on the device, one
host sync a token (`Scheduler._decode_active_single`). On the card each
single step, each decode chunk and each spec launch is one CUDA graph
replay (`serve/graphs.py`), captured per input shape; on the CPU the same
step functions run eagerly. `obs=Observability.default()` installs the
metrics registry, the request tracer and RoofLens (`repro_torch.obs`); the
scheduler's sites read the host clock around its device calls and nothing
else. `sla`, `injector`, `watchdog` and `host_tier` install overload
resilience and the host KV tier (see `GenerationEngine`); `snapshot` and
`restore` persist a tiered engine's warm state across a process's death.
`mesh=` serves sharded over a (data, model) mesh (see `GenerationEngine`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import _leaves, compressed_bytes, make_draft_tree
from repro_torch.core.formats import get_spec
from repro_torch.device import resolve
from repro_torch.dist import sharding as sh
from repro_torch.models.model import Model
from repro_torch.serve import sampling
from repro_torch.serve.graphs import StepGraphs
from repro_torch.checkpoint.ckpt import load_snapshot, save_snapshot
from repro_torch.serve.host_tier import HostTier, TierPayload, apply_page_planes, chain_key
from repro_torch.serve.paged_cache import PagedKVCache, _RadixNode
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.slo import RequestStatus


def make_prefill_step(model: Model, cache_len: Optional[int] = None) -> Callable:
    """prefill(params, batch) -> (last logits (B, V), caches), the
    reference's batch: {"tokens" (B, S) or "embeds" (B, S, D), and
    optionally "positions" (B, S) or (3, B, S)}; a fresh `init_cache` of
    `cache_len` slots (S by default) on the input's device, filled by one
    forward."""

    def prefill(params, batch):
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        x = tokens if tokens is not None else embeds
        b, s = x.shape[:2]
        cache = model.init_cache(b, cache_len or s, device=x.device)
        logits, cache = model.forward(params, tokens=tokens, embeds=embeds,
                                      positions=batch.get("positions"), cache=cache)
        return logits[:, -1, :], cache

    return prefill


def make_decode_step(model: Model) -> Callable:
    """serve_step(params, tokens (B, 1), positions (B, 1), caches) ->
    (logits (B, V), caches)."""

    def serve_step(params, tokens, positions, cache):
        return model.decode_step(params, tokens, positions, cache)

    return serve_step


def make_paged_prefill_step(model: Model) -> Callable:
    """paged_prefill(params, tokens (B,Sp), positions, pools, block_tables,
    write_slots, write_pos, fresh_pages, copies (C,2), last_idx (B,)) ->
    (last-token logits (B, V), pools). Each row's last real token is
    selected on the device, so only the (B, V) rows the sampler needs leave
    the forward. `copies` are the round's copy-on-write page clones ((0, 0)
    rows pad the shape): the cache update applies them in place before any
    scrub or scatter, so a prefix-hit row recomputing its last prompt token
    writes into its private clone, never into the shared page. The same
    step runs chunked prefill, through a length-bounded block table."""

    def paged_prefill(params, tokens, positions, cache, tables, slots, wpos,
                      fresh, copies, last_idx):
        logits, cache = model.forward(
            params, tokens=tokens, positions=positions, cache=cache,
            paged={
                "block_tables": tables,
                "write_slots": slots,
                "write_pos": wpos,
                "fresh_pages": fresh,
                "copy_pages": copies,
            },
        )
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, last_idx.long()], cache

    return paged_prefill


def argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...) int32 argmax in f32 on the logits' device."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def make_paged_decode_step(model: Model) -> Callable:
    """paged_step(params, tokens (M, 1), positions, pools, block_tables,
    write_slots, write_pos, fresh_pages, kv_lens (M,)) -> (logits (M, V),
    pools): one `decode_step_paged` over the M continuous-batching slots,
    fixed-shape, so one captured graph serves every step. `kv_lens` bounds
    the fused attention page walk."""

    def paged_step(params, tokens, positions, cache, tables, slots, wpos, fresh, kv_lens):
        return model.decode_step_paged(params, tokens, positions, cache, tables, slots,
                                       wpos, fresh, kv_lens)

    return paged_step


def make_paged_decode_chunk_step(model: Model) -> Callable:
    """C steps of `decode_step_paged` with sampling, token feedback and the
    EOS / length-cap done flags on the device. `greedy` picks the argmax;
    otherwise slot i's step j is sampled at `temp` under the key
    (`key`, rids[i], start_steps[i] + j) — rids and steps are uint32 words
    in int64 tensors, `temp` and `key` device tensors, so one captured
    graph serves every chunk."""

    def chunk_step(params, cache, tokens0, tables, positions, wslots, wpos,
                   fresh, kv_lens, rids, start_steps, max_steps, eos, active,
                   temp, key, *, greedy: bool):
        def sample(logits, j):
            if greedy:
                return argmax_tokens(logits)
            return sampling.sample_rows_keyed(key, rids, start_steps + j, logits, temp)

        return model.decode_chunk_paged(
            params, tokens0, cache, tables, positions, wslots, wpos, fresh,
            kv_lens, sample_fn=sample, max_steps=max_steps, eos_ids=eos,
            active=active,
        )

    return chunk_step


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding knobs (the reference's `SpecConfig`).

    `k` draft tokens per verify; `draft_codec` names the codec the engine
    re-encodes the weight tree at for the draft (`make_draft_tree`, no
    second checkpoint); `draft_window` > 0 caps the draft's attention
    window so its fused walk is O(window) (verify keeps the full window,
    so output stays exact); `rounds` draft/verify rounds run per device
    launch (default: enough to cover the engine's `decode_chunk` at full
    acceptance)."""

    k: int = 3
    draft_codec: str = "nf4"
    draft_window: int = 0
    rounds: Optional[int] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec_decode needs k >= 1, got {self.k}")
        if self.draft_window < 0:
            raise ValueError("draft_window must be >= 0 (0 = full window)")
        if self.rounds is not None and self.rounds < 1:
            raise ValueError("rounds must be >= 1")


def make_paged_spec_decode_step(
    model: Model, *, k: int, rounds: int, draft_window: int, block_size: int
) -> Callable:
    """`rounds` draft-k/verify-once rounds of `Model.spec_decode_chunk` per
    call. Every row, draft or verify, is sampled under the key of its
    request and global output index (rids, start_steps + the chunk-local
    index), as sequential decode samples it, so the accepted prefix plus
    the verify's next token is what sequential decode emits, greedy or
    not; the draft proposes from the same stream."""

    def spec_step(params, draft_params, cache, tokens0, tables, p0, fresh,
                  rids, start_steps, max_steps, eos, active, temp, key, *,
                  greedy: bool):
        def sample(logits, idx):
            # logits (M, S, V); idx (M, S) chunk-local output indices
            if greedy:
                return argmax_tokens(logits)
            m, s, v = logits.shape
            flat = sampling.sample_rows_keyed(
                key, rids[:, None].expand(m, s).reshape(-1),
                (start_steps[:, None] + idx).reshape(-1), logits.reshape(m * s, v), temp,
            )
            return flat.reshape(m, s)

        return model.spec_decode_chunk(
            params, draft_params, tokens0, cache, tables, p0, fresh,
            sample_fn=sample, max_steps=max_steps, eos_ids=eos, active=active,
            k=k, rounds=rounds, block_size=block_size, draft_window=draft_window,
        )

    return spec_step


_ITEM_12 = "ROADMAP Queue A item 12"


def _check_mesh(mesh, sla, injector, watchdog) -> None:
    """What a mesh engine does not serve yet raises, naming its ROADMAP
    item; none of it runs unsharded instead."""
    if mesh.size() > 1 and (sla is not None or injector is not None or watchdog is not None):
        raise ValueError(
            f"sla / injector / watchdog on a mesh of more than one rank are not "
            f"ported yet ({_ITEM_12}): their decisions read a host clock that "
            "differs from rank to rank")


def _warm_collectives(ctx, device) -> None:
    """One collective on each mesh axis's group, before any decode graph is
    captured: NCCL opens a communicator at its first collective, which
    must not happen inside a capture."""
    for axis in ctx.mesh.mesh_dim_names:
        sh.all_reduce(torch.zeros(1, device=device), axis, ctx)


class GenerationEngine:
    """Continuous-batching generation over a block-paged KV pool.

    Admission into `max_slots` decode slots while free pages suffice,
    page-granular KV allocation, one bucketed prefill launch per admission
    round, and up to `decode_chunk` decode steps per device-resident chunk
    (one host sync per chunk; `decode_chunk=1` is the single-step loop, one
    step and one host sync a token). `kv_quant` names any KV-capable codec of
    `core.codecs` and quantizes the pool end to end; `prefill_batch=False`
    prefills each admitted request in its own launch. `params` must lie on
    `device`, which defaults to the card. `temperature` > 0 samples every
    token with the reference's keyed stream from `seed`; 0 is greedy.

    `spec_decode` builds the draft tree from `params` at
    `SpecConfig.draft_codec` (decompressing every compressed leaf with the
    DECA decompression kernel on the card), drafts k tokens per round
    through the fused paged walk, verifies the k+1 positions in one target
    forward and rolls rejected pages back.

    `paged` ("auto" by default) picks the paged engine exactly when every
    layer is attention, as the reference; False (or an ssm or hybrid
    stack) gives the dense ring-cache engine, whose only request API is
    `generate`, and which refuses `spec_decode`, `sla`, `injector`,
    `watchdog` and `host_tier` with the reference's errors (there is no
    admission loop to gate and no pool to tier).

    `prefix_cache=True` turns on multi-tenant prefix sharing: a radix index
    over `block_size`-token prompt chunks maps cached prefixes to
    refcounted pages, admission pins the longest cached prefix and
    computes only the rest, and the first write into a shared page clones
    it (copy-on-write). It is off by default, so an idle pool drains to
    empty (the index keeps its pages). `prefill_chunk` caps the prompt
    tokens one prefill call processes per request: longer prompts run as
    chunks interleaved with decode rounds, each through a length-bounded
    block table. `None` keeps monolithic prefill. Neither changes a token
    on the CPU; both compose with `spec_decode`.

    `obs` installs a `repro_torch.obs.Observability` bundle: the scheduler
    feeds its metrics registry, tracer and RoofLens at each prefill call
    and decode launch, and the engine binds RoofLens to its traffic shape.
    With `obs=None` (the default) no site reads a clock or allocates.
    `prefill_sla_s` (with `prefill_chunk` and a RoofLens in `obs`) sizes
    each chunked-prefill launch: the largest page-aligned power-of-two span
    whose calibrated predicted wall fits the budget.

    `sla` installs a `repro_torch.serve.slo.SLAPolicy`: a bounded queue,
    TTFT shedding, RoofLens-driven ITL admission deferral, and the
    degradation ladder (evict index pages, spec off, one-page prefill
    chunks, spill to the host tier, park the lowest-priority resident and
    resume it later through the prefix cache). `injector` and `watchdog`
    hook a `repro_torch.dist.fault.FaultInjector` and `StragglerWatchdog`
    into the scheduler's round loop (the serving chaos harness). With
    either of `sla` and `injector`, a prefill whose logits are not finite
    fails only its request; the check rides the sampler's one copy to the
    host. `statuses` maps every finished rid to its `RequestStatus`.

    `host_tier` (True for an unbounded tier, or a configured `HostTier`;
    needs `prefix_cache=True`) installs a host-memory KV tier under the
    prefix cache: pool pressure spills cold cached pages (the KV codec's
    packed planes with a CRC32C) instead of dropping them, admission
    restores tier-resident prefix hits with a verified upload before the
    prefill launch, written into the pools in place so captured decode
    graphs keep replaying, and the ladder gains its `spill` rung.
    `snapshot(dir)` and `restore(dir)` persist such an engine's warm state
    (the reference's format: a snapshot of either package restores in the
    other).

    `mesh` (a `launch.mesh.make_test_mesh` (data, model) DeviceMesh over a
    process group the caller opened, gloo on the CPU, NCCL on the card)
    serves sharded, every rank running this same engine on the same
    requests (SPMD): the weights are cut to this rank's shards by
    `param_spec_tree` in serve mode (`sharding.local_tree`; a spec engine's
    draft tree re-encodes this rank's shards), the pool holds this rank's
    KV heads, the batch rows split over `data` where they divide, an MoE
    stack's experts split over `model` (each rank runs its own experts'
    bins and gathers their outputs), and every rank samples the same
    tokens from whole logits. A snapshot holds whole pages, so it restores
    in an unsharded engine of either package. The dense ring engine
    (`paged=False`) serves on a mesh too: each rank prefills and decodes
    its rows (all of them where `data` does not divide the batch) on its
    shards, its ring caches holding its KV heads and its recurrent states
    its channel block (`Model.init_cache`); `ring` holds them after
    `generate`. `fsdp=True` (the reference's ZeRO weights) also splits
    each FC leaf's other dim over `data`: the contraction dim of a
    column-parallel leaf, the output dim of a row-parallel one, an expert
    stack's K inside each expert. A rank then holds its `data` share of
    those leaves between steps, and every point of use all-gathers the
    leaf whole over `data` (a compressed leaf as its planes) into one
    buffer and releases it after the product (`sharding.gathered`); the
    products are then the non-fsdp mesh engine's. A spec engine's draft
    re-encodes the local shares where the draft's group divides their K;
    elsewhere it is the target's own local leaf, gathered as the target's.
    `sla` / `injector` / `watchdog` on more than one rank are not served
    on a mesh yet (ROADMAP Queue A item 12): they raise.
    """

    def __init__(
        self,
        model: Model,
        params: Any,
        *,
        max_len: int = 2048,
        temperature: float = 0.0,
        seed: int = 0,
        block_size: int = 32,
        max_slots: int = 4,
        num_blocks: Optional[int] = None,
        kv_quant: Optional[str] = None,
        decode_chunk: int = 8,
        prefill_batch: bool = True,
        spec_decode: Optional[SpecConfig] = None,
        prefix_cache: bool = False,
        prefill_chunk: Optional[int] = None,
        obs=None,
        prefill_sla_s: Optional[float] = None,
        sla=None,
        injector=None,
        watchdog=None,
        host_tier=None,
        paged="auto",
        device="cuda",
        mesh=None,
        fsdp: bool = False,
    ):
        if paged == "auto":
            paged = model.attn_only
        self.paged = bool(paged)
        self.mesh, self.fsdp = mesh, fsdp
        if not self.paged:
            if spec_decode is not None:
                raise ValueError("spec_decode requires the paged engine")
            if sla is not None or injector is not None or watchdog is not None:
                raise ValueError(
                    "sla / injector / watchdog require the paged engine "
                    "(the dense ring cache has no admission loop to gate)")
            if host_tier:
                raise ValueError("host_tier requires the paged engine")
        if mesh is not None:
            _check_mesh(mesh, sla, injector, watchdog)
        self.device = resolve(device)
        embed_dev = params["embed"].device
        if embed_dev.type != self.device.type:
            raise ValueError(f"params lie on {embed_dev}, the engine on {self.device}")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh lies on {mesh.device_type}, the engine on "
                             f"{self.device}")
        if kv_quant is not None and kv_quant != model.cfg.kv_quant:
            model = Model(dataclasses.replace(model.cfg, kv_quant=kv_quant))
        self.model = model
        self.cfg = model.cfg
        self.kv_quant = model.cfg.kv_quant
        self.params = params
        self._ctx = None if mesh is None else sh.ShardingCtx(mesh, fsdp=fsdp, mode="serve")
        self.max_len = max_len
        self.temperature = float(temperature)
        self.greedy = self.temperature <= 0.0
        self.seed = seed
        # static device scalars of the sampler: one graph serves every chunk
        self._key = sampling.prng_key(seed, self.device)
        self._temp = torch.tensor(self.temperature, dtype=torch.float32,
                                  device=self.device)
        self.draft_params = None
        self.spec = spec_decode
        self.obs = obs
        if not self.paged:
            self.tier = self.kv = self.scheduler = self.ring = None
            self._prefill = make_prefill_step(model, cache_len=max_len)
            self._decode = make_decode_step(model)
            if obs is not None and obs.rooflens is not None:
                self._bind_rooflens(obs.rooflens, max_slots)  # the whole params
            if self._ctx is not None:
                self.params = sh.local_tree(params, self._ctx)
                _warm_collectives(self._ctx, self.device)
            return
        self.block_size = block_size
        self.max_blocks = math.ceil(max_len / block_size)
        if num_blocks is None:
            num_blocks = max_slots * self.max_blocks
        self.tier: Optional[HostTier] = None
        if host_tier:
            self.tier = host_tier if isinstance(host_tier, HostTier) else HostTier()
        self.kv = PagedKVCache(
            model, num_blocks=num_blocks, block_size=block_size,
            device=self.device, prefix_cache=prefix_cache, tier=self.tier,
            ctx=self._ctx,
        )
        self._paged_prefill = make_paged_prefill_step(model)
        self._paged_decode = make_paged_decode_step(model)
        self._paged_decode_chunk = make_paged_decode_chunk_step(model)
        self.spec_rounds = 0
        # the step runs on this rank's shards under a mesh
        local = params if self._ctx is None else sh.local_tree(params, self._ctx)
        if spec_decode is not None:
            # on a mesh the rank's own shards re-encoded (an MoE leaf's
            # local experts only), each under its shard's spec
            self.draft_params = make_draft_tree(
                local, get_spec(spec_decode.draft_codec), layer_stack=model.layer_stack)
            if self._ctx is not None:
                sh.adopt_specs(self.draft_params, local, self._ctx)
            self.spec_rounds = spec_decode.rounds or max(
                1, -(-max(1, decode_chunk) // (spec_decode.k + 1))
            )
            self._paged_spec_chunk = make_paged_spec_decode_step(
                model, k=spec_decode.k, rounds=self.spec_rounds,
                draft_window=spec_decode.draft_window, block_size=block_size,
            )
        if obs is not None and obs.rooflens is not None:
            self._bind_rooflens(obs.rooflens, max_slots)  # the whole params
        self.params = local
        if self._ctx is not None:
            _warm_collectives(self._ctx, self.device)
        self._decode_graphs = self._chunk_graphs = self._spec_graphs = None
        if self.device.type == "cuda":
            self._decode_graphs = StepGraphs(self._decode_device, device=self.device,
                                             pools=lambda: self.kv.pools)
            self._chunk_graphs = StepGraphs(self._chunk_device, device=self.device,
                                            pools=lambda: self.kv.pools)
            if spec_decode is not None:
                self._spec_graphs = StepGraphs(self._spec_device, device=self.device,
                                               pools=lambda: self.kv.pools)
        # window freeing is sound only when every layer's attention is local:
        # one global layer keeps the whole history live (the pool is shared
        # by all layers), so gemma2's alternating stack never arms it
        all_local = all(k == "attn_local" for k in model.kinds)
        self.scheduler = Scheduler(
            self.kv,
            max_slots=max_slots,
            max_len=max_len,
            prefill_fn=self._run_paged_prefill,
            decode_fn=self._run_paged_decode,
            decode_chunk_fn=self._run_paged_decode_chunk,
            sample_fn=self._sample_rows,
            scrub_fn=self._run_paged_scrub,
            chunk=max(1, decode_chunk),
            prefill_batch=prefill_batch,
            local_window=self.cfg.window if all_local and self.cfg.window > 0 else None,
            spec_fn=self._run_paged_spec_chunk if spec_decode is not None else None,
            spec_k=spec_decode.k if spec_decode is not None else 0,
            spec_rounds=self.spec_rounds,
            spec_window=spec_decode.draft_window if spec_decode is not None else 0,
            prefill_chunk=prefill_chunk,
            obs=obs,
            prefill_sla_s=prefill_sla_s,
            sla=sla,
            injector=injector,
            watchdog=watchdog,
            tier_restore_fn=self._run_tier_restore if self.tier is not None else None,
        )

    def _bind_rooflens(self, lens, max_slots: int) -> None:
        """Bind RoofLens to this engine's traffic shape: the stored bytes of
        every leaf (compressed leaves count their packed planes), the dense
        elements behind the compressed leaves (the decompression vector-op
        term; an expert-stacked leaf counts its `shape`, one expert's, as
        the reference's bind does), the weight and KV codecs, the decode batch rows, and the
        draft tree's stored bytes (on a mesh, this rank's re-encoded
        shards'), depth and window on a spec engine."""
        compressed = [l for l in _leaves(self.params) if isinstance(l, CompressedTensor)]
        spec = self.spec
        lens.bind(
            cfg=self.cfg,
            weight_bytes=compressed_bytes(self.params),
            weight_elems=sum(math.prod(ct.shape) for ct in compressed),
            weight_spec=compressed[0].spec.name if compressed else None,
            kv_quant=self.kv_quant,
            m_slots=max_slots,
            n_chips=1 if self.mesh is None else self.mesh.size(),
            draft_weight_bytes=(
                compressed_bytes(self.draft_params)
                if self.draft_params is not None else None
            ),
            spec_k=spec.k if spec is not None else 0,
            draft_window=spec.draft_window if spec is not None else 0,
        )

    def _t(self, a) -> torch.Tensor:
        """A host array as an int32 tensor on the engine's device (bools as
        0 / 1, uint32 words as their two's complement)."""
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=self.device)

    def _sample_rows(self, logits: torch.Tensor, rids, steps, guard: bool = False):
        """Tokens of logits (N, V) on the device, row n keyed on (rids[n],
        steps[n]); only the (N,) ids cross to host. With `guard`, each row's
        all-finite flag is computed on the device beside its token and
        both cross in the same copy: (tokens, flags)."""
        if self.greedy:
            toks = argmax_tokens(logits)
        else:
            toks = sampling.sample_rows_keyed(
                self._key, sampling.as_u32(self._t(rids)),
                sampling.as_u32(self._t(steps)), logits, self._temp)
        if not guard:
            return toks.cpu().numpy()
        finite = torch.isfinite(logits).all(dim=-1).to(torch.int32)
        both = torch.stack([toks.to(torch.int32), finite]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _run_paged_prefill(self, tokens, positions, tables, slots, wpos, fresh,
                           copies, last_idx):
        with sh.scope(self._ctx):
            logits, self.kv.pools = self._paged_prefill(
                self.params, self._t(tokens), self._t(positions), self.kv.pools,
                self._t(tables), self._t(slots), self._t(wpos), self._t(fresh),
                self._t(copies), self._t(last_idx),
            )
        return logits

    def _run_paged_scrub(self, pages):
        self.kv.pools = self.model.paged_scrub(self.kv.pools, self._t(pages))

    def _run_tier_restore(self, dev_pages, planes_list):
        """Upload verified tier payloads into their device pages, in place,
        before the prefill launch that reads them: the pools keep their
        addresses, so the decode graphs captured on them replay unchanged.
        A payload holds whole pages; each rank uploads its KV heads."""
        apply_page_planes(self.kv.pools, dev_pages,
                          [self.kv.local_page_planes(p) for p in planes_list])

    def _decode_device(self, tokens, positions, tables, slots, wpos, fresh, kv_lens):
        """One decode step over int32 device tensors -> logits (M, V)."""
        with sh.scope(self._ctx):
            logits, self.kv.pools = self._paged_decode(
                self.params, tokens, positions, self.kv.pools, tables, slots, wpos, fresh,
                kv_lens,
            )
        return logits

    def _chunk_device(self, tokens0, tables, positions, wslots, wpos, fresh,
                      kv_lens, rids, start_steps, max_steps, eos, active):
        """The decode chunk over int32 device tensors -> tokens (C, M)."""
        with sh.scope(self._ctx):
            toks, self.kv.pools = self._paged_decode_chunk(
                self.params, self.kv.pools, tokens0, tables, positions, wslots,
                wpos, fresh, kv_lens, sampling.as_u32(rids),
                sampling.as_u32(start_steps), max_steps, eos, active != 0,
                self._temp, self._key, greedy=self.greedy,
            )
        return toks

    def _spec_device(self, tokens0, tables, p0, fresh, rids, start_steps,
                     max_steps, eos, active):
        """A spec launch over int32 device tensors -> the packed emissions
        (rounds * (k + 1), M) stacked over the per-round counts (rounds, M)."""
        with sh.scope(self._ctx):
            out, e_rounds, self.kv.pools = self._paged_spec_chunk(
                self.params, self.draft_params, self.kv.pools, tokens0, tables, p0,
                fresh, sampling.as_u32(rids), sampling.as_u32(start_steps),
                max_steps, eos, active != 0, self._temp, self._key,
                greedy=self.greedy,
            )
        return torch.cat([out, e_rounds])

    def _run_step(self, graphs: Optional[StepGraphs], fn: Callable, arrays) -> np.ndarray:
        """One device step on host arrays: a graph replay on the card, the
        eager step function on the CPU; its output is the one copy back."""
        if graphs is not None:
            return graphs(arrays).cpu().numpy()
        return fn(*(self._t(a) for a in arrays)).cpu().numpy()

    def _run_paged_decode(self, *arrays) -> torch.Tensor:
        """One decode step (the scheduler's `decode_fn` arguments): a graph
        replay on the card, the eager step on the CPU. The logits (M, V)
        stay on the device for `_sample_rows`, whose (M,) tokens are the
        step's one copy back; on the card they are the graph's output
        buffer, which the next step's replay overwrites."""
        if self._decode_graphs is not None:
            return self._decode_graphs(arrays)
        return self._decode_device(*(self._t(a) for a in arrays))

    def _run_paged_decode_chunk(self, *arrays):
        """One device-resident chunk (the scheduler's `decode_chunk_fn`
        arguments); only the (C, M) sampled token ids cross back."""
        return self._run_step(self._chunk_graphs, self._chunk_device, arrays)

    def _run_paged_spec_chunk(self, *arrays):
        """One launch of `spec_rounds` rounds (the scheduler's `spec_fn`
        arguments); the packed emissions and the per-round counts cross
        to the host in one copy."""
        both = self._run_step(self._spec_graphs, self._spec_device, arrays)
        cap = both.shape[0] - self.spec_rounds
        return both[:cap], both[cap:]

    def submit(self, prompt: np.ndarray, *, max_new_tokens: int,
               eos_id: Optional[int] = None, deadline_s: Optional[float] = None,
               priority: int = 0) -> int:
        """Enqueue one request; returns its id (key into run_until_drained).
        `deadline_s` drops the request (EXPIRED, or PREEMPTED once parked)
        when it can no longer be served in time; `priority` orders
        park-victim selection under pool pressure."""
        self._require_paged("submit")
        return self.scheduler.submit(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            deadline_s=deadline_s, priority=priority,
        )

    @property
    def statuses(self) -> Dict[int, Any]:
        """rid -> terminal `RequestStatus` of every finished request. Unlike
        results, statuses are not drained: they accumulate for the engine's
        life."""
        return dict(self.scheduler.statuses)

    def run_until_drained(self) -> Dict[int, np.ndarray]:
        """Step the scheduler until every submitted request completes."""
        self._require_paged("run_until_drained")
        return self.scheduler.run_until_drained()

    def _require_paged(self, what: str) -> None:
        if not self.paged:
            raise ValueError(f"{what} requires the paged engine; the dense engine "
                             "serves through generate()")

    # ------------------------------------------------------------------
    # crash-safe persistence
    # ------------------------------------------------------------------
    def _require_tiered(self, what: str) -> None:
        if self.kv.prefix is None or self.tier is None:
            raise RuntimeError(
                f"{what} requires the paged engine with prefix_cache=True and a "
                "host_tier (the snapshot format is the tier's content-addressed "
                "payloads)"
            )

    def _snapshot_fields(self) -> Dict[str, Any]:
        """The settings a resumed session's tokens depend on."""
        return {
            "kv_quant": self.kv_quant or "none",
            "block_size": self.block_size,
            "seed": self.seed,
            "temperature": self.temperature,
            "max_len": self.max_len,
        }

    def snapshot(self, directory: str) -> Dict[str, int]:
        """Persist the engine's warm state to `directory`, atomically
        (`checkpoint.ckpt.save_snapshot`, manifest written last). Every
        resident is parked (its emitted tokens fold into its prompt, the
        overload-preemption path), every index page spills into the host
        tier as a checksummed payload, and the radix index's structure, the
        tier payloads, the queued and parked requests, the undrained
        results and the sampling configuration go to disk. A fresh engine
        built with the same model, codec, block size, seed and temperature
        `restore`s it and resumes the parked sessions with the same tokens:
        their keys (seed, rid, output index) survive. This engine stays
        usable: its cached pages are now in the tier, and the next hit
        restores them. On a mesh every rank calls it (the head slices of
        each page are gathered whole) and rank 0 writes the directory.
        Returns {"nodes": ..., "requests": ...}."""
        self._require_tiered("snapshot")
        sched = self.scheduler
        for slot in range(sched.max_slots):
            if sched.slots[slot] is not None:
                sched._park(slot)
        self.kv.spill_all()
        prefix = self.kv.prefix
        payloads = self.tier.state()
        arrays: Dict[str, np.ndarray] = {}
        node_meta = []
        # depth first, parents before children: restore rebuilds top-down
        order: Dict[int, int] = {id(prefix._root): -1}
        stack = [prefix._root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                i = len(node_meta)
                order[id(c)] = i
                p = payloads[c.key]
                arrays[f"node/{i}/chunk"] = np.frombuffer(c.chunk, np.uint8)
                arrays[f"node/{i}/blob"] = np.frombuffer(p.blob, np.uint8)
                node_meta.append({
                    "parent": order[id(n)],
                    "tick": c.tick,
                    "codec": p.codec,
                    "wire_id": p.wire_id,
                    "planes": [[path, list(shape), dt] for path, shape, dt in p.planes],
                    "nbytes": p.nbytes,
                    "crc": p.crc,
                })
                stack.append(c)
        req_meta = []
        for j, r in enumerate(sched.queue):
            arrays[f"req/{j}/prompt"] = np.asarray(r.prompt, np.int32)
            arrays[f"req/{j}/done"] = np.asarray(r.done_tokens, np.int32)
            req_meta.append({
                "rid": r.rid,
                "max_new_tokens": r.max_new_tokens,
                "eos_id": r.eos_id,
                "priority": r.priority,
                "parks": r.parks,
                "was_parked": r.was_parked,
            })
        # finished but undrained results survive too: a session whose
        # tokens were computed but never fetched is still a session
        statuses = {}
        for rid, toks in sched.results.items():
            arrays[f"res/{rid}"] = np.asarray(toks, np.int32)
            statuses[str(rid)] = sched.statuses[rid].value
        meta = {
            "version": 1,
            **self._snapshot_fields(),
            "next_rid": sched._next_rid,
            "tick": prefix._tick,
            "nodes": node_meta,
            "requests": req_meta,
            "results": statuses,
        }
        if self.mesh is None:
            save_snapshot(directory, arrays, meta)
        else:  # every rank holds the same whole pages: rank 0 writes them
            import torch.distributed as dist

            if dist.get_rank() == 0:
                save_snapshot(directory, arrays, meta)
            dist.barrier()
        return {"nodes": len(node_meta), "requests": len(req_meta)}

    def restore(self, directory: str) -> Dict[str, int]:
        """Load a `snapshot` into this freshly built engine: the radix index
        is rebuilt with every node tiered (no device pages: a tenant's pages
        come back on its first hit), the tier refills with the saved
        payloads (a damaged one verbatim: it degrades to recompute at
        admission, as it would have before), and the queued and parked
        sessions re-enter the queue under their rids, so their sampling
        keys continue where they stopped. Raises ValueError when this
        engine's codec, block size, seed, temperature or max_len differ
        from the snapshot's: resumed tokens could not be the same."""
        self._require_tiered("restore")
        arrays, meta = load_snapshot(directory)
        if meta.get("version") != 1:
            raise ValueError(f"unsupported snapshot version {meta.get('version')!r}")
        for field, mine in self._snapshot_fields().items():
            if meta[field] != mine:
                raise ValueError(
                    f"snapshot {field} mismatch: saved {meta[field]!r}, this engine "
                    f"has {mine!r}; resumed outputs would not be the same"
                )
        prefix, tier, sched = self.kv.prefix, self.tier, self.scheduler
        if (prefix.pages or prefix.tiered_count or sched.queue
                or any(r is not None for r in sched.slots)):
            raise RuntimeError(
                "restore requires a fresh engine (empty prefix index, tier and queue)")
        if tier.capacity_pages is not None and tier.capacity_pages < len(meta["nodes"]):
            raise ValueError(
                f"tier capacity ({tier.capacity_pages} pages) is smaller than the "
                f"snapshot ({len(meta['nodes'])} pages)"
            )
        built = []
        for i, nm in enumerate(meta["nodes"]):
            parent = prefix._root if nm["parent"] < 0 else built[nm["parent"]]
            chunk = arrays[f"node/{i}/chunk"].tobytes()
            node = _RadixNode(chunk, None, parent, nm["tick"],
                              key=chain_key(parent.key, chunk))
            parent.children[chunk] = node
            prefix._tiered += 1
            built.append(node)
            tier.put(node.key, TierPayload(
                codec=nm["codec"],
                wire_id=nm["wire_id"],
                planes=tuple((path, tuple(shape), dt) for path, shape, dt in nm["planes"]),
                nbytes=nm["nbytes"],
                crc=nm["crc"],
                blob=arrays[f"node/{i}/blob"].tobytes(),
            ))
        prefix._tick = meta["tick"]
        now = sched._clock()
        for j, rm in enumerate(meta["requests"]):
            r = Request(rm["rid"], np.asarray(arrays[f"req/{j}/prompt"], np.int32),
                        rm["max_new_tokens"], rm["eos_id"], priority=rm["priority"],
                        submit_t=now)
            r.done_tokens = [int(t) for t in arrays[f"req/{j}/done"]]
            r.parks = rm["parks"]
            r.was_parked = rm["was_parked"]
            sched.queue.append(r)
        for rid_s, status in meta.get("results", {}).items():
            rid = int(rid_s)
            sched.results[rid] = np.asarray(arrays[f"res/{rid}"], np.int32)
            sched.statuses[rid] = RequestStatus(status)
        sched._next_rid = max(sched._next_rid, meta["next_rid"])
        return {"nodes": len(meta["nodes"]), "requests": len(meta["requests"])}

    def generate(self, prompts: np.ndarray, n_steps: int) -> np.ndarray:
        """prompts (B, S) int -> generated tokens (B, n_steps)."""
        if not self.paged:
            return self._generate_dense(np.asarray(prompts), n_steps)
        rids = [
            self.submit(np.asarray(p, np.int32), max_new_tokens=n_steps)
            for p in prompts
        ]
        done = self.run_until_drained()
        return np.stack([done[r] for r in rids], axis=0)

    def _generate_dense(self, prompts: np.ndarray, n_steps: int) -> np.ndarray:
        """The dense engine, as the reference's: one prefill of the (B, S)
        batch into fresh `max_len`-slot caches, then `n_steps` decode steps
        at positions S, S + 1, ...; row i's token j is sampled under the
        key (seed, i, j), greedy at temperature 0. Each sampled token is
        the one copy back to the host a step. An M-RoPE config gets its
        positions as three equal streams (`layers.rotate`), as the
        reference passes them. On a mesh every step runs under the
        engine's ctx on this rank's shards, and the logits come back whole,
        so every rank samples the same tokens. The caches stay in `ring`."""
        b, s = prompts.shape
        rows = np.arange(b)
        with sh.scope(self._ctx):
            logits, cache = self._prefill(self.params, {"tokens": self._t(prompts)})
            tok = self._sample_rows(logits, rows, np.zeros(b))
            out = []
            for i in range(n_steps):
                out.append(tok)
                pos = torch.full((b, 1), s + i, dtype=torch.int32, device=self.device)
                logits, cache = self._decode(self.params, self._t(tok[:, None]),
                                             pos, cache)
                tok = self._sample_rows(logits, rows, np.full(b, i + 1))
        self.ring = cache
        return np.stack(out, axis=1)

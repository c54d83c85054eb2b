"""Serving: the paged prefill / decode-chunk steps and the generation engine.

Counterpart of the paged path of `repro/serve/engine.py`: continuous
batching over a block-paged, quantized KV pool with DECA-compressed
weights. Requests go in through `submit()` and come out of
`run_until_drained()`; `generate()` submits one request per prompt row.

At temperature 0 sampling is greedy: the token with the largest logit
(the first on ties, as `jnp.argmax`). Above it every row is sampled with
the reference's keyed stream (`serve/sampling.py`): the key of a token is
(seed, request id, output index), so a request's tokens depend neither on
its batch nor on how decode is chunked. `spec_decode=SpecConfig(...)`
turns on self-speculative decoding: a draft tree re-encoded from the
served weights proposes k tokens per round and one target forward
verifies them with the same keyed samples, so the output is the
non-speculative engine's.

On the card each decode chunk and each spec launch is one CUDA graph
replay (`serve/graphs.py`), captured per input shape; on the CPU the same
step functions run eagerly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.decompress import make_draft_tree
from repro_torch.core.formats import get_spec
from repro_torch.device import resolve
from repro_torch.models.model import Model
from repro_torch.serve import sampling
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.scheduler import Scheduler


def make_paged_prefill_step(model: Model) -> Callable:
    """paged_prefill(params, tokens (B,Sp), positions, pools, block_tables,
    write_slots, write_pos, fresh_pages, last_idx (B,)) -> (last-token
    logits (B, V), pools). Each row's last real token is selected on the
    device, so only the (B, V) rows the sampler needs leave the forward."""

    def paged_prefill(params, tokens, positions, cache, tables, slots, wpos,
                      fresh, last_idx):
        logits, cache = model.forward(
            params, tokens=tokens, positions=positions, cache=cache,
            paged={
                "block_tables": tables,
                "write_slots": slots,
                "write_pos": wpos,
                "fresh_pages": fresh,
            },
        )
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, last_idx.long()], cache

    return paged_prefill


def argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...) int32 argmax in f32 on the logits' device."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


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


class GenerationEngine:
    """Continuous-batching generation over a block-paged KV pool.

    Admission into `max_slots` decode slots while free pages suffice,
    page-granular KV allocation, one bucketed prefill launch per admission
    round, and up to `decode_chunk` decode steps per device-resident chunk
    (one host sync per chunk). `kv_quant` names any KV-capable codec of
    `core.codecs` and quantizes the pool end to end; `prefill_batch=False`
    prefills each admitted request in its own launch. `params` must lie on
    `device`, which defaults to the card. `temperature` > 0 samples every
    token with the reference's keyed stream from `seed`; 0 is greedy.

    `spec_decode` builds the draft tree from `params` at
    `SpecConfig.draft_codec` (decompressing every compressed leaf with the
    DECA decompression kernel on the card), drafts k tokens per round
    through the fused paged walk, verifies the k+1 positions in one target
    forward and rolls rejected pages back. Only the paged engine exists in
    the port; `paged=False` raises.
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
        paged: bool = True,
        device="cuda",
    ):
        if not paged:
            if spec_decode is not None:
                raise ValueError("spec_decode requires the paged engine")
            raise ValueError(
                "the dense ring-cache engine is not ported (ROADMAP Queue A "
                "item 10); the port serves the paged path only"
            )
        self.device = resolve(device)
        embed_dev = params["embed"].device
        if embed_dev.type != self.device.type:
            raise ValueError(f"params lie on {embed_dev}, the engine on {self.device}")
        if kv_quant is not None and kv_quant != model.cfg.kv_quant:
            model = Model(dataclasses.replace(model.cfg, kv_quant=kv_quant))
        self.model = model
        self.cfg = model.cfg
        self.kv_quant = model.cfg.kv_quant
        self.params = params
        self.max_len = max_len
        self.temperature = float(temperature)
        self.greedy = self.temperature <= 0.0
        self.seed = seed
        # static device scalars of the sampler: one graph serves every chunk
        self._key = sampling.prng_key(seed, self.device)
        self._temp = torch.tensor(self.temperature, dtype=torch.float32,
                                  device=self.device)
        self.block_size = block_size
        self.max_blocks = math.ceil(max_len / block_size)
        if num_blocks is None:
            num_blocks = max_slots * self.max_blocks
        self.kv = PagedKVCache(
            model, num_blocks=num_blocks, block_size=block_size,
            device=self.device,
        )
        self._paged_prefill = make_paged_prefill_step(model)
        self._paged_decode_chunk = make_paged_decode_chunk_step(model)
        self.draft_params = None
        self.spec_rounds = 0
        if spec_decode is not None:
            self.draft_params = make_draft_tree(
                params, get_spec(spec_decode.draft_codec),
                layer_stack=model.layer_stack,
            )
            self.spec_rounds = spec_decode.rounds or max(
                1, -(-max(1, decode_chunk) // (spec_decode.k + 1))
            )
            self._paged_spec_chunk = make_paged_spec_decode_step(
                model, k=spec_decode.k, rounds=self.spec_rounds,
                draft_window=spec_decode.draft_window, block_size=block_size,
            )
        self._chunk_graphs = self._spec_graphs = None
        if self.device.type == "cuda":
            self._chunk_graphs = StepGraphs(self._chunk_device, device=self.device,
                                            pools=lambda: self.kv.pools)
            if spec_decode is not None:
                self._spec_graphs = StepGraphs(self._spec_device, device=self.device,
                                               pools=lambda: self.kv.pools)
        self.scheduler = Scheduler(
            self.kv,
            max_slots=max_slots,
            max_len=max_len,
            prefill_fn=self._run_paged_prefill,
            decode_chunk_fn=self._run_paged_decode_chunk,
            sample_fn=self._sample_rows,
            scrub_fn=self._run_paged_scrub,
            chunk=max(1, decode_chunk),
            prefill_batch=prefill_batch,
            spec_fn=self._run_paged_spec_chunk if spec_decode is not None else None,
            spec_k=spec_decode.k if spec_decode is not None else 0,
            spec_rounds=self.spec_rounds,
            spec_window=spec_decode.draft_window if spec_decode is not None else 0,
        )

    def _t(self, a) -> torch.Tensor:
        """A host array as an int32 tensor on the engine's device (bools as
        0 / 1, uint32 words as their two's complement)."""
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=self.device)

    def _sample_rows(self, logits: torch.Tensor, rids, steps) -> np.ndarray:
        """Tokens of logits (N, V) on the device, row n keyed on (rids[n],
        steps[n]); only the (N,) ids cross to host."""
        if self.greedy:
            toks = argmax_tokens(logits)
        else:
            toks = sampling.sample_rows_keyed(
                self._key, sampling.as_u32(self._t(rids)),
                sampling.as_u32(self._t(steps)), logits, self._temp)
        return toks.cpu().numpy()

    def _run_paged_prefill(self, tokens, positions, tables, slots, wpos, fresh,
                           last_idx):
        logits, self.kv.pools = self._paged_prefill(
            self.params, self._t(tokens), self._t(positions), self.kv.pools,
            self._t(tables), self._t(slots), self._t(wpos), self._t(fresh),
            self._t(last_idx),
        )
        return logits

    def _run_paged_scrub(self, pages):
        self.kv.pools = self.model.paged_scrub(self.kv.pools, self._t(pages))

    def _chunk_device(self, tokens0, tables, positions, wslots, wpos, fresh,
                      kv_lens, rids, start_steps, max_steps, eos, active):
        """The decode chunk over int32 device tensors -> tokens (C, M)."""
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
               eos_id: Optional[int] = None) -> int:
        """Enqueue one request; returns its id (key into run_until_drained)."""
        return self.scheduler.submit(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id
        )

    def run_until_drained(self) -> Dict[int, np.ndarray]:
        """Step the scheduler until every submitted request completes."""
        return self.scheduler.run_until_drained()

    def generate(self, prompts: np.ndarray, n_steps: int) -> np.ndarray:
        """prompts (B, S) int -> generated tokens (B, n_steps)."""
        rids = [
            self.submit(np.asarray(p, np.int32), max_new_tokens=n_steps)
            for p in prompts
        ]
        done = self.run_until_drained()
        return np.stack([done[r] for r in rids], axis=0)

"""RoofLens: the 3D roofline as a *predictive* serving model, validated live.

Port-owned copy of `repro/obs/rooflens.py`, priced on the H100 profile by
default (`core.roofsurface.H100_SXM`).

The roofsurface (core/roofsurface.py) prices the three serving traffic
streams — compressed weights, KV pages, activations — as rates. RoofLens
closes the loop (DESIGN.md §14, the inference-sim shape): before each
prefill batch or decode chunk the scheduler asks for a predicted step time
from the batch composition (rows, span, per-slot context lengths, codec,
chips), and after the host sync it records the measured wall time. The
paired samples give per-regime model error — prefill vs decode, per codec
combination — which is exactly the calibration data the planned SLA
admission controller (ROADMAP: SLA-aware scheduling) needs before it can
promise TTFT/ITL budgets.

Two-stage accuracy model:

  * the *raw* prediction is pure roofline time: counted flops / bytes /
    vector-ops through `surface_step_time` on a HardwareProfile. On the
    card this is the §4 optimal; a host-bound step, or a CPU run, is off
    by a large constant factor — which is fine, because
  * `calibrate()` fits one multiplicative scale per regime (median of
    measured/raw over the samples so far) that absorbs the host-dispatch
    constant. Post-calibration ratios answer the question that matters for
    scheduling: does the model *rank and scale* step times correctly as
    batch composition changes? `error_report` says, per regime.

Traffic accounting is deliberately first-order (documented per term below)
— the roofline's job is relative structure, not cycle accuracy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import roofsurface as rs
from repro_torch.core.formats import get_spec

# residual-stream activation planes read+written per token per layer
# (x, normed x, qkv/gate intermediates, mixer out, ffn in/out, residual
# adds), bf16. A coarse constant: activations are a minor term next to
# weights + KV at serving batch sizes, it just must not be zero.
_ACT_PLANES = 12
_ACT_BYTES = 2  # bf16


@dataclasses.dataclass
class _Sample:
    regime: str       # 'prefill' | 'prefill_chunk' | 'decode' | 'draft' |
                      # 'verify' | 'tier_restore'
    codec: str        # 'w=<spec>,kv=<quant>' traffic-shape key
    raw_pred_s: float  # unscaled roofline prediction
    measured_s: float


class RoofLens:
    """Predicted-vs-measured step-time loop over `surface_step_time`.

    Construct bare (`RoofLens()` — H100-SXM profile), then let the engine
    `bind()` its model geometry; or pass a profile explicitly. All methods
    are host-side only; `observe_*` is an O(1) append plus two histogram
    records when a registry is attached.
    """

    def __init__(self, profile: Optional[rs.HardwareProfile] = None, *,
                 registry=None):
        self.profile = profile if profile is not None else rs.H100_SXM
        self.registry = registry
        self.samples: List[_Sample] = []
        self.scale: Dict[str, float] = {}  # regime -> calibrated multiplier
        self._bound = False

    # -- engine binding -----------------------------------------------------

    def bind(self, *, cfg, weight_bytes: int, kv_quant: Optional[str],
             m_slots: int, weight_spec: Optional[str] = None,
             weight_elems: int = 0, n_chips: int = 1,
             draft_weight_bytes: Optional[int] = None,
             spec_k: int = 0, draft_window: int = 0) -> None:
        """Called by GenerationEngine: model geometry + weight-stream size.

        weight_bytes   stored bytes of the (possibly compressed) param tree
                       — the per-step weight read term
        weight_elems   dense elements behind the compressed leaves — sizes
                       the decompression vector-op term (0 = dense weights)
        m_slots        decode batch rows: the fixed-shape step computes all
                       of them every step, active or not
        draft_weight_bytes / spec_k / draft_window
                       speculative decode (DESIGN.md §16): the draft tree's
                       stored bytes (its per-step weight read), draft depth,
                       and the draft's attention-window cap (0 = full) —
                       left at the defaults on a non-speculative engine
        """
        self.cfg = cfg
        self.weight_bytes = float(weight_bytes)
        self.weight_elems = float(weight_elems)
        self.kv_quant = kv_quant if kv_quant not in (None, "", "none") else None
        self.weight_spec = weight_spec
        self.m_slots = m_slots
        self.n_chips = n_chips
        self.draft_weight_bytes = (
            float(draft_weight_bytes) if draft_weight_bytes else None
        )
        self.spec_k = spec_k
        self.draft_window = draft_window
        self.codec_key = f"w={weight_spec or 'dense'},kv={kv_quant or 'none'}"
        self._attn_layers = [
            k for k in cfg.layer_kinds() if k in ("attn", "attn_local")
        ]
        # 2 FMA per weight element touched per token: every matmul in the
        # stack, embeddings excluded to first order
        self._linear_flops_per_token = 2.0 * cfg.active_param_count()
        if self.weight_elems and weight_spec is not None:
            spec = get_spec(weight_spec)
            self._w_vops = (
                rs.software_vops_per_tile(spec)
                * self.weight_elems / rs.TILE_ELEMS
            )
        else:
            self._w_vops = 0.0
        self._bound = True

    # -- traffic terms (first-order; see module docstring) -------------------

    def _attn_len(self, kind: str, kv_len: float) -> float:
        if kind == "attn_local":
            return min(kv_len, self.cfg.window)
        return kv_len

    def _attn_flops(self, kv_len: float) -> float:
        """QK^T + PV FMAs for one query token: 4 * Hq * Dh per KV token,
        summed over attention layers (window-bounded for local ones)."""
        c = self.cfg
        per = 4.0 * c.n_heads * c.d_head
        return sum(per * self._attn_len(k, kv_len) for k in self._attn_layers)

    def _kv_token_bytes(self) -> float:
        """KV bytes one cached token costs per attention layer on read or
        write (codec code planes + scales + position, from roofsurface)."""
        c = self.cfg
        return rs.kv_bytes_per_token(
            self.kv_quant or "none", c.n_kv_heads, c.d_head
        )

    def _kv_read_bytes(self, kv_len: float) -> float:
        per = self._kv_token_bytes()
        return sum(per * self._attn_len(k, kv_len) for k in self._attn_layers)

    def _kv_vops(self, kv_len: float) -> float:
        c = self.cfg
        per = rs.kv_decode_vops_per_token(
            self.kv_quant or "none", c.n_kv_heads, c.d_head
        )
        return sum(per * self._attn_len(k, kv_len) for k in self._attn_layers)

    def _act_bytes_per_token(self) -> float:
        return _ACT_PLANES * _ACT_BYTES * self.cfg.d_model * self.cfg.n_layers

    # -- predictions --------------------------------------------------------

    def _raw_prefill(self, batch_rows: int, span: int) -> float:
        self._require_bound()
        tokens = float(batch_rows) * span
        # causal attention: mean context over the span is ~span/2
        flops = tokens * (
            self._linear_flops_per_token + self._attn_flops(span / 2.0)
        )
        kv_write = len(self._attn_layers) * self._kv_token_bytes()
        bytes_ = self.weight_bytes + tokens * (
            self._act_bytes_per_token() + kv_write
        )
        vops = tokens / 512.0 * self._w_vops if self._w_vops else 0.0
        return rs.surface_step_time(
            self.profile, flops=flops, hbm_bytes=bytes_, vector_ops=vops,
            n_chips=self.n_chips,
        )

    def _raw_prefill_chunk(self, batch_rows: int, span: int,
                           table_tokens: float) -> float:
        """Chunked prefill (DESIGN.md §15) is its own regime: unlike
        monolithic prefill, each chunk's queries attend a prefix *already
        in the pool* — so on top of the write-side traffic there is a
        KV gather-read of the length-bounded table (table_tokens ≈ tw * bs
        per row), and the attention flops see the full written prefix, not
        span/2. Its time constant also differs from both neighbours (small
        launches like decode, matmul-shaped like prefill), which is why it
        calibrates separately."""
        self._require_bound()
        tokens = float(batch_rows) * span
        # queries at the chunk's tail attend everything written so far:
        # mean context ~ table_tokens - span/2
        flops = tokens * (
            self._linear_flops_per_token
            + self._attn_flops(max(1.0, table_tokens - span / 2.0))
        )
        kv_write = len(self._attn_layers) * self._kv_token_bytes()
        bytes_ = (
            self.weight_bytes
            + tokens * (self._act_bytes_per_token() + kv_write)
            + batch_rows * self._kv_read_bytes(table_tokens)
        )
        vops = (
            (tokens / 512.0 * self._w_vops if self._w_vops else 0.0)
            + batch_rows * self._kv_vops(table_tokens)
        )
        return rs.surface_step_time(
            self.profile, flops=flops, hbm_bytes=bytes_, vector_ops=vops,
            n_chips=self.n_chips,
        )

    def _raw_decode(self, kv_lens: Sequence[float], steps: int) -> float:
        """`steps` fixed-shape decode steps over `m_slots` rows of
        which `len(kv_lens)` are active with the given context lengths at
        chunk start (growth inside the chunk is approximated at +steps/2)."""
        self._require_bound()
        mid = [kv + steps / 2.0 for kv in kv_lens]
        per_step_flops = (
            self.m_slots * self._linear_flops_per_token
            + sum(self._attn_flops(kv) for kv in mid)
        )
        kv_write = len(self._attn_layers) * self._kv_token_bytes()
        per_step_bytes = (
            self.weight_bytes
            + self.m_slots * self._act_bytes_per_token()
            + sum(self._kv_read_bytes(kv) for kv in mid)
            + len(kv_lens) * kv_write
        )
        per_step_vops = (
            sum(self._kv_vops(kv) for kv in mid)
            + (self.m_slots * self._w_vops / 512.0 if self._w_vops else 0.0)
        )
        return steps * rs.surface_step_time(
            self.profile, flops=per_step_flops, hbm_bytes=per_step_bytes,
            vector_ops=per_step_vops, n_chips=self.n_chips,
        )

    def _raw_draft(self, kv_lens: Sequence[float], k: int,
                   rounds: int) -> float:
        """Draft passes of a spec chunk: rounds * k fused S=1 steps whose
        weight stream reads the *draft* codec's bytes (the whole point of
        self-speculation — ~4x fewer bytes at a 4-bit draft) and whose KV
        walk is capped at `draft_window` tokens when set."""
        self._require_bound()
        w = self.draft_weight_bytes or self.weight_bytes
        span = float(k + 1)
        mid = [kv + rounds * span / 2.0 for kv in kv_lens]
        if self.draft_window:
            mid = [min(kv, float(self.draft_window)) for kv in mid]
        per_step_flops = (
            self.m_slots * self._linear_flops_per_token
            + sum(self._attn_flops(kv) for kv in mid)
        )
        kv_write = len(self._attn_layers) * self._kv_token_bytes()
        per_step_bytes = (
            w
            + self.m_slots * self._act_bytes_per_token()
            + sum(self._kv_read_bytes(kv) for kv in mid)
            + len(kv_lens) * kv_write
        )
        per_step_vops = (
            sum(self._kv_vops(kv) for kv in mid)
            + (self.m_slots * self._w_vops / 512.0 if self._w_vops else 0.0)
        )
        return rounds * k * rs.surface_step_time(
            self.profile, flops=per_step_flops, hbm_bytes=per_step_bytes,
            vector_ops=per_step_vops, n_chips=self.n_chips,
        )

    def _raw_verify(self, kv_lens: Sequence[float], k: int,
                    rounds: int) -> float:
        """Verify passes of a spec chunk: one S=k+1 mini-prefill per round
        at the *target* codec — prefill-chunk-shaped traffic (denser
        matmuls, a bounded gather-read over each slot's written prefix)
        amortizing one weight stream over k+1 positions."""
        self._require_bound()
        span = float(k + 1)
        tokens = self.m_slots * span
        mid = [kv + rounds * span / 2.0 for kv in kv_lens]
        per_round_flops = (
            tokens * self._linear_flops_per_token
            + span * sum(self._attn_flops(kv + span) for kv in mid)
        )
        kv_write = len(self._attn_layers) * self._kv_token_bytes()
        per_round_bytes = (
            self.weight_bytes
            + tokens * (self._act_bytes_per_token() + kv_write)
            + sum(self._kv_read_bytes(kv + span) for kv in mid)
        )
        per_round_vops = (
            (tokens / 512.0 * self._w_vops if self._w_vops else 0.0)
            + sum(self._kv_vops(kv + span) for kv in mid)
        )
        return rounds * rs.surface_step_time(
            self.profile, flops=per_round_flops, hbm_bytes=per_round_bytes,
            vector_ops=per_round_vops, n_chips=self.n_chips,
        )

    def _raw_tier_restore(self, n_pages: int, page_bytes: float) -> float:
        """Host-tier page restore (DESIGN.md §18): a pure upload — the
        packed payload bytes cross host->HBM and land in the pool planes,
        no compute worth counting. Priced as an HBM-bytes-only step so the
        TTFT admission gate can add restore time to the prefill prediction;
        its time constant (PCIe/DMA-dominated, host-staged on the CPU) is
        nothing like the launch regimes', hence its own calibration scale."""
        self._require_bound()
        return rs.surface_step_time(
            self.profile, flops=0.0,
            hbm_bytes=float(n_pages) * float(page_bytes), vector_ops=0.0,
            n_chips=self.n_chips,
        )

    def predict_prefill(self, batch_rows: int, span: int) -> float:
        """Calibrated predicted wall seconds for one bucketed prefill."""
        return self._raw_prefill(batch_rows, span) * self.scale.get(
            "prefill", 1.0
        )

    def predict_prefill_chunk(self, batch_rows: int, span: int,
                              table_tokens: float) -> float:
        """Calibrated predicted wall seconds for one chunked-prefill launch."""
        return self._raw_prefill_chunk(
            batch_rows, span, table_tokens
        ) * self.scale.get("prefill_chunk", 1.0)

    def predict_decode(self, kv_lens: Sequence[float], steps: int = 1) -> float:
        """Calibrated predicted wall seconds for one decode chunk."""
        return self._raw_decode(kv_lens, steps) * self.scale.get("decode", 1.0)

    def predict_decode_chunk(self, kv_lens: Sequence[float],
                             steps: int = 1) -> float:
        """Admission-control entry point (DESIGN.md §17): the predicted
        wall seconds of one `steps`-step decode chunk over a *hypothetical*
        batch — the scheduler passes the current residents' context lengths
        plus the candidate's, and divides by `steps` for the marginal
        per-token ITL the candidate would impose. Same model as
        `predict_decode` (one decode chunk is one decode chunk); the alias
        exists so the admission call site names the question it asks."""
        return self.predict_decode(kv_lens, steps)

    def predict_tier_restore(self, n_pages: int, page_bytes: float) -> float:
        """Calibrated predicted wall seconds to restore `n_pages` tier
        payloads of `page_bytes` each into HBM pages."""
        return self._raw_tier_restore(n_pages, page_bytes) * self.scale.get(
            "tier_restore", 1.0
        )

    def predict_draft(self, kv_lens: Sequence[float], k: int,
                      rounds: int = 1) -> float:
        """Calibrated predicted wall seconds for a spec chunk's draft passes."""
        return self._raw_draft(kv_lens, k, rounds) * self.scale.get(
            "draft", 1.0
        )

    def predict_verify(self, kv_lens: Sequence[float], k: int,
                       rounds: int = 1) -> float:
        """Calibrated predicted wall seconds for a spec chunk's verify passes."""
        return self._raw_verify(kv_lens, k, rounds) * self.scale.get(
            "verify", 1.0
        )

    # -- measurement loop ---------------------------------------------------

    def observe_prefill(self, batch_rows: int, span: int,
                        measured_s: float) -> None:
        self._record("prefill", self._raw_prefill(batch_rows, span),
                     measured_s)

    def observe_prefill_chunk(self, batch_rows: int, span: int,
                              table_tokens: float, measured_s: float) -> None:
        self._record(
            "prefill_chunk",
            self._raw_prefill_chunk(batch_rows, span, table_tokens),
            measured_s,
        )

    def observe_decode(self, kv_lens: Sequence[float], steps: int,
                       measured_s: float) -> None:
        self._record("decode", self._raw_decode(kv_lens, steps), measured_s)

    def observe_tier_restore(self, n_pages: int, page_bytes: float,
                             measured_s: float) -> None:
        self._record(
            "tier_restore", self._raw_tier_restore(n_pages, page_bytes),
            measured_s,
        )

    def observe_spec(self, kv_lens: Sequence[float], k: int, rounds: int,
                     measured_s: float) -> None:
        """One speculative-decode chunk (DESIGN.md §16). The chunk is a
        single launch (one graph replay on the card), so draft and verify
        share one measured wall time; it is attributed to the two regimes
        pro-rata to their raw predictions — a modeling choice (the only one
        available without a device profiler), which keeps both regimes'
        calibration fed from real traffic while the *sum* stays an honest
        measurement."""
        raw_d = self._raw_draft(kv_lens, k, rounds)
        raw_v = self._raw_verify(kv_lens, k, rounds)
        total = raw_d + raw_v
        if total <= 0:
            return
        self._record("draft", raw_d, measured_s * raw_d / total)
        self._record("verify", raw_v, measured_s * raw_v / total)

    def _record(self, regime: str, raw_pred: float, measured: float) -> None:
        self.samples.append(_Sample(regime, self.codec_key, raw_pred, measured))
        if self.registry is not None:
            self.registry.histogram(
                f"rooflens.{regime}.predicted_s", unit="s"
            ).record(raw_pred * self.scale.get(regime, 1.0))
            self.registry.histogram(
                f"rooflens.{regime}.measured_s", unit="s"
            ).record(measured)

    def _require_bound(self) -> None:
        if not self._bound:
            raise RuntimeError(
                "RoofLens is not bound to an engine: construct the "
                "GenerationEngine with obs=Observability(... rooflens=...) "
                "or call bind() with the model geometry first"
            )

    # -- calibration and error reporting ------------------------------------

    def reset_samples(self) -> None:
        """Drop recorded samples but keep the fitted calibration — the
        warmup-then-measure pattern: calibrate on the compile-warmup run,
        report error on the clean one."""
        self.samples.clear()

    def calibrate(self) -> Dict[str, float]:
        """Fit one measured/raw scale per regime (median — robust to the
        first-call compile outlier) and apply it to future predictions.
        Returns the fitted scales; regimes with no samples are untouched."""
        for regime in ("prefill", "prefill_chunk", "decode", "draft",
                       "verify", "tier_restore"):
            ratios = sorted(
                s.measured_s / s.raw_pred_s
                for s in self.samples
                if s.regime == regime and s.raw_pred_s > 0
            )
            if ratios:
                self.scale[regime] = ratios[len(ratios) // 2]
        return dict(self.scale)

    def error_report(self) -> Dict[str, Dict[str, float]]:
        """Per-(regime, codec) model error with the current calibration
        applied: n, geometric-mean measured/predicted ratio, p50/p90
        ratios, and worst |log2 error|. A geomean near 1 with small p90
        spread means the roofline ranks step times well enough to schedule
        against."""
        groups: Dict[str, List[float]] = {}
        for s in self.samples:
            scale = self.scale.get(s.regime, 1.0)
            pred = s.raw_pred_s * scale
            if pred <= 0 or s.measured_s <= 0:
                continue
            groups.setdefault(s.regime, []).append(s.measured_s / pred)
            groups.setdefault(f"{s.regime}[{s.codec}]", []).append(
                s.measured_s / pred
            )
        out: Dict[str, Dict[str, float]] = {}
        for key, ratios in sorted(groups.items()):
            ratios = sorted(ratios)
            logs = [math.log(r) for r in ratios]
            out[key] = {
                "n": len(ratios),
                "geomean_ratio": math.exp(sum(logs) / len(logs)),
                "p50_ratio": ratios[len(ratios) // 2],
                "p90_ratio": ratios[min(len(ratios) - 1,
                                        math.ceil(0.9 * len(ratios)) - 1)],
                "max_abs_log2": max(abs(x) for x in logs) / math.log(2),
            }
        return out

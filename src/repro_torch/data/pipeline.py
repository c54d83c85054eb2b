"""Deterministic synthetic data pipeline of the port.

Counterpart of `repro/data/pipeline.py`, numpy only, and a copy of it: its
batches are bitwise the reference's. Each (step, host) slice is a pure
function of (seed, step, host_id), so a restarted run regenerates the same
data, which the checkpoint-restart check relies on. Tokens follow a
zipf-like skew; labels are next-token targets (the encoder family's are
masked-prediction targets: the tokens themselves). The stubbed vision and
audio frontends get f32 embeddings in place of tokens, and an M-RoPE
config (3, B, S) positions, three equal streams. Batches are host numpy
arrays; the train loop moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.shape.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = self.shape.global_batch // self.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """One host-local batch for `step`."""
        cfg, s = self.cfg, self.shape.seq_len
        b = self.host_batch
        rng = self._rng(step)
        out: Dict[str, np.ndarray] = {}
        ranks = rng.zipf(1.2, size=(b, s + 1)).astype(np.int64)
        tokens = (ranks - 1) % cfg.vocab_size
        if cfg.is_encoder:
            out["labels"] = tokens[:, :s].astype(np.int32)
        else:
            out["labels"] = tokens[:, 1:].astype(np.int32)
        if cfg.frontend != "none":
            out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
                np.float32
            ) * 0.02
        else:
            out["tokens"] = tokens[:, :s].astype(np.int32)
        if cfg.mrope_sections:
            pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
            out["positions"] = np.broadcast_to(pos, (3, b, s)).copy()
        out["mask"] = np.ones((b, s), np.float32)
        return out

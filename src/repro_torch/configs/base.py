"""Model configuration dataclass and the registry of ported architectures.

Port-owned copy of `repro/configs/base.py`: the `ModelConfig` fields are
the reference's, so a config converts field by field; only the
architectures the port serves are registered."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free
    n_kv_heads: int
    d_head: int
    d_ff: int                   # dense FFN width (per-expert width for MoE)
    vocab_size: int
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- attention flavour ---
    attn_pattern: str = "global"    # global | local_global | none
    window: int = 4096              # local-attention window
    attn_softcap: float = 0.0       # gemma2 attention logit softcap
    final_softcap: float = 0.0      # gemma2 final logit softcap
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE
    causal: bool = True
    pos_emb: str = "rope"           # rope | learned | none
    pos_table: int = 4096           # learned-position table size
    mlp_act: str = "swiglu"         # swiglu | geglu | gelu | relu
    post_norms: bool = False        # gemma2 post-attn/post-mlp norms
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    # --- misc ---
    tie_embeddings: bool = False
    kv_quant: str = "none"          # none | bf8 (DECA-substrate KV cache)
    norm_eps: float = 1e-6
    embed_scale: bool = False       # gemma-style sqrt(d_model) embed scaling
    frontend: str = "none"          # none | patch_stub | frame_stub
    max_seq_len: int = 524288
    # substrate defaults at scale
    optimizer: str = "adamw"        # adamw | adafactor (the 1T-param archs)
    remat: str = "full"             # none | full (activation checkpointing)
    scan_layers: bool = True        # lax.scan over stacked layer params

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length n_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.block_pattern:
            p = self.block_pattern
            return tuple(p[i % len(p)] for i in range(self.n_layers))
        if self.attn_pattern == "local_global":
            return tuple(
                "attn_local" if i % 2 == 0 else "attn" for i in range(self.n_layers)
            )
        return ("attn",) * self.n_layers


_MODULES = {
    "llama3-8b": "llama3_8b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE_CONFIG

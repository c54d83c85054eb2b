"""Model configuration dataclass and the registry of ported architectures.

Port-owned copy of `repro/configs/base.py`: the `ModelConfig` fields are
the reference's, so a config converts field by field. Every architecture
of the reference's `ARCH_IDS` is registered, and `SHAPES` holds the
reference's named run shapes (`ShapeConfig`), which the synthetic data
pipeline and `launch/specs.py` read; `shape_applicability` says which
(arch, shape) cells run."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

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

    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

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

    def param_count(self) -> int:
        """Analytical parameter count (embeddings + blocks).

        A layer = mixer (attention / ssm / rec) + FFN-if-d_ff>0.
        MoE replaces the dense FFN with n_experts expert FFNs + a router.
        """
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        if self.pos_emb == "learned":
            total += self.pos_table * d
        glu = self.mlp_act in ("swiglu", "geglu")
        ffn = (3 * d * f if glu else 2 * d * f) if f else 0
        for kind in self.layer_kinds():
            total += 2 * d  # pre-norms
            if kind in ("attn", "attn_local"):
                hq, hkv, dh = self.n_heads, self.n_kv_heads, self.d_head
                total += d * hq * dh + 2 * d * hkv * dh + hq * dh * d
            elif kind == "ssm":
                di, st, dr = self.d_inner, self.ssm_state, self.dt_rank
                total += (
                    d * 2 * di + di * self.ssm_conv + di
                    + di * (dr + 2 * st) + dr * di + di
                    + di * st + di + di * d
                )
            elif kind == "rec":
                r = self.lru_width or d
                total += d * r * 2 + r * self.ssm_conv + 2 * r * r + 2 * r + r + r * d
            if f and kind != "ssm":  # mamba blocks have no separate FFN
                if self.n_experts:
                    total += d * self.n_experts + self.n_experts * ffn
                else:
                    total += ffn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = 3 * d * f if self.mlp_act in ("swiglu", "geglu") else 2 * d * f
        inactive = (self.n_experts - self.experts_per_token) * per_expert
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicability(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is skipped:
    an encoder has no decode step, and long_500k needs sub-quadratic
    sequence mixing (an ssm or hybrid stack)."""
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid")
        if not sub_quadratic:
            return "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return None


_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "grok-1-314b": "grok_1_314b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "gemma2-2b": "gemma2_2b",
    "granite-3-8b": "granite_3_8b",
    "hubert-xlarge": "hubert_xlarge",
    "llama2-70b": "llama2_70b",
    "llama3-8b": "llama3_8b",
    "llama3.2-1b": "llama3_2_1b",
    "opt-66b": "opt_66b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE_CONFIG

"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

Port-owned copy of `repro/configs/grok_1_314b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,          # per-expert FFN width
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    attn_softcap=30.0,   # grok uses attention logit softcap
    final_softcap=30.0,
    mlp_act="geglu",
    optimizer="adafactor",   # 314B params: factored optimizer state (DESIGN §8)
)

SMOKE_CONFIG = ModelConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    experts_per_token=2,
    capacity_factor=4.0,   # drop-free at smoke scale: decode == forward exactly
    attn_softcap=30.0,
    final_softcap=30.0,
    mlp_act="geglu",
)

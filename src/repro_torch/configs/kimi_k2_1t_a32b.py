"""kimi-k2-1t-a32b [moe] — 384 experts top-8, ~1T params / 32B active
[arXiv:2501.kimi2; unverified].

Port-owned copy of `repro/configs/kimi_k2_1t_a32b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,          # 7168 / 64
    d_ff=2048,           # per-expert FFN width
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    mlp_act="swiglu",
    optimizer="adafactor",   # ~1T params (DESIGN §8)
)

SMOKE_CONFIG = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=32,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    capacity_factor=4.0,   # drop-free at smoke scale: decode == forward exactly
    mlp_act="swiglu",
)

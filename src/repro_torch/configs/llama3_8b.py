"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified].

Port-owned copy of `repro/configs/llama3_8b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    mlp_act="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="llama3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=224,
    vocab_size=256,
    rope_theta=500000.0,
    mlp_act="swiglu",
)

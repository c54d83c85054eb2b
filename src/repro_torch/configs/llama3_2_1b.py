"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

Port-owned copy of `repro/configs/llama3_2_1b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    mlp_act="swiglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    rope_theta=500000.0,
    mlp_act="swiglu",
    tie_embeddings=True,
)

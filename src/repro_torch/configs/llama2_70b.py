"""llama2-70b — the paper's primary end-to-end model (Table 4).

Port-owned copy of `repro/configs/llama2_70b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32000,
    mlp_act="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="llama2-70b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=224,
    vocab_size=256,
    mlp_act="swiglu",
)

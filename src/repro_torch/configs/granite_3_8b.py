"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

Port-owned copy of `repro/configs/granite_3_8b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12800,
    vocab_size=49155,
    mlp_act="swiglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab_size=259,      # deliberately non-round: exercises vocab padding
    mlp_act="swiglu",
    tie_embeddings=True,
)

"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a stub: callers pass precomputed patch embeddings
(`Model.forward(embeds=...)`) and three position streams (temporal,
height, width); the transformer backbone below is what runs.

Port-owned copy of `repro/configs/qwen2_vl_7b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),   # temporal / height / width rotary sections
    mlp_act="swiglu",
    frontend="patch_stub",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    mrope_sections=(2, 3, 3),
    mlp_act="swiglu",
    frontend="patch_stub",
)

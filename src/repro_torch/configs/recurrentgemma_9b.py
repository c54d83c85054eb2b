"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent blocks
per 1 attention block (Griffin) [arXiv:2402.19427; unverified].

Port-owned copy of `repro/configs/recurrentgemma_9b.py`. `layer_kinds`
follows `block_pattern`, so the attention blocks are of kind "attn":
global, with `window` unused, as in the reference."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,        # MQA on the attention blocks
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    attn_pattern="local_global",  # attention blocks are local-window
    window=2048,
    lru_width=4096,
    mlp_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    scan_layers=False,   # 1:2 heterogeneous pattern: unrolled
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    block_pattern=("rec", "rec", "attn"),
    attn_pattern="local_global",
    window=32,
    lru_width=64,
    mlp_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    scan_layers=False,
)

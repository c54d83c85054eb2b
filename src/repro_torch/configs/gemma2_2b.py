"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

Port-owned copy of `repro/configs/gemma2_2b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256000,
    attn_pattern="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="geglu",
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
    scan_layers=False,   # alternating local/global blocks: unrolled
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    attn_pattern="local_global",
    window=32,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="geglu",
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
    scan_layers=False,
)

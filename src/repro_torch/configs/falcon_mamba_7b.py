"""falcon-mamba-7b [ssm] — attention-free Mamba-1 [arXiv:2410.05355;
unverified]. ssm_state=16; layer = Mamba block (no separate FFN, d_ff=0).

Port-owned copy of `repro/configs/falcon_mamba_7b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    attn_pattern="none",
    pos_emb="none",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=4,
    ssm_conv=4,
    ssm_expand=2,
    attn_pattern="none",
    pos_emb="none",
    tie_embeddings=True,
)

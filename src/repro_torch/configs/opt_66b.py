"""opt-66b — the paper's second end-to-end model (Table 4).

Port-owned copy of `repro/configs/opt_66b.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-66b",
    family="dense",
    n_layers=64,
    d_model=9216,
    n_heads=72,
    n_kv_heads=72,       # full MHA
    d_head=128,
    d_ff=36864,
    vocab_size=50272,
    pos_emb="learned",
    mlp_act="relu",
)

SMOKE_CONFIG = ModelConfig(
    name="opt-66b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=256,
    vocab_size=256,
    pos_emb="learned",
    mlp_act="relu",
)

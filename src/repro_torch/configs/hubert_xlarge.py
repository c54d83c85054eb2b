"""hubert-xlarge [audio] — encoder-only (wav2vec2-style backbone)
[arXiv:2106.07447; unverified].

The conv waveform frontend is a stub: callers pass tokens or precomputed
frame embeddings (`Model.forward(embeds=...)`). The encoder is
bidirectional (`causal=False`); the engines serve it as the reference's do.

Port-owned copy of `repro/configs/hubert_xlarge.py`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,       # full MHA
    d_head=80,
    d_ff=5120,
    vocab_size=504,      # masked-prediction codebook targets
    causal=False,        # bidirectional encoder
    pos_emb="learned",   # conv-positional stub -> learned abs positions
    pos_table=32768,     # covers the prefill_32k cell
    mlp_act="gelu",
)

SMOKE_CONFIG = ModelConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=32,
    causal=False,
    pos_emb="learned",
    mlp_act="gelu",
)

#!/usr/bin/env python3
"""`chip_smoke.py`'s `vlm_audio` phase alone, on one card.

    python3 tools/vlm_audio_serve.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built),
then runs only the phase: qwen2-vl-7b (28 layers, M-RoPE over three
position streams, 28 q / 4 kv heads: G 7) and hubert-xlarge (48 layers, a
bidirectional encoder with learned positions over 32768, Dh 80, a gelu
MLP, 504 targets) at full width and depth with bf8_50 weights compressed
on the card layer by layer. qwen2-vl: its kernels at its shapes against
their plain versions, 4 greedy requests through captured decode graphs
(launches, replays bitwise, the step beside its bytes bound, every token
against teacher-forced logits), the kernel path against the plain path
over 4 layers, a spec engine (nf4 draft, k = 3) and a forward on one
image's patch embeddings with Qwen2-VL's three position streams.
hubert-xlarge: its GeMV at its decode rows (M = 4) and GeMM at M = 4096
and 32768 (lm_head N = 504 on the direct path) and attention at Dh 80, causal=0, encoder passes at 4 x 1024
and 1 x 32768 (wall, peak, 289 GeMM launches, the FLOP bound), the kernel
path against the plain path, bidirectionality, and a paged serve of 4
prompts of 64 tokens. It prints the phase's lines and writes its record to
chiprun_out/vlm_audio.json; it exits non-zero when a check fails or no
card is present.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.exit(cs.phase_alone(cs.vlm_audio, "vlm_audio"))

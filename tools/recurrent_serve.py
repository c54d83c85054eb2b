#!/usr/bin/env python3
"""`chip_smoke.py`'s `recurrent` phase alone, on one card.

    python3 tools/recurrent_serve.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built),
then runs only the phase: falcon-mamba-7b (64 Mamba-1 layers) and
recurrentgemma-9b (38 layers, rec / rec / attn, int8 ring KV) at full
width and depth with bf8_50 weights compressed on the card layer by layer
(build time, stored bytes against the dense bf16 size, the build's peak),
the GeMV and GeMM against their plain versions at their shapes (K 256,
N 288 and 256, f32 x), a greedy serve of 4 prompts of 64 tokens and 32
new tokens through `GenerationEngine`, whose `paged="auto"` picks the
dense ring engine (prefill and decode walls, tok/s, peak memory, launches
a step, the decode step beside its bytes bound), the same serve with
`paged=False` on a one-rank NCCL mesh beside the plain ring engine
(tokens, ring planes and states bitwise, the same launches, the NCCL
kernels and copies of a step, the step's wall beside the plain one's),
the kernels at the model's (1, 4) local shard shapes, a profiler split of
a step, the kernel path against the plain path over the first 4 layers,
every token against teacher-forced logits of the full-sequence forward;
then llama3.2-1b with `paged=False` on an int8 ring, its tokens held to
teacher-forced logits and against its paged engine's up to a near tie.
It prints the phase's lines and writes its record to
chiprun_out/recurrent_serve.json; it exits non-zero when a check fails or
no card is present.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.exit(cs.phase_alone(cs.recurrent, "recurrent_serve"))

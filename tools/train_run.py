#!/usr/bin/env python3
"""`chip_smoke.py`'s `train` phase alone, on one card.

    python3 tools/train_run.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built),
then runs only the phase: (a) one AdamW step of llama3.2-1b smoke on the
card against the CPU from the same params and batch; (b) the
crash-at-step-6 restart through `ResilientTrainer` on the card, bitwise
the uninterrupted run under deterministic algorithms; (c) llama3.2-1b at
full width and depth trained 8 steps through `train_loop` on 2 x 4096
tokens with remat and AdamW (each step's loss, the median step, tokens/s,
6 N T FLOPs against the bf16 peak, peak memory, no DECA kernel launched);
(d) one Adafactor step of the same model and its state bytes against
AdamW's; (e) the same model 3 steps with int8 gradient compression on a
one-rank NCCL mesh (losses beside (c)'s, the round trip's device time,
sampled payloads bitwise the CPU port's, err within half a quantization
step), one bf8 step, and `shard_params` on that mesh. It prints the phase's lines and writes its record to
chiprun_out/train_run.json; it exits non-zero when a check fails or no
card is present.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.exit(cs.phase_alone(cs.train, "train_run"))

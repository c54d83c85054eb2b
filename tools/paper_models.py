#!/usr/bin/env python3
"""`chip_smoke.py`'s `paper_models` phase alone, on one card.

    python3 tools/paper_models.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built),
then runs only the phase: llama2-70b and opt-66b at full width and depth
with bf8_50 weights compressed on the card (build time, stored bytes
against the dense bf16 size, the build's peak), the kernels against their
plain versions at each model's shapes, a 4-request and a 1-request greedy
serve through captured decode graphs with the decode bytes bound beside
the replayed step, the kernel path against the plain path over the first
4 layers; then llama3.2-1b's tied head. It prints the phase's lines and
writes its record to chiprun_out/paper_models.json; it exits non-zero when
a check fails or no card is present.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.exit(cs.phase_alone(cs.paper_models, "paper_models"))

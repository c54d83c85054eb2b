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
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("paper_models: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import subprocess

    import chip_smoke as cs
    from repro_torch.core import roofsurface as rs
    from repro_torch.kernels import cuda

    cs.HBM_BYTES_PER_S, cs.BF16_FLOP_PER_S = rs.H100_SXM.mbw, rs.H100_SXM.peak_flops
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    cs.OUT.mkdir(exist_ok=True)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda.build()
    cs.log(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    report = {}
    try:
        cs.paper_models(torch, report)
    finally:
        (cs.OUT / "paper_models.json").write_text(json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""`chip_smoke.py`'s `mesh_serve` phase alone, on one card.

    python3 tools/mesh_serve.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built) and
full-width llama3-8b with bf8_50 weights as `chip_smoke.py` does, then
runs only the sharded-serving phase: the engine on a one-rank NCCL mesh
against the plain engine (tokens and pool planes bitwise, launches a
step, the captured chunk with its collectives replayed bitwise, the
replayed step beside the plain one), then the kernels at llama2-70b's
(1, 4) local shard shapes. It prints the phase's lines and writes its
record to chiprun_out/mesh_serve.json; it exits non-zero when a check
fails or no card is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_serve: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.core import roofsurface as rs
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import cuda
    from repro_torch.models.model import Model

    cs.HBM_BYTES_PER_S, cs.BF16_FLOP_PER_S = rs.H100_SXM.mbw, rs.H100_SXM.peak_flops
    cs.OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    cuda.build()
    cfg = get_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        spec=get_spec(cs.SERVED_SPEC))
    # the plain serve's prompts, drawn as chip_smoke.py draws them
    rng = torch.Generator().manual_seed(4)
    lens = torch.randint(64, 1025, (8,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).numpy() for n in lens]
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"built the kernels and the model in {time.perf_counter() - t0:.1f} s")
    report = {}
    try:
        cs.mesh_serve(torch, model, params, prompts, report)
    finally:
        (cs.OUT / "mesh_serve.json").write_text(json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The decode GeMV of one or more source trees, timed on one card.

    git archive <commit> | tar -x -C build/other   # any directory .gitignore lists
    python3 tools/gemv_bench.py [OTHER_TREE ...]

Times `kernels/deca_gemm.decompress_gemv` of this tree, and of each other
tree given (tagged with its directory name), at llama3-8b's FC shapes:
bf8_50 weights (the served codec) at M = 1, 4, 16 (the spec verify) and 32
for gate/up, M = 4 for the other FC shapes, and nf4_100 (the spec draft
codec) at M = 4 for gate/up. Weights and x come from seeds, x and out in
bf16 as the served path calls it. Each tree runs in a fresh process,
which builds only that tree's GeMV library; with other trees the order is
the others, this, this, the others reversed, so that the trees share the
card, its power limit and its host. Times are chip_smoke.py's: `ms`
between CUDA events after a 256 MB L2-evicting write (median of 10),
device time from a torch.profiler trace, and the wrapper's host time a
call. Prints one JSON line per case and appends them to
chiprun_out/gemv_bench.jsonl.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (K, N, role, spec, M)
CASES = ([(4096, 14336, "gate/up", "bf8_50", m) for m in (1, 4, 16, 32)]
         + [(k, n, role, "bf8_50", 4) for k, n, role in (
             (4096, 4096, "q/o"), (4096, 1024, "k/v"), (14336, 4096, "down"),
             (4096, 128256, "lm_head"))]
         + [(4096, 14336, "gate/up", "nf4_100", 4)])


def bench(root: Path, tag: str) -> None:
    """Every case on the GeMV of the tree at `root`, in this process."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root / "src"))
    import torch
    from chip_smoke import Timer, bound_ms
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import deca_gemm

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    for k, n, role, spec, m in CASES:
        w = torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k)
        ct = compress(w, get_spec(spec))
        del w
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        fn = lambda: deca_gemm.decompress_gemv(x, ct, out_dtype=torch.bfloat16)
        ms = timer(fn)
        device_ms, host_ms = timer.split(fn)
        bound, _ = bound_ms(ct.nbytes + 2 * m * k + 2 * m * n, 2.0 * m * k * n)
        print(json.dumps({"tree": tag, "role": role, "K": k, "N": n, "M": m, "spec": spec,
                          "ms": ms, "device_ms": device_ms, "host_ms": host_ms,
                          "bound_ms": bound}), flush=True)
        del ct
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        bench(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if any(a.startswith("-") for a in sys.argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    others = [Path(a).resolve() for a in sys.argv[1:]]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        print("gemv_bench: no CUDA card", file=sys.stderr)
        return 2
    print(smi, flush=True)
    trees = [(p, p.name) for p in others] + [(ROOT, "this")]
    order = trees + trees[::-1] if others else trees
    for tree, tag in order:
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), tag],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(lines) != len(CASES):
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        with open(out / "gemv_bench.jsonl", "a") as f:
            for ln in lines:
                print(ln, flush=True)
                f.write(ln + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

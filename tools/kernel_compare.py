#!/usr/bin/env python3
"""The prefill GeMM and the decode attention of this tree against another
tree's, timed on one card.

    git archive <commit> | tar -x -C build/other   # any directory .gitignore lists
    python3 tools/kernel_compare.py build/other

Times `kernels/deca_gemm.decompress_gemm` (bf8_50 gate/up at M = 2048, the
llama3-8b and llama2-70b widths) and `kernels/paged_attention.
paged_attention` (int8 pool, 4 slots of 2048/1500/777/64 tokens, bf16
queries: llama3-8b's G 4, llama2-70b's G 8, opt-66b's G 1 over 72 KV
heads, all at Dh 128, the shapes both trees take) in fresh processes in
the order other, this, this, other, so that both share the card, its
power limit and its host. Each process builds its tree's two libraries
at once (a no-op when built). Times are chip_smoke.py's: `ms` between
CUDA events after a 256 MB L2-evicting write (median of 10), device time
from a torch.profiler trace, and the wrapper's host time a call. Prints
one JSON line per case, appended to chiprun_out/kernel_compare.jsonl.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GEMM = [(4096, 14336, "llama3-8b gate/up"), (8192, 28672, "llama2-70b gate/up")]
ATTENTION = [(32, 8, "llama3-8b"), (64, 8, "llama2-70b"), (72, 72, "opt-66b")]


def bench(root: Path, tag: str) -> None:
    """Every case on the kernels of the tree at `root`, in this process."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root / "src"))
    import torch
    from chip_smoke import Timer, _attention_inputs
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import cuda, deca_gemm, paged_attention

    cuda.build(["deca_gemm_sm90", "paged_attention"])
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1)

    def record(case, fn):
        case["ms"] = timer(fn)
        case["device_ms"], case["host_ms"] = timer.split(fn)
        print(json.dumps({"tree": tag, **case}), flush=True)

    for k, n, role in GEMM:
        ct = compress(torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k),
                      get_spec("bf8_50"))
        x = torch.randn(2048, k, generator=g, device="cuda").bfloat16()
        record({"kernel": "gemm", "role": role, "M": 2048},
               lambda: deca_gemm.decompress_gemm(x, ct, out_dtype=torch.bfloat16))
        del ct, x
        torch.cuda.empty_cache()
    for hq, hkv, role in ATTENTION:
        q, pools, tables, kv_lens, q_pos = _attention_inputs(torch, "int8", g, hq, hkv, 128)
        qb = q.bfloat16()
        record({"kernel": "attention", "role": role, "G": hq // hkv, "Hkv": hkv},
               lambda: paged_attention.paged_attention(qb, pools, tables, kv_lens, q_pos,
                                                       quant="int8"))
        del pools
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        bench(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if len(sys.argv) != 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        print("kernel_compare: no CUDA card", file=sys.stderr)
        return 2
    print(smi, flush=True)
    n_cases = len(GEMM) + len(ATTENTION)
    for tree, tag in ((other, other.name), (ROOT, "this"), (ROOT, "this"),
                      (other, other.name)):
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), tag],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(lines) != n_cases:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        with open(out / "kernel_compare.jsonl", "a") as f:
            for ln in lines:
                print(ln, flush=True)
                f.write(ln + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The served path of chip_smoke.py, for two source trees on one card.

    git archive <commit> | tar -x -C build/other   # any directory .gitignore lists
    python3 tools/serve_compare.py build/other

Runs the plain serve of chip_smoke.py (full-width llama3-8b, bf8_50 weights,
int8 KV pool, 4 slots, the same 8 seeded prompts, 64 new tokens each) in a
fresh process per tree, in the order other, this, this, other, so that the
two trees share the card, its power limit and its host. Each process builds
its tree's kernels, builds the model, and serves twice: the first serve also
pays what a process does only once, the second does not. Prints one JSON
line per serve, with each prefill call's wall and the decode wall per step,
and appends them to chiprun_out/serve_compare.jsonl.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve(root: Path, tag: str) -> None:
    """Both serves of one tree, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import cuda
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine

    cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        spec=get_spec("bf8_50"))
    rng = torch.Generator().manual_seed(4)  # chip_smoke.py's prompts
    lens = torch.randint(64, 1025, (8,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).numpy() for n in lens]
    for rep in ("cold", "warm"):
        eng = GenerationEngine(model, params, kv_quant="int8", max_slots=4, block_size=32,
                               max_len=2048, decode_chunk=8)
        sched = eng.scheduler
        walls = {"prefill": [], "decode": []}

        def timed(name, fn):
            def run(*a):
                t = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t)
                return out
            return run

        sched._prefill = timed("prefill", sched._prefill)
        sched._decode_chunk = timed("decode", sched._decode_chunk)
        rids = [eng.submit(p, max_new_tokens=64) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = sched.stats()["decode_steps"]
        print(json.dumps({
            "tree": tag, "serve": rep, "wall_s": wall, "prefill_calls_s": walls["prefill"],
            "decode_s": sum(walls["decode"]), "decode_steps": steps,
            "decode_ms_per_step": 1e3 * sum(walls["decode"]) / steps,
            "tokens_head": [[int(t) for t in done[r][:8]] for r in rids]}), flush=True)
        del eng, sched, done
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        serve(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if len(sys.argv) != 2:
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
        print("serve_compare: no CUDA card", file=sys.stderr)
        return 2
    print(smi, flush=True)
    for tree, tag in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), tag],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(lines) != 2:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        with open(out / "serve_compare.jsonl", "a") as f:
            for ln in lines:
                print(ln, flush=True)
                f.write(ln + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

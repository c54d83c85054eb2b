#!/usr/bin/env python3
"""Where a process's first prefill spends its one-time cost, on one card.

    python3 tools/first_prefill.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built),
then runs three fresh processes on llama3-8b at full width and two layers
(bf8_50 weights, int8 KV pool, one 512-token prompt; depth does not change
what a process pays once):

  isolate  host timestamps, each closed by a synchronize, around what the
           prefill does for the first time: the CUDA context, loading each
           kernel library, the first launch of the GeMM (its module and its
           TMA encoder entry point), the first f32 cuBLAS batched matmul of
           the gather attention, and the first prefill itself (what is
           left), each beside its second call;
  profile  the first prefill alone under torch.profiler (CPU and CUDA),
           with its operators by host time;
  python   the first prefill alone under cProfile, its Python functions
           by own time (a ctypes kernel call counts in its wrapper's).

Prints one JSON line per process and writes them to
chiprun_out/first_prefill.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPT = 512


def _setup(torch):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.formats import get_spec
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import make_paged_prefill_step

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2, kv_quant="int8")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        spec=get_spec("bf8_50"))
    bs, pages = 32, PROMPT // 32
    g = torch.Generator(device="cuda").manual_seed(1)

    def prefill():
        pools = model.init_paged_cache(pages, bs, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=g, device="cuda")
        pos = torch.arange(PROMPT, dtype=torch.int32, device="cuda")[None]
        tables = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None]
        fresh = tables[0].clone()
        last = torch.tensor([PROMPT - 1], device="cuda")
        make_paged_prefill_step(model)(params, tokens, pos, pools, tables, pos + bs, pos,
                                       fresh, last)

    return params, prefill


def isolate() -> dict:
    t0 = time.perf_counter()
    import torch

    stamps = {"import_torch_s": time.perf_counter() - t0}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stamps[name] = time.perf_counter() - t

    timed("cuda_context_s", lambda: torch.zeros(1, device="cuda"))
    from repro_torch.kernels import cuda, deca_decompress, deca_gemm, paged_attention

    for name, sig in (("deca_gemm", deca_gemm._SIGNATURES),
                      ("deca_gemm_sm90", deca_gemm._GEMM_SIGNATURES),
                      ("paged_attention", paged_attention._SIGNATURES),
                      ("deca_decompress", deca_decompress._SIGNATURES)):
        timed(f"load_{name}_s", lambda: cuda.library(name, sig))
    t = time.perf_counter()
    params, prefill = _setup(torch)
    torch.cuda.synchronize()
    stamps["model_build_s"] = time.perf_counter() - t
    wq = params["layers"][0]["attn"]["wq"]
    x = torch.randn(PROMPT, 4096, device="cuda").bfloat16()
    for rep in ("first", "second"):
        timed(f"gemm_{rep}_s", lambda: deca_gemm.decompress_gemm(x, wq))
    a = torch.randn(8, 4, 512, 128, device="cuda")
    b = torch.randn(8, 512, 128, device="cuda")
    for rep in ("first", "second"):
        timed(f"cublas_f32_einsum_{rep}_s", lambda: torch.einsum("bgqd,bkd->bgqk", a, b))
    for rep in ("first", "second", "third"):
        timed(f"prefill_{rep}_s", prefill)
    return {"mode": "isolate", **stamps}


def profile() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    torch.zeros(1, device="cuda")
    _, prefill = _setup(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:20]
    t = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    return {"mode": "profile", "first_prefill_traced_s": wall,
            "second_prefill_s": time.perf_counter() - t,
            "top_self_cpu": [{"name": e.key, "self_cpu_ms": e.self_cpu_time_total / 1e3,
                              "count": e.count} for e in rows]}


def python_profile() -> dict:
    import cProfile
    import pstats

    import torch

    torch.zeros(1, device="cuda")
    _, prefill = _setup(torch)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    prefill()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{fn[0].split('/')[-1]}:{fn[1]}:{fn[2]}", tt, ct, nc)
                   for fn, (cc, nc, tt, ct, _) in stats.items()), key=lambda r: -r[1])[:25]
    return {"mode": "python", "first_prefill_s": wall,
            "top_own_time": [{"fn": f, "own_s": tt, "cumulative_s": ct, "calls": nc}
                             for f, tt, ct, nc in rows]}


MODES = {"isolate": isolate, "profile": profile, "python": python_profile}


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] in MODES:
        sys.path.insert(0, str(ROOT / "src"))
        result = MODES[sys.argv[1]]()
        print(json.dumps(result), flush=True)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("first_prefill: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    cuda.build()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = [{"card": smi}]
    for mode in MODES:
        proc = subprocess.run([sys.executable, __file__, mode], capture_output=True,
                              text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        results.append(json.loads(lines[-1]))
    (out / "first_prefill.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

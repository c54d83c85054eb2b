#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version at llama3-8b's shapes (every weight codec
at densities 1.0 and 0.5, every KV pool kind with window and softcap
variants), times each beside its plain version, a PyTorch library call of
the same function and the least time the card could take (and reads its
device time and its wrapper's host time per call apart), then stands up
full-width llama3-8b with bf8_50-compressed weights on the card and serves
8 greedy requests through `GenerationEngine`, checking that every kernel
carried the run, that the kernel path's logits agree with the plain path's
and that an lm_head GeMV never holds a dense weight. It imports nothing of
JAX. Details of every case go to chiprun_out/chip_smoke.json. The last line
is a JSON object with "ok" and the device; the line before it lists the
kernels. Without a card, or without the port beside it, it exits non-zero
and prints no result. After the plain serve it builds a self-speculative
engine on the same weights (an nf4 draft tree re-encoded through the
decompression kernel, k = 3), serves 4 greedy requests and holds every
emitted token against teacher-forced logits of the target. Both engines
run decode as CUDA graphs captured per shape: each captured graph (every
plain chunk length, and one spec launch) is replayed against the
uncaptured step from the same pools, tokens and every pool plane bitwise.
Last, it times the keyed temperature sampler captured alone and serves at
temperature 0.7, plain and spec, holding every token against teacher-forced
perturbed scores and spec against sequential token for token.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
# llama3-8b FC shapes (K, N) and their role
FC_SHAPES = [(4096, 4096, "q/o"), (4096, 1024, "k/v"), (4096, 14336, "gate/up"),
             (14336, 4096, "down"), (4096, 128256, "lm_head")]
SERVED_SPEC = "bf8_50"
SERVED_KV = "int8"
DRAFT_CODEC, SPEC_K, SPEC_NEW = "nf4", 3, 32  # self-speculative serve
CODECS = ("bf16", "bf8", "mxfp4", "int8", "int4", "nf4")
KV_KINDS = ("none", "bf8", "int8", "int4", "mxfp4", "nf4")
# kernel vs plain version on the same inputs, relative to max|plain|: the
# same exact bf16 products summed in f32 in another order (GeMV / GeMM,
# K <= 14336), and an f32 online softmax in another order (attention)
KERNEL_TOL = 1e-4
# kernel path vs plain path through 32 bf16 layers, relative to max|plain|
LOGIT_TOL = 5e-2


_LOG = []


def log(*parts):
    """Print a line and keep it for chiprun_out/chip_smoke.log."""
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    _LOG.append(line)
    if OUT.is_dir():
        (OUT / "chip_smoke.log").write_text("\n".join(_LOG) + "\n")


def bound_ms(nbytes: float, flops: float):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def fmt_ms(ms) -> str:
    return "not recorded" if ms is None else f"{ms:.4f} ms"


def achieved(case, nbytes: float, flops: float) -> str:
    """Record and describe the rate `case["ms"]` reached on the quantity
    that bounds it: TFLOP/s against the tensor cores' 989, or GB/s against
    the 3350 of device memory."""
    if case["bound_by"] == "operations":
        case["tflop_s"] = flops / case["ms"] / 1e9
        return f"{case['tflop_s']:.1f} TFLOP/s of {BF16_FLOP_PER_S / 1e12:.0f}"
    case["gb_s"] = nbytes / case["ms"] / 1e6
    return f"{case['gb_s']:.0f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}"


class Timer:
    """Median time of `fn` between two CUDA events, each run after a 256 MB
    write that evicts the 50 MB L2, as the serving path streams a weight
    or KV page cold. The write (about 0.08 ms) keeps the card busy while
    the host enqueues `fn`; where the wrapper's host work outlasts it, the
    rest falls between the events, so a short kernel's reading holds part
    of its wrapper's host time. `split` gives the two apart."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 10, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.fill_(1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    def split(self, fn, reps: int = 10) -> tuple:
        """(device ms, host ms) of one call of `fn`. Device: the kernels
        `fn` launched, summed over a torch.profiler trace of `reps` calls
        (each after the L2-evicting write, whose fill kernel is left out)
        and divided by `reps`; a trace that recorded no kernel of `fn` is
        taken again, up to three times, and then the device time is None.
        Host: the median wall of the call alone on an idle card, what the
        wrapper costs the host per launch."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            host.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        device = None
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.fill_(1)
                    fn()
                torch.cuda.synchronize()
            us = sum(
                evt.self_device_time_total for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith("aten::")
                and "FillFunctor<unsigned char>" not in evt.key)
            if us > 0:
                device = us / 1e3 / reps
                break
        return device, sorted(host)[len(host) // 2]


def rel_err(got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def bits(torch, t):
    """Integer view of an f32 / bf16 tensor: equal views are equal bits."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def check_decompress(torch, timer, ct, role, cases):
    """The decompression kernel against its plain version on one weight,
    bitwise, to f32 and to bf16; timed at the served codec."""
    from repro_torch.kernels import deca_decompress, ref

    k, n = ct.shape
    for dt in (torch.float32, torch.bfloat16):
        got, want = deca_decompress.decompress(ct, out_dtype=dt), ref.decompress(ct, dt)
        torch.cuda.synchronize()
        equal = torch.equal(bits(torch, got), bits(torch, want))
        case = {"kernel": "decompress", "role": role, "K": k, "N": n,
                "spec": ct.spec.name, "out": str(dt).split(".")[-1], "bitwise": equal,
                "max_abs_err": (got.float() - want.float()).abs().max().item()}
        del got, want
        if ct.spec.name == SERVED_SPEC:
            case["ms"] = timer(lambda: deca_decompress.decompress(ct, out_dtype=dt))
            case["device_ms"], case["host_ms"] = timer.split(
                lambda: deca_decompress.decompress(ct, out_dtype=dt))
            case["plain_ms"] = timer(lambda: ref.decompress(ct, dt), reps=3)
            case["library_ms"] = None  # no one PyTorch call decodes the triplet
            # each plane read once, the dense weight written once
            moved = ct.nbytes + k * n * (4 if dt == torch.float32 else 2)
            case["bound_ms"], case["bound_by"] = bound_ms(moved, 0.0)
            log(f"decompress {role:8s} {ct.spec.name} -> {case['out']:8s}: bitwise {equal} "
                f"kernel {case['ms']:.4f} ms ({achieved(case, moved, 0.0)}; device "
                f"{fmt_ms(case['device_ms'])}, host {case['host_ms']:.4f} ms) plain "
                f"{case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
        cases.append(case)
        if not equal:
            raise AssertionError(f"decompress disagrees with its plain version: {case}")


def check_matmuls(torch, timer, report):
    """GeMV (M in 1, 4, 16, 32: M = 16 is the spec verify) and GeMM (M in
    64, 2048, and 4096, the largest prefill bucket, at gate/up) against
    their plain versions, and the decompression kernel bitwise against its
    plain version, for every FC shape, codec and density; timed at the
    served codec, and the GeMV also at the draft codec (nf4_100, M = 4)."""
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import CompressionSpec
    from repro_torch.kernels import deca_gemm, ref

    cases, worst = [], {"gemv": 0.0, "gemm": 0.0}
    dec_cases = []
    g = torch.Generator(device="cuda").manual_seed(1)
    for k, n, role in FC_SHAPES:
        w = torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k)
        ms = (1, 4, 16, 32, 64, 2048) + ((4096,) if role == "gate/up" else ())
        xs = {m: torch.randn(m, k, generator=g, device="cuda").bfloat16().float() for m in ms}
        for quant in CODECS:
            for dens in (1.0, 0.5):
                spec = CompressionSpec(quant, dens)
                ct = compress(w, spec)
                errs = {"gemv": [], "gemm": []}
                for m, x in xs.items():
                    kind = "gemv" if m <= 32 else "gemm"
                    kern = deca_gemm.decompress_gemv if kind == "gemv" else deca_gemm.decompress_gemm
                    plain = ref.decompress_gemv if kind == "gemv" else ref.decompress_gemm
                    got, want = kern(x, ct), plain(x, ct)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, want)
                    worst[kind] = max(worst[kind], rel)
                    case = {"kernel": kind, "role": role, "K": k, "N": n, "M": m,
                            "spec": spec.name, "max_abs_err": err, "rel_err": rel}
                    draft = spec.name == f"{DRAFT_CODEC}_100" and kind == "gemv" and m == 4
                    if spec.name == SERVED_SPEC or draft:
                        xb = x.bfloat16()
                        dense = ref.decompress(ct, torch.bfloat16)
                        case["ms"] = timer(lambda: kern(xb, ct, out_dtype=torch.bfloat16))
                        case["device_ms"], case["host_ms"] = timer.split(
                            lambda: kern(xb, ct, out_dtype=torch.bfloat16))
                        case["plain_ms"] = timer(lambda: plain(xb, ct, out_dtype=torch.bfloat16), reps=3)
                        case["library_ms"] = timer(lambda: torch.matmul(xb, dense))
                        moved, flops = ct.nbytes + 2 * m * k + 2 * m * n, 2.0 * m * k * n
                        case["bound_ms"], case["bound_by"] = bound_ms(moved, flops)
                        del dense
                        log(f"{kind} {role:8s} M={m:5d} {spec.name}: rel_err {rel:.2e} "
                            f"kernel {case['ms']:.4f} ms ({achieved(case, moved, flops)}; device "
                            f"{fmt_ms(case['device_ms'])}, host {case['host_ms']:.4f} ms) plain "
                            f"{case['plain_ms']:.4f} ms library {case['library_ms']:.4f} ms "
                            f"bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
                    if rel > KERNEL_TOL:
                        raise AssertionError(f"{kind} disagrees with its plain version: {case}")
                    cases.append(case)
                    errs[kind].append(f"M={m} {rel:.2e}")
                for kind, row in errs.items():
                    log(f"  {kind} {role:8s} {spec.name:9s} rel err: {', '.join(row)}")
                check_decompress(torch, timer, ct, role, dec_cases)
                del ct
        del w, xs
        torch.cuda.empty_cache()
    log(f"gemv: {sum(c['kernel'] == 'gemv' for c in cases)} cases, max rel err "
        f"{worst['gemv']:.2e}; gemm: {sum(c['kernel'] == 'gemm' for c in cases)} cases, "
        f"max rel err {worst['gemm']:.2e} (tolerance {KERNEL_TOL})")
    log(f"decompress: {len(dec_cases)} cases (f32 and bf16 out), all bitwise equal to "
        f"the plain version")
    report["matmul_cases"] = cases
    report["decompress_cases"] = dec_cases
    return cases, dec_cases


def _attention_inputs(torch, kind, g):
    """llama3-8b decode attention: 4 slots with ragged lengths up to 2048
    over a 32-token-page pool quantized with `kind`, pages shuffled."""
    from repro_torch.kernels.ref import CACHE_EMPTY_POS
    from repro_torch.models import layers

    b, hq, hkv, dh, bs, mb = 4, 32, 8, 128, 32, 64
    kv_lens = torch.tensor([2048, 1500, 777, 64], dtype=torch.int32, device="cuda")
    pools = layers.init_paged_kv_cache(b * mb + 1, bs, hkv, dh, device="cuda", quant=kind)
    perm = torch.randperm(b * mb, generator=g, device="cuda").reshape(b, mb) + 1
    used = torch.arange(mb, device="cuda")[None] < (kv_lens[:, None] + bs - 1) // bs
    tables = torch.where(used, perm, torch.zeros_like(perm)).to(torch.int32)
    s = mb * bs
    pos = torch.arange(s, device="cuda")[None].expand(b, s)
    live = pos < kv_lens[:, None].long()
    slots = torch.where(live, tables.long().gather(1, pos // bs) * bs + pos % bs, pos % bs)
    wpos = torch.where(live, pos, torch.full_like(pos, CACHE_EMPTY_POS))
    k = torch.randn(b, s, hkv, dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, s, hkv, dh, generator=g, device="cuda").bfloat16()
    layers.paged_update_cache(pools, k, v, wpos, slots, quant=kind)
    q = torch.randn(b, hq, dh, generator=g, device="cuda").bfloat16().float()
    return q, pools, tables, kv_lens, (kv_lens - 1)


def check_attention(torch, timer, report):
    from repro_torch.core.codecs import get_codec
    from repro_torch.kernels import paged_attention, ref
    from repro_torch.models import layers

    g = torch.Generator(device="cuda").manual_seed(2)
    cases, worst = [], 0.0
    for kind in KV_KINDS:
        q, pools, tables, kv_lens, q_pos = _attention_inputs(torch, kind, g)
        errs = []
        for variant, kw in (("plain", {}), ("window", {"window": 512}),
                            ("softcap", {"softcap": 50.0})):
            args = (q, pools, tables, kv_lens, q_pos)
            got = paged_attention.paged_attention(*args, quant=kind, **kw)
            want = ref.paged_decode_attention(*args, quant=kind, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            worst = max(worst, rel)
            errs.append(f"{variant} {rel:.2e}")
            case = {"kind": kind, "variant": variant, "max_abs_err": err, "rel_err": rel}
            if variant == "plain":
                qb = q.bfloat16()
                bargs = (qb,) + args[1:]
                case["ms"] = timer(lambda: paged_attention.paged_attention(*bargs, quant=kind))
                case["device_ms"], case["host_ms"] = timer.split(
                    lambda: paged_attention.paged_attention(*bargs, quant=kind))
                case["plain_ms"] = timer(lambda: ref.paged_decode_attention(*bargs, quant=kind), reps=3)
                kg, vg, kpos = layers.paged_gather_kv(pools, tables, kind)
                # (B, Hq, T, Dh): each KV head serves its 4 query heads
                kt = kg.transpose(1, 2).repeat_interleave(4, dim=1)
                vt = vg.transpose(1, 2).repeat_interleave(4, dim=1)
                mask = (kpos <= q_pos[:, None]) & (kpos != ref.CACHE_EMPTY_POS)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                case["library_ms"] = timer(lambda: sdpa(
                    qb[:, :, None], kt, vt, attn_mask=mask[:, None, None]))
                codec = get_codec(kind) if kind != "none" else None
                w = codec.kv_code_width(128) if codec else 256  # bytes per head vector
                per_tok = 8 * (2 * w + (4 if codec and codec.has_scale else 0)) + 4
                pages = ((kv_lens + 31) // 32).sum().item()
                toks = kv_lens.sum().item()
                moved = pages * 32 * per_tok + 2 * qb.numel() * 2 + 4 * 4 * 64
                flops = 4.0 * 32 * 128 * toks
                case["bound_ms"], case["bound_by"] = bound_ms(moved, flops)
                log(f"attention {kind:5s}: rel_err {rel:.2e} kernel {case['ms']:.4f} ms "
                    f"({achieved(case, moved, flops)}; device {fmt_ms(case['device_ms'])}, host "
                    f"{case['host_ms']:.4f} ms) plain {case['plain_ms']:.4f} ms sdpa "
                    f"{case['library_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
                    f"({case['bound_by']})")
                del kg, vg, kt, vt
                if kind == SERVED_KV:
                    no_gathered_kv(torch, paged_attention.paged_attention, bargs, kind, report)
            if rel > KERNEL_TOL:
                raise AssertionError(f"paged attention disagrees with its plain version: {case}")
            cases.append(case)
        log(f"  attention {kind:5s} rel err: {', '.join(errs)}")
        del pools
    log(f"attention: {len(cases)} cases, max rel err {worst:.2e} (tolerance {KERNEL_TOL})")
    report["attention_cases"] = cases
    return cases


def check_compressed_leaf(torch, cfg, leaf, spec):
    """The served model's layer-0 wq, compressed on the card while the model
    was built, is bitwise what `compress` gives on a CPU copy of the same
    dense weight. The weight is drawn again by replaying `Model.init`'s
    draws from the same seed: embed, lm_head, then layer 0's wq."""
    from repro_torch.core.compression import compress
    from repro_torch.models.layers import dense_init

    g = torch.Generator(device="cuda").manual_seed(0)
    torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device="cuda")
    torch.randn((cfg.d_model, cfg.vocab_size), generator=g, device="cuda")
    w = dense_init(g, (cfg.d_model, cfg.n_heads * cfg.d_head), "cuda", torch.bfloat16)
    torch.cuda.empty_cache()
    on_card, on_cpu = compress(w, spec), compress(w.cpu(), spec)
    for plane in ("codes", "mask", "scales"):
        a, b, c = (getattr(t, plane) for t in (leaf, on_card, on_cpu))
        if (a is None) != (c is None) or (b is None) != (c is None):
            raise AssertionError(f"{plane}: planes present differ")
        if a is not None and not (torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c)):
            raise AssertionError(f"layer-0 wq {plane}: card and CPU compression differ")
    log(f"the served layer-0 wq ({tuple(w.shape)}, {spec.name}) == compress of its dense "
        f"weight on the card == compress on the CPU, bitwise, every plane")


def no_gathered_kv(torch, attend, args, kind, report):
    """One decode attention call over 4 slots of up to 2048 tokens never
    holds the gathered dense (bf16) K and V of its pages."""
    q, _, tables = args[:3]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    attend(*args, quant=kind)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    hkv, bs = 8, 32
    gathered = 2 * tables.numel() * bs * hkv * q.shape[-1] * 2
    log(f"paged attention ({kind}) peak extra allocation {extra / 1e6:.3f} MB < gathered "
        f"bf16 K+V {gathered / 1e6:.1f} MB: {extra < gathered}")
    report["attention_peak_extra_bytes"] = extra
    if extra >= gathered:
        raise AssertionError("paged attention allocated a gathered KV's worth of memory")


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to their plain versions (the
    comparison path of this check only)."""
    from repro_torch.kernels import deca_gemm, paged_attention, ref

    saved = (deca_gemm.decompress_gemv, deca_gemm.decompress_gemm,
             paged_attention.paged_attention)
    deca_gemm.decompress_gemv = ref.decompress_gemv
    deca_gemm.decompress_gemm = ref.decompress_gemm
    paged_attention.paged_attention = ref.paged_decode_attention
    try:
        yield
    finally:
        (deca_gemm.decompress_gemv, deca_gemm.decompress_gemm,
         paged_attention.paged_attention) = saved


def compare_paths(torch, model, params, report):
    """Prefill and decode-step logits of the kernel path against the plain
    path on the card, on the same tokens and the same fresh pools."""
    from repro_torch.serve.engine import make_paged_prefill_step

    bs, n = 32, 224
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, n), generator=g, device="cuda")
    pos = torch.arange(n, device="cuda", dtype=torch.int32)[None]
    tables = torch.zeros(1, 64, dtype=torch.int32, device="cuda")
    tables[0, :16] = torch.arange(1, 17)
    slots = (tables[0, pos[0].long() // bs] * bs + pos[0] % bs)[None]
    fresh = tables[0, :8].clone()
    last = torch.tensor([n - 1], device="cuda")
    results, fed, steps = {}, [], 4
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    for path in ("kernel", "plain"):
        ctx = plain_kernels() if path == "plain" else contextlib.nullcontext()
        with ctx:
            pools = model.init_paged_cache(16, bs, device="cuda")
            logits, pools = make_paged_prefill_step(model)(
                params, tokens, pos, pools, tables, slots, pos, fresh, last)
            outs = [logits.float()]
            for j in range(steps):
                if path == "kernel":  # both paths are fed the kernel path's tokens
                    fed.append(outs[-1].argmax(-1).to(torch.int32)[:, None])
                p = n + j
                step_pos = torch.tensor([[p]], dtype=torch.int32, device="cuda")
                step_slot = (tables[0, p // bs] * bs + p % bs).reshape(1, 1)
                lg, pools = model.decode_step_paged(
                    params, fed[j], step_pos, pools, tables, step_slot, step_pos,
                    zero, torch.tensor([p + 1], dtype=torch.int32, device="cuda"))
                outs.append(lg.float())
            torch.cuda.synchronize()
            results[path] = outs
            del pools
    rows = []
    for j, (a, b) in enumerate(zip(results["kernel"], results["plain"])):
        err, rel = rel_err(a, b)
        rows.append({"step": "prefill" if j == 0 else f"decode{j}", "max_abs_err": err,
                     "rel_err": rel, "argmax_equal": bool((a.argmax(-1) == b.argmax(-1)).all())})
    agree = sum(r["argmax_equal"] for r in rows)
    worst = max(r["rel_err"] for r in rows)
    log(f"kernel path vs plain path logits: max rel err {worst:.3e} over prefill + "
        f"{steps} decode steps (tolerance {LOGIT_TOL}); greedy-token agreement "
        f"{agree}/{len(rows)}")
    report["path_comparison"] = rows
    if worst > LOGIT_TOL:
        raise AssertionError(f"kernel path logits disagree with the plain path: {rows}")


def chunk_timer(torch, graphs, fn, records):
    """Wrap a scheduler's device step (`decode_chunk_fn` or `spec_fn`):
    each call's wall up to its tokens on the host, its device steps (the
    chunk length C, or the spec rounds) and whether it captured a graph
    (the first call of its shape: one uncaptured run plus the capture)."""
    def run(*a):
        n = len(graphs.graphs)
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        records.append({"wall_s": time.perf_counter() - t, "captured": len(graphs.graphs) > n,
                        "steps": int(a[2].shape[0]) if a[2].ndim == 3 else None})
        return out
    return run


def graph_costs(graphs, calls, what) -> dict:
    """Each captured graph's capture time and memory, and what its first
    call cost against the replayed calls."""
    rows = [{"key": [list(s) for s in key[:3]], "capture_s": g.capture_s,
             "graph_bytes": g.graph_bytes, "launches_a_replay": list(g.launches)}
            for key, g in graphs.graphs.items()]
    first = [c["wall_s"] for c in calls if c["captured"]]
    later = [c["wall_s"] for c in calls if not c["captured"]]
    log(f"{what} graphs: {len(rows)} captured, " + "; ".join(
        f"shapes {r['key']} capture {r['capture_s']:.3f} s, {r['graph_bytes'] / 1e6:.1f} MB, "
        f"{r['launches_a_replay'][0]} GeMV + {r['launches_a_replay'][2]} attention launches "
        f"a replay" for r in rows))
    log(f"  {what}: first call of each shape (uncaptured run + capture) "
        f"{', '.join(f'{1e3 * w:.1f}' for w in first)} ms; replayed calls mean "
        f"{1e3 * sum(later) / max(len(later), 1):.2f} ms over {len(later)}")
    return {"graphs": rows, "first_calls_s": first, "replayed_calls_s": later}


def check_replays(torch, eng, graphs, what, report, limit=None):
    """Each captured graph (up to `limit`) replayed on its last inputs
    against the uncaptured step from the same pools: tokens and every pool
    plane (null page excluded) bitwise equal, or the run fails."""
    from repro_torch.serve.graphs import replay_check

    keys = list(graphs.graphs)[:limit]
    for key in keys:
        bad = replay_check(graphs, key, eng.kv.pools)
        log(f"{what} replay, shapes {[list(s) for s in key[:3]]}: tokens and every pool "
            f"plane bitwise the uncaptured run's: {not bad}")
        if bad:
            raise AssertionError(f"{what} replay differs from the uncaptured run: {bad[:8]}")
    report.setdefault("replay_checks", []).append({"what": what, "graphs": len(keys)})
    torch.cuda.empty_cache()



def profile_replays(torch, graphs, what, report, n=4):
    """A captured graph alone: `n` replays of the first graph on its last
    inputs, timed between CUDA events (the wall), then `n` more traced with
    torch.profiler with events around them too: the kernels' device time
    over that window's wall is the share the card computes, the rest the
    gaps between the graph's kernels. The replays rewrite the pages of the
    graph's last chunk, which no request holds any more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    key, g = next(iter(graphs.graphs.items()))
    steps = key[2][0] if len(key[2]) == 3 else None  # positions (C, M, 1) of a chunk
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    g.graph.replay()
    a.record()
    for _ in range(n):
        g.graph.replay()
    b.record()
    b.synchronize()
    wall = a.elapsed_time(b) / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(n):
            g.graph.replay()
        b.record()
        b.synchronize()
    traced = a.elapsed_time(b) / n
    rows = sorted(({"name": e.key, "device_ms": e.self_device_time_total / 1e3 / n,
                    "count": e.count / n} for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("aten::")), key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups = {"GeMV": ("::gemv_kernel", "::splitk_reduce"),
              "attention": ("::split_kv_kernel", "::combine_kernel")}
    split = {k: sum(r["device_ms"] for r in rows if any(t in r["name"] for t in v))
             for k, v in groups.items()}
    split["other"] = busy - sum(split.values())
    kernels = sum(r["count"] for r in rows)
    per = f" = {wall / steps:.3f} ms a step" if steps else ""
    log(f"{what} replay alone (shapes {[list(x) for x in key[:3]]}): {wall:.3f} ms a replay"
        f"{per}; device busy {busy:.3f} ms ({', '.join(f'{k} {v:.3f}' for k, v in split.items())}),"
        f" {kernels:.0f} kernels; idle share {1 - busy / traced:.3f} of the traced "
        f"replays ({traced:.3f} ms each)")
    for r in rows[:8]:
        log(f"  {r['device_ms']:8.3f} ms {r['count']:7.0f}x  {r['name'][:90]}")
    report.setdefault("replay_profiles", {})[what] = {
        "wall_ms": wall, "traced_wall_ms": traced, "busy_ms": busy, "split_ms": split,
        "kernels": kernels,
        "steps": steps, "rows": rows[:30]}


def profile_serving(torch, eng, prompts, report, key="profile"):
    """Device time by kernel over a short second serving pass (4 requests,
    16 new tokens), traced with torch.profiler. The profiler slows the host,
    so the idle share it gives is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run_until_drained()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [  # kernels only: an operator's annotation row repeats its kernels' time
        {"name": evt.key, "device_ms": evt.self_device_time_total / 1e3, "count": evt.count}
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
        and not getattr(evt, "is_user_annotation", False) and not evt.key.startswith("aten::")
    ]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    report[key] = {"wall_ms": wall_ms, "device_busy_ms": busy, "rows": rows[:40]}
    if not rows:
        log("profiler: no device time recorded")
        return
    log(f"{key} pass: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall_ms:.3f} (upper bound: the profiler slows the host)")
    ours = ("::gemv_kernel", "::splitk_reduce", "::gemm_sm90_kernel", "::split_kv_kernel",
            "::combine_kernel")
    deca = sum(r["device_ms"] for r in rows if any(k in r["name"] for k in ours))
    log(f"  port kernels (GeMV with its split-K reduce, GeMM, split-KV attention with its "
        f"combine) {deca:.1f} ms, other kernels {busy - deca:.1f} ms")
    for r in rows[:8]:
        log(f"  {r['device_ms']:9.2f} ms {r['count']:6d}x  {r['name'][:90]}")
    gemv_per_step(rows, report[key])


def gemv_per_step(rows, out):
    """The GeMV's device time per forward step, by the codec of its
    instance (gemv_kernel<codec, MB>: 2 is bf8, the served weights; 6 is
    nf4, the spec draft's), each step being 225 launches (7 FC matmuls in
    each of 32 layers, and lm_head). The split-K reduce is not templated,
    so its time goes to each codec by its share of the GeMV launches."""
    reduce = [r for r in rows if "::splitk_reduce" in r["name"]]
    red_ms = sum(r["device_ms"] for r in reduce)
    kern = [r for r in rows if "::gemv_kernel<" in r["name"]]
    total = sum(r["count"] for r in kern)
    out["gemv_per_step"] = {}
    for codec, what in ((2, "bf8_50 target"), (6, "nf4 draft")):
        mine = [r for r in kern if f"::gemv_kernel<{codec}," in r["name"]]
        n = sum(r["count"] for r in mine)
        if n == 0:
            continue
        steps = n / 225
        ms = sum(r["device_ms"] for r in mine)
        shared = red_ms * n / total
        out["gemv_per_step"][what] = {"steps": steps, "kernel_ms": ms / steps,
                                      "with_reduce_ms": (ms + shared) / steps}
        log(f"  GeMV device time per {what} step: {(ms + shared) / steps:.3f} ms "
            f"({ms / steps:.3f} ms in gemv_kernel, {shared / steps:.3f} ms its share of "
            f"splitk_reduce) over {steps:.0f} steps ({n} launches; instances "
            + ", ".join(f"{r['name'].split('gemv_kernel')[1].split('>')[0]}> {r['count']}x"
                        for r in mine) + ")")


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import deca_decompress, deca_gemm, paged_attention

    return {"deca_gemv": deca_gemm.decompress_gemv, "deca_gemm": deca_gemm.decompress_gemm,
            "deca_paged_attention": paged_attention.paged_attention,
            "deca_decompress": deca_decompress.decompress}


def check_draft_leaf(torch, target, served, draft_spec):
    """The served draft's layer-0 w_up, built on the card through the
    decompression kernel, is bitwise the port's CPU `make_draft_tree` of
    the same target leaf."""
    import dataclasses

    from repro_torch.core.decompress import make_draft_tree

    cpu = dataclasses.replace(target, **{
        n: None if getattr(target, n) is None else getattr(target, n).cpu()
        for n in ("codes", "mask", "scales")})
    t0 = time.perf_counter()
    want = make_draft_tree({"w_up": cpu}, draft_spec)["w_up"]
    for plane in ("codes", "mask", "scales"):
        a, b = getattr(served, plane), getattr(want, plane)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            raise AssertionError(f"draft layer-0 w_up {plane}: card and CPU builds differ")
    log(f"the served draft's layer-0 w_up {target.shape} ({draft_spec.name}) == the CPU "
        f"make_draft_tree of the same target leaf, bitwise, every plane "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")


def teacher_forced(torch, model, params, prompts, outs, report):
    """Each emitted token's logit in one teacher-forced target forward over
    prompt + emitted tokens (kernel path) lies within LOGIT_TOL of the
    position's scale below the position's largest logit. Returns the share
    of positions where it is the argmax."""
    worst, exact, total = 0.0, 0, 0
    for p, out in zip(prompts, outs):
        seq = torch.as_tensor(list(p) + list(out[:-1]), device="cuda")
        rows = model.score(params, seq)[len(p) - 1:]
        em = torch.as_tensor(out, device="cuda").long()
        picked = rows.gather(1, em[:, None])[:, 0]
        gap = (rows.max(dim=1).values - picked) / rows.abs().max()
        worst = max(worst, gap.max().item())
        exact += int((rows.argmax(dim=1) == em).sum())
        total += len(out)
        del rows
    report["teacher_forced"] = {"worst_gap": worst, "argmax_share": exact / total}
    log(f"teacher-forced target logits: worst gap of an emitted token below the "
        f"position's max {worst:.3e} of max|logit| (tolerance {LOGIT_TOL}); emitted "
        f"token is the argmax at {exact}/{total} positions")
    if worst > LOGIT_TOL:
        raise AssertionError("a spec token lies outside the teacher-forced logit tolerance")
    return exact / total


def serve_spec(torch, model, params, prompts, plain_outs, report):
    """The self-speculative path at full width: build the engine (the
    draft tree through the decompression kernel), serve the requests all
    at once, and hold the output against the target model. Counts are
    zeroed before the build and read after the serve."""
    from repro_torch.core.compression import CompressedTensor
    from repro_torch.core.decompress import _leaves, compressed_bytes
    from repro_torch.core.formats import get_spec
    from repro_torch.serve.engine import GenerationEngine, SpecConfig

    spec = SpecConfig(k=SPEC_K, draft_codec=DRAFT_CODEC)
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8, spec_decode=spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_extra = torch.cuda.max_memory_allocated() - base
    built = counters()["deca_decompress"].launches
    n_ct = sum(isinstance(x, CompressedTensor) for x in _leaves(params))
    target_b, draft_b = compressed_bytes(params), compressed_bytes(eng.draft_params)
    fc = lambda tree: sum(x.nbytes for x in _leaves(tree) if isinstance(x, CompressedTensor))
    log(f"spec engine (k={SPEC_K}, draft {DRAFT_CODEC}, {eng.spec_rounds} rounds per "
        f"launch): draft tree built in {build_s:.2f} s with {built} decompress launches "
        f"({n_ct} compressed leaves), peak extra allocation {peak_extra / 1e9:.3f} GB "
        f"(pool included); compressed_bytes target {target_b / 1e9:.3f} GB, draft "
        f"{draft_b / 1e9:.3f} GB; FC planes target {fc(params) / 1e9:.3f} GB, draft "
        f"{fc(eng.draft_params) / 1e9:.3f} GB")
    if built != n_ct:
        raise AssertionError(f"{built} decompress launches for {n_ct} compressed leaves")
    check_draft_leaf(torch, params["layers"][0]["mlp"]["w_up"],
                     eng.draft_params["layers"][0]["mlp"]["w_up"], get_spec(DRAFT_CODEC))

    launches_ = []
    eng.scheduler._spec = chunk_timer(torch, eng._spec_graphs, eng.scheduler._spec, launches_)
    rids = [eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    outs = [done[r] for r in rids]
    st = eng.scheduler.stats()
    n_tok = sum(len(o) for o in outs)
    log(f"spec served {len(rids)} requests (prompt lengths {[len(p) for p in prompts]}) x "
        f"{SPEC_NEW} new tokens: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s; "
        f"accepted_tokens_per_step {st['accepted_tokens_per_step']:.3f}, draft_tokens "
        f"{st['draft_tokens']}, verify_calls {st['verify_calls']}, decode rounds "
        f"{st['decode_steps']} in {st['decode_chunks']} launches")
    log(f"launches on the spec path (engine build + serve): {launches}")
    if any(len(o) != SPEC_NEW for o in outs):
        raise AssertionError(f"a spec request did not emit its {SPEC_NEW} tokens")
    idle = [k for k in ("deca_decompress", "deca_gemv", "deca_paged_attention")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the spec path: {idle}")
    argmax_share = teacher_forced(torch, eng.model, params, prompts, outs, report)
    same = sum(list(o) == list(p[:SPEC_NEW]) for o, p in zip(outs, plain_outs))
    log(f"spec requests equal token for token to the non-spec serve of the same "
        f"prompts: {same}/{len(outs)}")
    later = [c["wall_s"] for c in launches_ if not c["captured"]]
    round_ms = 1e3 * sum(later) / max(len(later), 1) / eng.spec_rounds
    log(f"spec round wall (replayed launches of {eng.spec_rounds} rounds): {round_ms:.2f} ms "
        f"a round over {len(later)} launches, {st['accepted_tokens_per_step']:.3f} tokens a "
        f"verify")
    report["spec"] = {"build_s": build_s, "build_peak_extra_bytes": peak_extra,
                      "target_bytes": target_b, "draft_bytes": draft_b, "tokens": n_tok,
                      "wall_s": wall, "launches": launches, "stats": st,
                      "argmax_share": argmax_share, "same_as_plain": same,
                      "spec_launches": launches_, "round_ms": round_ms,
                      "graphs": graph_costs(eng._spec_graphs, launches_, "spec round")}
    check_replays(torch, eng, eng._spec_graphs, "spec launch", report, limit=1)
    profile_replays(torch, eng._spec_graphs, "spec launch", report)
    return eng, launches


def temperature_check(torch, model, params, prompts, outs, temp, seed, rids):
    """Every token of a temperature serve against teacher-forced logits:
    with the sampler's own keys (seed, request id, output index), the
    token's perturbed score gumbel + logit / temp lies within the kernel
    path's logit tolerance (over temp) of the position's largest. A wrong
    key would pick tokens the scores do not favour. Returns, per request,
    the teacher-forced perturbed scores (for the near-tie proofs)."""
    from repro_torch.serve import sampling

    key, worst, scores = sampling.prng_key(seed, "cuda"), 0.0, []
    for rid, p, out in zip(rids, prompts, outs):
        seq = torch.as_tensor(list(p) + list(out[:-1]), device="cuda")
        rows = model.score(params, seq)[len(p) - 1:]
        n, v = rows.shape
        keys = sampling.fold_in(sampling.fold_in(key.expand(n, 2),
                                                 torch.full((n,), rid, device="cuda")),
                                torch.arange(n, device="cuda"))
        s = sampling.gumbel(keys, v) + rows / temp
        tol = LOGIT_TOL * rows.abs().max() / temp
        em = torch.as_tensor(out, device="cuda").long()
        gap = (s.max(dim=1).values - s.gather(1, em[:, None])[:, 0]).max()
        worst = max(worst, float(gap / tol))
        scores.append((s, tol))
        del rows
    if worst > 1.0:
        raise AssertionError(f"a sampled token lies {worst:.2f} tolerances below the top "
                             "teacher-forced perturbed score")
    return worst, scores


def serve_temperature(torch, model, params, prompts, report, temp=0.7, seed=0):
    """The plain and the spec engine at temperature `temp`, seed `seed`, on
    the same requests: every token held against teacher-forced perturbed
    scores, and spec against sequential token for token. Where they part,
    the first differing token must be a near tie of the teacher-forced
    scores (both within the logit tolerance of the top): the two paths sum
    their logits in other orders (verify at M = 16 and gather attention,
    decode at M = 4 and the split-KV kernel)."""
    from repro_torch.serve.engine import GenerationEngine, SpecConfig

    outs, res = {}, {}
    for name, spec in (("plain", None), ("spec", SpecConfig(k=SPEC_K, draft_codec=DRAFT_CODEC))):
        eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                               max_len=2048, decode_chunk=8, temperature=temp, seed=seed,
                               spec_decode=spec)
        calls = []
        if spec is None:
            eng.scheduler._decode_chunk = chunk_timer(torch, eng._chunk_graphs,
                                                      eng.scheduler._decode_chunk, calls)
        else:
            eng.scheduler._spec = chunk_timer(torch, eng._spec_graphs, eng.scheduler._spec,
                                              calls)
        rids = [eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs[name] = [done[r] for r in rids]
        st = eng.scheduler.stats()
        later = [c for c in calls if not c["captured"]]
        per = sum(c["wall_s"] for c in later) / max(1, sum(c["steps"] or eng.spec_rounds
                                                          for c in later))
        worst, scores = temperature_check(torch, eng.model, params, prompts, outs[name],
                                          temp, seed, rids)
        res[name] = {"wall_s": wall, "ms_per_device_step": 1e3 * per, "stats": st,
                     "worst_gap_in_tolerances": worst}
        log(f"temperature {temp} seed {seed}, {name}: {sum(map(len, outs[name]))} tokens in "
            f"{wall:.2f} s; replayed {'decode steps' if spec is None else 'spec rounds'} "
            f"{1e3 * per:.2f} ms each; every token within {worst:.3f} of the tolerance of the "
            f"top teacher-forced perturbed score")
        del eng
        torch.cuda.empty_cache()
    same, ties = 0, []
    for i, (a, b) in enumerate(zip(outs["plain"], outs["spec"])):
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            same += 1
            continue
        j = diff[0]
        s, tol = scores[i]  # the spec serve's; the prefix up to j is common
        top = s[j].max()
        gaps = [float(top - s[j, int(t)]) for t in (a[j], b[j])]
        near = max(gaps) <= float(tol)
        ties.append({"request": i, "at": j, "near_tie": near,
                     "score_gap": abs(gaps[0] - gaps[1]), "tolerance": float(tol)})
        if not near:
            raise AssertionError(f"spec and sequential part at request {i} output {j} "
                                 "where the scores show no near tie")
    log(f"temperature: spec equals sequential token for token on {same}/{len(prompts)} "
        f"requests; where they part, a near tie of the teacher-forced scores: {ties}")
    report["temperature"] = {"temp": temp, "seed": seed, **res, "same": same, "ties": ties}


def sampler_time(torch, report):
    """The keyed sampler's device time, captured alone in a CUDA graph as
    the decode graph runs it: 4 rows (a plain step or a draft step) and 16
    rows (a verify of k = 3) of llama3-8b's 128256 logits, the median of
    20 replays between CUDA events."""
    from repro_torch.serve import sampling

    out = {}
    for rows in (4, 16):
        g = torch.Generator(device="cuda").manual_seed(rows)
        logits = torch.randn(rows, 128256, generator=g, device="cuda") * 3
        rids = torch.arange(rows, device="cuda")
        steps = torch.full((rows,), 7, device="cuda")
        key = sampling.prng_key(0, "cuda")
        temp = torch.tensor(0.7, device="cuda")
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            eager = sampling.sample_rows_keyed(key, rids, steps, logits, temp)
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph, stream=stream):
            toks = sampling.sample_rows_keyed(key, rids, steps, logits, temp)
        times = []
        for _ in range(20):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        if not torch.equal(toks, eager):
            raise AssertionError("the captured sampler disagrees with the uncaptured one")
        out[rows] = sorted(times)[len(times) // 2]
        del graph
    log(f"keyed sampler, captured alone: {out[4]:.4f} ms for 4 x 128256 logits (a decode "
        f"or draft step), {out[16]:.4f} ms for 16 x 128256 (a verify)")
    report["sampler_ms"] = out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.core.decompress import compressed_bytes
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import cuda, ops
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    report = {}
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    report["card"] = {"nvidia_smi": smi, "name": kind}

    # 2. build every kernel of the path, one nvcc per source, all at once
    t0 = time.perf_counter()
    ptxas = cuda.build()
    (OUT / "ptxas.txt").write_text("\n\n".join(f"== {k}\n{v}" for k, v in ptxas.items()))
    log(f"built {sorted(ptxas) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s "
        f"(ptxas report: chiprun_out/ptxas.txt)")

    # 3. each kernel against its plain version at the path's shapes
    timer = Timer(torch)
    mm_cases, dec_cases = check_matmuls(torch, timer, report)
    att_cases = check_attention(torch, timer, report)
    del timer
    torch.cuda.empty_cache()

    # 4. full-width llama3-8b, each layer compressed on the card as drawn
    cfg = get_config("llama3-8b")
    spec = get_spec(SERVED_SPEC)
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda", spec=spec)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    nbytes = compressed_bytes(params)
    log(f"llama3-8b full width ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}) built and compressed to {SERVED_SPEC} on the card in "
        f"{t_build:.1f} s: {nbytes / 1e9:.3f} GB of params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    report["model"] = {"build_s": t_build, "param_bytes": nbytes}
    check_compressed_leaf(torch, cfg, params["layers"][0]["attn"]["wq"], spec)

    # 5. serve 8 greedy requests through the engine; counters read the run
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8)
    rng = torch.Generator().manual_seed(4)
    lens = torch.randint(64, 1025, (8,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).numpy() for n in lens]
    sched = eng.scheduler
    walls = {"prefill": 0.0, "decode": 0.0}
    prefill_calls = []

    def timed(name, fn):
        def run(*a):
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            walls[name] += time.perf_counter() - t
            if name == "prefill":
                prefill_calls.append(time.perf_counter() - t)
            return out
        return run

    sched._prefill = timed("prefill", sched._prefill)
    chunks = []
    sched._decode_chunk = chunk_timer(torch, eng._chunk_graphs, sched._decode_chunk, chunks)
    rids = [eng.submit(p, max_new_tokens=64) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(done[r]) for r in rids)
    st = sched.stats()
    walls["decode"] = sum(c["wall_s"] for c in chunks)
    log(f"served {len(rids)} requests (prompt lengths {lens}) x 64 new tokens, "
        f"kv {SERVED_KV}: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s; "
        f"prefill {walls['prefill']:.2f} s over {st['prefill_calls']} calls "
        f"({', '.join(f'{w:.2f}' for w in prefill_calls)} s), decode "
        f"{walls['decode']:.2f} s over {st['decode_chunks']} chunks / {st['decode_steps']} "
        f"steps = {st['active_slot_steps'] / max(walls['decode'], 1e-9):.1f} tok/s; "
        f"peak device memory {peak / 1e9:.2f} GB")
    later = [c for c in chunks if not c["captured"]]
    replay_ms = 1e3 * sum(c["wall_s"] for c in later) / max(1, sum(c["steps"] for c in later))
    log(f"decode with graphs: {1e3 * walls['decode'] / st['decode_steps']:.2f} ms a decode "
        f"step over the serve (first chunk of each shape included); replayed chunks "
        f"{replay_ms:.2f} ms a device step over {len(later)} chunks")
    steps_run = launches["deca_paged_attention"] / cfg.n_layers  # one per layer a step
    log(f"launches on the served run: {launches}; per decode step: deca_gemv "
        f"{launches['deca_gemv'] / max(steps_run, 1):.1f}, deca_paged_attention "
        f"{cfg.n_layers}; per prefill call: deca_gemm "
        f"{launches['deca_gemm'] / max(st['prefill_calls'], 1):.1f}")
    if launches["deca_gemv"] != (7 * cfg.n_layers + 1) * steps_run:
        raise AssertionError("the decode steps did not launch 7 GeMVs a layer and lm_head's")
    report["serve"] = {"prompt_lens": lens, "tokens": n_tok, "wall_s": wall,
                       "prefill_s": walls["prefill"], "prefill_calls_s": list(prefill_calls),
                       "decode_s": walls["decode"], "chunks": chunks,
                       "decode_ms_per_step": 1e3 * walls["decode"] / st["decode_steps"],
                       "replayed_ms_per_device_step": replay_ms,
                       "peak_bytes": peak, "launches": launches, "stats": st}
    report["serve"]["graphs"] = graph_costs(eng._chunk_graphs, chunks, "plain decode")
    check_replays(torch, eng, eng._chunk_graphs, "plain decode chunk", report)
    profile_replays(torch, eng._chunk_graphs, "plain decode chunk", report)
    if any(len(done[r]) != 64 for r in rids):
        raise AssertionError("a request did not emit its 64 tokens")
    if not all(0 <= int(t) < cfg.vocab_size for r in rids for t in done[r]):
        raise AssertionError("a token lies outside the vocabulary")
    idle = [k for k, v in launches.items() if v == 0 and k != "deca_decompress"]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    profile_serving(torch, eng, [p[:512] for p in prompts[:4]], report)
    compare_paths(torch, eng.model, params, report)

    # the lm_head GeMV never holds the dense (4096, 128256) weight
    x = torch.randn(4, cfg.d_model, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.decompress_gemm(x, params["lm_head"], out_dtype=torch.float32)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    dense = cfg.d_model * cfg.vocab_size * 2
    log(f"lm_head GeMV peak extra allocation {extra / 1e6:.2f} MB < dense bf16 weight "
        f"{dense / 1e6:.1f} MB: {extra < dense}")
    report["lm_head_peak_extra_bytes"] = extra
    if extra >= dense:
        raise AssertionError("the lm_head GeMV allocated a dense weight's worth of memory")

    # 6. self-speculative decode on the same weights
    plain_outs = [done[r] for r in rids[:4]]
    del eng, sched, done, x
    torch.cuda.empty_cache()
    spec_eng, spec_launches = serve_spec(torch, model, params, prompts[:4], plain_outs, report)
    profile_serving(torch, spec_eng, [p[:512] for p in prompts[:4]], report, "spec_profile")
    del spec_eng
    torch.cuda.empty_cache()

    # 7. keyed temperature sampling, on the card inside the captured graphs
    sampler_time(torch, report)
    serve_temperature(torch, model, params, prompts[:4], report)

    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s; details in chiprun_out/chip_smoke.json")

    def pick(cases, **want):
        return next(c for c in cases if all(c.get(k) == v for k, v in want.items()))

    gv = pick(mm_cases, kernel="gemv", role="gate/up", M=4, spec=SERVED_SPEC)
    for m, sp in ((1, SERVED_SPEC), (4, SERVED_SPEC), (16, SERVED_SPEC), (32, SERVED_SPEC),
                  (4, f"{DRAFT_CODEC}_100")):
        c = pick(mm_cases, kernel="gemv", role="gate/up", M=m, spec=sp)
        log(f"deca_gemv gate/up M={m:2d} {sp}: event-timed {c['ms']:.4f} ms, device "
            f"{fmt_ms(c['device_ms'])}, wrapper host {c['host_ms']:.4f} ms; library "
            f"{c['library_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms")
    gm = pick(mm_cases, kernel="gemm", role="gate/up", M=2048, spec=SERVED_SPEC)
    gm4 = pick(mm_cases, kernel="gemm", role="gate/up", M=4096, spec=SERVED_SPEC)
    log(f"deca_gemm gate/up {SERVED_SPEC}: M=2048 {gm['ms']:.4f} ms, M=4096 {gm4['ms']:.4f} ms "
        f"({gm4['tflop_s']:.1f} TFLOP/s; library {gm4['library_ms']:.4f} ms, bound "
        f"{gm4['bound_ms']:.4f} ms)")
    at = pick(att_cases, kind=SERVED_KV, variant="plain")
    dc = pick(dec_cases, role="gate/up", spec=SERVED_SPEC, out="float32")
    for name, c in (("deca_gemv", gv), ("deca_gemm", gm), ("deca_paged_attention", at),
                    ("deca_decompress", dc)):
        log(f"{name}: event-timed {c['ms']:.4f} ms, device (profiler) {fmt_ms(c['device_ms'])}, "
            f"wrapper host {c['host_ms']:.4f} ms a call")
    csrc = "src/repro_torch/csrc/"
    # each kernel's launches on the path it serves: the matmul and attention
    # kernels on the non-spec serve, the decompression kernel on the spec path
    launches["deca_decompress"] = spec_launches["deca_decompress"]
    rows = [
        ("deca_gemv", csrc + "deca_gemm.cu", "src/repro/kernels/deca_gemm.py:176", gv),
        ("deca_gemm", csrc + "deca_gemm_sm90.cu", "src/repro/kernels/deca_gemm.py:104", gm),
        ("deca_paged_attention", csrc + "paged_attention.cu",
         "src/repro/kernels/paged_attention.py:118", at),
        ("deca_decompress", csrc + "deca_decompress.cu",
         "src/repro/kernels/deca_decompress.py:103", dc),
    ]
    worst_abs = {  # over every case each kernel was held on
        "deca_gemv": max(c["max_abs_err"] for c in mm_cases if c["kernel"] == "gemv"),
        "deca_gemm": max(c["max_abs_err"] for c in mm_cases if c["kernel"] == "gemm"),
        "deca_paged_attention": max(c["max_abs_err"] for c in att_cases),
        "deca_decompress": max(c["max_abs_err"] for c in dec_cases),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": worst_abs[name], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"],
    } for name, src, rep, c in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
and that an lm_head GeMV never holds a dense weight. Then `single_step`
serves the same traffic through the single-step loop (`decode_chunk=1`:
one captured (M, 1) step and one host sync a token), its tokens against
the chunk-8 serve's, its launches a step against a chunk step's, its graph
replayed bitwise, its walls beside the chunk's, and runs the two serving
example twins (`examples/*_torch.py`) on the card. It imports nothing of
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
Then it times the keyed temperature sampler captured alone and serves at
temperature 0.7, plain and spec, holding every token against teacher-forced
perturbed scores and spec against sequential token for token. Last come
two serving features: `prefix_serve` serves 8 prompts over two system
prompts in two waves with the prefix cache on and off (hits, copy-on-write
clones, the shared pages bitwise unchanged, per-request time to first
token), and `chunked_prefill` lets a 1536-token prompt arrive while three
requests decode, prefilled whole and in 256-token chunks (the worst gap
between decode chunks, the long request's time to first token, no decode
graph captured meanwhile). Each new phase sets the launch counts to 0
before it, reads them after, and holds every token against teacher-forced
logits. The last phase, `observed_serve`, installs `Observability.default()`
(metrics, tracer, RoofLens on the H100 profile) on the serving path: the
plain serve's traffic again, whose tokens, host syncs and launch counts
must equal the plain serve's (and its replayed decode step prints beside
it); a warm second serve whose RoofLens error and fitted scale per regime
print against the expected scales; the tracer's TTFT / ITL percentiles and
Chrome traces (chiprun_out/obs_trace*.json); an observed spec serve (draft
and verify regimes); and chunked_prefill's arrival with its chunk span
sized by RoofLens under a `prefill_sla_s` budget. Last, `overload_serve`
drives overload resilience and the host KV tier: (a) a spec engine with
the prefix cache, chunked prefill, a host tier and a bounded queue, on a
pool too small for its traffic, climbs the degradation ladder down to
parking residents and resumes them (every request OK, the ladder relaxed
at drain, tier pages spilled and restored, the page audit clean); (b) the
chaos harness: a poisoned prefill, an exhausted pool, a corrupted tier
payload and a slow round against a clean serve (one request FAILED, every
fault fired, the slow round flagged, survivors equal up to a near tie);
(c) the TTFT and ITL gates on RoofLens's calibrated prices (what they
shed, defer and expire, and how many admitted requests met each
objective). Then `mesh_serve` serves the same weights sharded,
`GenerationEngine(mesh=)` on a one-rank NCCL mesh (1, 1), beside the plain
engine on the same 4 requests: tokens and pool planes bitwise, a step's
launches the plain step's, the chunk captured with its collectives and
replayed bitwise, the replayed step beside the plain one; then the kernels
at llama2-70b's local shard shapes on a (1, 4) mesh (`tools/mesh_serve.py`
runs it alone). Last, `paper_models` frees llama3-8b and serves the paper's
two end-to-end models, llama2-70b and opt-66b (learned positions, a relu
MLP, full MHA), at full width and depth on the one card: each built with
its layers compressed on the card as they are drawn (the build's peak
within BUILD_HEADROOM of the stored params), its kernels held against
their plain versions at its shapes and timed, 4 requests and then 1
served greedily through captured decode graphs (prefill walls, the
replayed decode step beside its bytes bound, launches, a replay's
breakdown, tokens against teacher-forced logits), and its kernel path held
against the plain path over its first 4 layers; then llama3.2-1b the same
way, whose head is tied to the embedding. Last, `moe` serves grok-1-314b
(8 experts, top-2) at full width and 8 of its 64 layers, built one
expert at a time: its kernels at its shapes and kimi-k2's, a 4-request
serve with 417 GeMVs a decode step, replays bitwise and the token-slots
each prefill drops, the same weights served on a one-rank NCCL mesh (its
experts split over `model`, one rank holding all 8) beside the plain
engine, bitwise, and the kernels at its (1, 4) local shard shapes, the
kernel path against the plain path, a drop-free
copy with its routes pinned held against teacher-forced logits, and a
spec engine on 2 of its layers. Last, `recurrent` serves falcon-mamba-7b
(64 Mamba-1 layers) and recurrentgemma-9b (RG-LRU and global MQA blocks,
int8 ring KV) at full width and depth through the dense ring engine that
`paged="auto"` picks for them: the build, the GeMV and GeMM at their
shapes (K 256, N 288 and 256, f32 x), 4 prompts of 64 tokens x 32 new
with 256 and 292 GeMVs a decode step, the step beside its bytes bound,
the same serve with `paged=False` on a one-rank NCCL mesh beside the
plain ring engine (tokens, ring planes and recurrent states bitwise, the
same launches; `ring_on_mesh`) and the kernels at its (1, 4) local shard
shapes, a profiler split of a decode step, the kernel path against the
plain path, every token against teacher-forced logits of the full scan;
then llama3.2-1b
with `paged=False`, its tokens against its paged engine's up to a near
tie. Last, `vlm_audio` serves qwen2-vl-7b (M-RoPE over three position
streams, G 7) and hubert-xlarge (a bidirectional encoder with learned
positions over 32768, Dh 80, a gelu MLP, 504 targets) at full width and
depth: qwen2-vl's kernels at its shapes, 4 requests through captured
graphs with 197 GeMVs and 28 attention calls a step (replays bitwise,
tokens against teacher-forced logits), its kernel path against the plain
path, a spec engine, and a forward on one image's 32 x 32 patch
embeddings with Qwen2-VL's three streams; hubert's GeMV at its decode
rows (M = 4) and GeMM at M = 4096 and 32768 (lm_head N = 504 on the
direct path), attention at Dh 80 with
causal=0, encoder passes at 4 x 1024 and 1 x 32768 (289 GeMMs a pass,
beside the FLOP bound), its kernel path against the plain path,
bidirectionality, and a paged serve of 4 x 64 tokens
(`tools/vlm_audio_serve.py` runs it alone). Last, `train` trains: one
AdamW step of llama3.2-1b smoke on the card against the CPU, the
crash-and-restart through `ResilientTrainer` on the card (bitwise under
deterministic algorithms), llama3.2-1b at full width and depth for 8 steps
through `train_loop` on 2 x 4096 tokens with remat and AdamW (losses, the
median step, tokens/s, 6 N T FLOPs against the bf16 peak, peak memory,
no DECA kernel launched), one Adafactor step, and (e) the same model
trained 3 steps with int8 gradient compression on a one-rank NCCL mesh
(the round trip bitwise the CPU port's, err within half a quantization
step), one bf8 step, and its params placed with `shard_params`
(`tools/train_run.py` runs it alone). The kernel bounds take their
rates from the same H100 profile (`core/roofsurface.py`), whose
Roof-Surface lines print as an analytic line at the start.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM device memory bytes/s and dense bf16 tensor-core FLOP/s: set by
# main() from the port's roofsurface.H100_SXM, which RoofLens prices with
HBM_BYTES_PER_S = BF16_FLOP_PER_S = None
H100_NAME = "NVIDIA H100 80GB HBM3"  # the card H100_SXM describes
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
# the paper's end-to-end models (Table 4), served compressed at full width
# and depth after llama3-8b, then a model with a tied head
PAPER_MODELS = ("llama2-70b", "opt-66b")
TIED_MODEL = "llama3.2-1b"
PAPER_NEW = 32  # new tokens a request
# a compressed build may hold this much beyond its params: a layer drawn
# dense and its compression's scratch, never the dense model
BUILD_HEADROOM = 12e9
PATH_LAYERS = 4  # depth of their kernel-path vs plain-path comparison
# gemma2-2b at full width: 4 requests of seeded lengths, then one long one
# whose local layers' window (4096) cuts the page walk
GEMMA = "gemma2-2b"
GEMMA_LONG = 4600
GEMMA_MAX_LEN = 8192
# hubert-xlarge's lm_head width: code rows of 504 bytes, no TMA box
ODD_N, ODD_K = 504, 1280
# grok-1-314b at full width, cut in depth: one card holds 16 of its 64
# layers with all 8 experts (about 51 GB at bf8_50), a uniform stack; the
# script runs 8 of them (about 26 GB) to keep within its time budget; a
# drop-free copy (capacity = n_experts) with its routes pinned carries the
# token rule, and its spec engine runs at MOE_SPEC_LAYERS
MOE = "grok-1-314b"
MOE_LAYERS = 8
MOE_NEW = 64
MOE_SPEC_LAYERS = 2
MOE_PATH_STEPS = 1  # decode steps of its kernel-vs-plain comparison (plain GeMV ~0.1 s a call)
# expert matmul rows: decode bins of 4 slots (M = cap = 4), the spec
# verify's 16, a 1024-token prompt's bin at capacity 1.25 (160), a long prefill
MOE_EXPERT_MS = (1, 4, 16, 160, 2048)
KIMI = "kimi-k2-1t-a32b"  # its expert GeMVs and its attention at Dh 112, G 8
# falcon-mamba-7b (Mamba-1) and recurrentgemma-9b (RG-LRU + MQA) at full
# width and depth through the dense ring engine that `paged="auto"` picks
# for them, then llama3.2-1b on it with `paged=False`: 4 prompts of 64
# tokens, 32 new greedy tokens each
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-9b")
RING_MODEL = TIED_MODEL
RECURRENT_BATCH, RECURRENT_PROMPT, RECURRENT_NEW = 4, 64, 32
RECURRENT_MS = (1, 4, 256)  # the GeMV at decode rows, the GeMM at the prefill's 4 x 64
# each recurrent stack then served with paged=False on a one-rank NCCL mesh
# beside the plain ring engine (`ring_on_mesh`), and its kernels at its
# (1, 4) local shard shapes: falcon-mamba's in_proj N 16384 / 4 (gathered
# whole for [u | z]), x_proj N 288 / 4 = 72 (gathered whole for dt_r | B |
# C), dt_proj N 8192 / 4, out_proj K 8192 / 4; recurrentgemma's w_in /
# w_gate_branch / w_a / w_x / wq N 4096 / 4, wk / wv N 256 / 4 (its one KV
# head gathered whole), the MLP's N 12288 / 4, w_out / wo K 4096 / 4 and
# w_down K 12288 / 4
RING14 = {
    "falcon-mamba-7b": ("falcon-mamba-7b (1, 4)", (
        (4096, 4096, "in"), (8192, 72, "x"), (256, 2048, "dt"), (2048, 4096, "out"))),
    "recurrentgemma-9b": ("recurrentgemma-9b (1, 4)", (
        (4096, 1024, "in/gate_branch/a/x/q"), (4096, 64, "k/v"), (4096, 3072, "gate/up"),
        (1024, 4096, "out/o"), (3072, 4096, "down"))),
}
RING14_MS = (4, 256)  # the decode step's rows and the prefill's 4 x 64
# qwen2-vl-7b (M-RoPE, G 7) and hubert-xlarge (a bidirectional encoder, Dh
# 80, learned positions over 32768, a gelu MLP, 504 targets) at full width
# and depth: qwen's matmuls at decode rows, the spec verify's 16 and a
# prefill; one image of a 32 x 32 patch grid between 16 + 16 text
# embeddings; hubert's GeMV at its served decode rows (4), its GeMM at a
# 4 x 1024 pass and the reference's prefill_32k length (its batch of 32
# cut to 1), served paged as the reference serves it: 4 prompts of 64
# tokens, 8 new each
VLM, AUDIO = "qwen2-vl-7b", "hubert-xlarge"
VLM_MS = (1, 4, 16, 2048)
IMAGE_TEXT, IMAGE_GRID = 16, 32
AUDIO_MS = (4, 4096, 32768)
AUDIO_PASSES = ((4, 1024), (1, 32768))
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_NEW = 4, 64, 8
# training (the `train` phase): llama3.2-1b at full width and depth on
# SHAPES["train_4k"]'s 4096-token rows, its global batch of 256 cut to one
# card's TRAIN_BATCH; TRAIN_STEPS steps of cfg.optimizer with remat on a
# schedule that warms up in TRAIN_WARMUP steps to TRAIN_PEAK_LR
TRAIN_MODEL = TIED_MODEL
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_PEAK_LR = 2, 8, 2, 1e-4  # 1e-3 and 2e-4 overshoot: the loss jumps at step 3 or 4
TRAIN_SMOKE_LR = 1e-3  # the card-vs-CPU step at smoke size
TRAIN_LOSS_RTOL = 1e-3  # card against CPU: the loss
TRAIN_GRAD_SHARE = 5e-2  # card against CPU: each gradient leaf, of its largest magnitude
TRAIN_PARAM_SHARE = 1e-2  # card against CPU: params an update apart, of all elements
# (e) compressed data-parallel training on a one-rank NCCL mesh: (c)'s model,
# seed, batch and schedule, TRAIN_DIST_STEPS int8 steps, then one bf8 step;
# the round trip of TRAIN_DIST_SAMPLES checked against the CPU port's
TRAIN_DIST_STEPS = 3
TRAIN_DIST_SAMPLES = ("final_norm", "layers/0/attn/wk", "layers/15/mlp/w_down")
# |err| <= half a step a group, but for the f32 rounding of the dequantized
# q x scale (|q| <= 127): up to 2 x 127 x 2^-24 of the half step
HALF_STEP_SLACK = 2.0**-15
# the example twins the `single_step` phase runs on the card, each main(argv)
TWINS = (("quickstart_torch", []), ("compressed_serving_torch", []),
         ("compressed_serving_torch", ["--paged", "--chunk", "1"]),
         ("compressed_serving_torch", ["--paged", "--spec-k", str(SPEC_K)]))


# the mesh_serve phase: the plain serve's first 4 prompts cut to MESH_PROMPT
# tokens, MESH_NEW new tokens each, on a one-rank NCCL mesh; then the
# kernels at llama2-70b's local shard shapes on a (1, 4) mesh: column-
# parallel q and gate/up (N / 4), row-parallel o and down (K / 4), at the
# decode rows and a prefill's, and attention over 64 / 4 query and 8 / 4
# KV heads
MESH_PROMPT, MESH_NEW = 256, 32
TP70 = "llama2-70b (1, 4)"
TP70_SHAPES = ((8192, 2048, "q"), (8192, 7168, "gate/up"), (2048, 8192, "o"),
               (7168, 8192, "down"))
TP70_MS = (4, 2048)
TP70_HEADS = (16, 2)
# the moe phase's mesh serve: the phase's 4 prompts cut to MOE_MESH_PROMPT
# tokens, MOE_MESH_NEW new, on a one-rank NCCL mesh; then the kernels at
# grok-1's local shard shapes on a (1, 4) mesh: q (N / 4), k / v (N / 4:
# 2 of its 8 KV heads), o (K / 4), at the decode rows and a prefill's,
# and attention over 48 / 4 query and 8 / 4 KV heads; its 8 experts split
# 2 a rank, each whole, so the expert shapes are the unsharded ones
MOE_MESH_PROMPT, MOE_MESH_NEW = 256, 32
GROK14 = "grok-1-314b (1, 4)"
GROK14_SHAPES = ((6144, 1536, "q"), (6144, 256, "k/v"), (1536, 6144, "o"))
GROK14_MS = (4, 2048)
GROK14_HEADS = (12, 2)

_LOG = []
_T0 = time.perf_counter()
CARD = "card not read"  # nvidia-smi's name and power limit, once read


def log(*parts):
    """Print a line and keep it for chiprun_out/chip_smoke.log, there
    behind the seconds since the script started (where its time goes)."""
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    _LOG.append(f"{time.perf_counter() - _T0:7.1f}  {line}")
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


def time_matmul(torch, timer, case, kern, plain, x, ct):
    """Time one matmul case in bf16: the kernel between CUDA events and
    split into device and host time, its plain version, `torch.matmul` on
    the weight decompressed beforehand (the library call) and the bound:
    the compressed planes, x and out moved once, or 2 M K N operations."""
    from repro_torch.kernels import ref

    m, (k, n) = x.shape[0], ct.shape
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
    where = f"{case['model']} " if "model" in case else ""
    log(f"{where}{case['kernel']} {case['role']:8s} M={m:5d} {case['spec']}: rel_err "
        f"{case['rel_err']:.2e} kernel {case['ms']:.4f} ms ({achieved(case, moved, flops)}; "
        f"device {fmt_ms(case['device_ms'])}, host {case['host_ms']:.4f} ms) plain "
        f"{case['plain_ms']:.4f} ms library {case['library_ms']:.4f} ms "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']})")


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
                        time_matmul(torch, timer, case, kern, plain, x, ct)
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


def _attention_inputs(torch, kind, g, hq=32, hkv=8, dh=128):
    """Decode attention (llama3-8b's heads unless given): 4 slots with
    ragged lengths up to 2048 over a 32-token-page pool quantized with
    `kind`, pages shuffled."""
    from repro_torch.kernels.ref import CACHE_EMPTY_POS
    from repro_torch.models import layers

    b, bs, mb = 4, 32, 64
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


def time_attention(torch, timer, case, args):
    """Time one decode attention case with bf16 queries over `case`'s
    pool kind: the kernel between CUDA events and split into device and
    host time, its plain version, SDPA over the K/V gathered beforehand to
    bf16 (the library call) and the bound: every page the slots walk, the
    queries, the output and the tables moved once, or 4 Hq Dh operations
    a token. `case["causal"]` False times the bidirectional walk (and SDPA
    under the sentinel mask alone). Returns the bf16 arguments."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.kernels import paged_attention, ref
    from repro_torch.models import layers

    kind, causal = case["kind"], case.get("causal", True)
    q, pools, tables, kv_lens, q_pos = args
    b, hq, dh = q.shape
    bs, hkv = pools["kp"].shape[1:3]
    qb = q.bfloat16()
    bargs = (qb,) + args[1:]
    case["ms"] = timer(lambda: paged_attention.paged_attention(*bargs, quant=kind,
                                                               causal=causal))
    case["device_ms"], case["host_ms"] = timer.split(
        lambda: paged_attention.paged_attention(*bargs, quant=kind, causal=causal))
    case["plain_ms"] = timer(lambda: ref.paged_decode_attention(*bargs, quant=kind,
                                                                causal=causal), reps=3)
    kg, vg, kpos = layers.paged_gather_kv(pools, tables, kind)
    # (B, Hq, T, Dh): each KV head serves its group of query heads
    kt = kg.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vt = vg.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    mask = kpos != ref.CACHE_EMPTY_POS
    if causal:
        mask = mask & (kpos <= q_pos[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case["library_ms"] = timer(lambda: sdpa(
        qb[:, :, None], kt, vt, attn_mask=mask[:, None, None]))
    codec = get_codec(kind) if kind != "none" else None
    w = codec.kv_code_width(dh) if codec else 2 * dh  # bytes per head vector
    per_tok = hkv * (2 * w + (4 if codec and codec.has_scale else 0)) + 4
    pages = ((kv_lens + bs - 1) // bs).sum().item()
    toks = kv_lens.sum().item()
    moved = pages * bs * per_tok + 2 * qb.numel() * 2 + 4 * tables.numel()
    flops = 4.0 * hq * dh * toks
    case["bound_ms"], case["bound_by"] = bound_ms(moved, flops)
    where = "".join(f"{case[k]} " for k in ("model", "role") if k in case)
    log(f"{where}attention {kind:5s}: rel_err {case['rel_err']:.2e} kernel {case['ms']:.4f} ms "
        f"({achieved(case, moved, flops)}; device {fmt_ms(case['device_ms'])}, host "
        f"{case['host_ms']:.4f} ms) plain {case['plain_ms']:.4f} ms sdpa "
        f"{case['library_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})")
    del kg, vg, kt, vt
    return bargs


def check_attention(torch, timer, report):
    from repro_torch.kernels import paged_attention, ref

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
                bargs = time_attention(torch, timer, case, args)
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


def check_new_shapes(torch, timer, report):
    """The kernels at the shapes this slice opened, each against its plain
    version and timed: attention at gemma2-2b's heads (G 2, Dh 256) over
    the none, int8 and nf4 pools with windows 0 and 100 and softcap 50;
    attention at G 6, 7 and 16 at Dh 128 and 256 (int8 pool); the GeMV (M
    = 4) and the GeMM (M = 2048) at (K, N) = (ODD_K, ODD_N) for every
    weight codec, dense and at half density. Every case runs before a
    failure is raised."""
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import CompressionSpec
    from repro_torch.kernels import deca_gemm, paged_attention, ref

    g = torch.Generator(device="cuda").manual_seed(21)
    cases = []
    heads = [(8, 4, 256, kind) for kind in ("none", "int8", "nf4")]
    heads += [(hkv * grp, hkv, dh, "int8") for grp, hkv in ((6, 2), (7, 2), (16, 1))
              for dh in (128, 256)]
    for hq, hkv, dh, kind in heads:
        q, pools, tables, kv_lens, q_pos = _attention_inputs(torch, kind, g, hq, hkv, dh)
        args = (q, pools, tables, kv_lens, q_pos)
        role = f"G={hq // hkv} Hkv={hkv} Dh={dh}"
        variants = ((0, 0.0), (100, 0.0), (0, 50.0), (100, 50.0)) if dh == 256 and \
            hq == 8 else ((0, 0.0), (100, 50.0))
        for window, cap in variants:
            got = paged_attention.paged_attention(*args, quant=kind, window=window, softcap=cap)
            want = ref.paged_decode_attention(*args, quant=kind, window=window, softcap=cap)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            case = {"kernel": "attention", "kind": kind, "role": role, "window": window,
                    "softcap": cap, "variant": f"window {window} softcap {cap:g}",
                    "max_abs_err": err, "rel_err": rel}
            if window == 0 and cap == 0.0:
                time_attention(torch, timer, case, args)
            cases.append(case)
        del pools, args
        torch.cuda.empty_cache()
    w = torch.randn(ODD_K, ODD_N, generator=g, device="cuda") / math.sqrt(ODD_K)
    xs = {m: torch.randn(m, ODD_K, generator=g, device="cuda").bfloat16().float()
          for m in (4, 2048)}
    for quant in CODECS:
        for dens in (1.0, 0.5):
            ct = compress(w, CompressionSpec(quant, dens))
            for m, x in xs.items():
                kind = "gemv" if m <= 32 else "gemm"
                kern = deca_gemm.decompress_gemv if kind == "gemv" else deca_gemm.decompress_gemm
                plain = ref.decompress_gemv if kind == "gemv" else ref.decompress_gemm
                got, want = kern(x, ct), plain(x, ct)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                case = {"kernel": kind, "role": f"N={ODD_N}", "K": ODD_K, "N": ODD_N, "M": m,
                        "spec": ct.spec.name, "max_abs_err": err, "rel_err": rel}
                if ct.spec.name == SERVED_SPEC:
                    time_matmul(torch, timer, case, kern, plain, x, ct)
                cases.append(case)
    worst = max(c["rel_err"] for c in cases)
    log(f"new shapes: {len(cases)} cases, max rel err {worst:.2e} (tolerance {KERNEL_TOL}): "
        + ", ".join(f"{c['kernel']} {c.get('kind', c.get('spec'))} {c['role']}"
                    f"{' ' + c['variant'] if 'variant' in c else ' M=%d' % c['M']} "
                    f"{c['rel_err']:.2e}" for c in cases))
    report["new_shape_cases"] = cases
    bad = [c for c in cases if c["rel_err"] > KERNEL_TOL]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the new shapes: "
                             f"{bad}")
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


def no_dense_lm_head(torch, cfg, params, report, key="lm_head_peak_extra_bytes"):
    """One lm_head GeMV at M = 4 never holds the dense (d_model, vocab)
    bf16 weight: its peak extra allocation stays below that size."""
    from repro_torch.kernels import ops

    x = torch.randn(4, cfg.d_model, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.decompress_gemm(x, params["lm_head"], out_dtype=torch.float32)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    dense = cfg.d_model * cfg.vocab_size * 2
    log(f"{cfg.name} lm_head GeMV peak extra allocation {extra / 1e6:.2f} MB < dense bf16 "
        f"weight {dense / 1e6:.1f} MB: {extra < dense}")
    report[key] = extra
    if extra >= dense:
        raise AssertionError("the lm_head GeMV allocated a dense weight's worth of memory")


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


def compare_paths(torch, model, params, report, key="path_comparison", steps=4,
                  routes=None):
    """Prefill and `steps` decode-step logits of the kernel path against
    the plain path on the card, on the same tokens and the same fresh
    pools; with `routes` (an active RouteLog) the plain path replays the
    expert choices the kernel path made."""
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
    no_copy = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    results, fed = {}, []
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    mark = len(routes.seen) if routes is not None else 0
    for path in ("kernel", "plain"):
        ctx = plain_kernels() if path == "plain" else contextlib.nullcontext()
        pin = (routes.replay(routes.seen[mark:]) if routes is not None and path == "plain"
               else contextlib.nullcontext())
        with ctx, pin:
            pools = model.init_paged_cache(16, bs, device="cuda")
            logits, pools = make_paged_prefill_step(model)(
                params, tokens, pos, pools, tables, slots, pos, fresh, no_copy, last)
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
    report_paths(model, results, report, key, steps)


def report_paths(model, results, report, key, steps):
    """Log and record the kernel path's logits against the plain path's,
    step by step; fail beyond LOGIT_TOL of max|plain|."""
    rows = []
    for j, (a, b) in enumerate(zip(results["kernel"], results["plain"])):
        err, rel = rel_err(a, b)
        rows.append({"step": "prefill" if j == 0 else f"decode{j}", "max_abs_err": err,
                     "rel_err": rel, "argmax_equal": bool((a.argmax(-1) == b.argmax(-1)).all())})
    agree = sum(r["argmax_equal"] for r in rows)
    worst = max(r["rel_err"] for r in rows)
    log(f"{model.cfg.name} ({model.cfg.n_layers} layers): kernel path vs plain path logits: "
        f"max rel err {worst:.3e} over prefill + {steps} decode steps (tolerance "
        f"{LOGIT_TOL}); greedy-token agreement {agree}/{len(rows)}")
    report[key] = rows
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
    against the uncaptured step from the same pools: its output (a chunk's
    tokens, a single step's logits) and every pool plane (null page
    excluded) bitwise equal, or the run fails."""
    from repro_torch.serve.graphs import replay_check

    keys = list(graphs.graphs)[:limit]
    for key in keys:
        bad = replay_check(graphs, key, eng.kv.pools)
        log(f"{what} replay, shapes {[list(s) for s in key[:3]]}: its output and every "
            f"pool plane bitwise the uncaptured run's: {not bad}")
        if bad:
            raise AssertionError(f"{what} replay differs from the uncaptured run: {bad[:8]}")
    report.setdefault("replay_checks", []).append({"what": what, "graphs": len(keys)})
    torch.cuda.empty_cache()



def profile_replays(torch, graphs, what, report, n=4, traced_n=1):
    """A captured graph alone: `n` replays of the first graph on its last
    inputs, timed between CUDA events (the wall), then `traced_n` more
    traced with torch.profiler with events around them too: the kernels'
    device time over that window's wall is the share the card computes,
    the rest the gaps between the graph's kernels. One traced replay is a
    whole chunk: reading a trace costs ~0.1 ms of host a kernel (a 70B
    chunk launches ~80000). The replays rewrite the pages of the graph's
    last chunk, which no request holds any more."""
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
        for _ in range(traced_n):
            g.graph.replay()
        b.record()
        b.synchronize()
    traced = a.elapsed_time(b) / traced_n
    rows = sorted(({"name": e.key, "device_ms": e.self_device_time_total / 1e3 / traced_n,
                    "count": e.count / traced_n} for e in prof.key_averages()
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


def gemvs_per_step(cfg) -> int:
    """GeMV launches of one decode step: one per FC matmul of each layer
    (4 attention projections, 4 in a Mamba block, 5 in an RG-LRU one, and
    3 in a gated MLP or 2 in a relu one; an MoE layer runs every expert's
    FFN on its bin once per routing slot, E x k of them; a Mamba layer has
    no FFN) and one for an untied lm_head (a tied head is a cuBLAS GEMM).
    grok-1 at 8 layers: 8 x (4 + 8 x 2 x 3) + 1 = 417; falcon-mamba-7b
    64 x 4 = 256; recurrentgemma-9b 26 x (5 + 3) + 12 x (4 + 3) = 292."""
    ffn = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    if cfg.n_experts:
        ffn *= cfg.n_experts * cfg.experts_per_token
    mixer = {"ssm": 4, "rec": 5}
    return (sum(mixer.get(k, 4) + (0 if k == "ssm" else ffn) for k in cfg.layer_kinds())
            + (0 if cfg.tie_embeddings else 1))


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import deca_decompress, deca_gemm, paged_attention

    return {"deca_gemv": deca_gemm.decompress_gemv, "deca_gemm": deca_gemm.decompress_gemm,
            "deca_paged_attention": paged_attention.paged_attention,
            "deca_decompress": deca_decompress.decompress}


def first_w_up(params):
    """Layer 0's w_up: the MLP's, or expert 0's of an MoE layer."""
    layer = params["layers"][0]
    return layer["mlp"]["w_up"] if "mlp" in layer else layer["moe"]["w_up"].pick(0)


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


def teacher_forced(torch, model, params, prompts, outs, report, key="teacher_forced",
                   pin=None):
    """Each emitted token's logit in one teacher-forced target forward over
    prompt + emitted tokens (kernel path) lies within LOGIT_TOL of the
    position's scale below the position's largest logit. `pin(i)` gives a
    context for request i's forward (an MoE config's routes replayed).
    Returns the share of positions where it is the argmax."""
    worst, exact, total = 0.0, 0, 0
    for i, (p, out) in enumerate(zip(prompts, outs)):
        seq = torch.as_tensor(list(p) + list(out[:-1]), device="cuda")
        with pin(i) if pin else contextlib.nullcontext():
            rows = model.score(params, seq)[len(p) - 1:]
        em = torch.as_tensor(out, device="cuda").long()
        picked = rows.gather(1, em[:, None])[:, 0]
        gap = (rows.max(dim=1).values - picked) / rows.abs().max()
        worst = max(worst, gap.max().item())
        exact += int((rows.argmax(dim=1) == em).sum())
        total += len(out)
        del rows
    report[key] = {"worst_gap": worst, "argmax_share": exact / total}
    log(f"teacher-forced target logits ({key}): worst gap of an emitted token below the "
        f"position's max {worst:.3e} of max|logit| (tolerance {LOGIT_TOL}); emitted "
        f"token is the argmax at {exact}/{total} positions")
    if worst > LOGIT_TOL:
        raise AssertionError(f"a token lies outside the teacher-forced logit tolerance ({key})")
    return exact / total


def step_timer(torch, eng, records):
    """Time each single step of a decode_chunk=1 engine from its decode
    call to its sampled tokens on the host (the sampler's copy ends it):
    the wall and whether the call captured the step's graph (the first:
    one uncaptured run plus the capture). Prefill's sampler calls pass."""
    sched, graphs, open_step = eng.scheduler, eng._decode_graphs.graphs, {}
    decode, sample = sched._decode, sched._sample

    def on_decode(*a):
        open_step.update(n=len(graphs), t=time.perf_counter())
        return decode(*a)

    def on_sample(*a, **kw):
        out = sample(*a, **kw)
        if open_step:
            records.append({"wall_s": time.perf_counter() - open_step.pop("t"),
                            "captured": len(graphs) > open_step.pop("n"), "steps": 1})
        return out

    sched._decode, sched._sample = on_decode, on_sample


def run_twins(torch, report):
    """Each example twin's main(argv) in this process on the card (TWINS);
    a twin that raises fails the run. Their output goes to the log."""
    import importlib.util

    rows = []
    for name, argv in TWINS:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        twin = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(twin)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            twin.main(argv)
        torch.cuda.synchronize()
        rows.append({"twin": name, "argv": argv, "s": time.perf_counter() - t0,
                     "out": out.getvalue()})
        log(f"twin {name} {' '.join(argv) or '(defaults)'} on the card, "
            f"{rows[-1]['s']:.1f} s:")
        for line in out.getvalue().splitlines():
            if line.strip():
                log(f"  | {line}")
    report["twins"] = rows
    torch.cuda.empty_cache()


def single_step(torch, model, params, prompts, plain, report):
    """The single-step loop (decode_chunk=1) on the plain serve's weights
    and traffic: 8 prompts x 64 new greedy tokens, int8 KV, 4 slots. Its
    tokens are the chunk-8 serve's token for token (the same kernels at the
    same shapes on the same pool writes; a difference is logged and held by
    the teacher-forced rule), 225 GeMV and 32 attention launches a step and
    no decompression, exactly one captured graph (the (M, 1) step) whose
    replay is the uncaptured step bitwise, one host sync a step beside the
    prefill calls. Prints the replayed step's wall and the decode wall a
    token beside the chunk-8 serve's; then runs the example twins."""
    from repro_torch.serve.engine import GenerationEngine

    t_phase = time.perf_counter()
    cfg = model.cfg
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=1)
    sched = eng.scheduler
    steps = []
    step_timer(torch, eng, steps)
    rids = [eng.submit(p, max_new_tokens=64) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    st = sched.stats()
    n, n_tok = st["decode_steps"], sum(len(done[r]) for r in rids)
    decode_s = sum(c["wall_s"] for c in steps)
    later = [c["wall_s"] for c in steps if not c["captured"]]
    replay_ms = 1e3 * sum(later) / max(1, len(later))
    serve = report["serve"]
    chunk_tok_ms = 1e3 * serve["decode_s"] / serve["stats"]["active_slot_steps"]
    single_tok_ms = 1e3 * decode_s / st["active_slot_steps"]
    log(f"single_step: served {len(rids)} requests x 64 new tokens at decode_chunk=1: "
        f"{n_tok} tokens in {wall:.2f} s; {st['prefill_calls']} prefill calls, {n} decode "
        f"steps, {st['host_syncs']} host syncs")
    log(f"  replayed single step {replay_ms:.3f} ms (mean of {len(later)}; from the decode "
        f"call to its tokens on the host), against the chunk-8 serve's "
        f"{serve['replayed_ms_per_device_step']:.3f} ms a replayed device step: "
        f"{replay_ms / serve['replayed_ms_per_device_step']:.3f}x; a decode step over the "
        f"serve {1e3 * decode_s / n:.3f} ms (its capture included) against "
        f"{serve['decode_ms_per_step']:.3f} ms")
    log(f"  decode wall a token over the whole serve {single_tok_ms:.3f} ms at chunk 1, "
        f"{chunk_tok_ms:.3f} ms at chunk 8: {single_tok_ms / chunk_tok_ms:.3f}x")
    per_step = {k: launches[k] / max(n, 1) for k in launches}
    log(f"  launches {launches}: a decode step {per_step['deca_gemv']:.1f} GeMV, "
        f"{per_step['deca_paged_attention']:.1f} attention (chunk-8 serve: "
        f"{gemvs_per_step(cfg)}, {cfg.n_layers}); {launches['deca_gemm']} GeMM over "
        f"{st['prefill_calls']} prefill calls")
    if (launches["deca_gemv"] != gemvs_per_step(cfg) * n
            or launches["deca_paged_attention"] != cfg.n_layers * n
            or launches["deca_gemm"] != gemvs_per_step(cfg) * st["prefill_calls"]
            or launches["deca_decompress"]):
        raise AssertionError(f"single steps launched other kernels than a chunk's step: "
                             f"{launches} over {n} steps")
    if st["host_syncs"] != st["prefill_calls"] + n or st["decode_chunks"] != n:
        raise AssertionError(f"not one host sync a single step: {st}")
    graphs = eng._decode_graphs.graphs
    if len(graphs) != 1 or eng._chunk_graphs.graphs:
        raise AssertionError(f"{len(graphs)} single-step graphs captured, "
                             f"{len(eng._chunk_graphs.graphs)} chunk graphs")
    costs = graph_costs(eng._decode_graphs, steps, "single step")
    check_replays(torch, eng, eng._decode_graphs, "single decode step", report)
    profile_replays(torch, eng._decode_graphs, "single decode step", report)
    outs = [done[r] for r in rids]
    if any(len(o) != 64 for o in outs):
        raise AssertionError("a request did not emit its 64 tokens")
    apart = []  # (request, its first output index that differs)
    for i, (a, b) in enumerate(zip(outs, plain["outs"])):
        a, b = [int(t) for t in a], [int(t) for t in b]
        if a != b:
            apart.append((i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)))
    log(f"  tokens equal to the chunk-8 serve's: {len(outs) - len(apart)}/{len(outs)} "
        f"requests" + (f"; first differing output index of each other one "
                       f"(request, step): {apart}" if apart else ""))
    if apart:
        teacher_forced(torch, model, params, [prompts[i] for i, _ in apart],
                       [outs[i] for i, _ in apart], report, key="single_step_teacher_forced")
    del eng, sched, done
    torch.cuda.empty_cache()
    run_twins(torch, report)
    seconds = time.perf_counter() - t_phase
    log(f"single_step: {seconds:.1f} s")
    report["single_step"] = {
        "wall_s": wall, "tokens": n_tok, "stats": st, "launches": launches,
        "steps": steps, "replayed_ms_per_step": replay_ms, "decode_s": decode_s,
        "decode_ms_per_token": single_tok_ms, "chunk8_decode_ms_per_token": chunk_tok_ms,
        "graphs": costs, "differing": apart, "seconds": seconds}


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
    # an expert-stacked leaf decompresses one expert a launch
    n_ct = sum((x.lead[0] if x.lead else 1) for x in _leaves(params)
               if isinstance(x, CompressedTensor))
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
    check_draft_leaf(torch, first_w_up(params), first_w_up(eng.draft_params),
                     get_spec(DRAFT_CODEC))

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
    return eng, launches, outs


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


_PREFILL_SHAPES = set()  # (rows, span, table width) met by serve_waves


def serve_waves(torch, eng, waves, new):
    """Serve `waves` of prompts through `eng`, each wave submitted at once
    and drained before the next. Returns the tokens in submission order and
    what the run cost: its wall, each prefill call's wall, shape, clones
    and GeMV launches (a call whose shape this process had not met pays
    the first-call costs of its shape), each request's time from submit to
    its first token, each decode chunk's wall and the launches of the
    whole run, with every count set to 0 before it."""
    sched = eng.scheduler
    prefills, chunks, first, submitted = [], [], {}, {}
    inner_prefill, inner_rows = sched._prefill, sched._prefill_rows
    gemv = counters()["deca_gemv"]

    def prefill(*a):
        shape = (a[0].shape[0], a[0].shape[1], a[2].shape[1])
        n0 = gemv.launches
        t = time.perf_counter()
        out = inner_prefill(*a)
        torch.cuda.synchronize()
        prefills.append({"wall_s": time.perf_counter() - t, "rows": shape[0],
                         "span": shape[1], "table": shape[2],
                         "copies": int((a[6][:, 1] != 0).sum()),
                         "gemv_launches": gemv.launches - n0,
                         "new_shape": shape not in _PREFILL_SHAPES})
        _PREFILL_SHAPES.add(shape)
        return out

    def rows(rows_, **kw):
        inner_rows(rows_, **kw)  # ends in the host copy of the sampled tokens
        now = time.perf_counter()
        for _, r, _, _ in rows_:
            if r.out and r.rid not in first:
                first[r.rid] = now

    inner_chunk = sched._decode_chunk
    sched._prefill, sched._prefill_rows = prefill, rows
    sched._decode_chunk = chunk_timer(torch, eng._chunk_graphs, inner_chunk, chunks)
    gc.collect()  # a dead engine (its graphs hold it in a cycle) would count in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    outs, rids_all = [], []
    t0 = time.perf_counter()
    try:
        for wave in waves:
            rids = []
            for p in wave:
                rids.append(eng.submit(p, max_new_tokens=new))
                submitted[rids[-1]] = time.perf_counter()
            done = eng.run_until_drained()
            outs += [done[r] for r in rids]
            rids_all += rids
        torch.cuda.synchronize()
    finally:  # a later call on the engine records into its own lists only
        sched._prefill, sched._prefill_rows = inner_prefill, inner_rows
        sched._decode_chunk = inner_chunk
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    ttft = [first[r] - submitted[r] for r in rids_all]
    return outs, {"wall_s": wall, "tokens": sum(map(len, outs)), "prefills": prefills,
                  "ttft_s": ttft, "chunks": chunks, "launches": launches,
                  "peak_bytes": torch.cuda.max_memory_allocated(),
                  "graphs": len(eng._chunk_graphs.graphs), "stats": sched.stats()}


def pool_pages(torch, pools, pages):
    """Every plane of allocator pages `pages` (device pages + 1), per layer."""
    idx = torch.as_tensor([p + 1 for p in pages], device="cuda")
    return [{n: t[idx].clone() for n, t in layer.items()} for layer in pools]


def prefix_serve(torch, model, params, report, new=64):
    """The multi-tenant prefix cache at full width. Two seeded system
    prompts, A (1000 tokens, not page-aligned) and B (512 tokens, 16 whole
    pages); A with a tail and B alone are served and drained, then six
    more are submitted at once: A and B with seeded tails of 1-256 tokens,
    and B verbatim, whose cached pages cover the whole prompt (its last
    token is recomputed into a copy-on-write clone). A fresh engine with
    the cache off serves the same waves. Every token of both serves is
    held against teacher-forced logits; every plane of every page the
    index held after the first wave must be bitwise unchanged after the
    second; the drained pool holds only the index's pages."""
    from repro_torch.serve.engine import GenerationEngine

    v = model.cfg.vocab_size
    g = torch.Generator().manual_seed(7)
    sys_a = torch.randint(0, v, (1000,), generator=g)
    sys_b = torch.randint(0, v, (512,), generator=g)
    tails = [torch.randint(0, v, (int(n),), generator=g)
             for n in torch.randint(1, 257, (6,), generator=g)]
    cat = lambda *t: torch.cat(t).numpy()
    waves = [[cat(sys_a, tails[0]), sys_b.numpy()],
             [cat(sys_a, tails[1]), cat(sys_b, tails[2]), cat(sys_a, tails[3]),
              cat(sys_b, tails[4]), cat(sys_a, tails[5]), sys_b.numpy()]]
    prompts = waves[0] + waves[1]
    res, outs = {}, {}
    for name, on in (("prefix", True), ("baseline", False)):
        eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                               max_len=2048, decode_chunk=8, prefix_cache=on)
        got, first = serve_waves(torch, eng, waves[:1], new)
        cached = eng.kv.prefix.page_multiset() if on else []
        before = pool_pages(torch, eng.kv.pools, cached) if on else None
        rest, second = serve_waves(torch, eng, waves[1:], new)
        outs[name] = got + rest
        st, occ = second["stats"], eng.kv.occupancy()
        run = {"waves": [first, second], "occupancy": occ}
        if on:
            kept = set(eng.kv.prefix.page_multiset())
            if not set(cached) <= kept:
                raise AssertionError("pages cached after the first wave left the index")
            after = pool_pages(torch, eng.kv.pools, cached)
            bad = [(i, n) for i, (a, b) in enumerate(zip(before, after))
                   for n in a if not torch.equal(a[n], b[n])]
            run["cached_after_first_wave"] = len(cached)
            log(f"prefix_serve: {len(cached)} pages the index held after the first wave "
                f"(A, A's tail, B): every plane of every layer bitwise unchanged across "
                f"the second wave: {not bad}")
            if bad:
                raise AssertionError(f"shared pages changed under the second wave: {bad[:8]}")
            if not (st["prefix_hit_tokens"] > 0 and st["cow_copies"] >= 1):
                raise AssertionError(f"the prefix serve shared nothing: {st}")
            if occ["used"] != occ["cached"]:
                raise AssertionError(f"drained pool: used {occ['used']} != cached "
                                     f"{occ['cached']}")
        for w in (first, second):
            idle = [k for k, n in w["launches"].items() if n == 0 and k != "deca_decompress"]
            if idle:
                raise AssertionError(f"kernels never launched on the prefix path: {idle}")
        if len(eng._chunk_graphs.graphs) > 4:
            raise AssertionError("more than four decode graphs")
        teacher_forced(torch, eng.model, params, prompts, outs[name], report,
                       key=f"teacher_forced_{name}")
        n_tok = first["tokens"] + second["tokens"]
        wall = first["wall_s"] + second["wall_s"]
        pf = first["prefills"] + second["prefills"]
        log(f"prefix_serve {name}: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} "
            f"tok/s; peak device memory {max(first['peak_bytes'], second['peak_bytes']) / 1e9:.2f}"
            f" GB; prefix_hit_tokens {st['prefix_hit_tokens']}, cow_copies "
            f"{st['cow_copies']}, prefix_cached_pages {st['prefix_cached_pages']}; "
            f"occupancy {occ}; {len(eng._chunk_graphs.graphs)} decode graphs")
        log(f"  prefill calls (rows x span, table, clones, GeMV launches, wall; * = first of "
            f"its shape): " + "; ".join(
                f"{c['rows']}x{c['span']} t{c['table']} c{c['copies']} g{c['gemv_launches']} "
                f"{1e3 * c['wall_s']:.1f} ms{'*' if c['new_shape'] else ''}" for c in pf))
        log(f"  submit to first token: wave 1 (cold) "
            f"{', '.join(f'{1e3 * t:.1f}' for t in first['ttft_s'])} ms; wave 2 "
            f"({'hits' if on else 'cold'}) {', '.join(f'{1e3 * t:.1f}' for t in second['ttft_s'])}"
            f" ms; launches wave 1 {first['launches']}, wave 2 {second['launches']}")
        res[name] = run
        del eng
        torch.cuda.empty_cache()
    same = sum(list(a) == list(b) for a, b in zip(outs["prefix"], outs["baseline"]))
    log(f"prefix_serve: prefix-on tokens equal the prefix-off tokens on {same}/{len(prompts)} "
        "requests (both held against teacher-forced logits above)")
    report["prefix_serve"] = {"prompt_lens": [len(p) for p in prompts], "same": same, **res}


def arrival_inputs(torch, model):
    """chunked_prefill's traffic: three resident prompts of 64-256 tokens
    and a 1536-token prompt that arrives while they decode."""
    v = model.cfg.vocab_size
    g = torch.Generator().manual_seed(8)
    residents = [torch.randint(0, v, (int(n),), generator=g).numpy()
                 for n in torch.randint(64, 257, (3,), generator=g)]
    long = torch.randint(0, v, (1536,), generator=g).numpy()
    return residents, long


def arrival(torch, model, params, residents, long, **engine_kw):
    """One arrival run: the residents (192 new tokens each) decode; after
    their second decode chunk the long prompt (64 new tokens) arrives. The
    wall gap between consecutive decode chunks of the residents, each
    prefill call's wall and shape, the long request's time to its first
    token, the launches of the run (counts set to 0 before it) and the
    decode graphs captured before the arrival, at its first token and at
    the end. Returns (run, outs, engine)."""
    from repro_torch.serve.engine import GenerationEngine

    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8, **engine_kw)
    sched = eng.scheduler
    ends, prefills = [], []
    inner_chunk, inner_prefill = sched._decode_chunk, sched._prefill

    def decode(*a):
        out = inner_chunk(*a)
        torch.cuda.synchronize()
        ends.append((time.perf_counter(), bool(a[11][:3].all())))
        return out

    def prefill(*a):
        t = time.perf_counter()
        out = inner_prefill(*a)
        torch.cuda.synchronize()
        prefills.append({"wall_s": time.perf_counter() - t, "rows": a[0].shape[0],
                         "span": a[0].shape[1], "table": a[2].shape[1]})
        return out

    sched._decode_chunk, sched._prefill = decode, prefill
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=192) for p in residents]
    while sched.stats()["decode_chunks"] < 2:
        sched.step()
    graphs = len(eng._chunk_graphs.graphs)
    t_arrive = time.perf_counter()
    rids.append(eng.submit(long, max_new_tokens=64))
    req = sched.queue[-1]
    while not req.out:
        sched.step()
    ttft = time.perf_counter() - t_arrive
    graphs_at_first = len(eng._chunk_graphs.graphs)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    outs = [done[r] for r in rids]
    st = sched.stats()
    live = [t for t, residents_on in ends if residents_on]
    gaps = [b - a for a, b in zip(live, live[1:])]
    run = {"wall_s": wall, "ttft_s": ttft, "worst_gap_s": max(gaps),
           "median_gap_s": sorted(gaps)[len(gaps) // 2], "gaps_s": gaps,
           "prefills": prefills, "launches": launches, "stats": st,
           "graphs_before": graphs, "graphs_at_first_token": graphs_at_first,
           "graphs": len(eng._chunk_graphs.graphs), "tokens": sum(map(len, outs))}
    idle = [k for k, n in launches.items() if n == 0 and k != "deca_decompress"]
    if idle:
        raise AssertionError(f"kernels never launched on the arrival path: {idle}")
    if run["graphs"] > 4:
        raise AssertionError("more than four decode graphs")
    return run, outs, eng


def chunked_prefill(torch, model, params, report, chunk=256):
    """Chunked prefill at full width: three requests (prompts of 64-256
    tokens, 192 new tokens) decode; after their second decode chunk a
    1536-token prompt (64 new tokens) arrives. Run with the prompt
    prefilled whole and in chunks of `chunk` tokens: the largest wall gap
    between two consecutive decode chunks of the residents (the worst
    inter-token time), each prefill call's wall and the long request's
    time to its first token. Every token of both runs is held against
    teacher-forced logits, and the chunked run captures no decode graph
    while the long prompt prefills."""
    residents, long = arrival_inputs(torch, model)
    res = {}
    for name, pc in (("whole", None), ("chunked", chunk)):
        run, outs, eng = arrival(torch, model, params, residents, long, prefill_chunk=pc)
        st, gaps = run["stats"], run["gaps_s"]
        calls = ", ".join(f"{c['rows']}x{c['span']} {1e3 * c['wall_s']:.1f} ms"
                          for c in run["prefills"])
        log(f"chunked_prefill {name} (prefill_chunk={pc}): long request's first token "
            f"{1e3 * run['ttft_s']:.1f} ms after it arrived; worst gap between two decode "
            f"chunks of the residents {1e3 * max(gaps):.1f} ms (median "
            f"{1e3 * run['median_gap_s']:.1f}); prefill_chunk_calls "
            f"{st['prefill_chunk_calls']}; prefill calls (rows x span) {calls}; "
            f"decode graphs {run['graphs_before']} before the arrival, "
            f"{run['graphs_at_first_token']} at its first token, {run['graphs']} at the end; "
            f"{run['tokens']} tokens in {run['wall_s']:.2f} s; launches {run['launches']}")
        if pc is not None:
            if st["prefill_chunk_calls"] == 0:
                raise AssertionError("no chunked prefill launch")
            if run["graphs_at_first_token"] != run["graphs_before"]:
                raise AssertionError("a decode graph was captured while the long prompt "
                                     "prefilled in chunks")
        teacher_forced(torch, eng.model, params, residents + [long], outs, report,
                       key=f"teacher_forced_{name}_prefill")
        res[name] = run
        del eng
        torch.cuda.empty_cache()
    report["chunked_prefill"] = {"chunk": chunk, **res}


#: Calibrated RoofLens scale (measured wall / raw roofline time) expected
#: per regime: the raw H100 predictions of the plain serve's traffic
#: against the walls PERF.md records (PR 17 call 3, PR 18 call 1)
EXPECTED_SCALE = {"decode": (7.0, 9.0), "prefill": (14.0, 18.0), "prefill_chunk": (19.0, 28.0)}
#: observed_serve's chunked-prefill budget: a prefill launch may stall the
#: residents' token stream by three quarters of a replayed decode chunk
PREFILL_SLA_S = 0.075


def serve_traffic(torch, eng, prompts):
    """The plain serve's traffic through `eng`: `prompts` x 64 new tokens,
    submitted at once and drained. Tokens, wall, launches (counts set to 0
    before the drain), host syncs, and replayed decode ms a device step
    (each chunk timed by `chunk_timer`, as in the plain serve)."""
    sched = eng.scheduler
    chunks, inner = [], sched._decode_chunk
    sched._decode_chunk = chunk_timer(torch, eng._chunk_graphs, inner, chunks)
    syncs0 = sched.stats()["host_syncs"]
    rids = [eng.submit(p, max_new_tokens=64) for p in prompts]
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched._decode_chunk = inner
    later = [c for c in chunks if not c["captured"]]
    return [done[r] for r in rids], {
        "wall_s": wall, "launches": {k: fn.launches for k, fn in counters().items()},
        "host_syncs": sched.stats()["host_syncs"] - syncs0,
        "replayed_ms_per_device_step": 1e3 * sum(c["wall_s"] for c in later)
        / max(1, sum(c["steps"] for c in later)), "chunks": chunks}


def capture_checked_clock(torch):
    """The observability clock, refusing to be read inside a graph capture."""
    def clock():
        if torch.cuda.is_current_stream_capturing():
            raise AssertionError("an observability site ran inside a CUDA graph capture")
        return time.perf_counter()
    return clock


def lens_report(lens, what, scale=None) -> dict:
    """Log RoofLens's error report (measured over predicted, current scales)
    for every regime and codec key, and the fitted scales; check that
    every sample is finite and positive."""
    bad = [s for s in lens.samples
           if not (math.isfinite(s.raw_pred_s) and s.raw_pred_s > 0
                   and math.isfinite(s.measured_s) and s.measured_s > 0)]
    if bad:
        raise AssertionError(f"RoofLens samples not finite and positive: {bad[:4]}")
    rep = lens.error_report()
    for key, r in rep.items():
        log(f"  rooflens {what} {key}: n {r['n']}, measured/predicted geomean "
            f"{r['geomean_ratio']:.3f}, p50 {r['p50_ratio']:.3f}, p90 {r['p90_ratio']:.3f}, "
            f"worst |log2| {r['max_abs_log2']:.3f}")
    if scale is not None:
        def one(k, v):
            if k not in EXPECTED_SCALE:
                return f"{k} {v:.2f}"
            lo, hi = EXPECTED_SCALE[k]
            return f"{k} {v:.2f} (expected {lo:g}-{hi:g}{'' if lo <= v <= hi else ', outside'})"

        log(f"  rooflens {what} fitted scale (measured / raw roofline, median): "
            + ", ".join(one(k, v) for k, v in sorted(scale.items())))
    return {"error_report": rep, "scale": scale}


def observed_serve(torch, model, params, prompts, plain, spec_outs, report):
    """The serving path with `Observability.default()` installed.

    (a) the plain serve's traffic on a fresh engine: tokens, host syncs and
    every kernel's launches must equal the plain serve's; replayed decode
    ms a step beside the plain serve's; the host cost of the decode site.
    (b) RoofLens warm-then-measure: calibrate on (a), serve again on the
    same engine, report the error per regime and codec and the scales.
    (c) the tracer's TTFT / ITL percentiles; Chrome traces to chiprun_out/.
    (a') a control serve of the same traffic without observability on a
    fresh engine, so the decode walls with and without it alternate.
    (d) a spec serve with observability: draft and verify samples.
    (e) chunked_prefill's arrival with prefill_chunk=256 and the budget
    PREFILL_SLA_S, on a lens calibrated by a warm run: each launch's span,
    the worst and median gap between the residents' decode chunks, the
    long request's first token. Every token is held against the plain
    serve's or teacher-forced logits. The observability clock raises if it
    is read inside a graph capture."""
    from repro_torch.core import roofsurface as rs
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import GenerationEngine, SpecConfig

    res = {}
    obs = Observability.default(clock=capture_checked_clock(torch))
    lens = obs.rooflens
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8, obs=obs)
    sched = eng.scheduler
    log(f"observed_serve: RoofLens on {lens.profile.name} (mbw {lens.profile.mbw:.3g} B/s, "
        f"peak {lens.profile.peak_flops:.3g} FLOP/s, vos {lens.profile.vos:.4g} op/s) bound to "
        f"{lens.weight_bytes / 1e9:.3f} GB of weights, {lens.weight_elems:.4g} dense elements "
        f"({lens.codec_key}), {lens.m_slots} slots; raw predictions: decode step at kv "
        f"600-900 {1e3 * lens._raw_decode([600.0, 700.0, 800.0, 900.0], 1):.3f} ms, prefill "
        f"4 x 512 {1e3 * lens._raw_prefill(4, 512):.3f} ms, prefill chunk 1 x 256 at table "
        f"1536 {1e3 * lens._raw_prefill_chunk(1, 256, 1536):.3f} ms")
    site_s = []
    inner_observe = sched._observe_decode

    def observe(*a):
        t = time.perf_counter()
        inner_observe(*a)
        site_s.append(time.perf_counter() - t)

    sched._observe_decode = observe

    # (a) the plain serve's traffic, observed
    outs, first = serve_traffic(torch, eng, prompts)
    same = sum(list(a) == list(b) for a, b in zip(outs, plain["outs"]))
    site_us = 1e6 * sum(site_s) / max(1, len(site_s))
    log(f"observed_serve (a): {sum(map(len, outs))} tokens in {first['wall_s']:.2f} s; tokens "
        f"equal to the plain serve's on {same}/{len(outs)} requests; host_syncs "
        f"{first['host_syncs']} (plain {plain['host_syncs']}, registry "
        f"{obs.metrics.counter('serve.host_syncs', unit='calls').value}); launches "
        f"{first['launches']} (plain {plain['launches']}); replayed decode "
        f"{first['replayed_ms_per_device_step']:.2f} ms a step (plain "
        f"{plain['replayed_ms_per_device_step']:.2f}); decode site "
        f"{site_us:.1f} us of host time a chunk over {len(site_s)} chunks")
    if same != len(outs):
        raise AssertionError("observed tokens differ from the plain serve's")
    if first["host_syncs"] != plain["host_syncs"] or obs.metrics.counter(
            "serve.host_syncs", unit="calls").value != plain["host_syncs"]:
        raise AssertionError("observability changed the host syncs")
    if first["launches"] != plain["launches"]:
        raise AssertionError("observability changed the kernels' launch counts")
    summary1 = obs.tracer.summary()
    obs.tracer.export_chrome_trace(str(OUT / "obs_trace_first.json"))

    # (b) RoofLens, warm-then-measure
    scale1 = lens.calibrate()
    cold = lens_report(lens, "first serve (graph captures included)", scale1)
    lens.reset_samples()
    obs.tracer.reset()
    site_s.clear()
    outs2, second = serve_traffic(torch, eng, prompts)
    same2 = sum(list(a) == list(b) for a, b in zip(outs2, outs))
    log(f"observed_serve (b): warm serve on the same engine, {second['wall_s']:.2f} s, "
        f"replayed decode {second['replayed_ms_per_device_step']:.2f} ms a step, tokens "
        f"equal to (a)'s on {same2}/{len(outs)} requests; error against the first serve's "
        f"scales:")
    if same2 != len(outs):
        teacher_forced(torch, eng.model, params, prompts, outs2, report,
                       key="teacher_forced_observed_warm")
    warm = lens_report(lens, "warm serve, first serve's scales")
    scale2 = lens.calibrate()
    warm["scale"] = scale2
    lens_report(lens, "warm serve, refitted", scale2)
    for regime in ("prefill", "decode"):
        if regime not in scale2:
            raise AssertionError(f"no RoofLens samples of regime {regime}")

    # (c) the tracer
    summary2 = obs.tracer.summary()
    obs.tracer.export_chrome_trace(str(OUT / "obs_trace.json"))
    for name, sm in (("first serve", summary1), ("warm serve", summary2)):
        t, i = sm["ttft_s"], sm["itl_s"]
        log(f"observed_serve (c) tracer, {name}: {sm['n_requests']} requests, "
            f"{sm['n_tokens']} tokens; TTFT p50 {1e3 * t['p50']:.1f} ms, p90 "
            f"{1e3 * t['p90']:.1f}, p99 {1e3 * t['p99']:.1f}, mean {1e3 * t['mean']:.1f}; ITL "
            f"p50 {1e3 * i['p50']:.2f} ms, p90 {1e3 * i['p90']:.2f}, p99 {1e3 * i['p99']:.2f}, "
            f"mean {1e3 * i['mean']:.2f} (chunked decode: the tokens of a chunk land together)")
    log(f"  Chrome traces: chiprun_out/obs_trace_first.json, chiprun_out/obs_trace.json "
        f"({len(obs.tracer.spans)} scheduler spans in the warm serve)")
    del eng, sched
    torch.cuda.empty_cache()

    # (a') control: the same traffic on a fresh engine without observability,
    # so that the decode walls with and without it alternate in this run
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8)
    outs3, control = serve_traffic(torch, eng, prompts)
    same3 = sum(list(a) == list(b) for a, b in zip(outs3, plain["outs"]))
    log(f"observed_serve (a') control without observability on a fresh engine: replayed "
        f"decode {control['replayed_ms_per_device_step']:.2f} ms a step; in turns: plain "
        f"{plain['replayed_ms_per_device_step']:.2f}, observed "
        f"{first['replayed_ms_per_device_step']:.2f}, observed warm "
        f"{second['replayed_ms_per_device_step']:.2f}, plain again "
        f"{control['replayed_ms_per_device_step']:.2f} (the chunk walls exclude the sites, "
        f"which run after the token copy); tokens equal to the plain serve's on "
        f"{same3}/{len(outs3)}")
    if same3 != len(outs3):
        raise AssertionError("the control serve's tokens differ from the plain serve's")
    res["plain"] = {"first": {k: v for k, v in first.items() if k != "chunks"},
                    "warm": {k: v for k, v in second.items() if k != "chunks"},
                    "control": {k: v for k, v in control.items() if k != "chunks"},
                    "decode_site_us_per_chunk": site_us, "cold": cold, "warm_lens": warm,
                    "tracer_first": summary1, "tracer_warm": summary2}
    del eng
    torch.cuda.empty_cache()

    # (d) spec regimes
    obs_d = Observability.default(clock=capture_checked_clock(torch))
    for fn in counters().values():
        fn.launches = 0
    spec_eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                                max_len=2048, decode_chunk=8, obs=obs_d,
                                spec_decode=SpecConfig(k=SPEC_K, draft_codec=DRAFT_CODEC))
    rids = [spec_eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts[:4]]
    done = spec_eng.run_until_drained()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    souts = [done[r] for r in rids]
    same = sum(list(a) == list(b) for a, b in zip(souts, spec_outs))
    lens_d = obs_d.rooflens
    kv, rounds = [600.0, 700.0, 800.0, 900.0], spec_eng.spec_rounds
    log(f"observed_serve (d): spec serve (k={SPEC_K}, {DRAFT_CODEC} draft, draft tree "
        f"{lens_d.draft_weight_bytes / 1e9:.3f} GB) with observability: tokens equal to the "
        f"spec serve's on {same}/{len(souts)} requests; launches {launches}; raw predictions "
        f"of a launch of {rounds} rounds at kv 600-900: draft "
        f"{1e3 * lens_d._raw_draft(kv, SPEC_K, rounds):.3f} ms, verify "
        f"{1e3 * lens_d._raw_verify(kv, SPEC_K, rounds):.3f} ms")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the observed spec path: {idle}")
    teacher_forced(torch, spec_eng.model, params, prompts[:4], souts, report,
                   key="teacher_forced_observed_spec")
    scale_d = lens_d.calibrate()
    spec_rep = lens_report(lens_d, "spec serve", scale_d)
    for regime in ("draft", "verify"):
        if regime not in scale_d:
            raise AssertionError(f"no RoofLens samples of regime {regime}")
    res["spec"] = {"same_as_spec_serve": same, "launches": launches, **spec_rep}
    del spec_eng
    torch.cuda.empty_cache()

    # (e) SLA-sized chunked prefill on a lens calibrated by a warm run
    residents, long = arrival_inputs(torch, model)
    obs_e = Observability.default(clock=capture_checked_clock(torch))
    warm_run, _, eng = arrival(torch, model, params, residents, long, prefill_chunk=256,
                               obs=obs_e)
    del eng
    lens_e = obs_e.rooflens
    scale_e = lens_e.calibrate()
    warm_rep = lens_report(lens_e, "arrival warm run (prefill_chunk=256)", scale_e)
    if "prefill_chunk" not in scale_e:
        raise AssertionError("no RoofLens samples of regime prefill_chunk")
    ladder = {n: 1e3 * lens_e.predict_prefill_chunk(1, n, 1536) for n in (32, 64, 128, 256)}
    log(f"observed_serve (e): prefill_sla_s {PREFILL_SLA_S} s; calibrated predictions of a "
        f"1-row chunk at table 1536: " + ", ".join(f"{n} tokens {ms:.1f} ms"
                                                  for n, ms in ladder.items()))
    lens_e.reset_samples()
    obs_e.tracer.reset()
    torch.cuda.empty_cache()
    run, outs, eng = arrival(torch, model, params, residents, long, prefill_chunk=256,
                             obs=obs_e, prefill_sla_s=PREFILL_SLA_S)
    spans = [(s.args["batch_rows"], s.args["span"], s.t1 - s.t0)
             for s in obs_e.tracer.spans if s.name == "prefill"]
    ref = report["chunked_prefill"]["chunked"]
    log(f"observed_serve (e) SLA run: prefill launches (rows x span, wall) " + ", ".join(
        f"{b}x{sp} {1e3 * w:.1f} ms" for b, sp, w in spans))
    log(f"  long request's first token {1e3 * run['ttft_s']:.1f} ms after it arrived (fixed "
        f"256-token chunks: {1e3 * ref['ttft_s']:.1f}); worst gap between the residents' "
        f"decode chunks {1e3 * run['worst_gap_s']:.1f} ms (256: {1e3 * ref['worst_gap_s']:.1f}),"
        f" median {1e3 * run['median_gap_s']:.1f} (256: {1e3 * ref['median_gap_s']:.1f}); "
        f"prefill_chunk_calls {run['stats']['prefill_chunk_calls']}; launches "
        f"{run['launches']}; decode graphs {run['graphs_before']} before the arrival, "
        f"{run['graphs_at_first_token']} at its first token")
    if run["graphs_at_first_token"] != run["graphs_before"]:
        raise AssertionError("a decode graph was captured while the long prompt prefilled")
    if any(sp > 256 for _, sp, _ in spans):
        raise AssertionError("a chunked-prefill launch exceeded prefill_chunk")
    sla_rep = lens_report(lens_e, "SLA run, warm run's scales")
    teacher_forced(torch, eng.model, params, residents + [long], outs, report,
                   key="teacher_forced_sla_prefill")
    res["sla"] = {"prefill_sla_s": PREFILL_SLA_S, "warm_run": warm_run, "warm_lens": warm_rep,
                  "ladder_ms": ladder, "run": run, "spans": spans, "sla_lens": sla_rep}
    del eng
    torch.cuda.empty_cache()
    report["observed_serve"] = res


# ---------------------------------------------------------------------------
# overload_serve: SLO gates, the degradation ladder, park/resume, chaos and
# the host KV tier at full width
# ---------------------------------------------------------------------------

def ladder_traffic(torch, vocab):
    """(a)'s traffic, seeded: wave 0 (two tenants behind a 512-token system
    prompt), four residents of 384-512 tokens (16 new tokens for the first,
    64 for the others, so a slot frees while three still decode), two
    1024-token arrivals and, last, a tenant behind the system prompt
    again."""
    g = torch.Generator().manual_seed(9)
    rand = lambda n: torch.randint(0, vocab, (int(n),), generator=g)
    system = rand(512)
    wave0 = [torch.cat([system, rand(n)]).numpy() for n in (40, 70)]
    residents = [rand(n).numpy() for n in torch.randint(384, 513, (4,), generator=g)]
    arrivals = [rand(1024).numpy() for _ in range(2)]
    wave2 = torch.cat([system, rand(100)]).numpy()
    return wave0, residents, [16, 64, 64, 64], arrivals, wave2


def ladder_pages(residents, new, block=32, arrival=(1024, 64)) -> int:
    """The pool of (a): the arrival is blocked while the three long
    residents hold their pages (P < need + their pages) and fits once the
    youngest has parked (P >= need + the other two's): every rung must
    apply before it is admitted."""
    foot = [math.ceil((len(p) + n - 1) / block) for p, n in zip(residents, new)]
    need = math.ceil((arrival[0] + arrival[1] - 1) / block)
    return need + foot[1] + foot[2] + foot[3] // 2


class Recorder:
    """Wraps a scheduler's device steps and the host tier's functions and
    records, round by round, what the overload phase prints."""

    def __init__(self, torch, eng, graphs=True):
        from repro_torch.serve import paged_cache

        self.torch, self.eng, self.sched = torch, eng, eng.scheduler
        self.rungs, self.prefills, self.decodes, self.tier = [], [], [], {}
        sched = self.sched
        inner_degrade, inner_prefill, inner_rows = (sched._degrade, sched._prefill,
                                                    sched._prefill_rows)
        inner_chunk, inner_spec = sched._decode_chunk, sched._spec

        def degrade():
            lvl, n = sched.degradation_level, sched._stats["degradations"]
            inner_degrade()
            self.rungs.append({"round": sched._round, "from": lvl,
                               "to": sched.degradation_level,
                               "applied": sched._stats["degradations"] > n})

        def prefill(*a):
            t = time.perf_counter()
            out = inner_prefill(*a)
            torch.cuda.synchronize()
            self.prefills.append({"round": sched._round, "rows": a[0].shape[0],
                                  "span": a[0].shape[1], "wall_s": time.perf_counter() - t,
                                  "shrunk": sched._span_shrunk, "resumed": self._resumed,
                                  "rows_rids": self._rids})
            return out

        def rows(rows_, **kw):
            # the requests of this launch that are re-prefilling after a park
            self._resumed = [(r.rid, start, n) for _, r, start, n in rows_ if r.parks]
            self._rids = [r.rid for _, r, _, _ in rows_]
            inner_rows(rows_, **kw)

        def timed_decode(fn, graphs_, kind):
            def run(*a):
                n = len(graphs_.graphs) if graphs_ is not None else 0
                t = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                self.decodes.append({"round": sched._round, "kind": kind,
                                     "wall_s": time.perf_counter() - t,
                                     "captured": graphs_ is not None
                                     and len(graphs_.graphs) > n})
                return out
            return run

        self._resumed, self._rids = [], []
        sched._degrade, sched._prefill, sched._prefill_rows = degrade, prefill, rows
        sched._decode_chunk = timed_decode(inner_chunk, eng._chunk_graphs, "plain")
        if inner_spec is not None:
            sched._spec = timed_decode(inner_spec, eng._spec_graphs, "spec")
        # the host tier's steps, per page: gather + copy, pack (CRC
        # included), unpack (CRC included), upload
        self._saved = {n: getattr(paged_cache, n)
                       for n in ("extract_page_planes", "pack_payload", "unpack_payload")}
        for name, fn in self._saved.items():
            setattr(paged_cache, name, self._timed(name, fn))
        inner_restore = sched._tier_restore
        if inner_restore is not None:
            def restore(pages, planes):
                t = time.perf_counter()
                inner_restore(pages, planes)
                torch.cuda.synchronize()
                self.tier.setdefault("upload", []).append(
                    (time.perf_counter() - t) / max(1, len(pages)))
            sched._tier_restore = restore

    def _timed(self, name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            self.tier.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return run

    def close(self):
        from repro_torch.serve import paged_cache

        for name, fn in self._saved.items():
            setattr(paged_cache, name, fn)

    def applied(self):
        from repro_torch.serve.slo import LADDER

        return [(r["round"], LADDER[r["to"] - 1]) for r in self.rungs if r["applied"]]

    def tier_ms(self) -> dict:
        return {k: {"n": len(v), "median_ms": 1e3 * sorted(v)[len(v) // 2],
                    "max_ms": 1e3 * max(v)} for k, v in self.tier.items() if v}


def ladder_serve(torch, model, params, report):
    """(a) the degradation ladder on a self-speculative engine with the
    prefix cache, 256-token chunked prefill, a host tier, a bounded queue
    and observability, on a pool sized by `ladder_pages`."""
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import GenerationEngine, SpecConfig
    from repro_torch.serve.slo import RequestStatus, SLAPolicy

    wave0, residents, res_new, arrivals, wave2 = ladder_traffic(torch, model.cfg.vocab_size)
    pages = ladder_pages(residents, res_new)
    obs = Observability.default(clock=capture_checked_clock(torch))
    t0 = time.perf_counter()
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8, num_blocks=pages,
                           spec_decode=SpecConfig(k=SPEC_K, draft_codec=DRAFT_CODEC),
                           prefix_cache=True, prefill_chunk=256, host_tier=True,
                           sla=SLAPolicy(max_queue=16), obs=obs)
    build_s = time.perf_counter() - t0
    page_mb = eng.kv.bytes_per_token() * 32 / 1e6
    log(f"overload_serve (a): spec engine (k={SPEC_K}, {DRAFT_CODEC} draft) built in "
        f"{build_s:.2f} s; pool {pages} pages of {page_mb:.3f} MB = {pages * page_mb:.1f} MB; "
        f"residents {[len(p) for p in residents]} tokens x {res_new} new, arrivals "
        f"2 x 1024 x 64 new at priority 1")
    rec = Recorder(torch, eng)
    sched = eng.scheduler
    try:
        w0 = [eng.submit(p, max_new_tokens=16) for p in wave0]
        done = eng.run_until_drained()
        w1 = [eng.submit(p, max_new_tokens=n, priority=0) for p, n in zip(residents, res_new)]
        n = len(rec.decodes)
        while len(rec.decodes) == n:  # until wave 1's first decode launch
            sched.step()
        spec_graphs_before = len(eng._spec_graphs.graphs)
        t_arrive = time.perf_counter()
        arr = [eng.submit(p, max_new_tokens=64, priority=1) for p in arrivals]
        w2 = eng.submit(wave2, max_new_tokens=16, priority=1)
        done.update(eng.run_until_drained())
        wall = time.perf_counter() - t_arrive
    finally:
        rec.close()
    torch.cuda.synchronize()
    st, occ = sched.stats(), sched.check_invariants()
    rids = w0 + w1 + arr + [w2]
    prompts = wave0 + residents + arrivals + [wave2]
    outs = [done[r] for r in rids]
    traces = obs.tracer.requests
    resumes = {}
    for p in rec.prefills:
        for rid, start, n in p["resumed"]:
            resumes.setdefault(rid, []).append((start, n, p["wall_s"]))
    parked = [i for i, r in enumerate(w1) if r in resumes]
    # the parked residents again, unpressured (the arrivals gone), on the
    # same engine: token for token, up to a near tie
    again = [eng.submit(residents[i], max_new_tokens=res_new[i]) for i in parked]
    redone = eng.run_until_drained()
    calm = [redone[r] for r in again]
    differ = {w1[i]: next((j for j, (a, b) in enumerate(zip(done[w1[i]], c)) if a != b), None)
              for i, c in zip(parked, calm)}
    applied = rec.applied()
    order = [r for i, (_, r) in enumerate(applied)
             if r != "spill" and r not in [x for _, x in applied[:i]]]
    plain = [d for d in rec.decodes if d["kind"] == "plain"]
    captured = [d for d in plain if d["captured"]]
    graph = next(iter(eng._chunk_graphs.graphs.values()), None)
    shrunk = [p for p in rec.prefills if p["shrunk"]]
    scale = obs.rooflens.calibrate()
    log(f"  rungs applied (round, rung): {applied}; first occurrences {order}; rounds "
        f"{sched._round}; {len(rec.rungs)} blocked rounds; level at drain "
        f"{sched.degradation_level}, spec on {sched._spec_enabled}")
    if captured:
        log(f"  the plain decode graph was captured in round {captured[0]['round']} (spec "
            f"off): that round's decode {1e3 * captured[0]['wall_s']:.1f} ms (uncaptured run "
            f"+ capture), capture {graph.capture_s:.3f} s, {graph.graph_bytes / 1e6:.1f} MB; "
            f"{len(plain)} plain chunks, replayed mean "
            f"{1e3 * sum(d['wall_s'] for d in plain[1:]) / max(1, len(plain) - 1):.1f} ms; "
            f"spec graphs {spec_graphs_before} before the arrivals, "
            f"{len(eng._spec_graphs.graphs)} at drain")
    log(f"  shrunk (one-page) prefill launches: {len(shrunk)}, walls "
        + ", ".join(f"{p['rows']}x{p['span']} {1e3 * p['wall_s']:.0f}" for p in shrunk[:40])
        + (" ..." if len(shrunk) > 40 else "") + " ms")
    for rid in arr:
        t = traces[rid]
        log(f"  arrival {rid}: first token {1e3 * t.ttft:.0f} ms after submit, "
            f"{1e3 * (t.token_times[0] - t.admit_t):.0f} ms after admission, prefill in "
            f"{sum(1 for p in rec.prefills for q in p['rows_rids'] if q == rid)} launches")
    log(f"  parked residents served again unpressured: {len(parked)}; first differing token "
        f"by request {differ} (None: equal token for token; both runs held against "
        f"teacher-forced logits, so a divergence is a near tie)")
    for rid, calls in resumes.items():
        log(f"  resume of request {rid}: re-prefill from token {calls[0][0]} (prefix hit) in "
            f"{len(calls)} launches, {sum(c[2] for c in calls):.3f} s "
            f"({', '.join(f'{c[1]} tokens {1e3 * c[2]:.0f} ms' for c in calls[:8])})")
    tier = rec.tier_ms()
    log(f"  host tier per page (median / max ms): " + "; ".join(
        f"{k} {v['median_ms']:.2f} / {v['max_ms']:.2f} over {v['n']}" for k, v in tier.items())
        + f"; tier_spilled_pages {st['tier_spilled_pages']}, tier_restored_pages "
        f"{st['tier_restored_pages']}, tier_hit_tokens {st['tier_hit_tokens']}, tier_bytes "
        f"{st['tier_bytes']}")
    log(f"  RoofLens scales: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(scale.items()))
        + f"; parked {st['parked_requests']}, resumed {st['resumed_requests']}, "
        f"degradations {st['degradations']}, prefix_hit_tokens {st['prefix_hit_tokens']}; "
        f"statuses {sorted(set(s.value for s in eng.statuses.values()))}; occupancy {occ}; "
        f"{sum(map(len, outs))} tokens in {wall:.2f} s after the arrivals")
    if order != ["prefix_evict", "spec_off", "prefill_shrink", "park"]:
        raise AssertionError(f"the ladder applied {applied}, not prefix_evict, spec_off, "
                             "prefill_shrink, park in order")
    if st["parked_requests"] < 1 or st["resumed_requests"] < 1:
        raise AssertionError("no resident parked and resumed")
    if any(eng.statuses[r] != RequestStatus.OK for r in rids):
        raise AssertionError(f"a request did not end OK: {eng.statuses}")
    if sched.degradation_level != 0 or not sched._spec_enabled:
        raise AssertionError("the ladder did not relax at drain")
    if st["tier_spilled_pages"] == 0 or st["tier_restored_pages"] == 0:
        raise AssertionError("the host tier spilled or restored nothing")
    if not captured:
        raise AssertionError("spec_off ran no plain decode chunk")
    if any(len(o) != n for o, n in zip(outs, [16, 16] + res_new + [64, 64, 16])):
        raise AssertionError("a request did not emit its tokens")
    teacher_forced(torch, eng.model, params, prompts + [residents[i] for i in parked],
                   outs + calm, report, key="teacher_forced_ladder")
    res = {"pages": pages, "page_mb": page_mb, "applied": applied, "rungs": rec.rungs,
           "prefills": rec.prefills, "decodes": rec.decodes, "tier_ms": tier, "scale": scale,
           "stats": st, "occupancy": occ, "resumes": resumes, "wall_s": wall,
           "unpressured_first_difference": differ,
           "arrival_ttft_s": [traces[r].ttft for r in arr],
           "plain_capture": {"round": captured[0]["round"], "wall_s": captured[0]["wall_s"],
                             "capture_s": graph.capture_s, "graph_bytes": graph.graph_bytes}}
    del eng, sched, rec
    torch.cuda.empty_cache()
    return res


def chaos_traffic(torch, vocab):
    """(b)'s traffic, seeded: a 256-token system prompt S behind four
    warm-up prompts, four fresh prompts of 64-512 tokens and four more
    behind S (257-512 tokens)."""
    g = torch.Generator().manual_seed(10)
    rand = lambda n: torch.randint(0, vocab, (int(n),), generator=g)
    system = rand(256)
    warm = [torch.cat([system, rand(n)]).numpy() for n in (5, 9, 13, 17)]
    fresh = [rand(n).numpy() for n in torch.randint(64, 513, (4,), generator=g)]
    behind = [torch.cat([system, rand(n)]).numpy() for n in torch.randint(1, 257, (4,),
                                                                          generator=g)]
    return warm, fresh + behind


def chaos_engine(torch, model, params, warm, injector, watchdog):
    """A plain engine with the prefix cache and a host tier, warmed: each
    decode graph shape (chunks of 8, 4, 2, 1) captured, then the warm-up
    prompts' cached pages (S's 8) spilled to the tier."""
    from repro_torch.serve.engine import GenerationEngine

    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8, prefix_cache=True, host_tier=True,
                           injector=injector, watchdog=watchdog)
    for p, n in zip(warm, (9, 5, 3, 2)):
        eng.submit(p, max_new_tokens=n)
        eng.run_until_drained()
    eng.kv.spill_all()
    return eng


def drive(torch, eng, prompts, new):
    """Submit `prompts` at once and step to drain, recording each round's
    wall, admissions and finishes."""
    sched = eng.scheduler
    admits, inner = [], eng.kv.admit

    def admit(rid, *a, **kw):
        admits.append(sched._round)
        return inner(rid, *a, **kw)

    eng.kv.admit = admit
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    rounds = []
    while sched.queue or any(r is not None for r in sched.slots):
        r, n0, a0 = sched._round, len(sched.statuses), len(admits)
        t = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        rounds.append({"round": r, "wall_s": time.perf_counter() - t,
                       "admitted": len(admits) - a0, "ended": len(sched.statuses) - n0})
    done = sched.run_until_drained()
    eng.kv.admit = inner
    return rids, [done[i] for i in rids], rounds


def chaos_serve(torch, model, params, report):
    """(b) the serving chaos harness at full width: a poisoned prefill, an
    exhausted pool, a slow round and a corrupted tier payload on separate
    rounds of one serve, against a clean serve of the same traffic."""
    from repro_torch.dist.fault import FaultInjector, StragglerWatchdog
    from repro_torch.serve.slo import RequestStatus

    warm, prompts = chaos_traffic(torch, model.cfg.vocab_size)
    clean = chaos_engine(torch, model, params, warm, None, None)
    base = clean.scheduler._round
    crids, couts, crounds = drive(torch, clean, prompts, 32)
    cst = clean.scheduler.stats()
    clean.scheduler.check_invariants()
    del clean
    torch.cuda.empty_cache()
    # the slow round sleeps four times the clean serve's slowest round of
    # the first four, so it clears the watchdog's 3x the mean of the three
    # rounds before it whatever their prefills cost
    slow_s = 4 * max(r["wall_s"] for r in crounds[:4])
    inj, wd = FaultInjector(slow_s=slow_s), StragglerWatchdog()
    eng = chaos_engine(torch, model, params, warm, inj, wd)
    if eng.scheduler._round != base:
        raise AssertionError("the warm-ups took different rounds")
    wd.durations.clear()  # the baseline restarts after the warm-up's captures
    wd.events.clear()
    plan = {base: "poison_prefill", base + 1: "exhaust_pool", base + 2: "corrupt_tier_page",
            base + 3: "slow"}
    inj.plan.update(plan)
    rids, outs, rounds = drive(torch, eng, prompts, 32)
    st, occ = eng.scheduler.stats(), eng.scheduler.check_invariants()
    statuses = [eng.statuses[r] for r in rids]
    exhausted = next(r for r in rounds if r["round"] == base + 1)
    indexed = eng.kv.prefix.lookup_chain(prompts[0])
    differ = [i for i in range(1, len(prompts)) if list(outs[i]) != list(couts[i])]
    first = {i: next(j for j, (a, b) in enumerate(zip(outs[i], couts[i])) if a != b)
             for i in differ}
    log(f"overload_serve (b): plan {plan} (slow_s {slow_s:.3f} s = 4 x the clean serve's "
        f"slowest of its first four rounds); fired {sorted(inj.fired)}; statuses "
        f"{[s.value for s in statuses]}; watchdog {wd.report()}")
    log(f"  rounds (round, wall ms, admitted, ended): " + ", ".join(
        f"({r['round']}, {1e3 * r['wall_s']:.0f}, {r['admitted']}, {r['ended']})"
        for r in rounds) + f"; clean serve: " + ", ".join(
        f"({r['round']}, {1e3 * r['wall_s']:.0f}, {r['admitted']}, {r['ended']})"
        for r in crounds))
    log(f"  tier_corrupt {st['tier_corrupt']}, tier_fallback_recompute "
        f"{st['tier_fallback_recompute']}, tier_restored_pages {st['tier_restored_pages']} "
        f"(clean {cst['tier_restored_pages']}); failed_requests {st['failed_requests']}; "
        f"survivors equal to the clean serve token for token on "
        f"{len(prompts) - 1 - len(differ)}/{len(prompts) - 1}; first differing token "
        f"{first} (both serves held against teacher-forced logits: a divergence is a near "
        f"tie); occupancy {occ}")
    if statuses != [RequestStatus.FAILED] + [RequestStatus.OK] * (len(prompts) - 1):
        raise AssertionError(f"chaos statuses {statuses}")
    if len(outs[0]) or indexed != ([], []):
        raise AssertionError("the poisoned request emitted a token or seeded the index")
    if inj.fired != set(plan.items()):
        raise AssertionError(f"planned faults did not fire: {inj.fired}")
    if base + 3 not in wd.events:
        raise AssertionError(f"the slow round was not flagged: {wd.report()}")
    if exhausted["admitted"] or exhausted["ended"]:
        raise AssertionError(f"the exhausted round admitted or ended a request: {exhausted}")
    if st["tier_corrupt"] != 1 or st["tier_fallback_recompute"] != 1:
        raise AssertionError("the corrupted payload did not fall back to one recompute")
    teacher_forced(torch, eng.model, params, prompts[1:], outs[1:], report,
                   key="teacher_forced_chaos")
    teacher_forced(torch, eng.model, params, prompts[1:], couts[1:], report,
                   key="teacher_forced_chaos_clean")
    res = {"plan": {str(k): v for k, v in plan.items()}, "slow_s": slow_s,
           "watchdog": wd.report(), "rounds": rounds, "clean_rounds": crounds, "stats": st,
           "differ": first, "occupancy": occ}
    del eng
    torch.cuda.empty_cache()
    return res


def gated_serve(torch, model, params, prompts, report):
    """(c) the SLO gates on RoofLens's prices for this card: calibrate on
    a serve of the plain traffic, then serve twelve requests at once under
    a bounded queue, a TTFT objective of 1.5x that serve's TTFT p50 and an
    ITL objective of 1.25x its replayed decode step, two of them with a
    deadline of half the TTFT objective."""
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import GenerationEngine
    from repro_torch.serve.slo import RequestStatus, SLAPolicy

    obs = Observability.default(clock=capture_checked_clock(torch))
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=2048, decode_chunk=8, obs=obs, sla=SLAPolicy())
    _, warm = serve_traffic(torch, eng, prompts)
    scale = obs.rooflens.calibrate()
    summary = obs.tracer.summary()
    ttft = 1.5 * summary["ttft_s"]["p50"]
    itl = 1.25 * warm["replayed_ms_per_device_step"] / 1e3
    obs.tracer.reset()
    obs.rooflens.reset_samples()
    g = torch.Generator().manual_seed(11)
    extra = [torch.randint(0, model.cfg.vocab_size, (int(n),), generator=g).numpy()
             for n in torch.randint(64, 1025, (4,), generator=g)]
    reqs = list(prompts) + extra
    eng.scheduler.sla = SLAPolicy(max_queue=8, ttft_slo_s=ttft, itl_slo_s=itl)
    deadlines = {6: 0.5 * ttft, 7: 0.5 * ttft}
    rids = [eng.submit(p, max_new_tokens=64, deadline_s=deadlines.get(i))
            for i, p in enumerate(reqs)]
    done = eng.run_until_drained()
    st = eng.scheduler.stats()
    statuses = {r: eng.statuses[r] for r in rids}
    at_submit = sum(statuses[r] == RequestStatus.SHED for r in rids[8:])
    served = [r for r in rids if statuses[r] == RequestStatus.OK]
    rows = []
    for r in served:
        t = obs.tracer.requests[r]
        gaps = t.itl
        rows.append({"rid": r, "ttft_s": t.ttft, "itl_mean_s": sum(gaps) / max(1, len(gaps)),
                     "itl_max_s": max(gaps, default=0.0)})
    met_ttft = sum(x["ttft_s"] <= ttft for x in rows)
    met_itl = sum(x["itl_mean_s"] <= itl for x in rows)
    log(f"overload_serve (c): calibrated on the plain traffic (TTFT p50 "
        f"{1e3 * summary['ttft_s']['p50']:.1f} ms, replayed decode "
        f"{warm['replayed_ms_per_device_step']:.2f} ms a step; scales "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(scale.items()))
        + f"): T = {1e3 * ttft:.1f} ms, I = {1e3 * itl:.2f} ms; deadlines {0.5e3 * ttft:.1f} "
        f"ms on requests {rids[6]} and {rids[7]}")
    log(f"  shed at submit {at_submit} (4 expected), shed by the TTFT gate "
        f"{st['shed_requests'] - at_submit}, expired {st['expired_requests']}, itl_deferrals "
        f"{st['itl_deferrals']}; statuses {[s.value for s in statuses.values()]}")
    for x in rows:
        log(f"  request {x['rid']}: TTFT {1e3 * x['ttft_s']:.1f} ms ({'meets' if x['ttft_s'] <= ttft else 'misses'} T), "
            f"ITL mean {1e3 * x['itl_mean_s']:.2f} ms ({'meets' if x['itl_mean_s'] <= itl else 'misses'} I), "
            f"max gap {1e3 * x['itl_max_s']:.1f} ms")
    log(f"  admitted {len(rows)}: TTFT met by {met_ttft}/{len(rows)}, ITL (mean a token) met "
        f"by {met_itl}/{len(rows)}")
    if at_submit != 4:
        raise AssertionError(f"{at_submit} requests shed at submit, not 4")
    if not rows:
        raise AssertionError("the gates admitted nothing")
    teacher_forced(torch, eng.model, params, [reqs[rids.index(r)] for r in served],
                   [done[r] for r in served], report, key="teacher_forced_gated")
    res = {"ttft_slo_s": ttft, "itl_slo_s": itl, "scale": scale, "stats": st,
           "statuses": {str(r): s.value for r, s in statuses.items()}, "requests": rows,
           "shed_at_submit": at_submit, "met_ttft": met_ttft, "met_itl": met_itl}
    del eng
    torch.cuda.empty_cache()
    return res


def overload_serve(torch, model, params, prompts, report):
    """Overload resilience and the host KV tier at full width: (a) the
    degradation ladder down to park, (b) the chaos harness, (c) the SLO
    gates on RoofLens's prices. Launch counts are set to 0 before (a) and
    read after (c)."""
    t0 = time.perf_counter()
    launches = dict.fromkeys(counters(), 0)

    def bank():  # (c)'s serve_traffic sets the counts to 0 itself
        for k, fn in counters().items():
            launches[k] += fn.launches
            fn.launches = 0

    bank()
    launches = dict.fromkeys(counters(), 0)
    res = {"ladder": ladder_serve(torch, model, params, report)}
    bank()
    res["chaos"] = chaos_serve(torch, model, params, report)
    bank()
    res["gates"] = gated_serve(torch, model, params, prompts, report)
    bank()
    res["launches"], res["seconds"] = launches, time.perf_counter() - t0
    log(f"overload_serve: launches {launches}; {res['seconds']:.1f} s")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched in overload_serve: {idle}")
    report["overload_serve"] = res


def build_compressed(torch, arch, n_layers=None):
    """`arch` at full width and depth (or cut to `n_layers`) with
    SERVED_SPEC weights, each layer compressed on the card as `Model.init`
    draws it (an MoE weight one expert at a time): the build's seconds,
    the stored bytes beside the dense bf16 size, and the peak allocation
    over the build, which must stay within BUILD_HEADROOM of the stored
    bytes (the dense model never exists whole)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.decompress import compressed_bytes
    from repro_torch.core.formats import get_spec
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), kv_quant=SERVED_KV)
    full = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        spec=get_spec(SERVED_SPEC))
    torch.cuda.synchronize()
    rec = {"build_s": time.perf_counter() - t0, "param_bytes": compressed_bytes(params),
           "dense_bf16_bytes": 2 * cfg.param_count(),
           "build_peak_bytes": torch.cuda.max_memory_allocated() - base}
    over = rec["build_peak_bytes"] - rec["param_bytes"]
    depth = "depth" if cfg.n_layers == full else f"{cfg.n_layers} of its {full} layers"
    moe = (f"{cfg.n_experts} experts top-{cfg.experts_per_token} capacity "
           f"{cfg.capacity_factor:g}, " if cfg.n_experts else "")
    if cfg.family == "ssm":
        mixer = (f"Mamba-1 blocks (d_inner {cfg.d_inner}, state {cfg.ssm_state}, dt_rank "
                 f"{cfg.dt_rank}, conv {cfg.ssm_conv}), no FFN")
    else:
        mixer = f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads, {moe}d_ff {cfg.d_ff} {cfg.mlp_act}"
        if cfg.block_pattern:
            mixer = (f"blocks {'/'.join(cfg.block_pattern)} (RG-LRU width "
                     f"{cfg.lru_width}), " + mixer)
    log(f"{arch} full width and {depth} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{mixer}, vocab "
        f"{cfg.vocab_size}, {cfg.pos_emb} positions, "
        f"{'tied' if cfg.tie_embeddings else 'untied'} head) built and compressed to "
        f"{SERVED_SPEC} on the card in {rec['build_s']:.1f} s: {rec['param_bytes'] / 1e9:.3f} GB "
        f"of params against {rec['dense_bf16_bytes'] / 1e9:.1f} GB dense bf16 "
        f"({cfg.param_count() / 1e9:.2f} B parameters); build peak {rec['build_peak_bytes'] / 1e9:.3f}"
        f" GB, {over / 1e9:.3f} GB over the params (limit {BUILD_HEADROOM / 1e9:.0f} GB)")
    if over >= BUILD_HEADROOM:
        raise AssertionError(f"{arch}: the build held {over / 1e9:.2f} GB beyond its params")
    return model, params, rec


def check_model_kernels(torch, timer, model, params, cases, expert_ms=(1, 4, 2048),
                        ms=(1, 4, 2048), attention=True):
    """The matmul kernels on every distinct FC shape of a served model (the
    compressed leaves of the first layer of each kind and lm_head, at the
    served codec): the GeMV and GeMM at the rows `ms` (M <= 32 the GeMV),
    by default M = 1 and 4 and 2048 (an MoE expert at `expert_ms`, through
    the last expert's `pick` view of the stacked leaf, whose planes start
    furthest into the stack), and, with `attention`, the attention kernel
    at its heads over the served KV pool, each against its plain version
    and timed. x is f32 (bf16-valued), the GeMV's f32-x path. Every case
    runs before any failure is raised, so one run reports them all."""
    from repro_torch.core.compression import CompressedTensor
    from repro_torch.kernels import deca_gemm, ref

    cfg = model.cfg
    firsts = {}
    for kind, layer in zip(model.kinds, params["layers"]):
        firsts.setdefault(kind, layer)
    named = []
    for layer in firsts.values():
        for group in ("attn", "mlp", "mamba", "rec"):
            for n, ct in layer.get(group, {}).items():
                if isinstance(ct, CompressedTensor):
                    short = n[2:] if n.startswith("w_") else n[1:] if group == "attn" else n
                    named.append((short, ct, False))
        for n, ct in layer.get("moe", {}).items():
            if isinstance(ct, CompressedTensor):
                named.append((f"expert {n[2:]}", ct.pick(ct.lead[0] - 1), True))
    if "lm_head" in params:
        named.append(("lm_head", params["lm_head"], False))
    shapes = {}
    for name, ct, expert in named:
        shapes.setdefault((ct.shape, expert), []).append((name, ct))
    g = torch.Generator(device="cuda").manual_seed(11)
    mine = []
    for ((k, n), expert), group in shapes.items():
        role, ct = "/".join(name for name, _ in group), group[0][1]
        for m in (expert_ms if expert else ms):
            kind = "gemv" if m <= 32 else "gemm"
            kern = deca_gemm.decompress_gemv if kind == "gemv" else deca_gemm.decompress_gemm
            plain = ref.decompress_gemv if kind == "gemv" else ref.decompress_gemm
            x = torch.randn(m, k, generator=g, device="cuda").bfloat16().float()
            got, want = kern(x, ct), plain(x, ct)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            del got, want
            case = {"model": cfg.name, "kernel": kind, "role": role, "K": k, "N": n, "M": m,
                    "spec": ct.spec.name, "max_abs_err": err, "rel_err": rel}
            time_matmul(torch, timer, case, kern, plain, x, ct)
            mine.append(case)
        torch.cuda.empty_cache()
    if attention:
        check_attention_at(torch, timer, cfg, g, mine)
    worst = max(c["rel_err"] for c in mine)
    log(f"{cfg.name} kernels: {len(mine)} cases at its shapes, max rel err {worst:.2e} "
        f"(tolerance {KERNEL_TOL}): " + ", ".join(
            f"{c['kernel']} {c['role']}{' M=%d' % c['M'] if 'M' in c else ''} "
            f"{c['rel_err']:.2e}" for c in mine))
    cases += mine
    bad = [c for c in mine if c["rel_err"] > KERNEL_TOL]
    if bad:
        raise AssertionError(f"{cfg.name}: kernels disagree with their plain versions: {bad}")


def check_attention_at(torch, timer, cfg, g, mine):
    """The attention kernel at a model's heads over the served KV pool,
    against its plain version, timed; its case goes to `mine`. A
    bidirectional model's (`causal=False`) queries sit at a third of their
    slots' lengths, so the keys after them count."""
    from repro_torch.kernels import paged_attention, ref

    q, pools, tables, kv_lens, q_pos = _attention_inputs(
        torch, SERVED_KV, g, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if not cfg.causal:
        q_pos = kv_lens // 3
    args = (q, pools, tables, kv_lens, q_pos)
    got = paged_attention.paged_attention(*args, quant=SERVED_KV, causal=cfg.causal)
    want = ref.paged_decode_attention(*args, quant=SERVED_KV, causal=cfg.causal)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    role = (f"G={cfg.n_heads // cfg.n_kv_heads} Hkv={cfg.n_kv_heads} Dh={cfg.d_head}"
            + ("" if cfg.causal else " causal=0"))
    case = {"model": cfg.name, "kernel": "attention", "kind": SERVED_KV, "variant": "plain",
            "role": role, "causal": cfg.causal, "max_abs_err": err, "rel_err": rel}
    time_attention(torch, timer, case, args)
    mine.append(case)
    del args, pools, got, want
    torch.cuda.empty_cache()


def check_tied_head(torch, model, params, report):
    """The tied head's f32 logits (one bf16 GEMM with an f32 output)
    against the plain product of f32 copies, both summing exact products
    in f32: within 2 K 2^-24 sum|x e| of each other, and timed."""
    from repro_torch.models import layers

    embed = params["embed"]
    v, d = embed.shape
    x = torch.randn(4, 1, d, generator=torch.Generator(device="cuda").manual_seed(12),
                    device="cuda").bfloat16()
    got = layers.tied_logits(x, embed)
    want = x.float() @ embed.float().t()
    mag = x.float().abs() @ embed.float().abs().t()
    torch.cuda.synchronize()
    worst = float(((got - want).abs() / (2 * d * 2.0**-24 * mag).clamp_min(1e-30)).max())
    ms = {}
    for name, fn in (("tied", lambda: layers.tied_logits(x, embed)),
                     ("bf16", lambda: x[:, 0] @ embed.t())):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        ms[name] = a.elapsed_time(b) / 20
    bound = 1e3 * (2 * v * d + 4 * 4 * v) / HBM_BYTES_PER_S
    log(f"{model.cfg.name} tied head ({v} x {d} bf16 embed, 4 rows): f32 logits "
        f"{got.dtype}, worst error {worst:.3f} of the f32 summation bound against the plain "
        f"f32 product; {ms['tied']:.4f} ms a step (a bf16-output GEMM {ms['bf16']:.4f} ms; "
        f"bound {bound:.4f} ms, bytes)")
    report["tied_head"] = {"worst_of_bound": worst, "ms": ms["tied"], "bf16_ms": ms["bf16"],
                           "bound_ms": bound}
    if got.dtype != torch.float32 or worst > 1.0:
        raise AssertionError("the tied head's logits disagree with the plain f32 product")


def decode_kv_pages(cfg, lens, new, bs):
    """KV pages one decode step walks, summed over the layers and averaged
    over the decode steps, of requests with prompt lengths `lens` each
    emitting `new` tokens (the first from the prefill): a step at KV
    length kv walks ceil(kv / bs) pages in a global layer and only those
    from the first its window can see in a local one (the kernel's
    lo_page). Returns (layer pages a step, global pages a step of one
    layer), the second to be checked against the scheduler's count."""
    layer_pages = glob = 0
    steps = new - 1
    for n in lens:
        for t in range(1, new):
            kv = n + t
            full = -(-kv // bs)
            local = full - max(0, kv - cfg.window) // bs
            glob += full
            layer_pages += sum(local if k == "attn_local" else full for k in cfg.layer_kinds())
    return layer_pages / steps, glob / steps


def serve_paper_model(torch, model, params, report, batches, lens=None, max_len=2048,
                      check_all=False, new=PAPER_NEW, teacher=True, prompts=None):
    """Greedy serves through the plain serve's engine, one per entry of
    `batches` (requests submitted at once, PAPER_NEW new tokens each, seeded
    prompt lengths in 64-1024), every decode chunk a captured graph. Each
    prints its prefill walls, the replayed decode ms a step beside the
    decode bytes bound (the compressed FC planes, a tied head's table and
    the KV pages the step walks, over the card's memory rate), tok/s,
    launches, peak memory, its graphs and one replay's breakdown; every
    request must emit its tokens inside the vocabulary, and each decode
    step must launch one GeMV per FC matmul. `lens` gives the prompt
    lengths (`prompts` the prompts themselves); `check_all` also holds
    every serve's tokens against teacher-forced logits (not only the
    first's) and its graphs' replays bitwise against the uncaptured
    chunks; `teacher` False holds no tokens against teacher-forced logits
    (an MoE config whose routes and drops a teacher pass would not
    reproduce). An MoE step reads each expert's planes once per routing slot
    (the reference's dispatch runs every expert's bin each slot): the
    bound counts them k times, and the log gives the one-read bound too."""
    from repro_torch.core.compression import CompressedTensor
    from repro_torch.core.decompress import _leaves
    from repro_torch.serve.engine import GenerationEngine

    cfg, name = model.cfg, model.cfg.name
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                           max_len=max_len, decode_chunk=8)
    g = torch.Generator().manual_seed(4)
    if prompts is None:
        if lens is None:
            lens = torch.randint(64, 1025, (sum(batches),), generator=g).tolist()
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy() for n in lens]
    reads = lambda x: cfg.experts_per_token if x.lead else 1
    fc = sum(x.nbytes * reads(x) for x in _leaves(params) if isinstance(x, CompressedTensor))
    fc_once = sum(x.nbytes for x in _leaves(params) if isinstance(x, CompressedTensor))
    head = params["embed"].numel() * 2 if cfg.tie_embeddings else 0  # read whole a step
    page_bytes = eng.kv.bytes_per_token() * eng.kv.block_size
    log(f"{name} engine: int8 KV pool of {eng.kv.num_blocks} pages, "
        f"{eng.kv.bytes_per_token() / 1e6:.3f} MB a token, "
        f"{page_bytes * (eng.kv.num_blocks + 1) / 1e9:.2f} GB; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    out, start = {}, 0
    for b in batches:
        what = f"batch {b}"
        batch, start = prompts[start:start + b], start + b
        st0 = eng.scheduler.stats()
        outs, run = serve_waves(torch, eng, [batch], new)
        st, launches = run["stats"], run["launches"]
        if any(len(o) != new for o in outs):
            raise AssertionError(f"{name} {what}: a request did not emit its {new} tokens")
        if not all(0 <= int(t) < cfg.vocab_size for o in outs for t in o):
            raise AssertionError(f"{name} {what}: a token lies outside the vocabulary")
        steps_run = launches["deca_paged_attention"] / cfg.n_layers  # one a layer a step
        if launches["deca_gemv"] != gemvs_per_step(cfg) * steps_run or steps_run == 0:
            raise AssertionError(f"{name} {what}: the decode steps did not launch one GeMV "
                                 f"per FC matmul ({launches}, {gemvs_per_step(cfg)} a step)")
        if launches["deca_gemm"] == 0:
            raise AssertionError(f"{name} {what}: the prefill never launched the GeMM")
        later = [c for c in run["chunks"] if not c["captured"]]
        replay_ms = 1e3 * sum(c["wall_s"] for c in later) / max(1, sum(c["steps"] for c in later))
        steps = st["decode_steps"] - st0["decode_steps"]
        kv = (st["kv_pages_read"] - st0["kv_pages_read"]) * page_bytes / max(steps, 1)
        if cfg.attn_pattern == "local_global":
            # the scheduler counts a global layer's walk in every layer; a
            # local layer walks only the pages its window sees
            layer_pages, glob = decode_kv_pages(cfg, [len(p) for p in batch], new,
                                                eng.kv.block_size)
            if abs(glob - kv / page_bytes) > 1e-6:
                log(f"warning: {name} {what}: {glob} global pages a step by the prompt "
                    f"lengths against the scheduler's {kv / page_bytes}")
            kv = layer_pages * page_bytes / cfg.n_layers
        bound = 1e3 * (fc + head + kv) / HBM_BYTES_PER_S
        pf = run["prefills"]
        log(f"{name} {what}: prompts {[len(p) for p in batch]} x {new} new, "
            f"{run['tokens']} tokens in {run['wall_s']:.2f} s = "
            f"{run['tokens'] / run['wall_s']:.1f} tok/s; prefill "
            + ", ".join(f"{c['rows']}x{c['span']} {1e3 * c['wall_s']:.1f} ms" for c in pf)
            + f"; replayed decode {replay_ms:.2f} ms a step over {len(later)} chunks "
            f"({gemvs_per_step(cfg)} GeMVs a step); launches {launches}; peak device memory "
            f"{run['peak_bytes'] / 1e9:.2f} GB")
        once = 1e3 * (fc_once + head + kv) / HBM_BYTES_PER_S
        log(f"{name} {what}: decode bytes bound a step {bound:.3f} ms = (FC "
            f"{fc / 1e9:.3f} GB{f' + tied head {head / 1e9:.3f} GB' if head else ''} + KV "
            f"{kv / 1e9:.4f} GB) over {HBM_BYTES_PER_S / 1e12:.2f} TB/s; FC alone "
            f"{1e3 * fc / HBM_BYTES_PER_S:.3f} ms; the replayed step is {replay_ms / bound:.2f}x "
            f"the bound ({bound / replay_ms:.3f} of it)"
            + (f"; with one read of each expert ({fc_once / 1e9:.3f} GB of FC planes, "
               f"the experts read once instead of {cfg.experts_per_token} times) the bound "
               f"would be {once:.3f} ms, {replay_ms / once:.2f}x" if fc != fc_once else ""))
        out[what] = {"prompt_lens": [len(p) for p in batch], "tokens": run["tokens"],
                     "prompts": [[int(t) for t in p] for p in batch],
                     "outs": [[int(t) for t in o] for o in outs],
                     "wall_s": run["wall_s"], "prefills": pf, "replayed_ms_per_step": replay_ms,
                     "bound_ms": bound, "one_read_bound_ms": once, "fc_bytes": fc,
                     "fc_stored_bytes": fc_once, "head_bytes": head,
                     "kv_bytes_per_step": kv, "launches": launches,
                     "peak_bytes": run["peak_bytes"], "chunks": run["chunks"],
                     "graphs": graph_costs(eng._chunk_graphs, run["chunks"], f"{name} {what}")}
        profile_replays(torch, eng._chunk_graphs, f"{name} {what} decode chunk", report)
        if teacher and b == batches[0]:
            out["teacher_forced_argmax_share"] = teacher_forced(
                torch, model, params, batch, outs, report, key=f"teacher_forced_{name}")
        elif teacher and check_all:
            out[f"teacher_forced_argmax_share_{what}"] = teacher_forced(
                torch, model, params, batch, outs, report,
                key=f"teacher_forced_{name}_{what.replace(' ', '')}")
        if check_all:
            check_replays(torch, eng, eng._chunk_graphs, f"{name} {what} decode chunk", report)
    return out


def gemma2(torch, report):
    """gemma2-2b at full width and depth on one card (26 layers, local and
    global in turn, Dh 256, geglu, softcaps, post norms, a tied head of
    256000 x 2304), compressed to SERVED_SPEC: its build and peak, its
    kernels at its shapes, its tied head, a serve of 4 requests of seeded
    lengths and one of GEMMA_LONG tokens (its local layers' window of 4096
    cuts the walk), each decode chunk's replay held bitwise and its tokens
    against teacher-forced logits, and the kernel path against the plain
    path over PATH_LAYERS layers. Returns its kernel cases."""
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    timer = Timer(torch)
    cases = []
    model, params, rec = build_compressed(torch, GEMMA)
    cfg = model.cfg
    check_model_kernels(torch, timer, model, params, cases)
    del timer
    check_tied_head(torch, model, params, rec)
    g = torch.Generator().manual_seed(4)
    lens = torch.randint(64, 1025, (4,), generator=g).tolist() + [GEMMA_LONG]
    rec["serves"] = serve_paper_model(torch, model, params, report, (4, 1), lens=lens,
                                      max_len=GEMMA_MAX_LEN, check_all=True)
    long = rec["serves"]["batch 1"]
    eng_graphs = long["graphs"]
    log(f"{GEMMA} long request: {GEMMA_LONG} prompt tokens, the local layers' window "
        f"{cfg.window} walks {-(-cfg.window // 32) + 1} of its ~{-(-GEMMA_LONG // 32)} pages; "
        f"{len(eng_graphs['graphs'])} graphs")
    cut = Model(dataclasses.replace(cfg, n_layers=PATH_LAYERS))
    compare_paths(torch, cut, dict(params, layers=params["layers"][:PATH_LAYERS]), rec)
    del model, params, cut
    gc.collect()
    torch.cuda.empty_cache()
    rec["cases"], rec["seconds"] = cases, time.perf_counter() - t0
    log(f"{GEMMA}: {rec['seconds']:.1f} s; freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    report["gemma2"] = rec
    return cases


class RouteLog:
    """The experts an MoE config chooses, read from its own routing and fed
    back into it. While active, `layers.top_k` is wrapped: each uncaptured
    call keeps its choice (G, Tl, k), one call a layer of each forward (a
    captured decode step runs nothing and is not seen), and each engine
    prefill and decode chunk keeps its host arrays beside the calls it made
    (an engine built inside the context). Inside `replay(choices)` each call
    returns the next of `choices` instead, its gates read from the caller's
    own probabilities, and notes the routes where the caller's own choice
    differs, with the probability gap that decided each."""

    def __init__(self, torch):
        self.torch, self.seen, self.steps, self.replays = torch, [], [], []
        self.queue = None

    def __enter__(self):
        from repro_torch.models import layers
        from repro_torch.serve.engine import GenerationEngine as Eng

        self.inner = layers.top_k
        self.engine = (Eng._run_paged_prefill, Eng._run_paged_decode_chunk)

        def top_k(probs, k):
            vals, idx = self.inner(probs, k)
            if self.queue is not None:
                return self._replayed(probs, idx, k)
            if not (probs.is_cuda and self.torch.cuda.is_current_stream_capturing()):
                self.seen.append(idx.detach().clone())
            return vals, idx

        def step(kind, fn):
            def run(eng, *arrays):
                first = len(self.seen)
                out = fn(eng, *arrays)
                self.steps.append((kind, arrays, first, len(self.seen)))
                return out
            return run
        layers.top_k = top_k
        Eng._run_paged_prefill = step("prefill", self.engine[0])
        Eng._run_paged_decode_chunk = step("decode", self.engine[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        from repro_torch.serve.engine import GenerationEngine as Eng

        layers.top_k = self.inner
        Eng._run_paged_prefill, Eng._run_paged_decode_chunk = self.engine

    def _replayed(self, probs, own, k):
        idx = self.queue.pop(0)
        if idx.shape != own.shape:
            raise AssertionError(f"replayed choice {tuple(idx.shape)} for a call of "
                                 f"{tuple(own.shape)}")
        # the gap that decides a route: the smallest between neighbours
        # among the k + 1 largest probabilities (the order of the k, and
        # the k-th against the first left out)
        top = probs.sort(dim=-1, descending=True).values[..., :k + 1]
        gap = (top[..., :-1] - top[..., 1:]).min(dim=-1).values
        self.gaps.append(gap.flatten())
        self.flipped.append(gap[(own != idx).any(dim=-1)])
        return probs.gather(-1, idx), idx

    @contextlib.contextmanager
    def replay(self, choices):
        """Replay `choices` (one per call, in call order); on exit the gap
        of every route and of every flipped one join `replays`."""
        self.queue, self.gaps, self.flipped = list(choices), [], []
        try:
            yield
        finally:
            left, self.queue = len(self.queue), None
        if left:
            raise AssertionError(f"{left} logged choices were never replayed")
        self.replays.append((self.torch.cat(self.gaps).cpu(),
                             self.torch.cat(self.flipped).cpu()))

    def flips(self) -> dict:
        """Over every replay: the routes, those where the replaying pass
        would have chosen otherwise and the gap that decided each, the
        smallest and the median gap of all routes, and how many routes lie
        within the largest flipped gap."""
        gaps = self.torch.cat([g for g, _ in self.replays])
        flipped = self.torch.cat([f for _, f in self.replays])
        worst = flipped.max().item() if flipped.numel() else 0.0
        return {"routes": gaps.numel(), "flipped": flipped.numel(),
                "flip_gaps": sorted(flipped.tolist()), "smallest_gap": gaps.min().item(),
                "median_gap": gaps.median().item(),
                "routes_within_largest_flip_gap": int((gaps <= worst).sum())}

    def drops(self, cfg):
        """Per engine prefill: its rows' tokens (padding included) and its
        real prompt tokens, its bins' rows (`cap`), and the token-slots it
        drops over all its layers (a token past `cap` in its expert's bin in
        a routing slot; the bin fills in token order), of all tokens and of
        the prompt tokens alone. One dispatch group (G = 1)."""
        from repro_torch.kernels.ref import CACHE_EMPTY_POS

        torch, rows = self.torch, []
        for kind, arrays, a, b in self.steps:
            if kind != "prefill":
                continue
            real = torch.as_tensor(arrays[4] != CACHE_EMPTY_POS).flatten()
            tl, k, n = real.numel(), cfg.experts_per_token, int(real.sum())
            real = real.to(self.seen[a].device)
            cap = max(4, math.ceil(tl / cfg.n_experts * cfg.capacity_factor))
            dropped = ours = 0
            for idx in self.seen[a:b]:
                for s in range(k):
                    eid = idx[0, :, s]
                    count = torch.nn.functional.one_hot(eid, cfg.n_experts).cumsum(0)
                    out = count.gather(1, eid[:, None])[:, 0] > cap  # rank >= cap
                    dropped += int(out.sum())
                    ours += int((out & real).sum())
            rows.append({"tokens": tl, "prompt_tokens": n, "cap": cap, "dropped": dropped,
                         "share": dropped / ((b - a) * tl * k), "prompt_dropped": ours,
                         "prompt_share": ours / ((b - a) * n * k)})
        return rows

    def routes_of(self, cfg, prompts, rids, new=MOE_NEW):
        """Each request's choices at every position the engine ran it
        through, (len(prompt) + new, layers, k) on the host (-1 where none
        ran): prefill rows matched to requests by their prompts, decode
        slots by their request ids; a decode chunk logs C steps of
        n_layers calls."""
        import numpy as np
        from repro_torch.kernels.ref import CACHE_EMPTY_POS

        nl, k = cfg.n_layers, cfg.experts_per_token
        out = {r: np.full((len(p) + new, nl, k), -1, np.int64)
               for p, r in zip(prompts, rids)}
        for kind, arrays, a, b in self.steps:
            calls = np.stack([c[0].cpu().numpy() for c in self.seen[a:b]])  # (calls, Tl, k)
            if kind == "prefill":
                if len(calls) != nl:
                    raise AssertionError(f"a prefill logged {len(calls)} calls")
                tokens, wpos = arrays[0], arrays[4]
                for row in range(tokens.shape[0]):
                    n = int((wpos[row] != CACHE_EMPTY_POS).sum())
                    who = [r for p, r in zip(prompts, rids)
                           if len(p) == n and np.array_equal(tokens[row, :n], p)]
                    if who:
                        span = slice(row * tokens.shape[1], row * tokens.shape[1] + n)
                        out[who[0]][wpos[row, :n]] = calls[:, span].transpose(1, 0, 2)
                continue
            positions, slot_rids, max_steps, active = arrays[2], arrays[7], arrays[9], arrays[11]
            c = positions.shape[0]
            if len(calls) != c * nl:
                raise AssertionError(f"a decode chunk of {c} steps logged {len(calls)} calls")
            for j in range(c):
                for i in np.flatnonzero(active & (j < max_steps)):
                    out[int(slot_rids[i])][positions[j, i, 0]] = calls[j * nl:(j + 1) * nl, i]
        return out


def log_flips(cfg, st, what) -> dict:
    """A route log's replays (`RouteLog.flips`): the routes where the
    replaying pass would have chosen otherwise, each with its gap."""
    log(f"{cfg.name} {what}: the replaying pass's own top-{cfg.experts_per_token} differs "
        f"from the replayed choice at {st['flipped']} of {st['routes']} (token, layer) routes; "
        f"the probability gaps that decided them: "
        + ", ".join(f"{x:.2e}" for x in st["flip_gaps"][:32])
        + (" ..." if st["flipped"] > 32 else "")
        + f"; over all routes the smallest gap {st['smallest_gap']:.2e}, the median "
        f"{st['median_gap']:.3e}; {st['routes_within_largest_flip_gap']} routes lie within "
        f"the largest flipped gap")
    return st


def routed_serve(torch, model, params, prompts, report):
    """The token rule with the served routers: `model` (a drop-free copy,
    so a request's routes do not depend on its batch) serves `prompts`
    greedily, its decode chunks uncaptured so that every route is logged
    (the served serve holds its replays bitwise to the uncaptured chunks);
    then each request's teacher-forced forward replays the routes its serve
    chose, with gates from the teacher pass's own probabilities. A near tie
    that the teacher pass's summation order breaks the other way would
    otherwise send a token through other experts, which no tolerance on
    logits covers; those routes are logged with their gaps."""
    from repro_torch.serve.engine import GenerationEngine

    cfg = model.cfg
    with RouteLog(torch) as routes:
        eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=4, block_size=32,
                               max_len=2048, decode_chunk=8)
        eng._chunk_graphs = None  # every decode chunk runs uncaptured
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=MOE_NEW) for p in prompts]
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        outs = [done[r] for r in rids]
        if any(len(o) != MOE_NEW for o in outs):
            raise AssertionError(f"a request did not emit its {MOE_NEW} tokens")
        steps_run = launches["deca_paged_attention"] / cfg.n_layers
        if launches["deca_gemv"] != gemvs_per_step(cfg) * steps_run:
            raise AssertionError(f"the uncaptured decode steps did not launch one GeMV per FC "
                                 f"matmul ({launches})")
        chosen = routes.routes_of(cfg, prompts, rids)
        del eng
        torch.cuda.empty_cache()
        log(f"{cfg.name} drop-free copy (capacity {cfg.capacity_factor:g}) with the served "
            f"routers: {len(rids)} requests x {MOE_NEW} new in {wall:.2f} s, decode chunks "
            f"uncaptured; launches {launches}")

        def pin(i):
            n = len(prompts[i]) + len(outs[i]) - 1
            seq = chosen[rids[i]][:n]
            if (seq < 0).any():
                raise AssertionError(f"request {i}: a position with no logged route")
            return routes.replay([torch.as_tensor(seq[:, layer][None], device="cuda")
                                  for layer in range(cfg.n_layers)])
        share = teacher_forced(torch, model, params, prompts, outs, report,
                               key="teacher_forced_routed", pin=pin)
    return {"wall_s": wall, "launches": launches, "argmax_share": share,
            "outs": [list(map(int, o)) for o in outs],
            "flips": log_flips(cfg, routes.flips(), "teacher passes on the served routes")}


def zero_router(params):
    """The same weights with every router zeroed: each probability ties,
    and top-k takes experts 0 .. k-1 for every token whatever its
    activations. The expert planes are shared, not copied."""
    import torch

    return dict(params, layers=[
        dict(layer, moe=dict(layer["moe"], router=torch.zeros_like(layer["moe"]["router"])))
        for layer in params["layers"]])


def check_kimi_shapes(torch, timer, cases):
    """kimi-k2-1t-a32b's expert GeMVs (d_model 7168, d_ff 2048: 7168 x 2048
    gate/up, 2048 x 7168 down) at M = 1, 4, 16 on SERVED_SPEC weights, and
    its decode attention (64 q / 8 kv heads, Dh 112: the kernel's d < Dh
    guards) over every KV pool kind, each against its plain version; the
    served codec and pool timed."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import deca_gemm, paged_attention, ref

    cfg = get_config(KIMI)
    g = torch.Generator(device="cuda").manual_seed(23)
    mine = []
    for k, n, role in ((cfg.d_model, cfg.d_ff, "expert gate/up"),
                       (cfg.d_ff, cfg.d_model, "expert down")):
        ct = compress(torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k),
                      get_spec(SERVED_SPEC))
        for m in (1, 4, 16):
            x = torch.randn(m, k, generator=g, device="cuda").bfloat16().float()
            got, want = deca_gemm.decompress_gemv(x, ct), ref.decompress_gemv(x, ct)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            case = {"model": cfg.name, "kernel": "gemv", "role": role, "K": k, "N": n, "M": m,
                    "spec": ct.spec.name, "max_abs_err": err, "rel_err": rel}
            time_matmul(torch, timer, case, deca_gemm.decompress_gemv, ref.decompress_gemv,
                        x, ct)
            mine.append(case)
    role = f"G={cfg.n_heads // cfg.n_kv_heads} Hkv={cfg.n_kv_heads} Dh={cfg.d_head}"
    for kind in KV_KINDS:
        q, pools, tables, kv_lens, q_pos = _attention_inputs(
            torch, kind, g, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
        args = (q, pools, tables, kv_lens, q_pos)
        for window, cap in ((0, 0.0), (100, 50.0)):
            got = paged_attention.paged_attention(*args, quant=kind, window=window, softcap=cap)
            want = ref.paged_decode_attention(*args, quant=kind, window=window, softcap=cap)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            case = {"model": cfg.name, "kernel": "attention", "kind": kind, "role": role,
                    "variant": f"window {window} softcap {cap:g}", "max_abs_err": err,
                    "rel_err": rel}
            if kind == SERVED_KV and window == 0:
                time_attention(torch, timer, case, args)
            mine.append(case)
        del pools, args
        torch.cuda.empty_cache()
    worst = max(c["rel_err"] for c in mine)
    log(f"{cfg.name} shapes: {len(mine)} cases, max rel err {worst:.2e} (tolerance "
        f"{KERNEL_TOL}): " + ", ".join(
            f"{c['kernel']} {c['role']} {c.get('kind', '')}"
            f"{' ' + c['variant'] if 'variant' in c else ' M=%d' % c['M']} {c['rel_err']:.2e}"
            for c in mine))
    cases += mine
    bad = [c for c in mine if c["rel_err"] > KERNEL_TOL]
    if bad:
        raise AssertionError(f"{cfg.name}: kernels disagree with their plain versions: {bad}")


def moe(torch, report):
    """grok-1-314b at full width and MOE_LAYERS layers, compressed to
    SERVED_SPEC on the card one expert at a time: its build and peak, its
    kernels at its shapes (the experts through `pick` views) and kimi-k2's,
    a 4-request greedy serve of MOE_NEW tokens at its capacity 1.25 (each
    decode chunk replayed bitwise, 417 GeMVs a step, the replayed step
    beside its bytes bound with every expert read once per routing slot,
    the token-slots each prefill drops, of all and of the prompt tokens);
    the same weights served on a one-rank NCCL mesh beside the plain
    engine (`serve_on_mesh`: MOE_MESH_PROMPT-token prompts, MOE_MESH_NEW
    new; tokens and pool planes bitwise, 417 / 8 / 0 launches a step),
    then again with fsdp=True on the same group (each FC leaf gathered at
    its point of use inside the captured chunk, held to the same rules,
    its replayed step timed in turns with both), and the kernels at
    grok-1's (1, 4) local shard shapes (`tp_kernels`);
    the kernel path against the plain path over PATH_LAYERS layers at the
    served capacity and on a drop-free copy (capacity = n_experts), the
    plain path on the kernel path's routes; the drop-free copy with the
    served routers held to the token rule, each teacher pass on the routes
    its serve chose (`routed_serve`); and a self-speculative engine on
    MOE_SPEC_LAYERS layers of the drop-free copy (the draft tree through
    the decompression kernel, expert by expert), on zero routers, whose
    ties send every token to experts 0 and 1: the spec launch is captured,
    so its routes cannot be replayed into the teacher pass. Returns its
    kernel cases."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import GenerationEngine

    t0 = time.perf_counter()
    timer = Timer(torch)
    cases = []
    model, params, rec = build_compressed(torch, MOE, n_layers=MOE_LAYERS)
    cfg = model.cfg
    check_model_kernels(torch, timer, model, params, cases, expert_ms=MOE_EXPERT_MS)
    check_kimi_shapes(torch, timer, cases)
    del timer
    no_dense_lm_head(torch, cfg, params, rec)
    g = torch.Generator().manual_seed(4)
    lens = torch.randint(64, 1025, (4,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy() for n in lens]
    with RouteLog(torch) as routes:
        rec["serves"] = serve_paper_model(torch, model, params, rec, (4,), new=MOE_NEW,
                                          teacher=False, check_all=True, prompts=prompts)
    prefill = routes.drops(cfg)
    rec["prefill_drops"] = prefill
    t = time.perf_counter()
    rec["mesh"] = serve_on_mesh(torch, model, params,
                                [p[:MOE_MESH_PROMPT] for p in prompts], MOE_MESH_NEW,
                                "moe mesh serve", fsdp=True)
    timer = Timer(torch)
    mesh_cases = []
    tp_kernels(torch, timer, mesh_cases, GROK14, GROK14_SHAPES, GROK14_MS, GROK14_HEADS)
    del timer
    cases += mesh_cases
    rec["mesh"]["seconds"] = time.perf_counter() - t
    log(f"{MOE} on a one-rank mesh, plain and fsdp, and its (1, 4) shard shapes "
        f"({len(mesh_cases)} cases, the experts' shapes unchanged: 2 whole experts a rank): "
        f"{rec['mesh']['seconds']:.1f} s")
    log(f"{MOE} capacity {cfg.capacity_factor:g}: token-slots each prefill call drops "
        f"(over its {cfg.n_layers} layers and {cfg.experts_per_token} slots): " + ", ".join(
            f"{r['tokens']} tokens (padding included), bins of {r['cap']}: {r['dropped']} = "
            f"{r['share']:.4f}; of its {r['prompt_tokens']} prompt tokens "
            f"{r['prompt_dropped']} = {r['prompt_share']:.4f}" for r in prefill)
        + "; decode bins of 4 never drop")
    free_cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    head = dict(params, layers=params["layers"][:PATH_LAYERS])
    for what, c in (("served", cfg), ("drop_free", free_cfg)):
        with RouteLog(torch) as routes:
            compare_paths(torch, Model(dataclasses.replace(c, n_layers=PATH_LAYERS)), head,
                          rec, key=f"path_comparison_{what}", steps=MOE_PATH_STEPS,
                          routes=routes)
        rec[f"path_route_flips_{what}"] = log_flips(
            cfg, routes.flips(), f"capacity {c.capacity_factor:g}, plain path on the kernel "
            f"path's routes")
    del head
    free = Model(free_cfg)
    rec["drop_free"] = routed_serve(torch, free, params, prompts, rec)
    spec_model = Model(dataclasses.replace(free_cfg, n_layers=MOE_SPEC_LAYERS))
    spec_params = zero_router(dict(params, layers=params["layers"][:MOE_SPEC_LAYERS]))
    plain = GenerationEngine(spec_model, spec_params, kv_quant=SERVED_KV, max_slots=4,
                             block_size=32, max_len=2048, decode_chunk=8)
    rids = [plain.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
    done = plain.run_until_drained()
    del plain
    gc.collect()  # its graphs hold the engine in a cycle
    spec_rec = {}
    eng, rec["spec_launches"], _ = serve_spec(torch, spec_model, spec_params, prompts,
                                              [done[r] for r in rids], spec_rec)
    rec["spec"] = spec_rec
    del eng, model, params, free, spec_model, spec_params
    gc.collect()
    torch.cuda.empty_cache()
    rec["cases"], rec["seconds"] = cases, time.perf_counter() - t0
    log(f"{MOE}: {rec['seconds']:.1f} s; freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    report["moe"] = rec
    return cases


def snapshot_serve(torch, model, params, prompts, report, new=32):
    """Engine snapshots on full-width llama3-8b with the prefix cache and a
    host tier: 4 requests served uninterrupted, then the same 4 on a
    second engine snapshotted into a temporary directory after its first
    decode chunk, restored into a fresh engine and drained. Every resumed
    token must pass the teacher-forced rule, and the decode kernels must
    run in the resumed drain; the walls, the bytes on disk and the counts
    are printed."""
    import shutil
    import tempfile

    from repro_torch.serve.engine import GenerationEngine

    kw = dict(kv_quant=SERVED_KV, max_slots=4, block_size=32, max_len=2048, decode_chunk=8,
              prefix_cache=True, host_tier=True)
    batch = [p[:1024] for p in prompts[:4]]
    ref = GenerationEngine(model, params, **kw)
    rids = [ref.submit(p, max_new_tokens=new) for p in batch]
    want = ref.run_until_drained()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    eng = GenerationEngine(model, params, **kw)
    mine = [eng.submit(p, max_new_tokens=new) for p in batch]
    assert mine == rids
    eng.scheduler.step()  # admission and the prefill
    eng.scheduler.step()  # a decode chunk
    done_before = sum(len(r.out) for r in eng.scheduler.slots if r is not None)
    root = tempfile.mkdtemp(prefix="deca_snapshot_")
    try:
        snap = str(Path(root) / "snap")
        t = time.perf_counter()
        counts = eng.snapshot(snap)
        snap_s = time.perf_counter() - t
        disk = sum(f.stat().st_size for f in Path(snap).iterdir())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        fresh = GenerationEngine(model, params, **kw)
        t = time.perf_counter()
        if fresh.restore(snap) != counts:
            raise AssertionError("restore read other counts than the snapshot wrote")
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    occ = fresh.kv.occupancy()
    if occ["used"] != 0 or occ["tiered"] != counts["nodes"]:
        raise AssertionError(f"a restored engine holds device pages: {occ}")
    for fn in counters().values():
        fn.launches = 0
    t = time.perf_counter()
    got = fresh.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters().items()}
    st = fresh.scheduler.stats()
    fresh.scheduler.check_invariants()
    outs = [got[r] for r in rids]
    if any(len(o) != new for o in outs):
        raise AssertionError("a resumed request did not emit its tokens")
    if launches["deca_gemv"] == 0 or launches["deca_paged_attention"] == 0:
        raise AssertionError(f"the resumed drain did not run the decode kernels: {launches}")
    same = sum(int(a == b) for r, o in zip(rids, outs) for a, b in zip(o, want[r]))
    log(f"snapshot of a tiered llama3-8b engine in mid-serve ({done_before} tokens decoded): "
        f"{counts['nodes']} index nodes, {counts['requests']} requests, {disk / 1e6:.1f} MB on "
        f"disk; snapshot {snap_s:.3f} s, restore {restore_s:.3f} s into a fresh engine "
        f"({occ['tiered']} pages in the tier, {occ['used']} on the card); the drain "
        f"{drain_s:.2f} s restored {st['tier_restored_pages']} pages ({st['tier_hit_tokens']} "
        f"hit tokens, {st['tier_fallback_recompute']} recomputes); launches {launches}; "
        f"{same}/{new * len(rids)} tokens equal the uninterrupted serve's")
    tf = teacher_forced(torch, model, params, batch, outs, report, key="teacher_forced_snapshot")
    report["snapshot"] = {"nodes": counts["nodes"], "requests": counts["requests"],
                          "disk_bytes": disk, "snapshot_s": snap_s, "restore_s": restore_s,
                          "drain_s": drain_s, "launches": launches, "stats": st,
                          "tokens_equal": same, "argmax_share": tf}
    del fresh
    gc.collect()
    torch.cuda.empty_cache()


def tp_kernels(torch, timer, cases, model, shapes, ms, heads):
    """The kernels at one model's local shard shapes on a (1, 4) mesh
    (`shapes` (K, N, role) at `ms` rows, SERVED_SPEC weights; attention at
    `heads` (q, kv) over a SERVED_KV pool, none where `heads` is None: the
    ring engine reads its ring through `attention_core`), each against its
    plain version at KERNEL_TOL and timed beside its plain version, its
    library call and its bound; each case is tagged with `model`."""
    from repro_torch.core.compression import compress
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import deca_gemm, paged_attention, ref

    g = torch.Generator(device="cuda").manual_seed(5)
    spec = get_spec(SERVED_SPEC)
    for k, n, role in shapes:
        w = torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k)
        ct = compress(w, spec)
        del w
        for m in ms:
            x = torch.randn(m, k, generator=g, device="cuda").bfloat16().float()
            kind = "gemv" if m <= 32 else "gemm"
            kern = deca_gemm.decompress_gemv if kind == "gemv" else deca_gemm.decompress_gemm
            plain = ref.decompress_gemv if kind == "gemv" else ref.decompress_gemm
            got, want = kern(x, ct), plain(x, ct)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            case = {"model": model, "kernel": kind, "role": role, "K": k, "N": n, "M": m,
                    "spec": spec.name, "max_abs_err": err, "rel_err": rel}
            time_matmul(torch, timer, case, kern, plain, x, ct)
            if rel > KERNEL_TOL:
                raise AssertionError(f"{kind} disagrees with its plain version: {case}")
            cases.append(case)
        del ct
    if heads is None:
        torch.cuda.empty_cache()
        return
    hq, hkv = heads
    args = _attention_inputs(torch, SERVED_KV, g, hq=hq, hkv=hkv, dh=128)
    got = paged_attention.paged_attention(*args, quant=SERVED_KV)
    want = ref.paged_decode_attention(*args, quant=SERVED_KV)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    case = {"model": model, "kernel": "attention", "kind": SERVED_KV,
            "role": f"{hq}/{hkv} heads", "max_abs_err": err, "rel_err": rel}
    time_attention(torch, timer, case, args)
    if rel > KERNEL_TOL:
        raise AssertionError(f"paged attention disagrees with its plain version: {case}")
    cases.append(case)
    torch.cuda.empty_cache()


def replay_walls(torch, graphs, n=8):
    """(ms a replay, device steps a replay) of the first captured graph,
    `n` replays between CUDA events."""
    key, g = next(iter(graphs.graphs.items()))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    g.graph.replay()
    a.record()
    for _ in range(n):
        g.graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, key[2][0]


def first_replay(graphs):
    """The replay of a `StepGraphs`' first captured graph."""
    return next(iter(graphs.graphs.values())).graph.replay


def collective_kernels(torch, run, n=1) -> dict:
    """{kernel name: launches a call} of `run()`'s collectives (a graph's
    replay, an uncaptured step): the device kernels and copies of `n`
    traced calls whose names are NCCL's or a device copy's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    return {e.key: e.count / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("aten::")
            and ("nccl" in e.key.lower() or "memcpy" in e.key.lower())}


@contextlib.contextmanager
def one_rank_nccl(torch):
    """A one-rank NCCL world on card 0 (a free localhost port) and its
    (1, 1) mesh, the group destroyed on the way out."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _serve_mesh_engine(torch, model, params, batch, new, what, mesh, kw, plain, fsdp):
    """One `GenerationEngine(mesh=, fsdp=)` on `mesh` serving `batch` x
    `new` beside `plain` = (the plain engine, its outputs by request, its
    launches), the launch counts set to 0 before its serve and read after
    it: tokens and every pool plane (null page left out) must be the plain
    engine's bitwise, a decode step must launch the plain step's kernels
    (`gemvs_per_step` GeMV, one attention a layer, no decompression) and
    the serve the plain serve's launches; the chunk runs as captured
    graphs with the collectives (and under fsdp the gathers) inside, each
    replayed bitwise. Returns (its record, the engine)."""
    import numpy as np

    from repro_torch.core.decompress import compressed_bytes
    from repro_torch.serve.engine import GenerationEngine

    cfg = model.cfg
    plain_eng, plain_done, plain_launches = plain
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(model, params, mesh=mesh, fsdp=fsdp, **kw)
    sched = eng.scheduler
    chunks = []
    sched._decode_chunk = chunk_timer(torch, eng._chunk_graphs, sched._decode_chunk, chunks)
    rids = [eng.submit(p, max_new_tokens=new) for p in batch]
    for fn in counters().values():
        fn.launches = 0
    t = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated() - base
    st = sched.stats()
    n = sum(c["steps"] for c in chunks)  # device steps: every chunk runs its C
    same = [np.array_equal(done[r], plain_done[i]) for i, r in enumerate(rids)]
    bad = [f"layer {i} {name}" for i, (mine, want) in enumerate(zip(eng.kv.pools,
                                                                    plain_eng.kv.pools))
           for name, t in mine.items() if not torch.equal(t[1:], want[name][1:])]
    local, whole = compressed_bytes(eng.params), compressed_bytes(params)
    buf = eng._ctx.gather_buffer
    log(f"{what}: {cfg.name} on a (1, 1) NCCL mesh, fsdp={fsdp}, {len(rids)} requests x "
        f"{new} new tokens (prompts of {[len(p) for p in batch]}), kv {SERVED_KV}: "
        f"{wall:.2f} s; {st['prefill_calls']} prefill calls, {st['decode_steps']} decode steps "
        f"in {st['decode_chunks']} chunks ({n} device steps); this rank's params "
        f"{local / 1e9:.3f} GB of {whole / 1e9:.3f} GB; the mesh engine's peak "
        f"{peak / 1e9:.3f} GB beyond what was allocated before it"
        + (f" (its gather buffer {buf.numel() / 1e9:.3f} GB)" if buf is not None else ""))
    log(f"  tokens bitwise the plain engine's: {sum(same)}/{len(same)} requests; pool "
        f"planes bitwise (null page left out): {not bad}")
    per = {k: v / max(n, 1) for k, v in launches.items()}
    log(f"  launches {launches} (the plain serve's {plain_launches}): a device step "
        f"{per['deca_gemv']:.1f} GeMV, {per['deca_paged_attention']:.1f} attention, "
        f"{per['deca_decompress']:.1f} decompression (the plain chunk step: "
        f"{gemvs_per_step(cfg)} / {cfg.n_layers} / 0)")
    if not all(same) or bad:
        raise AssertionError(f"the mesh engine (fsdp={fsdp}) is not the plain engine "
                             f"bitwise: tokens {same}, planes {bad[:8]}")
    if (launches != plain_launches
            or launches["deca_gemv"] != gemvs_per_step(cfg) * n
            or launches["deca_paged_attention"] != cfg.n_layers * n
            or launches["deca_gemm"] != gemvs_per_step(cfg) * st["prefill_calls"]
            or launches["deca_decompress"]):
        raise AssertionError(f"the mesh serve (fsdp={fsdp}) launched other kernels than the "
                             f"plain serve's: {launches} over {n} device steps, plain "
                             f"{plain_launches}")
    if not eng._chunk_graphs.graphs or any(not c["captured"] for c in chunks[:1]):
        raise AssertionError(f"the mesh decode chunk (fsdp={fsdp}) was not captured")
    rec = {}
    costs = graph_costs(eng._chunk_graphs, chunks, f"{what} decode chunk")
    check_replays(torch, eng, eng._chunk_graphs, f"{what} decode chunk", rec)
    rec.update(wall_s=wall, stats=st, launches=launches, plain_launches=plain_launches,
               per_step=per, tokens_bitwise=same, planes_bitwise=not bad, graphs=costs,
               param_bytes={"rank": local, "whole": whole}, peak_beyond_bytes=peak,
               gather_buffer_bytes=0 if buf is None else buf.numel())
    return rec, eng


def gathered_bytes(eng) -> int:
    """The bytes an fsdp engine's decode step gathers: every leaf of its
    local tree with a `data` entry, whole (the embedding table's rows are
    gathered, not the table)."""
    from repro_torch.dist import sharding as sh

    ctx = eng._ctx
    return sum(t.numel() * t.element_size() * ctx.axis_sizes["data"]
               for leaf, spec in ctx.leaf_specs.values() if leaf is not eng.params["embed"]
               for t, p in sh.planes(leaf, spec) if sh.fsdp_dim(p) is not None)


def serve_on_mesh(torch, model, params, batch, new, what, fsdp=False):
    """`model` with `params` (no second build) served by
    `GenerationEngine(mesh=)` on a one-rank NCCL mesh (1, 1), int8 KV,
    `batch` x `new` greedy tokens, chunk 8, beside the plain engine on the
    same requests (`_serve_mesh_engine`). On one rank every shard is the
    whole leaf (a view, no copy) and every collective sums or gathers one
    operand, so all must be bitwise the plain engine's. Prints the NCCL
    kernels and copies a replay launches, the replayed step beside the
    plain engine's (the one-rank collectives' cost), this rank's param
    bytes and the mesh engine's peak memory beyond the params. With
    `fsdp`, a second mesh engine on the same group serves the same
    requests with `fsdp=True`: every FC leaf's `data` entry names the one
    rank, so each point of use all-gathers the leaf's planes into the
    gather buffer (a device copy) inside the captured chunk; it is held to
    the same rules, and its replayed step is timed in turns with the plain
    engine's and the non-fsdp mesh engine's beside the bound of the bytes
    its gathers copy. Opens its NCCL group and destroys it (after its
    engines and graphs). Returns the record (the fsdp engine's under
    "fsdp")."""
    from repro_torch.serve.engine import GenerationEngine

    kw = dict(kv_quant=SERVED_KV, max_slots=4, block_size=32, max_len=2048, decode_chunk=8)
    plain = GenerationEngine(model, params, **kw)
    plain_rids = [plain.submit(p, max_new_tokens=new) for p in batch]
    for fn in counters().values():
        fn.launches = 0
    plain_done = plain.run_until_drained()
    plain_launches = {k: fn.launches for k, fn in counters().items()}
    ref = (plain, [plain_done[r] for r in plain_rids], plain_launches)
    with one_rank_nccl(torch) as mesh:
        rec, eng = _serve_mesh_engine(torch, model, params, batch, new, what, mesh, kw, ref,
                                      False)
        nccl = collective_kernels(torch, first_replay(eng._chunk_graphs))
        plain_nccl = collective_kernels(torch, first_replay(plain._chunk_graphs))
        mesh_ms, steps = replay_walls(torch, eng._chunk_graphs)
        plain_ms, plain_steps = replay_walls(torch, plain._chunk_graphs)
        log(f"  a replay's NCCL kernels and copies: mesh {nccl or 'none recorded'}; plain "
            f"{plain_nccl or 'none recorded'}")
        log(f"  replayed chunk: mesh {mesh_ms:.3f} ms ({mesh_ms / steps:.3f} ms a step over "
            f"{steps}), plain {plain_ms:.3f} ms ({plain_ms / plain_steps:.3f} ms a step): "
            f"the one-rank collectives cost {(mesh_ms / steps - plain_ms / plain_steps):.3f} "
            f"ms a step")
        rec.update(nccl_kernels={"mesh": nccl, "plain": plain_nccl},
                   replay_ms={"mesh": mesh_ms, "plain": plain_ms},
                   steps_a_replay={"mesh": steps, "plain": plain_steps})
        if fsdp:
            rec["fsdp"] = fsdp_beside(torch, model, params, batch, new, what, mesh, kw, ref,
                                      eng, nccl)
        del eng
        gc.collect()
        torch.cuda.synchronize()
    del plain, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def fsdp_beside(torch, model, params, batch, new, what, mesh, kw, ref, mesh_eng, mesh_nccl):
    """`serve_on_mesh`'s fsdp engine, on the group of the non-fsdp one
    (`mesh_eng`, whose replay launched `mesh_nccl`): its serve held to the
    plain engine's; a replay's NCCL kernels and copies beside the non-fsdp
    mesh engine's; the three engines' replayed chunks timed in turns
    (plain, mesh, fsdp, fsdp, mesh, plain; 2 replays a turn); the bytes its gathers copy a
    step and their bound (read and write once at HBM_BYTES_PER_S). Returns
    its record."""
    frec, feng = _serve_mesh_engine(torch, model, params, batch, new, f"{what} (fsdp)", mesh,
                                    kw, ref, True)
    nccl = collective_kernels(torch, first_replay(feng._chunk_graphs))
    engines = {"plain": ref[0], "mesh": mesh_eng, "fsdp": feng}
    walls = {k: [] for k in engines}
    steps = {}
    for k in ("plain", "mesh", "fsdp", "fsdp", "mesh", "plain"):
        ms, steps[k] = replay_walls(torch, engines[k]._chunk_graphs, n=2)
        walls[k].append(ms)
    step = {k: sum(v) / len(v) / steps[k] for k, v in walls.items()}
    moved = gathered_bytes(feng)
    bound = 2 * moved / HBM_BYTES_PER_S * 1e3
    log(f"  {what} (fsdp): a replay's NCCL kernels and copies {nccl or 'none recorded'} "
        f"(the non-fsdp mesh engine's {mesh_nccl or 'none recorded'})")
    log(f"  replayed step in turns (plain, mesh, fsdp, fsdp, mesh, plain): fsdp "
        f"{step['fsdp']:.3f} ms, non-fsdp mesh {step['mesh']:.3f} ms, plain "
        f"{step['plain']:.3f} ms: the gathers cost {step['fsdp'] - step['mesh']:.3f} ms a "
        f"step; they copy {moved / 1e9:.3f} GB a step, bound {bound:.3f} ms (read and write "
        f"once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    frec.update(nccl_kernels={"fsdp": nccl, "mesh": mesh_nccl},
                replay_step_ms=step, replay_walls_ms=walls, gathered_bytes_a_step=moved,
                gather_bound_ms=bound)
    del feng, engines
    gc.collect()
    torch.cuda.synchronize()
    return frec


def mesh_serve(torch, model, params, prompts, report):
    """Sharded serving on the card: the plain serve's first 4 prompts cut to
    MESH_PROMPT tokens, MESH_NEW new, through `serve_on_mesh` (a one-rank
    NCCL mesh beside the plain engine: 225 GeMV, 32 attention, no
    decompression a step); then the kernels at llama2-70b's (1, 4) local
    shard shapes (`tp_kernels`). Returns the kernel cases."""
    t_phase = time.perf_counter()
    rec = serve_on_mesh(torch, model, params, [p[:MESH_PROMPT] for p in prompts[:4]],
                        MESH_NEW, "mesh_serve")
    cases = []
    timer = Timer(torch)
    tp_kernels(torch, timer, cases, TP70, TP70_SHAPES, TP70_MS, TP70_HEADS)
    del timer
    torch.cuda.empty_cache()
    rec["tp70_cases"] = cases
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"mesh_serve: {rec['seconds']:.1f} s")
    report["mesh_serve"] = rec
    return cases


def compare_dense_paths(torch, model, params, report, key, steps=2):
    """The dense engine's prefill (4 prompts of RECURRENT_PROMPT tokens) and
    `steps` decode steps over the first PATH_LAYERS layers: the kernel
    path's logits against the plain path's, both fed the kernel path's
    greedy tokens, from fresh `init_cache` caches."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import make_prefill_step

    cut = Model(dataclasses.replace(model.cfg, n_layers=PATH_LAYERS))
    head = dict(params, layers=params["layers"][:PATH_LAYERS])
    g = torch.Generator(device="cuda").manual_seed(3)
    b, n = RECURRENT_BATCH, RECURRENT_PROMPT
    tokens = torch.randint(0, cut.cfg.vocab_size, (b, n), generator=g, device="cuda")
    results, fed = {}, []
    for path in ("kernel", "plain"):
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            logits, cache = make_prefill_step(cut, cache_len=n + steps)(head, {"tokens": tokens})
            outs = [logits.float()]
            for j in range(steps):
                if path == "kernel":  # both paths are fed the kernel path's tokens
                    fed.append(outs[-1].argmax(-1).to(torch.int32)[:, None])
                pos = torch.full((b, 1), n + j, dtype=torch.int32, device="cuda")
                lg, cache = cut.decode_step(head, fed[j], pos, cache)
                outs.append(lg.float())
            torch.cuda.synchronize()
            results[path] = outs
            del cache
    report_paths(cut, results, report, key, steps)


def decode_step_bytes(cfg, params, batch, kv_tokens):
    """Bytes one dense-engine decode step must move, by part: the FC planes
    (every compressed leaf read once), a tied head's embedding table, the
    other dense leaves of the layers (norms, convs, the SSM's A and the
    gates' biases) read once, each recurrent layer's conv buffer and f32
    state read and written once, and each ring layer's KV of `kv_tokens`
    valid tokens a row read once, with the step's token written."""
    from repro_torch.core.compression import CompressedTensor
    from repro_torch.core.decompress import _leaves
    from repro_torch.models import layers as L

    leaves = list(_leaves(params["layers"])) + [params["final_norm"]]
    fc = sum(x.nbytes for x in leaves if isinstance(x, CompressedTensor))
    fc += params["lm_head"].nbytes if "lm_head" in params else 0
    small = sum(x.numel() * x.element_size() for x in leaves
                if not isinstance(x, CompressedTensor))
    head = params["embed"].numel() * params["embed"].element_size() if cfg.tie_embeddings else 0
    state = kv = 0
    codec = L.kv_codec(cfg.kv_quant)
    for kind in cfg.layer_kinds():
        if kind == "ssm":
            state += batch * (2 * (cfg.ssm_conv - 1) * cfg.d_inner
                              + 4 * cfg.d_inner * cfg.ssm_state)
        elif kind == "rec":
            r = cfg.lru_width or cfg.d_model
            state += batch * (2 * (cfg.ssm_conv - 1) * r + 4 * r)
        else:
            dh = cfg.d_head
            per = (2 * dh if codec is None
                   else codec.kv_code_width(dh) + (2 if codec.has_scale else 0))
            kv += batch * 2 * cfg.n_kv_heads * per * (kv_tokens + 1)
    return {"fc": fc, "head": head, "small": small, "state": 2 * state, "kv": kv}


def profile_dense_step(torch, model, params, report, key, n=3):
    """`n` dense decode steps after a prefill of RECURRENT_BATCH prompts,
    timed between CUDA events and traced with torch.profiler, the scan
    loops (`layers.selective_scan`, `layers.linear_recurrence`) inside
    record_function ranges: device time of the GeMV (with its split-K
    reduce), of the scans' kernels, of the other kernels (norms, convs,
    gates, the tied head), and the idle share of the traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers as L
    from repro_torch.serve.engine import make_prefill_step

    cfg = model.cfg
    b, s = RECURRENT_BATCH, RECURRENT_PROMPT
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    _, cache = make_prefill_step(model, cache_len=s + 2 * n + 1)(params, {"tokens": tokens})
    tok = tokens[:, -1:].to(torch.int32)

    def step(i):
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device="cuda")
        return model.decode_step(params, tok, pos, cache)[0]

    step(0)  # warm
    saved = L.selective_scan, L.linear_recurrence

    def ranged(fn):
        def run(*a):
            with record_function("recurrent_scan"):
                return fn(*a)
        return run

    L.selective_scan, L.linear_recurrence = (ranged(f) for f in saved)
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            a.record()
            for i in range(n):
                step(1 + i)
            e.record()
            e.synchronize()
    finally:
        L.selective_scan, L.linear_recurrence = saved
    wall = a.elapsed_time(e) / n
    rows = [evt for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0 and not evt.key.startswith("aten::")
            and not getattr(evt, "is_user_annotation", False)]
    busy = sum(r.self_device_time_total for r in rows) / 1e3 / n
    gemv = sum(r.self_device_time_total for r in rows
               if "::gemv_kernel" in r.key or "::splitk_reduce" in r.key) / 1e3 / n
    scan = sum(getattr(ev, "device_time_total", 0) for ev in prof.events()
               if ev.name == "recurrent_scan" and ev.device_type == DeviceType.CPU) / 1e3 / n
    kernels = sum(r.count for r in rows) / n
    split = {"gemv_ms": gemv, "scan_ms": scan, "other_ms": busy - gemv - scan}
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:8]
    log(f"{cfg.name} decode step profile (uncaptured, {n} steps traced): {wall:.3f} ms a step "
        f"between events; device busy {busy:.3f} ms (GeMV {gemv:.3f}, scan {scan:.3f}, other "
        f"{busy - gemv - scan:.3f}), {kernels:.0f} kernels a step; idle share "
        f"{1 - busy / wall:.3f}")
    for r in top:
        log(f"  {r.self_device_time_total / 1e3 / n:8.3f} ms {r.count / n:7.0f}x  {r.key[:90]}")
    report[key] = {"wall_ms": wall, "busy_ms": busy, "kernels": kernels,
                   "idle_share": 1 - busy / wall, **split,
                   "rows": [{"name": r.key, "device_ms": r.self_device_time_total / 1e3 / n,
                             "count": r.count / n} for r in top]}
    del cache


def timed_generate(torch, eng, prompts, new) -> dict:
    """One greedy `generate` of `prompts` (B, S) through the dense ring
    engine `eng`, the launch counts set to 0 before it and read after it:
    {outs, ring (the engine's caches after it), wall (s), walls (s of the
    prefill and of each uncaptured decode step, each ended by a
    synchronize), launches, peak (bytes over the serve, reset before the
    prefill), prefill_extra (the prefill's peak over what it found
    allocated)}."""
    if eng.paged:
        raise AssertionError(f"{eng.cfg.name}: the engine is paged, not the dense ring engine")
    walls = {"prefill": [], "decode": []}
    prefill_peak = {}

    def timed(fn, name):
        def run(*a):
            torch.cuda.synchronize()
            if name == "prefill":
                prefill_peak["base"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t)
            if name == "prefill":
                prefill_peak["peak"] = torch.cuda.max_memory_allocated()
            return out
        return run

    prefill, decode = eng._prefill, eng._decode
    eng._prefill, eng._decode = timed(prefill, "prefill"), timed(decode, "decode")
    gc.collect()
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        outs = eng.generate(prompts, new)  # the peak is reset before the prefill
        torch.cuda.synchronize()
    finally:
        eng._prefill, eng._decode = prefill, decode
    return {"outs": outs, "ring": eng.ring, "wall": time.perf_counter() - t0, "walls": walls,
            "launches": {k: fn.launches for k, fn in counters().items()},
            "peak": torch.cuda.max_memory_allocated(),
            "prefill_extra": prefill_peak["peak"] - prefill_peak["base"]}


def dense_serve(torch, model, params, report, key, prompts, new=RECURRENT_NEW, **engine_kw):
    """One greedy `generate` of `prompts` (B, S) through the dense engine
    (`paged="auto"` for a recurrent stack, `paged=False` given for an
    attention one): the prefill's wall, each decode step's (uncaptured:
    every op launched from the host), tok/s, the peak device memory over
    the run, and the GeMM launches of the prefill and GeMV launches a
    decode step, which must be one per FC matmul; the decode step beside
    its bytes bound. Returns the `timed_generate` record (its tokens
    `outs`, (B, new))."""
    from repro_torch.serve.engine import GenerationEngine

    cfg = model.cfg
    b, s = prompts.shape
    eng = GenerationEngine(model, params, max_len=s + new, **engine_kw)
    run = timed_generate(torch, eng, prompts, new)
    del eng
    outs, wall, walls, launches = run["outs"], run["wall"], run["walls"], run["launches"]
    peak, pf_extra = run["peak"], run["prefill_extra"]
    if outs.shape != (b, new) or not ((0 <= outs) & (outs < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: tokens {outs.shape} outside ({b}, {new}) or the vocabulary")
    per = gemvs_per_step(cfg)
    if launches["deca_gemv"] != per * new or launches["deca_gemm"] != per:
        raise AssertionError(f"{cfg.name}: launches {launches}, not {per} GeMMs in the prefill "
                             f"and {per} GeMVs in each of {new} decode steps")
    if launches["deca_paged_attention"]:
        raise AssertionError(f"{cfg.name}: the dense engine launched paged attention")
    step_ms = sorted(1e3 * w for w in walls["decode"])
    median = step_ms[len(step_ms) // 2]
    parts = decode_step_bytes(cfg, params, b, s + (new + 1) / 2)
    bound = 1e3 * sum(parts.values()) / HBM_BYTES_PER_S
    log(f"{cfg.name} dense engine: {b} prompts of {s} x {new} new greedy tokens in {wall:.2f} s "
        f"= {b * new / wall:.1f} tok/s; prefill {1e3 * walls['prefill'][0]:.1f} ms "
        f"({launches['deca_gemm']} GeMMs at M = {b * s}); decode {median:.2f} ms a step "
        f"(median of {len(step_ms)}, min {step_ms[0]:.2f}, uncaptured), {per} GeMVs a step; "
        f"launches {launches}; peak device memory {peak / 1e9:.2f} GB over the serve, the "
        f"prefill's {pf_extra / 1e9:.3f} GB over what it found allocated")
    log(f"{cfg.name} decode step bytes bound {bound:.3f} ms = (" + " + ".join(
        f"{k} {v / 1e9:.4f} GB" for k, v in parts.items()) + f") over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the median step is {median / bound:.1f}x the bound "
        f"({bound / median:.3f} of it)")
    report[key] = {"prompt_len": s, "batch": b, "new": new, "wall_s": wall,
                   "prefill_ms": 1e3 * walls["prefill"][0], "decode_ms": step_ms,
                   "decode_median_ms": median, "tok_s": b * new / wall, "launches": launches,
                   "gemvs_per_step": per, "peak_bytes": peak, "prefill_extra_bytes": pf_extra,
                   "bound_ms": bound,
                   "bound_parts_bytes": parts}
    return run


def ring_on_mesh(torch, model, params, prompts, plain, what):
    """`model` with `params` (no second build) served by the dense ring
    engine (`paged=False`) on a one-rank NCCL mesh (1, 1) through
    `timed_generate`, beside `plain`, the plain ring engine's `dense_serve`
    of the same (B, S) greedy prompts. On one rank every shard is the
    whole leaf, a channel block every channel and every collective sums or
    gathers one operand: the tokens and every ring-cache plane and recurrent state
    after the serve must be the plain engine's bitwise, and the DECA
    launches the plain serve's. Prints the NCCL kernels and device copies
    of one more decode step of each engine (traced), the median decode
    step beside the plain engine's, the host time of one all-reduce and
    one all-gather as the step calls them, this rank's param bytes and
    each serve's peak, each line with the card's name and power limit.
    Returns the record."""
    import numpy as np

    from repro_torch.core.decompress import compressed_bytes
    from repro_torch.dist import sharding as sh
    from repro_torch.serve.engine import GenerationEngine

    cfg = model.cfg
    b, s = prompts.shape
    new = plain["outs"].shape[1]
    t0 = time.perf_counter()
    runs = {"plain": plain}
    with one_rank_nccl(torch) as mesh:
        eng = GenerationEngine(model, params, mesh=mesh, max_len=s + new, paged=False)
        runs["mesh"] = timed_generate(torch, eng, prompts, new)
        same = [np.array_equal(a, p) for a, p in zip(runs["mesh"]["outs"], plain["outs"])]
        bad = [f"layer {i} {name}" for i, (mine, want) in enumerate(zip(eng.ring,
                                                                        plain["ring"]))
               for name, t in mine.items() if not torch.equal(t, want[name])]
        tok = torch.as_tensor(plain["outs"][:, -1:], dtype=torch.int32, device="cuda")
        pos = torch.full((b, 1), s + new, dtype=torch.int32, device="cuda")

        def mesh_step():
            with sh.scope(eng._ctx):
                eng._decode(eng.params, tok, pos, eng.ring)

        copies = {"mesh": collective_kernels(torch, mesh_step),
                  "plain": collective_kernels(
                      torch, lambda: model.decode_step(params, tok, pos, plain["ring"]))}
        local, whole = compressed_bytes(eng.params), compressed_bytes(params)
        # the host cost of one collective as the step calls it, on a (B, 1,
        # d_model) bf16 row block: uncaptured, every call pays it
        x = torch.zeros((b, 1, cfg.d_model), dtype=torch.bfloat16, device="cuda")
        coll_us = {}
        for name, fn in (("all_reduce", lambda: sh.all_reduce(x, "model", eng._ctx)),
                         ("all_gather", lambda: sh.all_gather(x, "model", eng._ctx, -1))):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            coll_us[name] = (time.perf_counter() - t) * 1e4
        del eng, x
        gc.collect()
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    median = {k: sorted(r["walls"]["decode"])[len(r["walls"]["decode"]) // 2] * 1e3
              for k, r in runs.items()}
    m, p = runs["mesh"], runs["plain"]
    log(f"{what}: {cfg.name} with paged=False on a (1, 1) NCCL mesh beside the plain ring "
        f"engine, {b} prompts of {s} x {new} new greedy tokens [{CARD}]: tokens bitwise "
        f"{sum(same)}/{len(same)} rows; every ring plane and recurrent state bitwise: "
        f"{not bad}; launches {m['launches']} (the plain serve's {p['launches']})")
    log(f"  decode step (uncaptured, median of {len(m['walls']['decode'])}): mesh "
        f"{median['mesh']:.2f} ms, plain {median['plain']:.2f} ms "
        f"({median['mesh'] - median['plain']:+.2f} ms); prefill mesh "
        f"{1e3 * m['walls']['prefill'][0]:.1f} ms, plain {1e3 * p['walls']['prefill'][0]:.1f} "
        f"ms; a decode step's NCCL kernels and device copies: mesh {copies['mesh'] or 'none'}, "
        f"plain {copies['plain'] or 'none'} [{CARD}]")
    log(f"  this rank's params {local / 1e9:.3f} GB of {whole / 1e9:.3f} GB; peak over the "
        f"serve: mesh {m['peak'] / 1e9:.3f} GB, plain {p['peak'] / 1e9:.3f} GB; one "
        f"collective's host time (100 calls on {b} x {cfg.d_model} bf16, synchronized "
        f"after): all_reduce {coll_us['all_reduce']:.1f} us, all_gather + cat "
        f"{coll_us['all_gather']:.1f} us; {time.perf_counter() - t0:.1f} s [{CARD}]")
    if not all(same) or bad:
        raise AssertionError(f"{what}: the mesh ring engine is not the plain one bitwise: "
                             f"tokens {same}, planes {bad[:8]}")
    if m["launches"] != p["launches"]:
        raise AssertionError(f"{what}: the mesh serve launched {m['launches']}, the plain "
                             f"serve {p['launches']}")
    return {"tokens_bitwise": same, "planes_bitwise": not bad, "launches": m["launches"],
            "plain_launches": p["launches"], "decode_median_ms": median,
            "decode_ms": {k: [1e3 * w for w in r["walls"]["decode"]] for k, r in runs.items()},
            "prefill_ms": {k: 1e3 * r["walls"]["prefill"][0] for k, r in runs.items()},
            "step_copies": copies, "collective_host_us": coll_us,
            "param_bytes": {"rank": local, "whole": whole},
            "peak_bytes": {k: r["peak"] for k, r in runs.items()}, "card": CARD,
            "seconds": time.perf_counter() - t0}


def near_tie_rows(torch, model, params, prompts, outs, other, key_report):
    """Rows of `outs` against `other` (two engines' tokens for the same
    prompts): equal, or the first token where they part is a near tie,
    its two candidates within LOGIT_TOL of max|logit| in a teacher-forced
    forward over the shared prefix."""
    equal, gaps = 0, []
    for p, a, b in zip(prompts, outs, other):
        if list(a) == list(b):
            equal += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = torch.as_tensor(list(p) + list(a[:j]), device="cuda")
        row = model.score(params, seq)[-1]
        gaps.append(float((row[int(a[j])] - row[int(b[j])]).abs() / row.abs().max()))
    key_report.update({"equal_rows": equal, "tie_gaps": gaps})
    log(f"{model.cfg.name} dense (ring) against paged engine tokens: {equal}/{len(outs)} rows "
        f"equal; the first differing token of each other row is a near tie of gap "
        f"{[f'{x:.2e}' for x in gaps]} (tolerance {LOGIT_TOL})")
    if any(x > LOGIT_TOL for x in gaps):
        raise AssertionError(f"{model.cfg.name}: dense and paged tokens part beyond a near tie")


def recurrent(torch, report):
    """falcon-mamba-7b (64 Mamba-1 layers) and recurrentgemma-9b (38 layers
    in the pattern rec, rec, attn; int8 ring KV) at full width and depth,
    compressed to SERVED_SPEC on the card layer by layer: the build's
    seconds, stored bytes and peak; the GeMV and GeMM at each model's
    shapes (K 256, N 288 and 256, f32 x) against their plain versions and
    timed; a greedy serve of RECURRENT_BATCH prompts of RECURRENT_PROMPT
    tokens and RECURRENT_NEW new ones through `GenerationEngine`, whose
    `paged="auto"` picks the dense ring engine, with its launches, walls,
    peak and the decode step beside its bytes bound; the same serve on a
    one-rank NCCL mesh beside the plain ring engine, bitwise
    (`ring_on_mesh`), and the kernels at the model's (1, 4) local shard
    shapes (`tp_kernels`, RING14); a profiler split of a decode step; the kernel path against the plain path over
    PATH_LAYERS layers; each token against teacher-forced logits of the
    full-sequence forward (the GeMM and the full scan). Then llama3.2-1b
    with `paged=False` on an int8 ring: the token rule, and its tokens
    against its paged engine's up to a near tie. Returns its kernel
    cases."""
    from repro_torch.serve.engine import GenerationEngine

    t0 = time.perf_counter()
    timer = Timer(torch)
    cases, res = [], {}
    g = torch.Generator().manual_seed(4)
    for arch in RECURRENT + (RING_MODEL,):
        model, params, rec = build_compressed(torch, arch)
        cfg = model.cfg
        prompts = torch.randint(0, cfg.vocab_size, (RECURRENT_BATCH, RECURRENT_PROMPT),
                                generator=g).numpy()
        if arch in RECURRENT:
            check_model_kernels(torch, timer, model, params, cases, ms=RECURRENT_MS,
                                attention=False)
            run = dense_serve(torch, model, params, rec, "serve", prompts)
            outs = run["outs"]
            rec["mesh"] = ring_on_mesh(torch, model, params, prompts, run, f"{arch} ring mesh")
            del run
            t = time.perf_counter()
            tp_kernels(torch, timer, cases, *RING14[arch], RING14_MS, None)
            log(f"{RING14[arch][0]} local shard shapes: {2 * len(RING14[arch][1])} cases in "
                f"{time.perf_counter() - t:.1f} s [{CARD}]")
            profile_dense_step(torch, model, params, rec, "decode_profile")
            compare_dense_paths(torch, model, params, rec, "path_comparison")
        else:
            outs = dense_serve(torch, model, params, rec, "serve", prompts, paged=False)["outs"]
            paged = GenerationEngine(model, params, max_len=RECURRENT_PROMPT + RECURRENT_NEW,
                                     max_slots=RECURRENT_BATCH, decode_chunk=8)
            other = paged.generate(prompts, RECURRENT_NEW)
            del paged
            gc.collect()  # its graphs hold the engine in a cycle
            rec["against_paged"] = {}
            near_tie_rows(torch, model, params, prompts, outs, other, rec["against_paged"])
        teacher_forced(torch, model, params, list(prompts), list(outs), rec,
                       key=f"teacher_forced_{arch}")
        res[arch] = rec
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    del timer
    res["cases"], res["seconds"] = cases, time.perf_counter() - t0
    log(f"recurrent: {res['seconds']:.1f} s")
    report["recurrent"] = res
    return cases


def image_positions(torch, text: int, grid: int):
    """Qwen2-VL's three position streams (3, 1, S) for `text` text tokens,
    one image of a grid x grid patch grid, then `text` more (the paper's
    rule for one image): text tokens have t = h = w = their index; the
    patches share t = `text` and take h = `text` + row, w = `text` +
    column; the text after them resumes at the largest id plus one."""
    before = torch.arange(text).expand(3, text)
    rows = torch.arange(grid).repeat_interleave(grid)
    cols = torch.arange(grid).repeat(grid)
    image = text + torch.stack([torch.zeros_like(rows), rows, cols])
    after = int(image.max()) + 1 + torch.arange(text).expand(3, text)
    return torch.cat([before, image, after], dim=1)[:, None].to(torch.int32).cuda()


def patch_forward(torch, model, params, rec):
    """The cache-free forward on one sequence of IMAGE_TEXT text embeddings
    (rows of `embed`), a IMAGE_GRID x IMAGE_GRID grid of patch embeddings
    (0.02 x standard normal, as the reference's pipeline makes them) and
    IMAGE_TEXT more, in f32, with `image_positions`' three streams: all
    layers' logits finite, and the kernel path against the plain path
    over PATH_LAYERS layers."""
    from repro_torch.models.model import Model

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(14)
    text = lambda: params["embed"][torch.randint(0, cfg.vocab_size, (IMAGE_TEXT,), generator=g,
                                                 device="cuda")].float()
    patches = torch.randn(IMAGE_GRID * IMAGE_GRID, cfg.d_model, generator=g,
                          device="cuda") * 0.02
    embeds = torch.cat([text(), patches, text()])[None]
    pos = image_positions(torch, IMAGE_TEXT, IMAGE_GRID)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, embeds=embeds, positions=pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    del logits
    cut = Model(dataclasses.replace(cfg, n_layers=PATH_LAYERS))
    head = dict(params, layers=params["layers"][:PATH_LAYERS])
    results = {}
    for path in ("kernel", "plain"):
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            lg, _ = cut.forward(head, embeds=embeds, positions=pos)
            results[path] = [lg[0].float()]
    torch.cuda.synchronize()
    s = embeds.shape[1]
    log(f"{cfg.name} patch forward: {IMAGE_TEXT} text + {IMAGE_GRID}x{IMAGE_GRID} patches + "
        f"{IMAGE_TEXT} text = {s} f32 embeddings, streams t/h/w up to "
        f"{pos.max(dim=-1).values.flatten().tolist()}; {cfg.n_layers} layers in {1e3 * wall:.1f} "
        f"ms, logits all finite: {finite}")
    rec["patch_forward"] = {"tokens": s, "wall_ms": 1e3 * wall, "finite": finite}
    report_paths(cut, results, rec, "patch_path_comparison", 0)
    if not finite:
        raise AssertionError(f"{cfg.name}: the patch forward's logits are not finite")


def encoder_pass(torch, model, params, rec, b, s, warm=True):
    """One cache-free forward of the encoder over (b, s) tokens: its wall
    (after one warm call unless `warm` is False), the peak allocation over
    what it found, one
    GeMM per FC matmul (289 at hubert-xlarge's 48 layers) and the pass
    beside its bound: the FC matmuls' 2 M K N plus 4 S^2 Dh H of
    attention a layer and sequence over the bf16 tensor-core rate, or the
    compressed planes and the activations once over the memory rate."""
    from repro_torch.core.compression import CompressedTensor
    from repro_torch.core.decompress import _leaves

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(15)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    if warm:
        model.forward(params, tokens=tokens)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, _ = model.forward(params, tokens=tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(logits).all())
    del logits
    fcs = [x for x in _leaves(params) if isinstance(x, CompressedTensor)]
    fc_flops = sum(2.0 * b * s * x.shape[0] * x.shape[1] for x in fcs)
    attn_flops = cfg.n_layers * b * 4.0 * s * s * cfg.d_head * cfg.n_heads
    moved = sum(x.nbytes for x in fcs) + 2 * b * s * cfg.d_model + 4 * b * s * cfg.vocab_size
    bound, by = bound_ms(moved, fc_flops + attn_flops)
    per = gemvs_per_step(cfg)
    log(f"{cfg.name} encoder pass {b} x {s}: {1e3 * wall:.1f} ms, {b * s / wall:.0f} tokens/s; "
        f"launches {launches} ({per} FC matmuls); peak {peak / 1e9:.3f} GB over the "
        f"{base / 1e9:.3f} GB it found; bound {bound:.2f} ms ({by}: FC {fc_flops / 1e12:.2f} + "
        f"attention {attn_flops / 1e12:.2f} TFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s), "
        f"the pass {wall * 1e3 / bound:.1f}x it; logits finite {finite}")
    rec[f"pass_{b}x{s}"] = {"wall_ms": 1e3 * wall, "launches": launches, "peak_extra_bytes": peak,
                            "fc_tflop": fc_flops / 1e12, "attention_tflop": attn_flops / 1e12,
                            "bound_ms": bound, "bound_by": by, "finite": finite}
    if launches["deca_gemm"] != per or launches["deca_gemv"] or not finite:
        raise AssertionError(f"{cfg.name} {b} x {s}: launches {launches}, not {per} GeMMs "
                             f"and no GeMV, or logits not finite ({finite})")


def encoder_checks(torch, model, params, rec):
    """The encoder at 4 x 1024: its first PATH_LAYERS layers' logits on the
    kernel path against the plain path, and bidirectionality: changing the
    last token of each row changes position 0's logits."""
    from repro_torch.models.model import Model

    cfg = model.cfg
    b, s = AUDIO_PASSES[0]
    g = torch.Generator(device="cuda").manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    cut = Model(dataclasses.replace(cfg, n_layers=PATH_LAYERS))
    head = dict(params, layers=params["layers"][:PATH_LAYERS])
    results = {}
    for path in ("kernel", "plain"):
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            results[path] = [cut.forward(head, tokens=tokens)[0].float()]
    report_paths(cut, results, rec, "path_comparison", 0)
    other = tokens.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab_size
    first = model.forward(params, tokens=tokens)[0][:, 0]
    moved = (model.forward(params, tokens=other)[0][:, 0] - first).abs().amax(dim=-1)
    rec["bidirectional_first_row_change"] = moved.tolist()
    log(f"{cfg.name} bidirectional: changing each row's last token (position {s - 1}) moves "
        f"position 0's logits by {[f'{x:.3e}' for x in moved.tolist()]} (max abs)")
    if not bool((moved > 0).all()):
        raise AssertionError(f"{cfg.name}: position 0 does not see the last token")


def audio_serve(torch, model, params, rec):
    """hubert-xlarge through the paged engine, as the reference serves it:
    AUDIO_BATCH prompts of AUDIO_PROMPT tokens (whole pages, one prefill
    of AUDIO_BATCH rows: no pad row), AUDIO_NEW new each; each decode step
    one GeMV per FC matmul and the attention kernel at Dh 80, G 1,
    causal=0 in every layer; each captured graph's replay against the
    uncaptured chunk, bitwise, and a replay's wall and breakdown alone;
    and the attention kernel on the served pool
    (the last chunk's tables and lengths) against its plain version."""
    from repro_torch.kernels import paged_attention, ref
    from repro_torch.serve.engine import GenerationEngine

    cfg = model.cfg
    eng = GenerationEngine(model, params, kv_quant=SERVED_KV, max_slots=AUDIO_BATCH,
                           block_size=32, max_len=256, decode_chunk=8)
    g = torch.Generator().manual_seed(17)
    prompts = [torch.randint(0, cfg.vocab_size, (AUDIO_PROMPT,), generator=g).numpy()
               for _ in range(AUDIO_BATCH)]
    last = {}
    inner = eng.scheduler._decode_chunk

    def chunk(*a):
        last["tables"], last["kv_lens"] = a[1], a[6]
        return inner(*a)

    eng.scheduler._decode_chunk = chunk
    outs, run = serve_waves(torch, eng, [prompts], AUDIO_NEW)
    launches = run["launches"]
    steps = launches["deca_paged_attention"] // cfg.n_layers  # one call a layer a step
    per = gemvs_per_step(cfg)
    log(f"{cfg.name} paged serve: prompts {[len(p) for p in prompts]} x {AUDIO_NEW} new in "
        f"{run['wall_s']:.2f} s; prefill "
        + ", ".join(f"{c['rows']}x{c['span']} {1e3 * c['wall_s']:.1f} ms" for c in run["prefills"])
        + f"; {steps} decode steps; launches {launches} ({per} GeMVs and {cfg.n_layers} "
        f"bidirectional attention calls a step)")
    rec["serve"] = {"prompt_lens": [len(p) for p in prompts], "wall_s": run["wall_s"],
                    "prefills": run["prefills"], "chunks": run["chunks"],
                    "launches": launches, "decode_steps": steps,
                    "graphs": graph_costs(eng._chunk_graphs, run["chunks"], f"{cfg.name} decode")}
    if any(len(o) != AUDIO_NEW or not all(0 <= int(t) < cfg.vocab_size for t in o)
           for o in outs):
        raise AssertionError(f"{cfg.name}: a request did not emit {AUDIO_NEW} tokens in the vocab")
    if (launches["deca_gemv"] != per * steps or steps < AUDIO_NEW - 1
            or launches["deca_gemm"] != per * len(run["prefills"])):
        raise AssertionError(f"{cfg.name}: launches {launches} for {steps} steps")
    if any(c["rows"] != AUDIO_BATCH for c in run["prefills"]):
        raise AssertionError(f"{cfg.name}: a prefill call padded its rows")
    check_replays(torch, eng, eng._chunk_graphs, f"{cfg.name} decode chunk", rec)
    profile_replays(torch, eng._chunk_graphs, f"{cfg.name} decode chunk", rec)
    tables = torch.as_tensor(last["tables"], device="cuda").to(torch.int32)
    kv_lens = torch.as_tensor(last["kv_lens"][-1], device="cuda").to(torch.int32)
    q = torch.randn(AUDIO_BATCH, cfg.n_heads, cfg.d_head,
                    generator=torch.Generator(device="cuda").manual_seed(18), device="cuda")
    args = (q, eng.kv.pools[0], tables, kv_lens, kv_lens // 3)
    got = paged_attention.paged_attention(*args, quant=SERVED_KV, causal=False)
    want = ref.paged_decode_attention(*args, quant=SERVED_KV, causal=False)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    rec["served_pool_attention"] = {"max_abs_err": err, "rel_err": rel}
    log(f"{cfg.name} attention kernel (Dh {cfg.d_head}, G 1, causal=0) on the served pool's "
        f"layer 0 (KV lengths {kv_lens.tolist()}): rel err {rel:.2e} against its plain "
        f"version (tolerance {KERNEL_TOL})")
    del eng
    gc.collect()
    if rel > KERNEL_TOL:
        raise AssertionError(f"{cfg.name}: attention on the served pool disagrees: {rel}")
    return {"kernel": "attention", "model": cfg.name, "role": "served pool causal=0",
            "max_abs_err": err, "rel_err": rel}


def vlm_audio(torch, report):
    """qwen2-vl-7b (M-RoPE over three streams, 28 q / 4 kv heads: G 7) and
    hubert-xlarge (a bidirectional encoder) at full width and depth,
    compressed to SERVED_SPEC on the card layer by layer. qwen2-vl: its
    kernels at its shapes (M in VLM_MS), 4 requests of seeded lengths
    served greedily through captured graphs (197 GeMVs and 28 attention
    calls at G 7 a step, 197 GeMMs a prefill call, replays bitwise, every
    token against teacher-forced logits of `score` with M-RoPE), the kernel
    path against the plain path over PATH_LAYERS layers, a spec engine
    (nf4 draft, k = 3) at full depth, and the patch-embedding forward with
    an image's three streams. hubert-xlarge: its GeMV and GeMM at M in
    AUDIO_MS (the served decode rows and the passes; lm_head N = 504 on
    the GeMM's direct path) and attention at Dh 80, G 1,
    causal=0; encoder passes at AUDIO_PASSES; the kernel path against the
    plain path and bidirectionality at 4 x 1024; the paged serve.
    Returns its kernel cases."""
    import numpy as np

    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    timer = Timer(torch)
    cases, res = [], {}

    model, params, rec = build_compressed(torch, VLM)
    check_model_kernels(torch, timer, model, params, cases, ms=VLM_MS)
    no_dense_lm_head(torch, model.cfg, params, rec)
    rec["serves"] = serve_paper_model(torch, model, params, report, (4,), check_all=True)
    served = rec["serves"]["batch 4"]
    per = gemvs_per_step(model.cfg)
    if served["launches"]["deca_gemm"] != per * len(served["prefills"]):
        raise AssertionError(f"{VLM}: {served['launches']['deca_gemm']} GeMMs over "
                             f"{len(served['prefills'])} prefill calls, not {per} a call")
    cut = Model(dataclasses.replace(model.cfg, n_layers=PATH_LAYERS))
    compare_paths(torch, cut, dict(params, layers=params["layers"][:PATH_LAYERS]), rec)
    spec_eng, _, _ = serve_spec(torch, model, params,
                                [np.asarray(p, np.int32) for p in served["prompts"]],
                                served["outs"], rec)
    del spec_eng
    gc.collect()
    patch_forward(torch, model, params, rec)
    res[VLM] = rec
    del model, params, cut
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{VLM} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    model, params, rec = build_compressed(torch, AUDIO)
    check_model_kernels(torch, timer, model, params, cases, ms=AUDIO_MS)
    del timer
    for i, (b, s) in enumerate(AUDIO_PASSES):  # the first pass warms the second's path
        encoder_pass(torch, model, params, rec, b, s, warm=i == 0)
    encoder_checks(torch, model, params, rec)
    cases.append(audio_serve(torch, model, params, rec))
    res[AUDIO] = rec
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    res["cases"], res["seconds"] = cases, time.perf_counter() - t0
    log(f"vlm_audio: {res['seconds']:.1f} s; freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    report["vlm_audio"] = res
    return cases


class GradTap:
    """An optimizer that keeps a host copy of the grads it is handed, then
    updates as `opt` does."""

    def __init__(self, opt):
        self.opt = opt
        self.grads = None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, step):
        from repro_torch.checkpoint.ckpt import flatten

        self.grads = {k: v.float().cpu() for k, v in flatten(grads).items()}
        return self.opt.update(grads, state, params, step)


def train_card_vs_cpu(torch, rec):
    """(a) One AdamW step of llama3.2-1b smoke on the card and on the CPU
    from the same params and batch: the loss within TRAIN_LOSS_RTOL, each
    gradient leaf within TRAIN_GRAD_SHARE of its largest magnitude, and the
    updated params: AdamW's first step moves each by lr times the sign of
    its gradient, so an element whose tiny gradient changes sign lands 2 lr
    away; at most TRAIN_PARAM_SHARE of the elements may differ by more than
    a bf16 ulp of themselves, none by more than 2 lr and an ulp."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import AdamW, tree_map
    from repro_torch.train.trainer import device_batch, make_train_step

    cfg = get_smoke_config(TRAIN_MODEL)
    model = Model(cfg)
    start = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticPipeline(cfg, ShapeConfig("t", "train", 64, 4), seed=1).batch(0)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda p: p.to(dev, copy=True), start)
        tap = GradTap(AdamW(lr=TRAIN_SMOKE_LR))
        params, _, m = make_train_step(model, tap)(params, tap.init(params),
                                                  device_batch(batch, dev), 0)
        runs[dev] = (float(m["loss"]), tap.grads,
                     {k: v.float().cpu() for k, v in flatten(params).items()})
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_share = max(float((g_card[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                     for k, g in g_cpu.items())
    n = apart = 0
    worst = 0.0
    for k, p in p_cpu.items():
        d = (p_card[k] - p).abs()
        ulp = p.abs().clamp(min=1e-30) * 2.0 ** -8
        apart += int((d > ulp).sum())
        n += d.numel()
        worst = max(worst, float((d - ulp).max()) / TRAIN_SMOKE_LR)
    rec["card_vs_cpu"] = {"loss_cpu": l_cpu, "loss_card": l_card, "loss_rel": loss_rel,
                          "grad_share": grad_share, "params_apart": apart, "params": n,
                          "worst_over_ulp_in_lr": worst}
    log(f"train (a) card vs CPU, {TRAIN_MODEL} smoke, one AdamW step at 4 x 64: loss "
        f"{l_card:.6f} / {l_cpu:.6f} (rel {loss_rel:.3e}, limit {TRAIN_LOSS_RTOL}); worst "
        f"gradient leaf {grad_share:.3e} of its largest magnitude (limit {TRAIN_GRAD_SHARE}); "
        f"params more than a bf16 ulp apart: {apart} of {n}; the worst beyond an ulp "
        f"{worst:.3f} lr (limit 2)")
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_share <= TRAIN_GRAD_SHARE
            and apart <= TRAIN_PARAM_SHARE * n and worst <= 2.0 + 1e-3):
        raise AssertionError(f"train (a): the card's step departs from the CPU's: "
                             f"{rec['card_vs_cpu']}")


def train_restart(torch, rec):
    """(b) llama3.2-1b smoke through `ResilientTrainer` on the card under
    `torch.use_deterministic_algorithms(True)`: a crash at step 6, after the
    step-4 checkpoint, resumed, must end with params and AdamW state
    bitwise the uninterrupted run's, and the same losses. The checkpoints
    are written under chiprun_out/train_ckpt and removed after."""
    import os
    import shutil

    from repro_torch.checkpoint.ckpt import Checkpointer, flatten
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.dist.fault import FaultInjector, ResilientTrainer
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import AdamW
    from repro_torch.train.trainer import make_train_step

    cfg = get_smoke_config(TRAIN_MODEL)
    model = Model(cfg)
    opt = AdamW(lr=TRAIN_SMOKE_LR)
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", 64, 4), seed=5)

    def init_fn():
        params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        return params, opt.init(params)

    root = OUT / "train_ckpt"
    # cuBLAS is deterministic with a fixed workspace; torch asks for it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    try:
        runs = []
        for name, inj in (("uninterrupted", None), ("crash_at_6", FaultInjector(plan={6: "crash"}))):
            tr = ResilientTrainer(model, lambda: make_train_step(model, opt), pipe,
                                  Checkpointer(str(root / name), async_save=False),
                                  checkpoint_every=4, injector=inj)
            params, state = tr.run(init_fn, 10)
            runs.append((tr, flatten({"params": params, "opt_state": state})))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    (ref, want), (tr, got) = runs
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    rec["restart"] = {"restarts": tr.restarts, "leaves": len(want), "leaves_differ": differ,
                      "losses": [m["loss"] for _, m in tr.history],
                      "history_equal": tr.history == ref.history,
                      "seconds": time.perf_counter() - t0}
    log(f"train (b) restart on the card, {TRAIN_MODEL} smoke, deterministic algorithms: "
        f"{tr.restarts} restart after a crash at step 6; {len(want) - len(differ)} of "
        f"{len(want)} leaves (params and AdamW state) bitwise the uninterrupted run's; "
        f"history equal: {rec['restart']['history_equal']}; "
        f"{rec['restart']['seconds']:.1f} s")
    if tr.restarts != 1 or differ or not rec["restart"]["history_equal"]:
        raise AssertionError(f"train (b): the restarted run is not the uninterrupted one's: "
                             f"{differ[:8]}")


def profile_train_step(torch, step_fn, params, state, batch, step, rec):
    """One more train step traced with torch.profiler, events around it:
    the kernels' device time by group (GEMMs, softmax, reductions, the
    rest: elementwise and copies) and the idle share of its wall. Returns
    (params, state)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        params, state, m = step_fn(params, state, batch, step)
        b.record()
        b.synchronize()
    wall = a.elapsed_time(b)
    rows = sorted(({"name": e.key, "device_ms": e.self_device_time_total / 1e3, "count": e.count}
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("aten::")), key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups = {"gemm": ("gemm", "nvjet", "cutlass", "xmma"), "softmax": ("softmax",),
              "reduce": ("reduce",)}
    split = {}
    for r in rows:
        name = r["name"].lower()
        g = next((k for k, v in groups.items() if any(t in name for t in v)), "other")
        split[g] = split.get(g, 0.0) + r["device_ms"]
    kernels = sum(r["count"] for r in rows)
    rec["profile"] = {"wall_ms": wall, "busy_ms": busy, "split_ms": split, "kernels": kernels,
                      "loss": float(m["loss"]), "rows": rows[:30]}
    log(f"  one traced step: {wall:.1f} ms; device busy {busy:.1f} ms ("
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"), {kernels} kernels; idle share {1 - busy / wall:.3f}")
    for r in rows[:8]:
        log(f"  {r['device_ms']:9.2f} ms {r['count']:6d}x  {r['name'][:90]}")
    return params, state


class RoundTripLog:
    """While installed, `dist.grad_compression._codec_roundtrip` runs
    between CUDA events (its device time a call) and, on the calls of
    `keep` (indices from the first), keeps device copies of its input and
    output (no host sync inside the step)."""

    def __init__(self, torch, gc_mod, keep):
        self.torch, self.mod, self.keep = torch, gc_mod, set(keep)
        self.events, self.kept, self.orig = [], {}, None

    def __enter__(self):
        self.orig = self.mod._codec_roundtrip
        self.mod._codec_roundtrip = self
        return self

    def __exit__(self, *exc):
        self.mod._codec_roundtrip = self.orig

    def __call__(self, x, codec, group):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.orig(x, codec, group)
        ev[1].record()
        if len(self.events) in self.keep:
            self.kept[len(self.events)] = (x.clone(), out.clone())
        self.events.append(ev)
        return out

    def device_ms(self, first, count) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[first:first + count])


def roundtrip_order(params, group=128) -> list:
    """The round trips of one compressed all-reduce over a layer stack, in
    order (`make_compressed_allreduce(layer_stack > 1)`): the top-level
    leaves, then each layer path across the layers, one call a layer, or
    one call for the path's stack ("layers/*/<path>") where its leaves are
    no multiple of the group."""
    from repro_torch.checkpoint.ckpt import flatten

    top = list(flatten({k: v for k, v in params.items() if k != "layers"}))
    calls = []
    for path, leaf in flatten(params["layers"][0]).items():
        if leaf.numel() % group:
            calls.append(f"layers/*/{path}")
        else:
            calls += [f"layers/{i}/{path}" for i in range(len(params["layers"]))]
    return top + calls


def train_compressed(torch, model, pipe, lr, full, rec):
    """(e) (c)'s model, seed, batch and schedule for TRAIN_DIST_STEPS steps
    of `train_loop` with int8 gradient compression over a one-rank NCCL
    mesh (`make_test_mesh(1, 1)`); each loss beside (c)'s, the step wall
    beside (c)'s median, the round trip's device time a step, the err
    state's bytes and the peak memory. For TRAIN_DIST_SAMPLES at the last
    step, the card's sent payload against the CPU port's round trip of the
    same g + err (bitwise), and each group's largest |err| against half
    its quantization step. Then one more int8 step traced by the profiler
    (`profile_train_step`), one bf8 step, and the params placed by
    `shard_params` on the mesh: each local shard is the whole leaf,
    bitwise. The process group is destroyed before it returns."""
    import socket
    import statistics

    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.core.codecs import get_codec
    from repro_torch.dist import grad_compression as gc_mod
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.optimizers import make_optimizer, tree_map
    from repro_torch.train.trainer import device_batch, make_train_step, train_loop

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        opt = make_optimizer(model.cfg.optimizer, lr=lr)
        state = opt.init(params)
        order = roundtrip_order(params)
        n = len(order)
        last = (TRAIN_DIST_STEPS - 1) * n
        keep = {last + order.index(k): k for k in TRAIN_DIST_SAMPLES}
        step_fn = make_train_step(model, opt, remat=True, grad_compression="int8", mesh=mesh)
        for fn in counters().values():
            fn.launches = 0
        with RoundTripLog(torch, gc_mod, keep) as rt:
            params, state, hist = train_loop(model, params, state, pipe,
                                             n_steps=TRAIN_DIST_STEPS, train_step=step_fn,
                                             grad_compression="int8", mesh=mesh)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters().items()}
        peak = torch.cuda.max_memory_allocated() - base
        if any(launches.values()):
            raise AssertionError(f"train (e): the dense training path launched a DECA kernel: "
                                 f"{launches}")
        if len(rt.events) != TRAIN_DIST_STEPS * n:
            raise AssertionError(f"train (e): {len(rt.events)} round trips for "
                                 f"{TRAIN_DIST_STEPS} steps of {n} leaves")
        rt_ms = [rt.device_ms(i * n, n) for i in range(TRAIN_DIST_STEPS)]
        losses = [m["loss"] for _, m, _ in hist]
        secs = [dt for _, _, dt in hist]
        err_bytes = 4 * sum(t.numel() for t in flatten(params).values())
        codec = get_codec("int8")
        samples = {}
        for idx, key in keep.items():
            comp, sent_card = (t.cpu() for t in rt.kept.pop(idx))
            sent_cpu = gc_mod._codec_roundtrip(comp, codec, 128)
            flat = comp.reshape(-1)
            pad = (-flat.numel()) % 128
            groups = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, 128)
            _, scales = codec.kv_encode(groups)
            half = scales.float() / 2  # half a quantization step a group
            err = torch.nn.functional.pad((comp - sent_card).reshape(-1), (0, pad))
            worst = err.reshape(-1, 128).abs().amax(dim=1)
            ratio = float((worst / half.clamp(min=1e-30)).max())
            if tuple(comp.shape) != tuple(flatten(params)[key].shape):
                raise AssertionError(f"train (e): round trip {idx} is not {key}'s")
            samples[key] = {"shape": list(comp.shape),
                            "bitwise": bool(torch.equal(sent_card.view(torch.int32),
                                                        sent_cpu.view(torch.int32))),
                            "worst_err_over_half_step": ratio,
                            "zero_groups_exact": bool((worst[half == 0] == 0).all())}
        res = {"steps": TRAIN_DIST_STEPS, "losses": losses, "step_s": secs,
               "median_step_s": statistics.median(secs[1:]), "roundtrip_device_ms": rt_ms,
               "err_bytes": err_bytes, "peak_bytes": peak, "samples": samples,
               "launches": launches,
               "plain_losses": full["losses"][:TRAIN_DIST_STEPS],
               "plain_median_step_s": full["median_step_s"]}
        log(f"train (e) {TRAIN_MODEL} full width, int8 gradient compression on a one-rank "
            f"NCCL mesh (1, 1), {TRAIN_DIST_STEPS} steps of (c)'s batch and schedule:")
        log("  loss by step: " + ", ".join(f"{x:.4f}" for x in losses) + " (c): "
            + ", ".join(f"{x:.4f}" for x in res["plain_losses"]))
        log(f"  step walls {', '.join(f'{x:.3f}' for x in secs)} s (the first opens NCCL's "
            f"communicators), median after the first {res['median_step_s']:.3f} s against "
            f"(c)'s {full['median_step_s']:.3f} s; the "
            f"round trip {', '.join(f'{x:.1f}' for x in rt_ms)} ms of device time a step over "
            f"{n} leaves; err state {err_bytes / 1e9:.2f} GB f32; peak allocated "
            f"{peak / 1e9:.2f} GB; kernel launches {launches}")
        for key, v in samples.items():
            log(f"  {key} {v['shape']}: sent bitwise the CPU port's: {v['bitwise']}; largest "
                f"|err| of a group / half its step: {v['worst_err_over_half_step']:.6f}")
        bad = [k for k, v in samples.items() if not v["bitwise"]
               or v["worst_err_over_half_step"] > 1.0 + HALF_STEP_SLACK
               or not v["zero_groups_exact"]]
        if bad or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train (e): losses {losses}, samples off: {bad}")

        # one more int8 step traced (err from zeros): its device time by
        # group and idle share beside (c)'s traced step
        err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        traced = lambda p, st, b, i: step_fn(p, st, b, i, err)[:3]
        params, state = profile_train_step(torch, traced, params, state,
                                           device_batch(pipe.batch(TRAIN_DIST_STEPS), "cuda"),
                                           TRAIN_DIST_STEPS, res)
        del err, traced

        bf8 = make_train_step(model, opt, remat=True, grad_compression="bf8", mesh=mesh)
        t1 = time.perf_counter()
        params, state, hist = train_loop(model, params, state, pipe, n_steps=1,
                                         start_step=TRAIN_DIST_STEPS + 1, train_step=bf8,
                                         grad_compression="bf8", mesh=mesh)
        res["bf8"] = {"loss": hist[0][1]["loss"], "step_s": time.perf_counter() - t1}
        log(f"  one bf8 step: loss {res['bf8']['loss']:.4f}, {res['bf8']['step_s']:.3f} s")
        if not math.isfinite(res["bf8"]["loss"]):
            raise AssertionError(f"train (e): bf8 loss {res['bf8']['loss']}")
        del state, opt
        gc.collect()
        torch.cuda.empty_cache()

        placed = sh.shard_params(params, sh.ShardingCtx(mesh))
        whole = [torch.equal(d.to_local(), p) for d, p in
                 zip(flatten(placed).values(), flatten(params).values())]
        res["shard_params"] = {"leaves": len(whole), "whole_bitwise": sum(whole)}
        log(f"  shard_params on the (1, 1) mesh: {sum(whole)} of {len(whole)} local shards "
            f"are their whole leaf, bitwise")
        if not all(whole):
            raise AssertionError("train (e): a local shard on a (1, 1) mesh is not its leaf")
        del placed, params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"train (e): {res['seconds']:.1f} s")
    rec["compressed"] = res


def state_bytes(tree) -> int:
    from repro_torch.checkpoint.ckpt import flatten

    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def train(torch, report):
    """Training on the card. (a) one AdamW step of llama3.2-1b smoke on the
    card against the CPU; (b) the crash-and-restart through
    `ResilientTrainer`, bitwise under deterministic algorithms; (c)
    llama3.2-1b at full width and depth (16 layers, d 2048, 32 / 8 heads,
    d_ff 8192, vocab 128256, tied head, dense bf16) trained TRAIN_STEPS
    steps through `train_loop` on TRAIN_BATCH x 4096 tokens with remat and
    cfg.optimizer (AdamW): each step's loss, the median step after the
    first, tokens/s, 6 N T model FLOPs (attention not counted) against the
    bf16 peak, peak memory, and no launch of the four kernels (a dense tree
    multiplies through torch.matmul, as the reference's einsums), then one
    more step traced by the profiler; (d) one Adafactor step of the same
    model, its state bytes against AdamW's; (e) `train_compressed`. A
    full-width checkpoint would be ~17 GB, so (b) stays at smoke size."""
    import functools
    import statistics

    from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
    from repro_torch.train.trainer import device_batch, make_train_step, train_loop

    t0 = time.perf_counter()
    rec = {}
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    train_card_vs_cpu(torch, rec)
    train_restart(torch, rec)

    # (c) full width and depth
    cfg = get_config(TRAIN_MODEL)
    model = Model(cfg)
    shape = SHAPES["train_4k"]
    pipe = SyntheticPipeline(cfg, ShapeConfig("train_4k_one_card", "train", shape.seq_len,
                                              TRAIN_BATCH), seed=0)
    lr = functools.partial(warmup_cosine, peak_lr=TRAIN_PEAK_LR, warmup=TRAIN_WARMUP,
                           total=TRAIN_STEPS)
    opt = make_optimizer(cfg.optimizer, lr=lr)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    state = opt.init(params)
    torch.cuda.synchronize()
    p_bytes, adamw_bytes = state_bytes(params), state_bytes(state)
    for fn in counters().values():
        fn.launches = 0
    step_fn = make_train_step(model, opt, remat=True)
    params, state, hist = train_loop(model, params, state, pipe, n_steps=TRAIN_STEPS,
                                     train_step=step_fn)
    launches = {k: fn.launches for k, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated() - base
    losses = [m["loss"] for _, m, _ in hist]
    secs = [dt for _, _, dt in hist]
    step_s = statistics.median(secs[1:])
    tokens = TRAIN_BATCH * shape.seq_len
    n_params = cfg.param_count()
    flops = 6 * n_params * tokens
    full = {"batch": TRAIN_BATCH, "seq": shape.seq_len, "steps": TRAIN_STEPS,
            "losses": losses, "step_s": secs, "median_step_s": step_s,
            "tokens_per_s": tokens / step_s, "model_flops": flops,
            "flop_share": flops / step_s / BF16_FLOP_PER_S, "peak_bytes": peak,
            "param_bytes": p_bytes, "adamw_state_bytes": adamw_bytes, "launches": launches,
            "metrics": [m for _, m, _ in hist]}
    rec["full"] = full
    log(f"train (c) {TRAIN_MODEL} full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, tied; {n_params / 1e9:.3f} B params, {p_bytes / 1e9:.2f} GB bf16, "
        f"AdamW state {adamw_bytes / 1e9:.2f} GB) at {TRAIN_BATCH} x {shape.seq_len} tokens "
        f"(train_4k's global batch {shape.global_batch} cut to {TRAIN_BATCH}), remat, "
        f"{cfg.optimizer}:")
    log("  loss by step: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"  step walls {', '.join(f'{x:.3f}' for x in secs)} s; median after the first "
        f"{step_s:.3f} s = {tokens / step_s:.0f} tokens/s; 6 N T = {flops / 1e12:.1f} TFLOP a "
        f"step (attention FLOPs not counted) = {flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{100 * full['flop_share']:.1f} % of the bf16 peak {BF16_FLOP_PER_S / 1e12:.0f}; "
        f"peak allocated {peak / 1e9:.2f} GB over what the phase found; kernel launches "
        f"{launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train (c): the loss is not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"train (c): the dense training path launched a DECA kernel: "
                             f"{launches}")
    params, state = profile_train_step(torch, step_fn, params, state,
                                       device_batch(pipe.batch(TRAIN_STEPS), "cuda"),
                                       TRAIN_STEPS, full)

    # (d) one Adafactor step of the same model
    del state, opt
    gc.collect()
    torch.cuda.empty_cache()
    ada = make_optimizer("adafactor", lr=lr, stacked=model.layer_stack > 1)
    a_state = ada.init(params)
    ada_bytes = state_bytes(a_state)
    probe = params["layers"][0]["mlp"]["w_up"].clone()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, a_state, m = make_train_step(model, ada)(
        params, a_state, device_batch(pipe.batch(TRAIN_STEPS + 1), "cuda"), TRAIN_STEPS + 1)
    loss = float(m["loss"])
    ada_s = time.perf_counter() - t1
    moved = not torch.equal(probe, params["layers"][0]["mlp"]["w_up"])
    rec["adafactor"] = {"state_bytes": ada_bytes, "adamw_state_bytes": adamw_bytes,
                        "loss": loss, "step_s": ada_s, "moved": moved}
    log(f"train (d) one Adafactor step (stacked over {model.layer_stack} layers): loss "
        f"{loss:.4f}, {ada_s:.3f} s; state {ada_bytes / 1e6:.1f} MB against AdamW's "
        f"{adamw_bytes / 1e9:.2f} GB ({adamw_bytes / ada_bytes:.0f}x)")
    if not math.isfinite(loss) or not moved:
        raise AssertionError(f"train (d): loss {loss}, params moved: {moved}")
    del params, a_state, probe
    gc.collect()
    torch.cuda.empty_cache()

    # (e) int8 gradient compression on a one-rank NCCL mesh
    train_compressed(torch, model, pipe, lr, full, rec)
    rec["seconds"] = time.perf_counter() - t0
    log(f"train: {rec['seconds']:.1f} s")
    report["train"] = rec


def paper_models(torch, report):
    """The paper's two end-to-end models (Table 4) at full width and depth
    on one card, compressed to SERVED_SPEC, then a tied head: each built,
    its kernels held at its shapes, served, and its kernel path held
    against the plain path over its first PATH_LAYERS layers."""
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    timer = Timer(torch)
    res, cases = {}, []
    for arch in PAPER_MODELS + (TIED_MODEL,):
        model, params, rec = build_compressed(torch, arch)
        cfg = model.cfg
        check_model_kernels(torch, timer, model, params, cases)
        if cfg.tie_embeddings:
            check_tied_head(torch, model, params, rec)
            log(f"{arch}: lm_head no-dense-weight check skipped: the tied head is the dense "
                f"embed table, which the reference keeps dense by design "
                f"(src/repro/core/decompress.py:61, _SKIP)")
        else:
            no_dense_lm_head(torch, cfg, params, rec)
        rec["serves"] = serve_paper_model(
            torch, model, params, report, (4,) if cfg.tie_embeddings else (4, 1))
        cut = Model(dataclasses.replace(cfg, n_layers=PATH_LAYERS))
        compare_paths(torch, cut, dict(params, layers=params["layers"][:PATH_LAYERS]), rec)
        res[arch] = rec
        del model, params, cut
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    del timer
    res["cases"], res["seconds"] = cases, time.perf_counter() - t0
    log(f"paper_models: {res['seconds']:.1f} s")
    report["paper_models"] = res
    return cases


def phase_alone(phase, record: str) -> int:
    """One phase of this script alone on one card (`tools/paper_models.py`,
    `tools/moe_serve.py`): the card's name and power limit, the kernels'
    build (a no-op when they are built), then `phase(torch, report)`, whose
    record goes to chiprun_out/<record>.json. Non-zero without a card."""
    import torch

    if not torch.cuda.is_available():
        print(f"{record}: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global HBM_BYTES_PER_S, BF16_FLOP_PER_S
    from repro_torch.core import roofsurface as rs
    from repro_torch.kernels import cuda

    HBM_BYTES_PER_S, BF16_FLOP_PER_S = rs.H100_SXM.mbw, rs.H100_SXM.peak_flops
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda.build()
    log(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    report = {}
    try:
        phase(torch, report)
    finally:
        (OUT / f"{record}.json").write_text(json.dumps(report, indent=1, default=str))
    return 0


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
    global HBM_BYTES_PER_S, BF16_FLOP_PER_S
    from repro_torch.core import roofsurface as rs

    # the kernel bounds and RoofLens read one set of constants
    HBM_BYTES_PER_S, BF16_FLOP_PER_S = rs.H100_SXM.mbw, rs.H100_SXM.peak_flops
    from repro_torch.configs.base import get_config
    from repro_torch.core.decompress import compressed_bytes
    from repro_torch.core.formats import get_spec
    from repro_torch.kernels import cuda
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
    global CARD
    CARD = smi
    if smi.split(",")[0].strip() != H100_NAME:
        log(f"warning: the card is not an {H100_NAME}; the roofline bounds and RoofLens "
            f"use the H100 SXM profile ({rs.H100_SXM}), which is not this card's")
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    report["card"] = {"nvidia_smi": smi, "name": kind}
    served = get_spec(SERVED_SPEC)
    bord = rs.bord_regions(rs.H100_SXM)
    points = {"software": rs.evaluate(served, rs.H100_SXM),
              "deca_32_8": rs.evaluate(served, rs.H100_SXM, ai_xv=rs.deca_ai_xv(served))}
    log(f"analytic, not measured (Roof-Surface on {rs.H100_SXM.name}): BORD lines " + ", ".join(
        f"{k} {v:.4g}" for k, v in bord.items()) + f"; {SERVED_SPEC} weights at batch 4: " +
        "; ".join(f"{k} AI_XM {p.ai_xm:.4g}, AI_XV {p.ai_xv:.4g}, {p.bound}-bound, "
                  f"{p.flops / 1e12:.2f} TFLOP/s" for k, p in points.items()))
    report["analytic"] = {"bord_regions": bord, "served_spec": {
        k: dataclasses.asdict(p) for k, p in points.items()}}

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
    new_cases = check_new_shapes(torch, timer, report)
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
    if launches["deca_gemv"] != gemvs_per_step(cfg) * steps_run:
        raise AssertionError("the decode steps did not launch a GeMV per FC matmul")
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
    no_dense_lm_head(torch, cfg, params, report)

    plain_outs = [done[r] for r in rids[:4]]
    plain = {"outs": [done[r] for r in rids], "launches": dict(launches),
             "host_syncs": st["host_syncs"], "replayed_ms_per_device_step": replay_ms}
    del eng, sched, done
    torch.cuda.empty_cache()

    # 5b. the single-step loop (decode_chunk=1) on the same weights and
    # traffic, then the example twins
    single_step(torch, model, params, prompts, plain, report)

    # 6. self-speculative decode on the same weights
    spec_eng, spec_launches, spec_outs = serve_spec(torch, model, params, prompts[:4],
                                                    plain_outs, report)
    profile_serving(torch, spec_eng, [p[:512] for p in prompts[:4]], report, "spec_profile")
    del spec_eng
    torch.cuda.empty_cache()

    # 7. keyed temperature sampling, on the card inside the captured graphs
    sampler_time(torch, report)
    serve_temperature(torch, model, params, prompts[:4], report)

    # 8. the multi-tenant prefix cache and copy-on-write clones
    prefix_serve(torch, model, params, report)

    # 9. a long prompt prefilled whole and in chunks while others decode
    chunked_prefill(torch, model, params, report)

    # 10. the serving path observed: metrics, tracer, RoofLens, SLA-sized chunks
    observed_serve(torch, model, params, prompts, plain, spec_outs, report)

    # 11. overload: the ladder down to park, chaos, the SLO gates, the host tier
    overload_serve(torch, model, params, prompts, report)

    # 12. a snapshot in mid-serve, restored into a fresh engine
    snapshot_serve(torch, model, params, prompts, report)

    # 12b. sharded serving on a one-rank NCCL mesh; the kernels at
    # llama2-70b's local shard shapes on a (1, 4) mesh
    mesh_cases = mesh_serve(torch, model, params, prompts, report)

    # 13. the paper's two models at full width and depth, then a tied head
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"llama3-8b freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    paper_cases = paper_models(torch, report)

    # 14. gemma2-2b: local and global layers, Dh 256, geglu, softcaps
    gemma_cases = gemma2(torch, report)

    # 15. grok-1-314b: top-2 of 8 experts, 8 of its 64 layers at full width
    moe_cases = moe(torch, report)

    # 16. the dense ring engine: falcon-mamba-7b, recurrentgemma-9b, llama3.2-1b
    recurrent_cases = recurrent(torch, report)

    # 17. M-RoPE and patch embeddings (qwen2-vl-7b), the bidirectional encoder
    # (hubert-xlarge)
    vlm_audio_cases = vlm_audio(torch, report)

    # 18. training: llama3.2-1b at full width and depth, card against CPU,
    # the restart on the card, one Adafactor step
    train(torch, report)

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
    held = (mm_cases + att_cases + new_cases + paper_cases + gemma_cases + moe_cases
            + recurrent_cases + vlm_audio_cases + mesh_cases)
    worst_abs = {  # over every case each kernel was held on
        "deca_gemv": max(c["max_abs_err"] for c in held if c.get("kernel") == "gemv"),
        "deca_gemm": max(c["max_abs_err"] for c in held if c.get("kernel") == "gemm"),
        "deca_paged_attention": max(c["max_abs_err"] for c in held
                                    if c.get("kernel", "attention") == "attention"),
        "deca_decompress": max(c["max_abs_err"] for c in dec_cases),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": worst_abs[name], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"],
    } for name, src, rep, c in rows]
    # the recurrent stacks' shapes (K 256, N 288 and 256, f32 x), and
    # qwen2-vl-7b's and hubert-xlarge's (N 152064 and 504, M up to 32768;
    # attention at G 7 and at Dh 80, causal=0), each timed
    keys = ("model", "role", "K", "N", "M", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for entry, matmul in zip(kernels[:3], ("gemv", "gemm", "attention")):
        for name, shapes in (("recurrent_shapes", recurrent_cases),
                             ("vlm_audio_shapes", vlm_audio_cases),
                             ("tp70_local_shapes", mesh_cases),
                             ("grok14_local_shapes",
                              [c for c in moe_cases if c.get("model") == GROK14])):
            timed = [{k: c[k] for k in keys if k in c} for c in shapes
                     if c["kernel"] == matmul and "ms" in c]
            if timed:
                entry[name] = timed
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

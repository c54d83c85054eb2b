"""End-to-end serving example of the PyTorch port, the twin of
`examples/compressed_serving.py`: serve a small model with batched
requests and DECA-compressed weights.

Builds the llama3-8b smoke model, compresses every FC weight to MXFP4 (the
paper's Q4), and serves a batch of prompts through `GenerationEngine.generate`
on the engine `paged="auto"` picks, as the reference example does: the
paged engine for this attention stack (one prefill call for the batch,
then device-resident decode chunks), with every FC matmul running the
decompress-on-the-fly GeMM or GeMV. Reports the compression factor and
tokens/s. It runs on the card unless `--device cpu`.

Run:  PYTHONPATH=src python examples/compressed_serving_torch.py [--format bf8_50]
      PYTHONPATH=src python examples/compressed_serving_torch.py --device cpu

`--paged` switches to the mixed-length continuous-batching demo: requests
of different prompt lengths go through submit()/run_until_drained() on the
block-paged KV cache, and the report includes slot occupancy and the
padding waste a max_len ring cache would have paid. `--chunk` sets the
decode steps a device-resident chunk runs; 1 is the single-step loop, one
decode step and one host sync a token.

`--ttft-slo/--itl-slo/--deadline/--max-queue` install the overload policy
on the paged path: requests the engine cannot serve on time are shed or
expired with explicit terminal statuses, and the report adds a per-status
summary table.

`--mesh DxM` serves sharded over a (data, model) mesh on the paged engine
(the dense ring engine on a mesh is ROADMAP Queue A item 12): in-process
over a one-rank group for `1x1`, and under `torchrun --nproc-per-node D*M`
for larger meshes, every rank serving the same requests (rank 0 prints).
A mesh larger than the world is refused, as the reference refuses one
larger than its device count.

Run:  PYTHONPATH=src python examples/compressed_serving_torch.py --mesh 1x1
      PYTHONPATH=src torchrun --nproc-per-node 2 \
          examples/compressed_serving_torch.py --mesh 2x1 --device cpu
"""
import argparse
import contextlib
import io
import os
import socket
import time

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.decompress import compress_tree, compressed_bytes
from repro_torch.core.formats import get_spec
from repro_torch.device import resolve
from repro_torch.models.model import Model
from repro_torch.serve.engine import GenerationEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", default="mxfp4_100")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve sharded over a (data, model) mesh: 1x1 in "
                         "this process, larger under torchrun; implies --paged")
    ap.add_argument("--paged", action="store_true",
                    help="mixed-length continuous-batching demo: submit "
                         "requests of different prompt lengths through the "
                         "paged scheduler and report occupancy / padding-"
                         "waste stats")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per device-resident chunk (1 = the "
                         "single-step loop, one host sync a token)")
    ap.add_argument("--kv-quant", default=None, metavar="FMT",
                    help="quantize the KV cache with any KV-capable codec "
                         "of repro_torch.core.codecs (bf8/int8/int4/mxfp4/nf4)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="multi-tenant prefix sharing: keep finished "
                         "prompts' KV pages in a radix index, admit later "
                         "requests against their longest cached prefix "
                         "(copy-on-write on divergence); submits shared-"
                         "prefix traffic and reports hit/CoW stats; "
                         "implies --paged")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="N",
                    help="chunked prefill: at most N prompt tokens per "
                         "request per scheduler round, interleaved with "
                         "decode (default: whole prompt in one launch); "
                         "implies --paged")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="self-speculative decoding: per round, propose K "
                         "tokens with a cheaper re-encoding of the same "
                         "weights and verify them in one batched target "
                         "forward; implies --paged")
    ap.add_argument("--draft-codec", default="nf4", metavar="FMT",
                    help="codec the draft weight tree is re-encoded with "
                         "(default nf4; any registry format works)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record the request lifecycle and export a Chrome "
                         "trace (open in Perfetto); implies --paged")
    ap.add_argument("--metrics", action="store_true",
                    help="attach a metrics registry and dump the "
                         "serve.* counters/gauges/histograms after the "
                         "run; implies --paged")
    ap.add_argument("--ttft-slo", type=float, default=None, metavar="S",
                    help="SLO admission control: shed queued requests whose "
                         "wait plus roofline-predicted prefill would breach "
                         "S seconds to first token; implies --paged")
    ap.add_argument("--itl-slo", type=float, default=None, metavar="S",
                    help="defer admissions that would push the predicted "
                         "per-token decode latency of running requests "
                         "past S seconds; implies --paged")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request deadline: a request still queued S "
                         "seconds after submit is expired (parked "
                         "requests keep their partial output); implies "
                         "--paged")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bound the submit queue at N requests; later "
                         "submits are shed instantly; implies --paged")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if not args.mesh:
        return serve(args, device, None)
    with mesh_world(args.mesh, device) as mesh:
        import torch.distributed as dist

        quiet = dist.get_rank() != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            return serve(args, device, mesh)


def parse_mesh(arg):
    """'DxM' -> (data, model)."""
    try:
        data, model = (int(x) for x in arg.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects DxM (e.g. 2x2), got {arg!r}")
    return data, model


@contextlib.contextmanager
def mesh_world(arg, device):
    """The (data, model) mesh of `arg` over the process group: torchrun's
    world when its variables are set, else a one-rank group opened here
    (gloo on the CPU, NCCL on the card) and destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    data, model = parse_mesh(arg)
    backend = "nccl" if device.type == "cuda" else "gloo"
    launched = "WORLD_SIZE" in os.environ
    world = int(os.environ.get("WORLD_SIZE", 1))
    if data * model > world:
        raise SystemExit(f"--mesh {arg} needs {data * model} ranks, have {world} "
                         f"(run it under torchrun --nproc-per-node {data * model})")
    opened = False
    if not dist.is_initialized():
        if launched:
            dist.init_process_group(backend)
        else:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                    rank=0, world_size=1)
        opened = True
    try:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        yield make_test_mesh(data, model, device=device.type)
    finally:
        if opened:
            dist.destroy_process_group()


def serve(args, device, mesh):
    """The serving demo of `args` on `device`, sharded over `mesh` (None:
    unsharded)."""
    if mesh is not None:
        args.paged = True  # the dense ring engine on a mesh is item 12's
    sla_requested = (args.ttft_slo or args.itl_slo or args.deadline
                     or args.max_queue)
    if (args.trace or args.metrics or args.prefix_cache or args.prefill_chunk
            or args.spec_k or sla_requested):
        # these features all live in the paged scheduler path
        args.paged = True

    cfg = get_smoke_config("llama3-8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    dense_bytes = compressed_bytes(params)

    spec = get_spec(args.format)
    cparams = compress_tree(params, spec, layer_stack=model.layer_stack)
    comp_bytes = compressed_bytes(cparams)
    print(f"model: {cfg.name} on {device}  weights {dense_bytes/1e6:.2f} MB -> "
          f"{comp_bytes/1e6:.2f} MB (CF={dense_bytes/comp_bytes:.2f}, "
          f"scheme CF={spec.compression_factor():.2f})")

    rng = np.random.default_rng(0)

    if args.paged:
        # mixed-length traffic: each request holds ceil(len/block_size) KV
        # pages instead of a max_len ring slot
        lengths = [int(x) for x in rng.integers(8, 49, args.batch)]
        sys_prompt = None
        if args.prefix_cache:
            # shared-prefix traffic: one 32-token system prompt fronts
            # every request, the shape the radix index exists to win
            sys_prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
        obs = None
        if args.trace or args.metrics or sla_requested:
            # the SLO gates consume RoofLens predictions, so an SLA run
            # brings the observability stack along
            from repro_torch.obs import Observability

            obs = Observability.default()
        sla = None
        if sla_requested:
            from repro_torch.serve.slo import SLAPolicy

            sla = SLAPolicy(ttft_slo_s=args.ttft_slo, itl_slo_s=args.itl_slo,
                            max_queue=args.max_queue)
            print(f"SLA policy: ttft_slo={args.ttft_slo} "
                  f"itl_slo={args.itl_slo} max_queue={args.max_queue} "
                  f"deadline={args.deadline}")
        spec_cfg = None
        if args.spec_k:
            from repro_torch.serve.engine import SpecConfig

            spec_cfg = SpecConfig(k=args.spec_k, draft_codec=args.draft_codec)
        engine = GenerationEngine(model, cparams, max_len=128, temperature=0.0,
                                  block_size=args.block_size, max_slots=4,
                                  kv_quant=args.kv_quant, decode_chunk=args.chunk,
                                  prefix_cache=args.prefix_cache,
                                  prefill_chunk=args.prefill_chunk, obs=obs,
                                  spec_decode=spec_cfg, sla=sla, device=device,
                                  mesh=mesh)
        if mesh is not None:
            print(f"mesh: {args.mesh} (data x model) over "
                  f"{mesh.size()} rank(s); this rank's params "
                  f"{compressed_bytes(engine.params)/1e6:.2f} MB")
        if spec_cfg is not None:
            draft_bytes = compressed_bytes(engine.draft_params)
            print(f"self-speculation: k={args.spec_k} draft={args.draft_codec} "
                  f"({draft_bytes/1e6:.2f} MB draft tree, "
                  f"{engine.spec_rounds} rounds/launch)")
        if args.kv_quant:
            print(f"KV pools quantized with {args.kv_quant}: "
                  f"{engine.kv.bytes_per_token():.0f} B/token (all layers)")

        def make_prompt(n):
            tail = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            if sys_prompt is None:
                return tail
            return np.concatenate([sys_prompt, tail])

        rids = [
            engine.submit(make_prompt(n), max_new_tokens=args.steps,
                          deadline_s=args.deadline)
            for n in lengths
        ]
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        dt = time.perf_counter() - t0
        st = engine.scheduler.stats()
        n_tok = sum(len(done[r]) for r in rids)
        print(f"served {len(rids)} mixed-length requests "
              f"(prompts {min(lengths)}-{max(lengths)} tokens), "
              f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
        print(f"decode: chunk={args.chunk} decode_steps={st['decode_steps']} "
              f"decode_chunks={st['decode_chunks']} host_syncs={st['host_syncs']}")
        if sla_requested:
            # every request resolves to a terminal status
            statuses = engine.statuses
            print(f"{'status':<12}{'requests':>9}{'tokens':>8}")
            for status in sorted({statuses[r] for r in rids}, key=lambda s: s.value):
                members = [r for r in rids if statuses[r] == status]
                print(f"{status.value:<12}{len(members):>9}"
                      f"{sum(len(done[r]) for r in members):>8}")
            print(f"resilience: sheds={st['shed_requests']} "
                  f"expired={st['expired_requests']} "
                  f"parked={st['parked_requests']} "
                  f"degradations={st['degradations']} "
                  f"itl_deferrals={st['itl_deferrals']}")
        print(f"paged KV: block_size={args.block_size} "
              f"peak_blocks={st['peak_blocks']} "
              f"mean_occupancy={st['mean_occupancy']:.2f} "
              f"padding_waste_saved={st['padding_waste_saved']:.2%}")
        if spec_cfg is not None:
            print(f"speculation: accepted_tokens_per_step="
                  f"{st['accepted_tokens_per_step']:.2f} "
                  f"(draft_tokens={st['draft_tokens']} "
                  f"verify_calls={st['verify_calls']})")
        if args.prefix_cache:
            occ = engine.kv.occupancy()
            print(f"prefix cache: hit_tokens={st['prefix_hit_tokens']} "
                  f"cow_copies={st['cow_copies']} "
                  f"cached_pages={occ['cached']} shared_pages={occ['shared']}")
        if args.prefill_chunk:
            print(f"chunked prefill: {st['prefill_chunk_calls']} chunk "
                  f"launches of <= {args.prefill_chunk} tokens/request")
        if obs is not None:
            # client-visible latency: TTFT from submit to the prefill
            # sample, ITL from token-visibility deltas (bursty per chunk)
            s = obs.tracer.summary()
            print(f"request lifecycle ({s['n_requests']} finished, "
                  f"{s['n_tokens']} tokens):")
            print(f"{'metric':<16}{'p50':>10}{'p90':>10}{'p99':>10}")
            for name in ("ttft_s", "itl_s", "queue_wait_s"):
                d = s[name]
                label = name.replace("_s", "_ms")
                print(f"{label:<16}{d['p50'] * 1e3:>10.3f}"
                      f"{d['p90'] * 1e3:>10.3f}{d['p99'] * 1e3:>10.3f}")
        if args.trace:
            obs.tracer.export_chrome_trace(args.trace)
            print(f"chrome trace written to {args.trace} (open in Perfetto)")
        if args.metrics:
            print("metrics registry snapshot:")
            for name, m in sorted(obs.metrics.snapshot().items()):
                fields = " ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in m.items() if k != "type"
                )
                print(f"  [{m['type']:>9}] {name}: {fields}")
        print("sample:", done[rids[0]][:12].tolist())
        return done

    prompts = rng.integers(0, cfg.vocab_size, (args.batch, 16)).astype(np.int32)
    engine = GenerationEngine(model, cparams, max_len=128, temperature=0.0,
                              kv_quant=args.kv_quant, device=device)
    if args.kv_quant:
        print(f"KV cache quantized with {args.kv_quant}")
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.steps)
    dt = time.perf_counter() - t0
    tps = args.batch * args.steps / dt
    print(f"generated {out.shape} tokens in {dt:.2f}s  ({tps:.1f} tok/s, "
          f"batched decode with compressed weights)")
    print("sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()

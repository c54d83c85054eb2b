#!/usr/bin/env python3
"""`chip_smoke.py`'s `moe` phase alone, on one card.

    python3 tools/moe_serve.py

Builds the kernels (`kernels/cuda.build`, a no-op when they are built),
then runs only the phase: grok-1-314b at full width and 8 of its 64
layers, all 8 experts, with bf8_50 weights compressed on the card one
expert at a time (build time, stored bytes against the dense bf16 size,
the build's peak), the kernels against their plain versions at its shapes
(the experts through their `pick` views) and at kimi-k2's (expert GeMVs,
attention at Dh 112), a 4-request greedy serve at capacity 1.25 through
captured decode graphs (replays bitwise, 417 GeMVs a step, the replayed
step beside its bytes bound, the token-slots each prefill drops), the
same weights served on a one-rank NCCL mesh (`GenerationEngine(mesh=)`,
its experts split over `model`) beside the plain engine, bitwise, then
again with `fsdp=True` on the same mesh (every FC leaf all-gathered over
`data` at its point of use inside the captured chunk: tokens, pools,
launches and replays bitwise; its replayed step timed in turns with the
plain and the non-fsdp mesh engines'), with the kernels at grok-1's
(1, 4) local shard shapes, the
kernel path against the plain path over the first 4 layers at capacity
1.25 and drop-free (the plain path on the kernel path's routes), a
drop-free copy with the served routers held against teacher-forced logits
(each teacher pass on the routes its serve chose), and a self-speculative
engine on 2 layers of it with zero routers. It prints the phase's lines
and writes its record to chiprun_out/moe_serve.json; it exits non-zero
when a check fails or no card is present.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.exit(cs.phase_alone(cs.moe, "moe_serve"))

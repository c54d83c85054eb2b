"""CUDA graphs of the decode steps.

The reference jits its decode chunk and its spec rounds, each one
`lax.scan`, so a chunk is one device program (`repro/serve/engine.py`
`make_paged_decode_chunk_step`, `make_paged_spec_decode_step`). The port
walks the same steps in Python, some 500 kernel launches a decode step,
and on the card that walk, not the kernels, set the pace. `StepGraphs`
captures a step function once per input shape into a `torch.cuda.CUDAGraph`
and replays it, so a chunk costs the host one copy of its inputs, one
replay and one copy of its tokens back.

A step function takes int32 device tensors (the scheduler's host arrays,
in its order) and returns one device tensor; it may write the KV pools in
place. For each shape key:

  - the inputs live in one static device buffer, filled before each run
    by one copy from a pinned host buffer;
  - the first chunk runs uncaptured on a side stream (a real run, whose
    output is used: it builds and loads the kernel libraries, sets their
    shared-memory attributes and loads each kernel, none of which may
    happen inside a capture), then the same call is captured on that
    stream, which runs nothing on the card;
  - later chunks replay the graph.

The kernel wrappers' launch counters tick in Python, so they would count
only the capture: each graph keeps the launches its capture made, the
counters are set back after the capture, and each replay adds them.

The graph holds the addresses of the pools it writes, so the pools must
never be reallocated once a graph exists: every run checks that they
have not moved. A capture that fails raises; nothing falls back to the
uncaptured walk. CUDA graphs exist only on the card: the engine runs its
step functions directly on CPU tensors.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def launch_counters() -> List[Callable]:
    """The kernel wrappers whose `launches` a graph replays."""
    from repro_torch.kernels import deca_decompress, deca_gemm, paged_attention

    return [deca_gemm.decompress_gemv, deca_gemm.decompress_gemm,
            paged_attention.paged_attention, deca_decompress.decompress]


def _counts() -> Tuple[int, ...]:
    return tuple(fn.launches for fn in launch_counters())


def _add_counts(delta: Sequence[int]) -> None:
    for fn, d in zip(launch_counters(), delta):
        fn.launches += d


class Graph:
    """One captured step: its static inputs, its output, the kernel
    launches a replay makes, and what its capture cost."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], device: torch.device):
        sizes = [math.prod(s) for s in shapes]
        self.host = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(sum(sizes), dtype=torch.int32, device=device)
        self.inputs: List[torch.Tensor] = []
        offset = 0
        for shape, n in zip(shapes, sizes):
            self.inputs.append(self.dev[offset:offset + n].view(shape))
            offset += n
        self.graph = torch.cuda.CUDAGraph()
        self.out: torch.Tensor = None
        self.launches: Tuple[int, ...] = ()
        self.capture_s = 0.0
        self.graph_bytes = 0

    def load(self, arrays: Sequence[np.ndarray]) -> None:
        """One host-to-device copy of the step's inputs, in stream order
        before the next run. The pinned buffer is rewritten only after the
        previous chunk's tokens came back, so the copy has completed."""
        host, offset = self.host.numpy(), 0
        for a in arrays:
            host[offset:offset + a.size] = a.reshape(-1).astype(np.int32)
            offset += a.size
        self.dev.copy_(self.host, non_blocking=True)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        _add_counts(self.launches)
        return self.out

    def capture(self, fn: Callable, stream: torch.cuda.Stream) -> torch.Tensor:
        """Run `fn` on the loaded inputs uncaptured on `stream` (the real
        run, whose output is returned), then capture the same call."""
        current = torch.cuda.current_stream(self.dev.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(*self.inputs)
        before = _counts()
        # Destroying a CUDA graph (a dead engine's, freed by the cyclic
        # garbage collector whenever it runs) inside a capture invalidates
        # the capture: collect now, and keep the collector off while
        # recording.
        gc.collect()
        torch.cuda.synchronize(self.dev.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.dev.device)
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.graph_bytes = torch.cuda.memory_reserved(self.dev.device) - reserved
        self.launches = tuple(a - b for a, b in zip(_counts(), before))
        _add_counts([-d for d in self.launches])  # the capture ran nothing
        current.wait_stream(stream)
        return out


class StepGraphs:
    """Graphs of one step function, one per input shape key.

    `fn(*int32 device tensors) -> device tensor` is the step; `pools()`
    returns the KV pools it writes in place, whose addresses the graphs
    hold."""

    def __init__(self, fn: Callable, *, device: torch.device, pools: Callable):
        self.fn = fn
        self.device = device
        self._pools = pools
        self._addresses = None
        self._stream = torch.cuda.Stream(device)
        self.graphs: Dict[tuple, Graph] = {}

    def _check_pools(self) -> None:
        addresses = tuple(t.data_ptr() for layer in self._pools() for t in layer.values())
        if self._addresses is None:
            self._addresses = addresses
        elif addresses != self._addresses:
            raise RuntimeError("the KV pools were reallocated after a decode graph "
                               "captured their addresses")

    def __call__(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """The step's output for host `arrays`: a replay when a graph of
        their shapes exists, else the first (uncaptured) run and a capture."""
        arrays = [np.asarray(a) for a in arrays]
        key = tuple(a.shape for a in arrays)
        self._check_pools()
        g = self.graphs.get(key)
        if g is not None:
            g.load(arrays)
            return g.replay()
        g = Graph(key, self.device)
        g.load(arrays)
        out = g.capture(self.fn, self._stream)
        self.graphs[key] = g
        return out


def _planes(pools) -> List[Dict[str, torch.Tensor]]:
    return [{n: t.clone() for n, t in layer.items()} for layer in pools]


def replay_check(steps: StepGraphs, key: tuple, pools) -> List[str]:
    """What differs between a replay of the graph `key` and the uncaptured
    step on the same inputs (its last ones), both from the same pools: []
    when the output and every pool plane are bitwise equal. The null page
    is left out: several pad writes of one call land on one of its slots,
    in no fixed order, under the empty position that masks them. Neither
    run counts as launches; the pools end as the uncaptured run left them."""
    g = steps.graphs[key]
    counts = _counts()
    start = _planes(pools)
    replayed = g.replay().clone()
    after = _planes(pools)
    for layer, saved in zip(pools, start):
        for name, t in layer.items():
            t.copy_(saved[name])
    eager = steps.fn(*g.inputs)
    torch.cuda.synchronize(g.dev.device)
    _add_counts([a - b for a, b in zip(counts, _counts())])
    bad = [] if torch.equal(replayed, eager) else ["output"]
    for i, (layer, want) in enumerate(zip(pools, after)):
        bad += [f"layer {i} {name}" for name, t in layer.items()
                if not torch.equal(t[1:], want[name][1:])]
    return bad

"""Sharding rules: one place that decides how every tensor of the port is
laid out over a mesh (counterpart of `repro/dist/sharding.py`).

Axes (`launch/mesh.py`): `data` (batch / FSDP), `model` (tensor parallel)
and optionally `pod` (a second batch axis of the multi-pod mesh). Rules are
divisibility-aware: a dim is sharded over an axis (or axis tuple) only when
its total size divides the dim, and no mesh axis is used twice within one
spec; `_resolve_dim` falls back to replication otherwise.

A spec is a tuple with one entry per dim: None, an axis name, or a tuple of
axis names (the reference's `PartitionSpec`, entry for entry). A compressed
leaf gets a `CompressedSpec`, one spec per plane.

The port's trees hold one dict per layer (`params["layers"][i]`) where the
reference scans a uniform stack as one (n_layers, ...) `blocks` leaf; the
rules read the port's names, and a layer leaf's spec is the reference's
stacked spec without its leading None (the layer dim is never sharded).

Entry points:
  use_mesh(mesh, fsdp=, mode=, batch_axes=)  activates a ShardingCtx
  active_ctx()                               the innermost ctx, or None
  spec_for(shape, roles, ctx)                roles -> spec
  param_spec_tree / opt_spec_tree / data_spec_tree
  constrain(x, kind) / constrain_qkv         exact identity with no mesh
  placements(spec, mesh) / placement_tree, shard_params(params, ctx),
  local_shard(x, spec, ctx)
  serve_ctx / local_tree / leaf_spec         the serving step on local shards
  channel_axis / channels                    a recurrent block's channel block
  expert_range / adopt_specs                 a rank's experts; a re-encoded local tree
  gathered(w, ctx) / planes / fsdp_dim       fsdp: a local leaf whole over `data`
  constrain_local(x, kind, have) / relayout  a local activation's layout
  all_reduce / all_gather over a named mesh axis

The sharded serving step (`GenerationEngine(mesh=)`, mode "serve") runs on
plain local tensors, never on DTensors: the kernels take local shards.
`local_tree` cuts every leaf to this rank's block under `param_spec_tree`
and registers the spec it came from (`leaf_spec`), so a matmul site knows
whether its weight is column-parallel (N over `model`), row-parallel (K
over `model`: the f32 partial products are summed over the axis and
rounded once) or replicated. An activation's layout is a spec beside it,
which `constrain_local` gathers or cuts to what `_ACT_ROLES[kind]`
resolves to; every rank runs the same host scheduler on whole inputs.
An expert-stacked MoE leaf (E, K, N) is cut along E over `model` where E
divides (`expert_range`: rank r holds experts [r E/m, (r+1) E/m), each
whole, as a view of the whole leaf); the MoE block runs only those and
gathers their outputs over `model`, the reference's `egcd` transpose.
Under fsdp (the ctx's `fsdp`) each FC leaf's other dim is cut over `data`
as well; `gathered` all-gathers such a leaf whole at its point of use
into the ctx's one gather buffer, so every product sees the layout of
the non-fsdp step.

A ctx's `batch_axes` name the mesh axes over which this process holds only
its own rows of the batch (data-parallel training, `train/trainer.py`):
there the MoE dispatch groups are this rank's share of the reference's, and
`batch_all_reduce` sums over those axes.

CompressedTensor leaves shard along the same logical (K, N) axes as the
dense weight they replace: `codes (ng, ck, N)`, `mask (ng, N)` and `scales
(ng, N)` put the K-axis sharding on the group dim `ng` (re-checking
divisibility against ng: K % ax == 0 does not imply ng % ax == 0) and the
N-axis sharding on their last dim.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.compression import CompressedTensor

Axis = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[Axis], ...]


class CompressedSpec(NamedTuple):
    """The specs of a compressed leaf's planes (None for an absent plane)."""

    codes: Spec
    mask: Optional[Spec]
    scales: Optional[Spec]


@dataclasses.dataclass
class ShardingCtx:
    """Active sharding context: the mesh plus per-run policy knobs.

    fsdp       : shard weight contraction dims over 'data' (ZeRO-3 style);
                 `launch/specs.py` turns it on above a param threshold.
    mode       : 'train' | 'serve'.
    batch_axes : the mesh axes over which this process holds only its own
                 rows of the batch (empty: the tensors are whole).
    """

    mesh: Any
    fsdp: bool = False
    mode: str = "train"
    batch_axes: Tuple[str, ...] = ()
    # id(local leaf) -> (the leaf, its spec): `local_tree` fills it
    leaf_specs: Dict[int, Tuple[Any, Any]] = dataclasses.field(default_factory=dict)
    # fsdp: the bytes every `gathered` leaf is gathered into, sized by
    # `local_tree` / `adopt_specs` for the largest leaf with a `data` entry
    gather_buffer: Optional[torch.Tensor] = None
    _sizes: Optional[Dict[str, int]] = dataclasses.field(default=None, init=False,
                                                         repr=False, compare=False)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """{axis name: size}, read from the mesh once: a DeviceMesh
        rebuilds its rank tensor on every read of its shape (~50 us), and
        the serving step reads the sizes at every layout decision."""
        if self._sizes is None:
            from repro_torch.launch.mesh import axis_sizes

            self._sizes = axis_sizes(self.mesh)
        return self._sizes

    @property
    def batch_split(self) -> int:
        """Into how many row blocks the batch is split across processes."""
        sizes = self.axis_sizes
        return math.prod(sizes[a] for a in self.batch_axes)

    def batch_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed in place over the batch axes' process groups."""
        import torch.distributed as dist

        for a in self.batch_axes:
            dist.all_reduce(t, group=self.mesh.get_group(a))
        return t


_STACK = threading.local()


def active_ctx() -> Optional[ShardingCtx]:
    stack = getattr(_STACK, "ctxs", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh, *, fsdp: bool = False, mode: str = "train",
             batch_axes: Tuple[str, ...] = ()):
    """Activate `mesh` for the dynamic extent: constrain() redistributes
    DTensors, MoE dispatch groups follow the batch sharding, the spec functions
    resolve against the mesh axes."""
    with scope(ShardingCtx(mesh, fsdp=fsdp, mode=mode,
                           batch_axes=tuple(batch_axes))) as ctx:
        yield ctx


@contextlib.contextmanager
def scope(ctx: Optional[ShardingCtx]):
    """Activate an existing ctx (the engine's, whose `leaf_specs` its local
    trees filled) for the dynamic extent; None activates nothing."""
    if ctx is None:
        yield None
        return
    stack = getattr(_STACK, "ctxs", None)
    if stack is None:
        stack = _STACK.ctxs = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# axis resolution
# ---------------------------------------------------------------------------

# candidates per logical role, tried in order
_ROLE_AXES: Dict[str, Tuple[Axis, ...]] = {
    "batch": (("pod", "data"), ("data",), ("pod",)),
    "model": (("model",),),
    "fsdp": (("data",),),
    "expert": (("model",),),  # EP rides the model axis (no dedicated axis)
}


def _resolve_dim(dim: int, candidate_axes: Sequence[Axis], ctx: Any,
                 used: set) -> Optional[Axis]:
    """First candidate mesh axis (or axis tuple) whose total size divides
    `dim`, never reusing an axis already consumed by this spec: the bare
    name for a single axis, the tuple for a compound one, None when
    nothing fits (replicate)."""
    sizes = ctx.axis_sizes
    for cand in candidate_axes:
        axes = (cand,) if isinstance(cand, str) else tuple(cand)
        if any(a in used or a not in sizes for a in axes):
            continue
        size = math.prod(sizes[a] for a in axes)
        if size <= 0 or dim % size:
            continue
        used.update(axes)
        return axes[0] if len(axes) == 1 else axes
    return None


def _resolve_role(dim: int, role: Optional[str], ctx: Any, used: set):
    if role in (None, "none", "layers", "stack", "seq"):
        return None
    if role == "fsdp" and not getattr(ctx, "fsdp", False):
        return None
    return _resolve_dim(dim, _ROLE_AXES.get(role, ()), ctx, used)


def spec_for(shape: Sequence[int], roles: Sequence[Optional[str]], ctx: Any,
             used: Optional[set] = None) -> Spec:
    """The spec of `shape` with one role per dim ('batch', 'model', 'fsdp',
    'expert'; 'none' / 'layers' / 'seq' replicate)."""
    if ctx is None:
        return (None,) * len(shape)
    used = set() if used is None else used
    return tuple(_resolve_role(dim, role, ctx, used) for dim, role in zip(shape, roles))


# ---------------------------------------------------------------------------
# tree walking
# ---------------------------------------------------------------------------

def _map_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """`fn(path, leaf)` over a tree of dicts and lists whose leaves are
    tensors or CompressedTensors (a list index is its decimal name)."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _is_spec(x: Any) -> bool:
    return isinstance(x, CompressedSpec) or (
        isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x))


def _map_specs(fn, specs: Any, *rest: Any) -> Any:
    """`fn(spec, *leaves)` over a spec tree and trees of its structure."""
    if _is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(specs)]
    if specs is None:
        return None
    raise TypeError(f"not a spec tree node: {specs!r}")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# leaves that are never worth sharding (tiny, or not GeMM operands)
_REPLICATED_TOKENS = (
    "norm", "conv", "router", "bias", "a_param", "a_log", "dt_bias",
    "b_a", "b_x", "d_skip", "pos_embed",
)
# weights whose *first* matrix dim is the model-parallel one (row-parallel
# in megatron terms: contraction sharded over 'model', output over FSDP)
_ROW_PARALLEL = ("wo", "w_down", "w_out", "out_proj", "embed")


def _param_roles(path_names: Tuple[str, ...], shape: Tuple[int, ...]) -> Tuple[str, ...]:
    """Per-dim roles of a parameter leaf, from its name and position.

    Column-parallel weights (wq / wk / wv / w_up / w_gate / lm_head / ...)
    shard (contraction -> fsdp, output -> model); row-parallel ones (wo /
    w_down / embed / ...) the transpose; MoE expert dims ride the model
    axis. The reference's stacked leaves add an unsharded layer dim in
    front, which the port's per-layer leaves do not have."""
    name = path_names[-1] if path_names else ""
    nd = len(shape)
    roles = ["none"] * nd
    if nd == 0 or any(t in name for t in _REPLICATED_TOKENS):
        return tuple(roles)
    i = 0
    if "moe" in path_names and nd - i == 3:
        roles[i] = "expert"
        i += 1
    if nd - i == 2:
        if name in _ROW_PARALLEL:
            roles[i], roles[i + 1] = "model", "fsdp"
        else:
            roles[i], roles[i + 1] = "fsdp", "model"
    return tuple(roles)


def _compressed_spec(path_names: Tuple[str, ...], ct: CompressedTensor,
                     ctx: Any) -> CompressedSpec:
    """Plane specs of a compressed leaf, sharded along the same logical
    (K, N) axes as the dense weight the leaf replaces."""
    k, n = ct.shape
    lead = ct.lead
    ng = ct.codes.shape[-3]
    roles = _param_roles(path_names, lead + (k, n))
    used: set = set()
    lead_entries = tuple(_resolve_role(d, r, ctx, used) for d, r in zip(lead, roles[:-2]))
    # K-axis sharding lands on the group dim, N-axis on the last dim; both
    # resolved once so the three planes stay aligned
    k_ax = _resolve_role(ng, roles[-2], ctx, used)
    n_ax = _resolve_role(n, roles[-1], ctx, used)
    gn = lead_entries + (k_ax, n_ax)
    return CompressedSpec(
        codes=lead_entries + (k_ax, None, n_ax),
        mask=gn if ct.mask is not None else None,
        scales=gn if ct.scales is not None else None,
    )


def param_spec_tree(params: Any, ctx: Any) -> Any:
    """A spec tree mirroring a param tree (tensors, meta tensors or
    DTensors; CompressedTensor leaves get a CompressedSpec)."""

    def one(path, leaf):
        if isinstance(leaf, CompressedTensor):
            return _compressed_spec(path, leaf, ctx)
        shape = tuple(leaf.shape)
        return spec_for(shape, _param_roles(path, shape), ctx)

    return _map_path(one, params)


def _flat_specs(specs: Any, path: Tuple[str, ...] = (), out=None) -> Dict[str, Any]:
    out = {} if out is None else out
    if _is_spec(specs):
        out["/".join(path)] = specs
    elif isinstance(specs, dict):
        for k, v in specs.items():
            _flat_specs(v, path + (str(k),), out)
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            _flat_specs(v, path + (str(i),), out)
    return out


def opt_spec_tree(opt_state: Any, params: Any, ctx: Any) -> Any:
    """Optimizer-state specs: each state leaf inherits the spec of the
    param it tracks (AdamW's mu / nu / master mirror the params; Adafactor's
    factored vr / vc get the param's spec without the averaged-out dim).
    A layer-stacked state (`Adafactor(stacked=True)`: `v["layers"]` one dict
    of (n_layers, ...) factors, the reference's `blocks`) gets the layer
    spec behind a leading None."""
    flat_p = _flat_specs(param_spec_tree(params, ctx))

    def one(path, leaf):
        names = list(path)
        replicated = (None,) * leaf.dim()
        stacked = False
        if "layers" in names:
            j = names.index("layers")
            if j + 1 < len(names) and not names[j + 1].isdigit():
                names.insert(j + 1, "0")  # every layer of a uniform stack alike
                stacked = True
        tail = None
        if names and names[-1] in ("vr", "vc", "v") and "/".join(names) not in flat_p:
            tail, names = names[-1], names[:-1]
        for start in range(len(names) + 1):
            key = "/".join(names[start:])
            if key in flat_p:
                spec = flat_p[key]
                break
        else:
            return replicated
        if isinstance(spec, CompressedSpec):  # never trained; replicate
            return replicated
        entries = ((None,) if stacked else ()) + tuple(spec)
        if tail == "vr":  # the param's shape less its last dim
            return entries[:-1]
        if tail == "vc":  # less its second-to-last dim
            return entries[:-2] + entries[-1:]
        return entries

    return _map_path(one, opt_state)


# ---------------------------------------------------------------------------
# input / activation-state specs
# ---------------------------------------------------------------------------

def data_spec_tree(tree: Any, ctx: Any) -> Any:
    """Specs of input trees: training / prefill batches (tokens, labels,
    mask, embeds, positions), the port's per-layer ring and paged caches,
    and CompressedTensor leaves (sharded as the dense weight they stand
    for). Batch dims shard over ('pod', 'data'), KV heads over 'model'."""

    def one(path, leaf):
        name = path[-1] if path else ""
        if isinstance(leaf, CompressedTensor):
            return _compressed_spec(path, leaf, ctx)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0 or name in ("pos", "length", "ppos"):
            return (None,) * nd
        used: set = set()
        if name in ("kp", "vp", "ks", "vs"):
            # paged pool (NB, bsize, Hkv, Dh) and its scale planes (NB,
            # bsize, Hkv): pages replicated over the data axis (every data
            # shard reads any request's blocks), KV heads over 'model'
            head_dim = nd - 1 if name in ("ks", "vs") else nd - 2
            return tuple(_resolve_dim(shape[j], _ROLE_AXES["model"], ctx, used)
                         if j == head_dim else None for j in range(nd))
        entries = []
        i = 0
        if name == "positions" and nd == 3:
            entries.append(None)  # (3, B, S) M-RoPE stream dim
            i = 1
        entries.append(_resolve_dim(shape[i], _ROLE_AXES["batch"], ctx, used))
        for j in range(i + 1, nd):
            # KV heads over 'model': dim -2 of a code buffer, -1 of the ring
            # cache's quantized-KV scale planes
            if (name in ("k", "v") and j == nd - 2) or (
                    name in ("k_scale", "v_scale") and j == nd - 1):
                entries.append(_resolve_dim(shape[j], _ROLE_AXES["model"], ctx, used))
            else:
                entries.append(None)
        return tuple(entries)

    return _map_path(one, tree)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def entry_axes(entry: Optional[Axis]) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: Shard(d) on each mesh dim
    that dim d's entry names, Replicate() on the rest. A tuple entry
    shards over its axes major first, which must be their mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def placement_tree(specs: Any, mesh) -> Any:
    """`placements` of every spec of a spec tree (per plane for a
    CompressedSpec)."""
    def one(spec):
        if isinstance(spec, CompressedSpec):
            return CompressedSpec(*(None if p is None else placements(p, mesh) for p in spec))
        return placements(spec, mesh)

    return _map_specs(one, specs)


def local_shard(x: torch.Tensor, spec: Spec, ctx: ShardingCtx) -> torch.Tensor:
    """This rank's block of a whole tensor under `spec` (a view): each
    sharded dim cut to the block its mesh coordinates pick, major axis
    first, as DTensor's even `Shard` gives it."""
    coords = dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.get_coordinate()))
    sizes = ctx.axis_sizes
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = 0, 1
        for a in entry_axes(entry):
            index, count = index * sizes[a] + coords[a], count * sizes[a]
        block = x.shape[d] // count
        x = x.narrow(d, index * block, block)
    return x


def shard_params(params: Any, ctx: ShardingCtx) -> Any:
    """A (possibly compressed) param tree placed on ctx.mesh as DTensors
    (`distribute_tensor`, from rank 0's values) with `param_spec_tree`'s
    placements: the serving-side placement of the reference's
    `shard_params`."""
    from torch.distributed.tensor import distribute_tensor

    mesh = ctx.mesh
    put = lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh))

    def one(spec, leaf):
        if isinstance(leaf, CompressedTensor):
            return dataclasses.replace(
                leaf, codes=put(leaf.codes, spec.codes),
                mask=None if leaf.mask is None else put(leaf.mask, spec.mask),
                scales=None if leaf.scales is None else put(leaf.scales, spec.scales))
        return put(leaf, spec)

    return _map_specs(one, param_spec_tree(params, ctx), params)


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

# per-dim roles of each activation layout the layers emit
_ACT_ROLES: Dict[str, Tuple[str, ...]] = {
    "bsd": ("batch", "none", "none"),             # residual stream (B, S, D)
    "bshd": ("batch", "none", "model", "none"),   # per-head q/k/v/attn-out
    "bsf": ("batch", "none", "model"),            # MLP hidden (B, S, F)
    "btv": ("batch", "none", "model"),            # logits (B, S, V)
    "egcd": ("expert", "batch", "none", "none"),  # MoE dispatch (E, G, c, D)
    "egcf": ("expert", "batch", "none", "none"),  # MoE hidden (E, G, c, F)
    "edf_use": ("expert", "none", "none"),        # expert weight at point of use
    "efd_use": ("expert", "none", "none"),        # (FSDP shard all-gathered)
    "pkv": ("none", "none", "model", "none"),     # paged KV pool (NB, bs, Hkv, Dh)
    "pkvs": ("none", "none", "model"),            # paged KV scale plane (NB, bs, Hkv)
}


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """`x` laid out as the active mesh's rules say: a DTensor is
    redistributed to its spec; a plain local tensor is returned unchanged.
    The exact identity with no active mesh."""
    ctx = active_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    roles = _ACT_ROLES[kind]
    if not isinstance(x, DTensor) or len(roles) != x.dim():
        return x
    spec = spec_for(tuple(x.shape), roles, ctx)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


def constrain_qkv(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return constrain(q, "bshd"), constrain(k, "bshd"), constrain(v, "bshd")


# ---------------------------------------------------------------------------
# the serving step on local shards
# ---------------------------------------------------------------------------

def serve_ctx() -> Optional[ShardingCtx]:
    """The active ctx when it is a serving one on a real mesh, else None:
    the layers' sharded paths run only then (a training ctx holds whole
    params and its own batch rows)."""
    ctx = active_ctx()
    if ctx is None or ctx.mode != "serve":
        return None
    from repro_torch.launch.mesh import is_real

    return ctx if is_real(ctx.mesh) else None


def _coord(ctx: ShardingCtx, axis: str) -> int:
    return dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.get_coordinate()))[axis]


def _entry(entry: Optional[Axis]) -> Optional[str]:
    """A spec entry as one axis name; the serving step's meshes are
    (data, model), whose rules never compound two axes."""
    axes = entry_axes(entry)
    if len(axes) > 1:
        raise NotImplementedError(f"the serving step takes single-axis entries, got {entry}")
    return axes[0] if axes else None


def all_reduce(t: torch.Tensor, axis: str, ctx: ShardingCtx) -> torch.Tensor:
    """`t` summed in place over `axis`'s process group."""
    import torch.distributed as dist

    dist.all_reduce(t, group=ctx.mesh.get_group(axis))
    return t


def all_gather(t: torch.Tensor, axis: str, ctx: ShardingCtx, dim: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The blocks of `t` of every rank along `axis`, concatenated along
    `dim` in the axis's order. `out` (n * t.shape[0], ...) receives the
    collective's result where given (else it is allocated); a gather
    along another dim than 0 over more than one rank is then copied out
    of it into a new tensor."""
    import torch.distributed as dist

    n, shape = ctx.axis_sizes[axis], tuple(t.shape)
    if out is None:
        out = torch.empty((n * shape[0],) + shape[1:], dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t.contiguous(), group=ctx.mesh.get_group(axis))
    if dim == 0 or n == 1:
        return out
    return torch.cat(out.view((n,) + shape).unbind(0), dim=dim)


def block_start(block: int, axis: str, ctx: ShardingCtx) -> int:
    """Where this rank's block of `block` elements starts in the whole dim
    split over `axis`."""
    return _coord(ctx, axis) * block


def cut(t: torch.Tensor, axis: Optional[str], ctx: ShardingCtx, dim: int) -> torch.Tensor:
    """This rank's block of a whole dim under `axis` (a view); the whole
    tensor when `axis` is None."""
    if axis is None:
        return t
    block = t.shape[dim] // ctx.axis_sizes[axis]
    return t.narrow(dim, block_start(block, axis, ctx), block)


def relayout(x: torch.Tensor, have: Spec, want: Spec, ctx: ShardingCtx) -> torch.Tensor:
    """A local block of layout `have` as the block of layout `want`: each
    dim whose entry changes is gathered over its old axis, then cut to its
    new one."""
    for d, (h, w) in enumerate(zip(have, want)):
        h, w = _entry(h), _entry(w)
        if h == w:
            continue
        if h is not None:
            x = all_gather(x, h, ctx, d)
        x = cut(x, w, ctx, d)
    return x


def whole_shape(local: Sequence[int], spec: Spec, ctx: ShardingCtx) -> Tuple[int, ...]:
    sizes = ctx.axis_sizes
    return tuple(n * math.prod(sizes[a] for a in entry_axes(e)) for n, e in zip(local, spec))


def constrain_local(x: torch.Tensor, kind: str,
                    have: Optional[Spec] = None) -> Tuple[torch.Tensor, Spec]:
    """A local activation of layout `have` (whole when None) gathered or
    cut to the layout `_ACT_ROLES[kind]` resolves to on its whole shape:
    (the local block, its spec). With no serving ctx it is the exact
    identity, and on a one-rank mesh every layout is the whole tensor."""
    have = (None,) * x.dim() if have is None else tuple(have)
    ctx = serve_ctx()
    if ctx is None:
        return x, have
    want = spec_for(whole_shape(x.shape, have, ctx), _ACT_ROLES[kind], ctx)
    return relayout(x, have, want, ctx), want


def batch_axis(rows: int, ctx: Optional[ShardingCtx]) -> Optional[str]:
    """The axis a whole batch of `rows` rows is split over ('data' where
    it divides), or None: the batch is then replicated."""
    if ctx is None:
        return None
    return _entry(_resolve_dim(rows, _ROLE_AXES["batch"], ctx, set()))


def local_rows(t: torch.Tensor, rows: int, ctx: Optional[ShardingCtx],
               dim: int = 0) -> torch.Tensor:
    """This rank's rows of a whole-batch tensor (the batch on `dim`)."""
    if ctx is None:
        return t
    return cut(t, batch_axis(rows, ctx), ctx, dim)


def kv_head_axis(hkv: int, ctx: ShardingCtx) -> Optional[str]:
    """The axis a paged pool's `hkv` KV heads are split over (the `pkv`
    spec's head entry), or None: every rank holds them all."""
    return _entry(spec_for((1, 1, hkv, 1), _ACT_ROLES["pkv"], ctx)[2])


def channel_axis(width: int, ctx: Optional[ShardingCtx]) -> Optional[str]:
    """The axis a recurrent block's `width` channels are split over
    ('model' where it divides, as the column-parallel N of `w_in`,
    `dt_proj` or `w_a`), or None: every rank holds them all."""
    if ctx is None:
        return None
    return _entry(_resolve_dim(width, _ROLE_AXES["model"], ctx, set()))


def channels(t: torch.Tensor, ctx: Optional[ShardingCtx], dim: int = -1) -> torch.Tensor:
    """This rank's channel block (`channel_axis`) of a replicated
    per-channel leaf (`conv_w`, `a_log`, `d_skip`, ...) or of a whole
    state along `dim`, as a view; the tensor itself with no ctx."""
    if ctx is None:
        return t
    return cut(t, channel_axis(t.shape[dim], ctx), ctx, dim)


def _leaf_shard(leaf: Any, spec: Any, ctx: ShardingCtx) -> Any:
    """A leaf's local shard as contiguous plain tensors; a compressed one
    with its local logical (K, N). Every entry cuts, the fsdp role's
    `data` entries included. A block that is contiguous in the whole leaf
    (a cut of its first dim: an expert stack's experts, a K split of a 2-D
    leaf's codes) stays a view of it; other cuts (an N split, the K split
    inside each expert of a stack) are copied."""
    piece = lambda t, s: local_shard(t, s, ctx).contiguous()
    if isinstance(leaf, CompressedTensor):
        codes = piece(leaf.codes, spec.codes)
        k, _ = leaf.shape
        ng = leaf.codes.shape[-3]
        return dataclasses.replace(
            leaf, codes=codes,
            mask=None if leaf.mask is None else piece(leaf.mask, spec.mask),
            scales=None if leaf.scales is None else piece(leaf.scales, spec.scales),
            shape=(k // ng * codes.shape[-3], codes.shape[-1]))
    return piece(leaf, spec)


def local_tree(params: Any, ctx: ShardingCtx) -> Any:
    """This rank's shard of every leaf of a whole param tree under
    `param_spec_tree(params, ctx)` (serve mode), as plain tensors: the
    tree the serving step runs. Each local leaf's spec is registered in
    `ctx` for `leaf_spec`. Under fsdp a leaf with a `data` entry holds
    only this rank's share of it between steps (`gathered` makes it whole
    at its point of use), and the ctx's gather buffer is sized here."""
    made = []

    def one(spec, leaf):
        out = _leaf_shard(leaf, spec, ctx)
        ctx.leaf_specs[id(out)] = (out, spec)
        made.append((out, spec))
        return out

    tree = _map_specs(one, param_spec_tree(params, ctx), params)
    # the embedding's rows are gathered after their lookup: its table is
    # gathered whole only as a tied head's (no lm_head)
    lookup = tree.get("embed") if "lm_head" in tree else None
    _reserve(ctx, [(leaf, spec) for leaf, spec in made if leaf is not lookup])
    return tree


def leaf_spec(w: Any, ctx: Optional[ShardingCtx]) -> Optional[Any]:
    """The spec a local leaf of `local_tree` came from, or None."""
    hit = None if ctx is None else ctx.leaf_specs.get(id(w))
    return hit[1] if hit is not None and hit[0] is w else None


def expert_range(w: Any, ctx: Optional[ShardingCtx]) -> Tuple[range, Optional[str]]:
    """(the global experts this rank holds of an expert-stacked leaf, the
    axis the expert dim is split over or None). A local leaf of
    `local_tree` whose E divides `model` holds experts [r E/m, (r+1) E/m)
    of `model` rank r; with no mesh, or where E does not divide and the
    expert dim is replicated, it is every expert, range(E)."""
    n = w.lead[0] if isinstance(w, CompressedTensor) else w.shape[0]
    spec = leaf_spec(w, ctx)
    ax = None if spec is None else _entry(
        (spec.codes if isinstance(spec, CompressedSpec) else spec)[0])
    start = 0 if ax is None else block_start(n, ax, ctx)
    return range(start, start + n), ax


def _carried_spec(spec: Any, leaf: Any) -> Any:
    """`spec` of a local leaf carried to its re-encoding `leaf`: a dense
    leaf's (..., K, N) entries become a compressed leaf's planes (K on the
    group dim), a compressed leaf's keep their entries, for the planes the
    new codec has."""
    if not isinstance(leaf, CompressedTensor):
        return spec
    codes = spec.codes if isinstance(spec, CompressedSpec) else spec[:-1] + (None,) + spec[-1:]
    gn = codes[:-2] + codes[-1:]
    return CompressedSpec(codes=codes, mask=gn if leaf.mask is not None else None,
                          scales=gn if leaf.scales is not None else None)


def adopt_specs(tree: Any, source: Any, ctx: ShardingCtx) -> Any:
    """Register every leaf of `tree`, a leaf-for-leaf re-encoding of the
    local tree `source` (`make_draft_tree` of it), under the spec of the
    leaf it came from: a re-encoded block stands for the same block of
    the product (a K block is re-encoded only when the new group divides
    its K, so its groups stay whole). A leaf `tree` shares with `source`
    is registered already."""
    specs = _map_path(lambda path, leaf: leaf_spec(leaf, ctx), source)
    made = []

    def one(spec, leaf):
        if leaf_spec(leaf, ctx) is None:
            ctx.leaf_specs[id(leaf)] = (leaf, _carried_spec(spec, leaf))
            made.append(ctx.leaf_specs[id(leaf)])
        return leaf

    _map_specs(one, specs, tree)
    _reserve(ctx, made)


def matmul_axes(w: Any, ctx: Optional[ShardingCtx]) -> Tuple[Optional[str], Optional[str]]:
    """(K axis, N axis) of a local weight: a K over an axis is a
    row-parallel weight, an N over one a column-parallel weight."""
    spec = leaf_spec(w, ctx)
    if spec is None:
        return None, None
    if isinstance(spec, CompressedSpec):
        return _entry(spec.codes[-3]), _entry(spec.codes[-1])
    return _entry(spec[-2]), _entry(spec[-1])


# ---------------------------------------------------------------------------
# fsdp: a leaf's `data` share gathered at its point of use
# ---------------------------------------------------------------------------

_FSDP_AXIS = _ROLE_AXES["fsdp"][0][0]
_ALIGN = 256  # bytes: every plane of a gathered leaf starts on this boundary


def planes(leaf: Any, spec: Any) -> list:
    """[(plane, its spec)] of a leaf: a compressed leaf's present planes,
    a dense leaf itself."""
    if isinstance(leaf, CompressedTensor):
        return [(t, p) for t, p in zip((leaf.codes, leaf.mask, leaf.scales), spec)
                if t is not None]
    return [(leaf, spec)]


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim of a plane's spec split over the fsdp axis, or None (no
    spec names an axis twice)."""
    return next((d for d, e in enumerate(spec) if _FSDP_AXIS in entry_axes(e)), None)


def _gather_bytes(leaf: Any, spec: Any, ctx: ShardingCtx) -> int:
    """The bytes `gathered` takes of the buffer for `leaf` (each plane
    whole, from an aligned start); 0 for a leaf with no `data` entry."""
    n = ctx.axis_sizes.get(_FSDP_AXIS, 1)
    return sum(-(-t.numel() * t.element_size() * n // _ALIGN) * _ALIGN
               for t, p in planes(leaf, spec) if fsdp_dim(p) is not None)


def _reserve(ctx: ShardingCtx, leaves: Sequence[Tuple[Any, Any]]) -> None:
    """Grow the ctx's gather buffer to the largest of `leaves` (leaf,
    spec) whole: one buffer, allocated before any step runs (and so
    outside every captured graph), takes every gather in turn."""
    need = max((_gather_bytes(leaf, spec, ctx) for leaf, spec in leaves), default=0)
    have = 0 if ctx.gather_buffer is None else ctx.gather_buffer.numel()
    if need > have:
        device = next(leaf.device for leaf, spec in leaves if _gather_bytes(leaf, spec, ctx))
        ctx.gather_buffer = None
        ctx.gather_buffer = torch.empty(need, dtype=torch.uint8, device=device)


def _without_fsdp(spec: Any) -> Any:
    """`spec` with its `data` entries replicated: a gathered leaf's."""
    drop = lambda p: None if p is None else tuple(
        None if _FSDP_AXIS in entry_axes(e) else e for e in p)
    if isinstance(spec, CompressedSpec):
        return CompressedSpec(*(drop(p) for p in spec))
    return drop(spec)


def _gather_leaf(w: Any, spec: Any, ctx: ShardingCtx) -> Any:
    """`w` all-gathered over `data` along each plane's `data` dim, into
    the ctx's gather buffer. Each plane crosses as its bytes (any dtype,
    on NCCL and gloo alike): a split of the last dim gathers whole
    elements' bytes in the axis's order."""
    buf, n = ctx.gather_buffer, ctx.axis_sizes[_FSDP_AXIS]
    offset = 0

    def whole(t, p):
        nonlocal offset
        d = None if t is None else fsdp_dim(p)
        if d is None:
            return t
        b = t.contiguous().view(torch.uint8)
        size = b.numel() * n
        if buf is None or offset + size > buf.numel():
            raise RuntimeError(f"the gather buffer holds {0 if buf is None else buf.numel()} "
                               f"bytes, a leaf needs {offset + size}: it was not reserved")
        out = buf[offset:offset + size].view((n * b.shape[0],) + tuple(b.shape[1:]))
        offset += -(-size // _ALIGN) * _ALIGN
        return all_gather(b, _FSDP_AXIS, ctx, d, out=out).view(t.dtype)

    if not isinstance(w, CompressedTensor):
        return whole(w, spec)
    codes, mask, scales = (whole(t, p) for t, p in zip((w.codes, w.mask, w.scales), spec))
    k, _ = w.shape
    return CompressedTensor(codes, mask, scales, spec=w.spec,
                            shape=(k // w.codes.shape[-3] * codes.shape[-3], codes.shape[-1]))


@contextlib.contextmanager
def gathered(w: Any, ctx: Optional[ShardingCtx]):
    """`w`, a local leaf of `local_tree` (or of a tree `adopt_specs`
    registered), whole along its `data` entries for the extent of the
    `with`: under fsdp a rank holds its `data` share of each FC leaf
    between steps, and the point of use all-gathers the rest. A
    compressed leaf crosses as its codes / mask / scales planes, never
    decompressed. The whole leaf lies in the ctx's one gather buffer,
    valid until the next gather, and is registered under its spec less
    the `data` entries, so `matmul_axes` and `expert_range` read what they
    read without fsdp. A leaf with no such entry, or no ctx, is `w`."""
    spec = leaf_spec(w, ctx)
    if spec is None or not _gather_bytes(w, spec, ctx):
        yield w
        return
    whole = _gather_leaf(w, spec, ctx)
    ctx.leaf_specs[id(whole)] = (whole, _without_fsdp(spec))
    try:
        yield whole
    finally:
        del ctx.leaf_specs[id(whole)]

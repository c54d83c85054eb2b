"""Meshes: the production shapes and a small test mesh, as
`torch.distributed.device_mesh.DeviceMesh`es over the initialized process
group (counterpart of `repro/launch/mesh.py`).

Single pod: (data=16, model=16) = 256 cards. Multi-pod: (pod=2, data=16,
model=16) = 512 cards.

A mesh's backend follows its device: gloo for "cpu", NCCL for "cuda". The
caller opens the process group (`torch.distributed.init_process_group`
with its address, world size and rank); a real mesh on a device whose
backend is missing, or over a group of another backend, is an error,
never a mesh on another backend or device.

Where the world is not the production size, `make_production_mesh`
returns a `RuleMesh`: the axis names and sizes alone, which the spec
functions of `dist.sharding` read as they read a real mesh. Functions, not
constants: importing this module touches no device and no process group.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve

_BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


class RuleMesh:
    """A rule-level mesh: axis names and sizes, no devices. The spec
    functions read it (`axis_sizes`); nothing can be placed on it."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in length")
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)

    def __repr__(self) -> str:
        return f"RuleMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a RuleMesh."""
    shape = mesh.shape if isinstance(mesh, RuleMesh) else tuple(mesh.mesh.shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def is_real(mesh) -> bool:
    """A mesh whose ranks exist: a DeviceMesh, not a RuleMesh."""
    return not isinstance(mesh, RuleMesh)


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device):
    """A DeviceMesh of `shape` over every rank of the initialized process
    group, whose backend must be the device's."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve(device)
    want = _BACKENDS[dev.type]
    available = dist.is_gloo_available() if want == "gloo" else dist.is_nccl_available()
    if not (dist.is_available() and available):
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend, which this "
                           f"torch build lacks")
    if not dist.is_initialized():
        raise RuntimeError("open the process group first "
                           "(torch.distributed.init_process_group)")
    backend = str(dist.get_backend()).lower()  # "gloo", or "cpu:gloo,cuda:nccl"
    if want not in backend:
        raise RuntimeError(f"a {dev.type} mesh runs on {want}; the process group "
                           f"runs on {backend}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the world has "
                         f"{world}")
    ranks = torch.arange(world).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"): a DeviceMesh where the world has that many ranks, else a
    RuleMesh of those names and sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() == math.prod(shape):
        return _device_mesh(shape, axes, device)
    return RuleMesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, *, device="cuda"):
    """A (data, model) DeviceMesh over the initialized process group, whose
    world must hold data x model ranks."""
    return _device_mesh((data, model), ("data", "model"), device)

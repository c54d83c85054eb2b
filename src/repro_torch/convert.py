"""Weight carrier from the JAX reference's parameter trees.

`params_from_jax(tree, cfg)` takes the reference's `Model.init` tree, or
its `compress_tree` tree, as host arrays (`jax.device_get`), and returns the
port's params: the layer-stacked `blocks` of the scanned stack are unstacked
into one dict per layer, including the lead-L planes of stacked compressed
weights. The reference's compressed leaves are read by their attributes
(`codes`, `mask`, `scales`, `spec`, `shape`), so this module imports nothing
of the reference. It lets both packages compute from the same numbers.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.formats import CompressionSpec
from repro_torch.device import resolve

# numpy storage -> the dtype whose bits torch holds it in
_VIEWS = {"uint32": np.int32, "uint16": np.int16, "bfloat16": np.int16}


def to_tensor(a: Any, device) -> torch.Tensor:
    """Host array -> torch tensor with the same bits (bf16 stays bf16;
    uint32 / uint16 planes become int32 / int16 holding the bits)."""
    a = np.array(a)  # a writable, contiguous copy
    name = a.dtype.name
    t = torch.from_numpy(a.view(_VIEWS[name]) if name in _VIEWS else a)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _is_compressed(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in ("codes", "mask", "scales", "spec", "shape"))


def _leaf(leaf: Any, layer: Optional[int], device):
    """One leaf, sliced to `layer` when it is layer-stacked."""
    def plane(a):
        if a is None:
            return None
        a = np.asarray(a)
        return to_tensor(a if layer is None else a[layer], device)

    if _is_compressed(leaf):
        s = leaf.spec
        return CompressedTensor(
            codes=plane(leaf.codes), mask=plane(leaf.mask),
            scales=plane(leaf.scales),
            spec=CompressionSpec(s.quant, s.density, s.group),
            shape=tuple(int(d) for d in leaf.shape),
        )
    return plane(leaf)


def _map(tree: Any, layer: Optional[int], device):
    if isinstance(tree, dict):
        return {k: _map(v, layer, device) for k, v in tree.items()}
    return _leaf(tree, layer, device)


def params_from_jax(tree: Any, cfg: ModelConfig, *, device="cuda") -> dict:
    """The reference's parameter tree -> the port's params on `device`."""
    device = resolve(device)
    out = {k: _map(v, None, device) for k, v in tree.items()
           if k not in ("blocks", "layers")}
    if "blocks" in tree:
        out["layers"] = [_map(tree["blocks"], i, device) for i in range(cfg.n_layers)]
    else:
        out["layers"] = [
            _map(tree["layers"][str(i)], None, device) for i in range(cfg.n_layers)
        ]
    return out

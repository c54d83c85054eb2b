"""Abstract inputs and spec trees of every (architecture x shape x mesh)
cell (counterpart of `repro/launch/specs.py`).

An abstract tree is a tree of meta tensors, torch's shapes and dtypes
without storage (the reference's `ShapeDtypeStruct`s through
`jax.eval_shape`): `Model.init` runs on the meta device, so a 1T-param
config costs no memory.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.compression import CompressedTensor
from repro_torch.core.decompress import eligible
from repro_torch.core.formats import CompressionSpec
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import is_real
from repro_torch.models.model import Model
from repro_torch.train.trainer import build_optimizer

FSDP_PARAM_THRESHOLD = 12e9  # params above this get 'data'-axis weight sharding

META = torch.device("meta")


def wants_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > FSDP_PARAM_THRESHOLD


def abstract_params(model: Model) -> Any:
    """The param tree of `model` on the meta device."""
    return model.init(torch.Generator(), device=META)


def abstract_compress_tree(aparams: Any, spec: CompressionSpec, *,
                           layer_stack: Optional[int] = None) -> Any:
    """The meta analog of `core.decompress.compress_tree`: each eligible FC
    weight (`decompress.eligible`: the `_SKIP` names, rank >= 2, K a
    multiple of the group, the 4096-element floor counted over the
    reference's layer stack) becomes a CompressedTensor of meta planes in
    the codec's dtypes and shapes, so a compressed cell is specced without
    compressing 1T params. `layer_stack` as in `compress_tree`."""
    from repro_torch.core.decompress import _map_leaves

    def one(path, leaf, stack):
        shape = tuple(leaf.shape)
        if not eligible(path, shape, spec, stack):
            return leaf
        lead, (k, n) = shape[:-2], shape[-2:]
        ng = k // spec.group
        ck = 2 * spec.k_cap if spec.quant == "bf16" else spec.k_cap * spec.bits // 8
        plane = lambda dims, dtype: torch.empty(lead + dims, dtype=dtype, device=META)
        sdt = torch.uint8 if spec.quant == "mxfp4" else torch.int16
        return CompressedTensor(
            codes=plane((ng, ck, n), torch.uint8),
            mask=plane((ng, n), torch.int32) if spec.is_sparse else None,
            scales=plane((ng, n), sdt) if spec.has_scale else None,
            spec=spec, shape=(k, n))

    return _map_leaves(aparams, one, layer_stack)


def abstract_opt_state(model: Model, aparams: Any) -> Any:
    """The state of `build_optimizer(cfg)` (AdamW, or Adafactor stacked as
    the reference's uniform stack) over meta params."""
    return build_optimizer(model.cfg).init(aparams)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """One training / prefill batch as meta tensors: the data pipeline's
    output signature."""
    b, s = shape.global_batch, shape.seq_len
    out = {"labels": _meta((b, s), torch.int32), "mask": _meta((b, s), torch.float32)}
    if cfg.frontend != "none":
        out["embeds"] = _meta((b, s, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if cfg.mrope_sections:
        out["positions"] = _meta((3, b, s), torch.int32)
    return out


def decode_specs(model: Model, shape: ShapeConfig) -> Tuple[Any, Any, Any]:
    """(tokens, positions, cache) of one decode step, one new token against
    a seq_len-deep ring cache (the port's per-layer `init_cache`)."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    tokens = _meta((b, 1), torch.int32)
    positions = _meta((3, b, 1) if cfg.mrope_sections else (b, 1), torch.int32)
    return tokens, positions, model.init_cache(b, s + 1, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model: Optional[Model] = None) -> Dict[str, Any]:
    """Every model input of the cell, as meta tensors."""
    model = model or Model(cfg)
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape)}
    tokens, positions, cache = decode_specs(model, shape)
    return {"tokens": tokens, "positions": positions, "cache": cache}


def cell_shardings(model: Model, shape: ShapeConfig, ctx: sh.ShardingCtx,
                   aparams: Any = None) -> Dict[str, Any]:
    """The spec trees of the cell's params, optimizer state (train) and
    inputs, with the abstract trees they describe. On a real mesh,
    "placements" holds the same trees as DTensor placement lists
    (`sharding.placements`)."""
    cfg = model.cfg
    if aparams is None:
        aparams = abstract_params(model)
    out: Dict[str, Any] = {"params": sh.param_spec_tree(aparams, ctx),
                           "abstract_params": aparams}
    if shape.kind == "train":
        aopt = abstract_opt_state(model, aparams)
        out["opt_state"] = sh.opt_spec_tree(aopt, aparams, ctx)
        out["abstract_opt_state"] = aopt
    if shape.kind in ("train", "prefill"):
        out["batch"] = sh.data_spec_tree(batch_specs(cfg, shape), ctx)
    else:
        tokens, positions, cache = decode_specs(model, shape)
        out["tokens"] = sh.data_spec_tree({"tokens": tokens}, ctx)["tokens"]
        out["positions"] = sh.data_spec_tree({"positions": positions}, ctx)["positions"]
        out["cache"] = sh.data_spec_tree(cache, ctx)
    if is_real(ctx.mesh):
        out["placements"] = {k: sh.placement_tree(out[k], ctx.mesh) for k in
                             ("params", "opt_state", "batch", "tokens", "positions", "cache")
                             if k in out}
    return out

"""One-shot snapshot directories: the serving engine's crash-safe state.

Counterpart of `save_snapshot` / `load_snapshot` in
`repro/checkpoint/ckpt.py`, writing the same bytes, so a snapshot that one
package writes the other reads:

    <dir>/arrays.npz      every array under its key, "/" escaped as "§"
    <dir>/manifest.json   {"meta": ..., "dtypes": {key: dtype name}}

The directory is built as `<dir>.tmp` with the manifest written last
(tmp file + rename) and then renamed into place, so a kill at any point
leaves the old snapshot or none, never a torn one; a directory without a
manifest is refused. npz has no bf16: bf16 is stored as its 16-bit words
(uint16) and its manifest dtype says "bfloat16". No `ml_dtypes` here: a
bf16 entry comes back as a CPU `torch.bfloat16` tensor of the same bits,
every other entry as a numpy array. The train-state `Checkpointer` waits
for ROADMAP Queue A item 11.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _stored(v: Any) -> Tuple[np.ndarray, str]:
    """(array npz can hold, dtype name for the manifest) of one entry: a
    numpy array, or a tensor (bf16 as its uint16 words)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = t.numpy()
    v = np.asarray(v)
    return v, v.dtype.name


def save_snapshot(directory: str, arrays: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write one atomic snapshot directory: `arrays` (flat str -> array or
    tensor) into arrays.npz and `meta` into a manifest.json written last."""
    tmp = directory + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    stored, dtypes = {}, {}
    for k, v in arrays.items():
        a, dtypes[k] = _stored(v)
        stored[k.replace("/", "§")] = a
    np.savez(os.path.join(tmp, "arrays.npz"), **stored)
    with open(os.path.join(tmp, "manifest.json.tmp"), "w") as f:
        json.dump({"meta": meta, "dtypes": dtypes}, f)
    os.rename(os.path.join(tmp, "manifest.json.tmp"), os.path.join(tmp, "manifest.json"))
    shutil.rmtree(directory, ignore_errors=True)
    os.rename(tmp, directory)  # atomic publish


def load_snapshot(directory: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a `save_snapshot` directory back as (arrays, meta). Raises
    FileNotFoundError when the directory holds no complete snapshot."""
    manifest_path = os.path.join(directory, "manifest.json")
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no complete snapshot under {directory}")
    with open(manifest_path) as f:
        manifest = json.load(f)
    arrays: Dict[str, Any] = {}
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        for k in z.files:
            arrays[k.replace("§", "/")] = z[k]
    for k, dt in manifest["dtypes"].items():
        if dt == "bfloat16" and k in arrays:
            words = np.ascontiguousarray(arrays[k]).view(np.int16)
            arrays[k] = torch.from_numpy(words).view(torch.bfloat16)
    return arrays, manifest["meta"]

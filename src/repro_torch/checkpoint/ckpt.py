"""Train-state checkpoints and one-shot snapshot directories.

Counterpart of `repro/checkpoint/ckpt.py`, writing the same bytes, so what
one package writes the other reads.

`Checkpointer` keeps a training run's params and optimizer state, one
directory a step:

    <dir>/step_00000123/manifest.json        step, each leaf's shape and dtype
    <dir>/step_00000123/host0000/shards.npz  every leaf under its path

A leaf's path joins its keys and list indices with "/" ("params/layers/
0/attn/wq"; the reference's uniform stack writes "params/blocks/attn/wq").
The step is written as `step_...tmp` with the manifest last and renamed
into place, so a directory without a manifest is an incomplete step, which
is ignored; only the newest `keep` steps are kept. A save copies every
leaf to the host before it returns and may write from a thread. `restore`
rebuilds a `like` tree on its leaves' devices; `read` returns the flat
leaves of any checkpoint, the reference's too.

`save_snapshot` / `load_snapshot` are the serving engine's crash-safe
state:

    <dir>/arrays.npz      every array under its key, "/" escaped as "§"
    <dir>/manifest.json   {"meta": ..., "dtypes": {key: dtype name}}

The directory is built as `<dir>.tmp` with the manifest written last
(tmp file + rename) and then renamed into place, so a kill at any point
leaves the old snapshot or none, never a torn one; a directory without a
manifest is refused. npz has no bf16: bf16 is stored as its 16-bit words
(uint16) and its manifest dtype says "bfloat16". No `ml_dtypes` here: a
bf16 entry comes back as a CPU `torch.bfloat16` tensor of the same bits,
every other entry as a numpy array.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

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


def _to_host(a: np.ndarray, dtype: str) -> Any:
    """A stored npz entry as the caller gets it back: bf16 words as a CPU
    `torch.bfloat16` tensor of the same bits, anything else as is."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


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
        if k in arrays:
            arrays[k] = _to_host(arrays[k], dt)
    return arrays, manifest["meta"]


def flatten(tree: Any) -> Dict[str, Any]:
    """The leaves of a tree of dicts and lists under their "/"-joined
    paths, in the tree's order."""
    flat: Dict[str, Any] = {}

    def rec(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(path + (str(i),), v)
        else:
            flat["/".join(path)] = node

    rec((), tree)
    return flat


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat "/"-joined paths back into nested dicts (list indices stay
    string keys, as the reference's unrolled `layers` are)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, params: Any, opt_state: Any = None) -> None:
        """Copy every leaf to the host now (a consistent snapshot of the
        step), then write it, from a thread with `async_save` (one save
        outstanding at a time)."""
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        # copies, not views: the optimizer updates its tensors in place
        # while a thread may still be writing them
        flat = {k: _stored(v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                           else np.array(v)) for k, v in flatten(tree).items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, Tuple[np.ndarray, str]]) -> None:
        d = self._step_dir(step)
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, "host0000"), exist_ok=True)
        np.savez(os.path.join(tmp, "host0000", "shards.npz"),
                 **{k.replace("/", "§"): a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in flat.items()},
            "n_hosts": 1,
        }
        with open(os.path.join(tmp, "manifest.json.tmp"), "w") as f:
            json.dump(manifest, f)
        os.rename(os.path.join(tmp, "manifest.json.tmp"), os.path.join(tmp, "manifest.json"))
        shutil.rmtree(d, ignore_errors=True)
        os.rename(tmp, d)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> list:
        """The complete steps on disk, ascending."""
        steps = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
        """(step, flat leaves on the host) of `step`, by default the latest
        complete one: bf16 leaves as CPU `torch.bfloat16` tensors, the
        rest as numpy arrays. Raises FileNotFoundError when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "host0000", "shards.npz")) as z:
            flat = {k.replace("§", "/"): z[k] for k in z.files}
        return step, {k: _to_host(flat[k], meta["dtype"])
                      for k, meta in manifest["leaves"].items()}

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[int, Any]:
        """(step, the checkpoint in the structure of `like`, a tree such as
        {"params": ..., "opt_state": ...}), each leaf a tensor on the
        device of `like`'s leaf at its path."""
        step, flat = self.read(step)
        return step, _unflatten(flat, like)


def _unflatten(flat: Dict[str, Any], like: Any) -> Any:
    def rec(path, node):
        if isinstance(node, dict):
            return {k: rec(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(path + (str(i),), v) for i, v in enumerate(node))
        leaf = flat["/".join(path)]
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        return leaf.to(node.device)

    return rec((), like)

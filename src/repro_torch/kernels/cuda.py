"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. A library is built
at its first use into `build/` beside the sources (listed in .gitignore),
named by a hash of the sources, so an edited kernel is never served from a
stale build. `build(names)` starts one `nvcc` per source at once; a source
listed in `_PARTS` compiles in parts, one `nvcc -c` for each set of
defines, all started with the rest, and links them into its library.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIBRARIES = ("deca_gemm", "deca_gemm_sm90", "paged_attention", "deca_decompress")

# sources compiled in parts (each part's defines), then linked: the
# attention source's 84 instances split by KV codec (csrc/paged_attention.cu)
_PARTS = {
    "paged_attention": [[f"-DDECA_KV_CODEC={i}"] for i in (0, 2, 3, 4, 5, 6)]
    + [["-DDECA_ATTN_MAIN"]],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _command(name: str, out: Path, defines=None):
    """nvcc of `name`'s source into the library `out`, or, with `defines`,
    into the object `out` of one part."""
    kind = ["-shared"] if defines is None else ["-c"] + list(defines)
    return [
        _nvcc(), *_ARCH, "-std=c++17", "-O3", *kind, "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build(names: Iterable[str] = LIBRARIES) -> Dict[str, str]:
    """Compile the named libraries that are not built yet, all at once.
    Returns each compiled library's `ptxas -v` report; raises with the
    compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        if name in _PARTS:
            objs = [tmp.with_suffix(f".part{i}.o") for i in range(len(_PARTS[name]))]
            procs[name] = (out, tmp, objs, [
                start(_command(name, o, d)) for o, d in zip(objs, _PARTS[name])])
        else:
            procs[name] = (out, tmp, None, [start(_command(name, tmp))])
    reports, failed = {}, []
    for name, (out, tmp, objs, parts) in procs.items():
        logs = [p.communicate()[0] for p in parts]
        reports[name] = "\n".join(logs)
        bad = [(p.returncode, log) for p, log in zip(parts, logs) if p.returncode != 0]
        if not bad and objs is not None:
            link = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                bad.append((link.returncode, link.stdout + link.stderr))
            for o in objs:
                o.unlink(missing_ok=True)
        if bad:
            failed += [f"{name}: nvcc exited {rc}\n{log}" for rc, log in bad]
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed. `signatures` maps
    each C function to its ctypes argument types; every function returns
    the launch's `cudaGetLastError()` as an int."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

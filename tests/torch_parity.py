"""Run a reference-vs-port check in a fresh Python process in which XLA
rounds every bf16 op (`--xla_allow_excess_precision=false`).

By default XLA:CPU may keep a fused chain of bf16 ops in f32, where the
reference's source (and the port) round after every op; the flag can only
be set before XLA starts, hence the separate process. Under it the port
reproduces the reference bitwise, which the parity tests assert.
"""
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def run_exact(module: str, func: str, *args, timeout: int = 600):
    """`module.func(*args)` in the exact-rounding process; returns its JSON
    result (the last line it prints)."""
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_allow_excess_precision=false",
        PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"), str(HERE)]),
    )
    code = (f"import json, {module} as m; "
            f"print(json.dumps(m.{func}(*{list(args)!r})))")
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE,
                         capture_output=True, text=True, timeout=timeout)
    if run.returncode != 0:
        raise RuntimeError(run.stderr[-4000:])
    return json.loads(run.stdout.strip().splitlines()[-1])

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


class Exact:
    """`module.func(*args)` started in the exact-rounding process; `result()`
    waits for it and returns its JSON result (the last line it prints).
    Several may run at once."""

    def __init__(self, module: str, func: str, *args, timeout: int = 600):
        env = dict(
            os.environ, JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_allow_excess_precision=false",
            PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"), str(HERE)]),
        )
        code = (f"import json, {module} as m; "
                f"print(json.dumps(m.{func}(*{list(args)!r})))")
        self.timeout = timeout
        self.proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=HERE,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
        self._result = None

    def result(self):
        if self._result is None:
            try:
                out, err = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            if self.proc.returncode != 0:
                raise RuntimeError(err[-4000:])
            self._result = json.loads(out.strip().splitlines()[-1])
        return self._result


def run_exact(module: str, func: str, *args, timeout: int = 600):
    """`module.func(*args)` in the exact-rounding process; returns its JSON
    result (the last line it prints)."""
    return Exact(module, func, *args, timeout=timeout).result()

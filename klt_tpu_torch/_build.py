"""Build directory and atomic compiles for the port's native libraries.

Both the host runtime (native/) and the CUDA kernels (cuda/) compile at
first use into `build/klt_tpu_torch/` at the root of the checkout.  The
compiler writes a private temporary file that is renamed into place, so
concurrent processes (pytest-xdist workers) never load a half-written
library.
"""

from __future__ import annotations

import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_ROOT, "build", "klt_tpu_torch")


def repo_path(*parts: str) -> str:
    return os.path.join(_ROOT, *parts)


def is_stale(lib: str, sources: list[str]) -> bool:
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(s) > built for s in sources)


def compile_shared(cmd: list[str], lib: str) -> str:
    """Run `cmd + ["-o", tmp]`, then rename tmp to `lib`.  Returns the
    compiler's output; raises with it when the compiler fails."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {os.path.basename(lib)} failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return proc.stdout + proc.stderr

"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into a shared library with a plain C
interface, under ``build/torch_kernels/`` at the repository root, keyed by
a hash of the source and the flags.  Nothing is built when a module is
imported: the CPU tests import every module on hosts with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

# No --use_fast_math: sqrtf and division stay IEEE and sinf/cosf accurate.
# -fmad=false: no a*b+c contraction, so kernels round as their plain
# PyTorch versions do.  -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    src = (CSRC / (name + ".cu")).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / "{}-{}.so".format(name, key)


def build(name):
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    compiler's output (its ``-Xptxas -v`` report of registers and spills),
    or None when the library was already there."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.tmp{}".format(os.getpid()))
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("kernel build failed: {}: nvcc exit {}\n{}".format(
            name, proc.returncode, proc.stdout))
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load(name):
    """Build ``csrc/<name>.cu`` if needed and load it (one handle per name)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))

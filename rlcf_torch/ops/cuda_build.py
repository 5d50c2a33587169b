"""Build a hand-written CUDA source of the port into a plain-C shared library.

Each source under ``rlcf_torch/csrc/`` is compiled on its own with ``nvcc``
for ``sm_90a`` into the package's git-ignored ``_build/`` directory at first
use, and loaded with ``ctypes``. Builds of different sources may run at the
same time (one lock per library); ``nvcc``'s ptxas report (registers,
shared memory, spills) is kept per library in ``PTXAS``.
"""

from __future__ import annotations

import collections
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
PTXAS = {}  # library name -> ptxas report of its last build
_LOCKS = collections.defaultdict(threading.Lock)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels cannot be built")


def build(source: str, name: str, extra_flags=(), force: bool = False, deps=()) -> str:
    """Compile ``csrc/<source>`` into ``_build/lib<name>.so`` (unless one newer
    than the source and the headers ``deps`` it includes exists and ``force``
    is false); returns the library path."""
    src = os.path.join(CSRC_DIR, source)
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _LOCKS[name]:
        newest = max(os.path.getmtime(os.path.join(CSRC_DIR, f)) for f in (source, *deps))
        if not force and os.path.exists(lib) and os.path.getmtime(lib) >= newest:
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.build.{os.getpid()}"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", *extra_flags, "-o", tmp, src]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src}:\n{res.stderr[-6000:]}")
            PTXAS[name] = res.stderr
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees a half-written file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib

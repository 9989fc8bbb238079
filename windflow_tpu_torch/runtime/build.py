"""Atomic, lock-guarded builds of the port's shared libraries.

Every native artifact of ``windflow_tpu_torch`` -- the host C++ engine
(``runtime/native.py``, g++ over the repo's unchanged ``native/*.cpp``)
and the hand-written CUDA kernels (``ops/cuda/*.cu``, nvcc) -- is built
from sources in the checkout into ``windflow_tpu_torch/_build/`` on
first use.  Several processes may build at once (pytest workers, a
fleet of graph processes), so a build:

* holds an ``fcntl`` lock on ``<lib>.lock`` for its whole duration,
* compiles to a process/thread-unique temporary name, then
  ``os.replace``-s it onto the final name (a reader never maps a
  half-written library),
* is skipped when the library is newer than every source and was
  built by the same command line (recorded in ``<lib>.cmd``).
"""
from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import threading
from typing import List, Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

# placeholder in a command line for the compiler's output path
OUT = "{out}"


def _is_fresh(lib: str, srcs: Sequence[str], stamp: str,
              cmd_str: str) -> bool:
    if not os.path.exists(lib):
        return False
    mtime = os.path.getmtime(lib)
    if any(os.path.getmtime(s) > mtime for s in srcs):
        return False
    try:
        with open(stamp) as f:
            return f.read() == cmd_str
    except OSError:
        return False


def nvcc_command(src: str, include_dirs: Sequence[str] = ()) -> List[str]:
    """The nvcc command line that builds one ``.cu`` file with a plain C
    interface into a shared library for Hopper (``sm_90a``), searching
    ``include_dirs`` for its quoted includes."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc")
        if nvcc is None:
            raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC"] \
        + [f"-I{d}" for d in include_dirs] + ["-o", OUT, src]


def build_shared(name: str, cmd: Sequence[str], srcs: Sequence[str],
                 timeout: float = 600.0) -> str:
    """Build ``_build/<name>`` with ``cmd`` (which names its output as
    :data:`OUT`) unless a fresh build exists; returns the library path.
    Raises ``OSError`` / ``subprocess.SubprocessError`` on failure, with
    the compiler's stderr attached to a ``CalledProcessError``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, name)
    stamp = lib + ".cmd"
    cmd_str = " ".join(cmd)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _is_fresh(lib, srcs, stamp, cmd_str):
            return lib
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run([tmp if a == OUT else a for a in cmd],
                           check=True, capture_output=True, text=True,
                           timeout=timeout)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with open(stamp + ".tmp", "w") as f:
            f.write(cmd_str)
        os.replace(stamp + ".tmp", stamp)
        return lib

"""Build the package's CUDA sources with ``nvcc`` and load them through
``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface.  :func:`load` builds
it at first use into ``build/paddle_tpu_torch/`` at the root of the
checkout (a directory ``.gitignore`` lists), under a file name keyed by
a hash of the source, the ``csrc/`` headers it includes and the flags,
so an edited source or header is rebuilt and an unchanged one is
reused.  A missing ``nvcc`` or a failed compile raises with the
compiler's own message; nothing falls back to the plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"

#: sm_90a: Hopper's wgmma and setmaxnreg (the bf16 flash forward) exist
#: only for that target; -Xptxas=-v reports registers, shared memory and
#: spills per kernel.  No -lcuda: the one driver call, TMA's
#: cuTensorMapEncodeTiled, is reached through the runtime's entry point.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's diagnostics (the ptxas register report) of builds run in this
#: process, by source name.
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
        "needed to build paddle_tpu_torch's kernels")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def included_headers(src: Path) -> list[Path]:
    """The headers beside ``src`` that it includes by a quoted name,
    directly or through one another, each once, in the order found."""
    found, todo = [], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_text()):
            header = src.parent / name
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the build of ``<csrc>/<name>.cu`` lives: keyed by a hash of
    the source, the headers it includes and the flags."""
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in included_headers(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOGS[name] = proc.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib

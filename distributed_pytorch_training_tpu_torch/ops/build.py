"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. ``nvcc``
compiles it for Hopper (``sm_90a``) into ``csrc/build/lib<name>-<hash>.so``
at first use; the hash is of the source, so an edited source builds anew
and a stale library is never loaded. Nothing builds at import time: the
CPU tests import every module on a machine with no ``nvcc``.

No fast math and no flush-to-zero: the int8 quantizer must reproduce IEEE
division and denormals to stay bitwise equal to its reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}   # guarded-by: _lock


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda; raises
    when there is none (a CUDA kernel has no fallback)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels build from csrc/ with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(name: str) -> Path:
    """Compile kernel ``name`` unless it is built already; returns the
    library's path. Raises with nvcc's output when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(name, tmp, find_nvcc()),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name} (nvcc "
                           f"rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it on first use)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.dpt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dpt_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise when a C launcher returned a non-zero cudaGetLastError()."""
    if code != 0:
        msg = lib.dpt_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")

"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. ``nvcc``
compiles it for Hopper (``sm_90a``) into ``csrc/build/lib<name>-<hash>.so``
at first use; the hash is of the source and the shared headers
(``csrc/*.cuh``), so an edited source builds anew and a stale library is
never loaded. nvcc's output, with ptxas's registers
and spills of every kernel (``-Xptxas -v``), is kept beside it as
``lib<name>-<hash>.log``. Nothing builds at import time: the
CPU tests import every module on a machine with no ``nvcc``.

No fast math and no flush-to-zero: the int8 quantizer must reproduce IEEE
division and denormals to stay bitwise equal to its reference, and the
flash-attention kernels use the accurate ``expf``/``logf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every shared header beside it (``csrc/*.cuh``)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every kernel of ``names`` that is not built yet, one
    ``nvcc`` each, all started together; returns {name: library path}.
    Raises with nvcc's output when a build fails."""
    outs = {name: library_path(name) for name in names}
    todo = [name for name, out in outs.items() if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmps = {name: outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
            for name in todo}
    procs = {name: subprocess.Popen(
        nvcc_command(name, tmps[name], nvcc), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in todo}
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmps[name].unlink(missing_ok=True)
            failed.append(f"{name} (nvcc rc={proc.returncode}):\n{log}")
        else:
            outs[name].with_suffix(".log").write_text(log)
            os.replace(tmps[name], outs[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile kernel ``name`` unless it is built already; returns the
    library's path."""
    return build_all([name])[name]


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

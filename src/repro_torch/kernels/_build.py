"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use and
load them with ``ctypes``.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface in
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  The file name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.  All
sources build in parallel, one ``nvcc`` each.  Nothing here runs at
import time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# The launchers set each kernel's shared-memory size (cudaFuncSetAttribute),
# state of the process, to what the launch at hand needs, just before it:
# two threads launching one kernel at two sizes would race between the two
# calls.  Every launch from Python holds this lock for its enqueue (a few
# microseconds) and counts itself under it.
LAUNCH_LOCK = threading.Lock()
PTXAS_LOG: dict[str, str] = {}   # nvcc's -Xptxas -v report per source built here


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, ctypes.CDLL]:
    """Build (one nvcc per source, all at once) and load every source in
    ``names`` (default: all of ``csrc/*.cu``).  Raises RuntimeError with
    nvcc's output on failure, after stopping the other builds."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else names
    with _LOCK:
        jobs = {}
        try:
            for name in names:
                lib = _library_path(name)
                if name in _LIBS or lib.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True), tmp)
            for name, (proc, tmp) in jobs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
                lib = _library_path(name)
                os.replace(tmp, lib)
                lib.with_suffix(".log").write_text(out)
                PTXAS_LOG[name] = out
        finally:
            for proc, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name in names:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]


def check(err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

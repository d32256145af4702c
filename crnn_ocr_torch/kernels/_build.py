"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``crnn_ocr_torch/_build/`` (git-ignored) under a name
keyed by a hash of the source and the flags, so an edited ``.cu`` builds
anew. Builds happen at first use; ``build_all`` starts one nvcc per source
at once. A failed build raises with nvcc's stderr: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCES = ("fused_stem", "bigru", "ctc_loss")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source,
# from the builds this process ran
ptxas_reports: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    stdout, stderr = proc.communicate()
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stderr}{stdout}"
        )
    ptxas_reports[name] = stderr + stdout
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Build every named source that has no library for its current hash,
    one nvcc process per source, all started together. Returns the names
    that were built (the others were up to date)."""
    with _lock:
        todo = {n: _lib_path(n) for n in names}
        todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
        procs = {n: _start(n, p) for n, p in todo.items()}
        try:
            for n, proc in procs.items():
                _finish(n, todo[n], proc)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return list(todo)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (each library
    exports ``crnn_error_string``, cudaGetErrorString under a C name)."""
    if err != 0:
        lib.crnn_error_string.restype = ctypes.c_char_p
        lib.crnn_error_string.argtypes = [ctypes.c_int]
        msg = lib.crnn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

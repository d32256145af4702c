"""The host C++ beam decoder (``ctc_beam_tf.cc``), bound with ctypes.

The source builds at first use with

    g++ -O3 -std=c++17 -fPIC -shared -o _build/ctc_beam_tf-<hash>.so
        native/ctc_beam_tf.cc

into ``crnn_ocr_torch/_build/`` (git-ignored), under a name keyed by a
hash of the source and the flags. A failed build raises with the
compiler's message: there is no fallback to the numpy oracle
(``ops/ctc_beam_exact.py``), which gives the same outputs and would hide
behind this path in a timing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "ctc_beam_tf.cc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_lock = threading.Lock()
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ctc_beam_tf-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless its library exists; returns its path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC} (exit {proc.returncode}):"
                           f"\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ctc_beam_decode_tf.restype = None
            lib.ctc_beam_decode_tf.argtypes = [
                _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _i32p,
                _f32p,
            ]
            _lib = lib
        return _lib


def ctc_beam_decode_tf(probs: np.ndarray, seq_len: np.ndarray,
                       beam_width: int = 10, top_paths: int = 1,
                       merge_repeated: bool = True):
    """TF-exact beam decode of (B, T, C) post-softmax ``probs`` on the host.
    Returns (paths (B, top_paths, T) int32 padded with -1, lens (B,
    top_paths) int32, scores (B, top_paths) float32)."""
    lib = load()
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    B, T, C = probs.shape
    seq_len = np.ascontiguousarray(seq_len, dtype=np.int32).reshape(B)
    out_paths = np.full((B, top_paths, T), -1, np.int32)
    out_lens = np.zeros((B, top_paths), np.int32)
    out_scores = np.zeros((B, top_paths), np.float32)
    lib.ctc_beam_decode_tf(
        probs.ctypes.data_as(_f32p), B, T, C, seq_len.ctypes.data_as(_i32p),
        beam_width, top_paths, 1 if merge_repeated else 0,
        out_paths.ctypes.data_as(_i32p), out_lens.ctypes.data_as(_i32p),
        out_scores.ctypes.data_as(_f32p),
    )
    return out_paths, out_lens, out_scores

"""The port's host C++, bound with ctypes: the TF-exact beam decoder
(``ctc_beam_tf.cc``), the edit distance (``editdistance.cc``) and one
line's preprocessing (``imgproc.cc``), copies of
``crnn_ocr_tpu/native/src/``.

Each source builds at first use with

    g++ -O3 -std=c++17 -fPIC -shared -o _build/<name>-<hash>.so
        native/<name>.cc

into ``crnn_ocr_torch/_build/`` (git-ignored), under a name keyed by a
hash of the source and the flags. A failed build raises with the
compiler's message: there is no fallback to the plain Python versions
(``ops/ctc_beam_exact.py``, ``utils/metrics.py::levenshtein_plain``), which
give the same outputs and would hide behind this path in a timing.

Processes that start together (the ranks of a data-parallel run) build
once: "check, build, rename" runs under an exclusive ``fcntl.flock`` on
``<build dir>/.lock`` (``build_lock``, which the CUDA kernels' builder
takes too), and each library is written under a temporary name and
renamed into place, so no process loads a library half written.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterator, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = {name: os.path.join(_DIR, f"{name}.cc")
           for name in ("ctc_beam_tf", "editdistance", "imgproc")}
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64

# each library's functions: (restype, argtypes)
_SIGNATURES = {
    "ctc_beam_tf": {"ctc_beam_decode_tf": (None, [
        _f32p, _i64, _i64, _i64, _i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _i32p, _i32p, _f32p])},
    "editdistance": {"levenshtein_i32": (_i64, [_i32p, _i64, _i32p, _i64])},
    "imgproc": {"preprocess_line_u8": (ctypes.c_int32, [
        _u8p, _i64, _i64, _f32p, _i64, _i64, ctypes.c_int])},
}


def lib_path(src: str) -> str:
    """Where the library of source file ``src`` is built."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


@contextlib.contextmanager
def build_lock(build_dir: str) -> Iterator[None]:
    """Hold an exclusive ``flock`` on ``<build_dir>/.lock``: one process at
    a time checks for, builds and renames a library there."""
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(src: str) -> str:
    """Compile ``src`` unless its library exists; returns its path."""
    out = lib_path(src)
    if os.path.exists(out):
        return out
    with build_lock(os.path.dirname(out)):
        if os.path.exists(out):  # built by another process meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src} (exit "
                               f"{proc.returncode}):\n{proc.stderr}"
                               f"{proc.stdout}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (a key of ``SOURCES``), built
    if needed."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(SOURCES[name]))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def ctc_beam_decode_tf(probs: np.ndarray, seq_len: np.ndarray,
                       beam_width: int = 10, top_paths: int = 1,
                       merge_repeated: bool = True):
    """TF-exact beam decode of (B, T, C) post-softmax ``probs`` on the host.
    Returns (paths (B, top_paths, T) int32 padded with -1, lens (B,
    top_paths) int32, scores (B, top_paths) float32)."""
    lib = load("ctc_beam_tf")
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


def _as_i32(seq: Sequence) -> np.ndarray:
    """A string by its code points, an int sequence as it is; a sequence
    of other tokens raises ``TypeError``."""
    if isinstance(seq, str):
        return np.frombuffer(seq.encode("utf-32-le"), np.int32)
    arr = np.asarray(list(seq))
    if arr.dtype.kind == "U" or arr.dtype == object:
        raise TypeError("token sequences need mapping to ids")
    return np.ascontiguousarray(arr, dtype=np.int32)


def editdistance(a: Sequence, b: Sequence) -> int:
    """Unit-cost Levenshtein distance between two strings, two int
    sequences or two token lists (WER's words, given ids in order of first
    sight over ``a`` then ``b``), in C++."""
    lib = load("editdistance")
    try:
        aa, bb = _as_i32(a), _as_i32(b)
    except TypeError:
        vocab: Dict[object, int] = {}
        aa, bb = (np.asarray([vocab.setdefault(t, len(vocab)) for t in s],
                             np.int32) for s in (a, b))
    return int(lib.levenshtein_i32(aa.ctypes.data_as(_i32p), len(aa),
                                   bb.ctypes.data_as(_i32p), len(bb)))


def preprocess_line(img: np.ndarray, out_h: int = 32, out_w: int = 128,
                    normalize: bool = True):
    """One (h, w) uint8 line -> ((out_h, out_w) float32 frame, content
    width), in C++: bilinear resize to ``out_h`` with cv2's half-pixel
    sampling, white pad to ``out_w``, /255 and, with ``normalize``, the
    per-image standardization."""
    lib = load("imgproc")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"expected a non-empty (h, w) image, got "
                         f"{img.shape}")
    h, w = img.shape
    dst = np.empty((out_h, out_w), np.float32)
    w_new = lib.preprocess_line_u8(img.ctypes.data_as(_u8p), h, w,
                                   dst.ctypes.data_as(_f32p), out_h, out_w,
                                   1 if normalize else 0)
    return dst, int(w_new)

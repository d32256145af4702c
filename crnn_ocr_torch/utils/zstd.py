"""zstd decompression through the system's ``libzstd``, bound with ctypes.

The JAX package's orbax checkpoints compress their OCDBT nodes and their
zarr chunks with zstd (``train/orbax.py``), and neither machine gives
Python a zstd module the port may use. Both have the C library
``libzstd.so.1`` (Debian and Ubuntu install it with ``dpkg``), so the port
calls its one-shot decoder: ``ZSTD_getFrameContentSize``,
``ZSTD_decompress``, ``ZSTD_isError`` and ``ZSTD_getErrorName``. There is
no other decoder to fall back to: without the library ``decompress``
raises, naming it.

    from crnn_ocr_torch.utils import zstd
    raw = zstd.decompress(frame)              # one frame or several
    raw = zstd.decompress(frame, size_hint=n) # a frame without its size
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded ``libzstd``, its four functions typed."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(ctypes.util.find_library("zstd") or LIBRARY)
            except OSError as e:
                raise OSError(
                    f"zstd: the system library {LIBRARY} (libzstd) is not "
                    f"installed; reading orbax checkpoints needs it ({e})"
                ) from e
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                     ctypes.c_size_t]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_char_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_versionNumber.restype = ctypes.c_uint
            _lib = lib
        return _lib


def describe() -> dict:
    """Which decoder runs: the route, the library's name and version."""
    v = library().ZSTD_versionNumber()
    return {"route": "ctypes", "library": ctypes.util.find_library("zstd")
            or LIBRARY, "version": f"{v // 10000}.{v // 100 % 100}.{v % 100}"}


def decompress(data: bytes, size_hint: Optional[int] = None) -> bytes:
    """The decompressed bytes of ``data``: one zstd frame or several in a
    row (skippable frames included). The output buffer takes the first
    frame's content size where its header states one, else ``size_hint``
    (a zarr chunk's byte count), else four times the input; a buffer found
    too small is doubled and the call repeated. A corrupt frame raises
    ``ValueError`` with libzstd's message."""
    lib = library()
    data = bytes(data)
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError(f"zstd: not a zstd frame ({data[:4].hex()})")
    cap = (size if size != _CONTENTSIZE_UNKNOWN
           else size_hint if size_hint is not None
           else 4 * len(data) + 64)
    while True:
        buf = ctypes.create_string_buffer(max(int(cap), 1))
        n = lib.ZSTD_decompress(buf, cap, data, len(data))
        if not lib.ZSTD_isError(n):
            return buf.raw[:n]
        err = lib.ZSTD_getErrorName(n).decode()
        if "too small" not in err:
            raise ValueError(f"zstd: {err}")
        cap = 2 * cap + 64

"""Packed image cache: decode a corpus once, then read batches from mmap.

A copy of ``crnn_ocr_tpu/data/packed.py::PackedCache``; its shards and
index are byte-identical to the JAX package's for the same images.

  first epoch   each image is decoded once (cv2), height-normalized to the
                model's height with ``cv2.INTER_LINEAR`` (the reference's
                host resize) and its (height, bucket) uint8 row, white past
                ``w_new``, appended to a per-bucket flat shard under
                ``<path>/.crnn_pack/``;
  thereafter    batches assemble from ``np.memmap`` row slices: no image
                decode, no resize.

Layout:
  .crnn_pack/index.json      {"version", "height", "buckets",
                              "entries": {relpath: [bucket, row, w_new]},
                              "counts": {bucket: n_rows}}
  .crnn_pack/shard_<W>.bin   n_rows * height * W uint8, row-major

A load checks each shard's size against its count: rows appended after the
last index flush (an interrupted build) are cut off, and a shard shorter
than its count, or an index of another configuration, starts the cache
afresh. On a read-only data directory ``add`` raises ``OSError`` and the
reader stays uncached.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

VERSION = 1


class PackedCache:
    """Per-bucket mmap shards of height-normalized grayscale rows."""

    def __init__(self, root: str, height: int, buckets: Sequence[int]):
        self.dir = os.path.join(root, ".crnn_pack")
        self.height = int(height)
        self.buckets = tuple(int(b) for b in buckets)
        self.entries: Dict[str, Tuple[int, int, int]] = {}
        self.counts: Dict[int, int] = {b: 0 for b in self.buckets}
        self._mmaps: Dict[int, np.memmap] = {}
        self._load()

    # ---- persistence ----

    def _index_path(self) -> str:
        return os.path.join(self.dir, "index.json")

    def _shard_path(self, bucket: int) -> str:
        return os.path.join(self.dir, f"shard_{bucket}.bin")

    def _load(self) -> None:
        try:
            with open(self._index_path()) as f:
                idx = json.load(f)
            if (idx.get("version") != VERSION
                    or idx.get("height") != self.height
                    or tuple(idx.get("buckets", ())) != self.buckets):
                raise ValueError("index config mismatch")
            counts = {int(k): int(v) for k, v in idx["counts"].items()}
            for b, n in counts.items():
                want = n * self.height * b
                have = (os.path.getsize(self._shard_path(b))
                        if os.path.exists(self._shard_path(b)) else 0)
                if have > want:
                    # interrupted build: rows appended after the last index
                    # flush are unreferenced — drop them so new appends land
                    # at the row the index will assign
                    with open(self._shard_path(b), "r+b") as f:
                        f.truncate(want)
                elif have < want:
                    raise ValueError(
                        f"shard_{b}.bin is {have} bytes, index says {want}"
                    )
            self.entries = {
                k: (int(v[0]), int(v[1]), int(v[2]))
                for k, v in idx["entries"].items()
            }
            self.counts = {b: counts.get(b, 0) for b in self.buckets}
        except (OSError, ValueError, KeyError):
            # missing / interrupted / reconfigured cache: start clean
            self.entries = {}
            self.counts = {b: 0 for b in self.buckets}
            for b in self.buckets:
                try:
                    if os.path.exists(self._shard_path(b)):
                        os.remove(self._shard_path(b))
                except OSError:
                    pass

    def flush_index(self) -> bool:
        """Atomically persist the index; False if the dir is read-only."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._index_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "version": VERSION,
                        "height": self.height,
                        "buckets": list(self.buckets),
                        "counts": {str(k): v for k, v in self.counts.items()},
                        "entries": {
                            k: list(v) for k, v in self.entries.items()
                        },
                    },
                    f,
                )
            os.replace(tmp, self._index_path())
            return True
        except OSError:
            return False

    # ---- write path (first epoch) ----

    def bucket_for_width(self, w_new: int) -> int:
        for b in self.buckets:
            if w_new <= b:
                return b
        return self.buckets[-1]

    def add(self, relpath: str, img: np.ndarray) -> Tuple[int, int, int]:
        """Height-normalize a decoded grayscale image and append it.

        Returns (bucket, row, w_new). Raises OSError on read-only dirs
        (caller falls back to uncached reads).
        """
        import cv2

        h, w = img.shape[:2]
        w_new = max(1, int(round(w * self.height / h)))
        bucket = self.bucket_for_width(w_new)
        w_new = min(w_new, bucket)
        resized = cv2.resize(
            img, (w_new, self.height), interpolation=cv2.INTER_LINEAR
        )
        row = np.full((self.height, bucket), 255, np.uint8)
        row[:, :w_new] = resized
        os.makedirs(self.dir, exist_ok=True)
        with open(self._shard_path(bucket), "ab") as f:
            f.write(row.tobytes())
        r = self.counts[bucket]
        self.counts[bucket] = r + 1
        self.entries[relpath] = (bucket, r, w_new)
        self._mmaps.pop(bucket, None)  # shard grew; remap on next read
        return bucket, r, w_new

    # ---- read path (steady state) ----

    def get(self, relpath: str) -> Optional[np.ndarray]:
        """(32, w_new) uint8 view for a cached image, or None."""
        e = self.entries.get(relpath)
        if e is None:
            return None
        bucket, row, w_new = e
        mm = self._mmaps.get(bucket)
        if mm is None:
            n = self.counts[bucket]
            mm = np.memmap(
                self._shard_path(bucket), dtype=np.uint8, mode="r",
                shape=(n, self.height, bucket),
            )
            self._mmaps[bucket] = mm
        return mm[row, :, :w_new]

    def size(self, relpath: str) -> Optional[Tuple[int, int]]:
        """(h, w) of the STORED row — already height-normalized."""
        e = self.entries.get(relpath)
        if e is None:
            return None
        return (self.height, e[2])

    def __contains__(self, relpath: str) -> bool:
        return relpath in self.entries

    def __len__(self) -> int:
        return len(self.entries)

"""Dataset reader: an image directory and its transcriptions -> batches.

A copy of ``crnn_ocr_tpu/data/reader.py`` (``ReaderConfig``, ``Reader``,
``_parse_filename_label``, ``IMG_EXTS``), the reference's
``utils.py#Readf``: it walks an image directory, builds or takes the class
map, encodes transcriptions as dense labels, groups images into width
buckets and yields raw host batches under the reference's key names
(``the_input``, ``the_labels``, ``label_length``), which
``data.pipeline.device_batches`` moves to the device. For the same
directory and configuration the batch stream (canvas bytes, heights,
widths, labels, bucket, texts and order) is the JAX package's.

Two layouts:
  * ``annotation``: a text file of ``<relpath><sep><transcription>`` lines
    (IAM-words style; the separator is a tab, else a space).
  * ``filename``: the transcription between the first pair of underscores
    of the file name (mjsynth style, ``189_plate_3.png`` -> "plate"), else
    the stem (plate crops, ``A123BC.png``).

The host work is the image decode (``cv2.imread``, imported where it is
used), and none at all for an image already in the packed cache
(``pack_cache``, ``data/packed.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from crnn_ocr_torch.data.codec import LabelCodec

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".tif", ".tiff")


@dataclasses.dataclass
class ReaderConfig:
    path: str
    annotation: Optional[str] = None  # file name inside path, or None
    layout: str = "annotation"  # "annotation" | "filename"
    height: int = 32
    buckets: Sequence[int] = (64, 128, 192, 256)
    batch_size: int = 32
    val_fraction: float = 0.1
    max_label_len: int = 32
    shuffle_seed: int = 0
    limit: Optional[int] = None
    # Decode-once packed cache (data/packed.py): first epoch decodes each
    # image once into per-bucket mmap shards under <path>/.crnn_pack/;
    # every later batch assembles from mmap slices with ZERO image decodes.
    # The batch stream (bucketing, shuffling, resume replay) is identical
    # either way; pixels differ only by cv2's host resample against the
    # device preprocess's.
    pack_cache: bool = False


def _parse_filename_label(fname: str) -> str:
    stem = os.path.splitext(os.path.basename(fname))[0]
    parts = stem.split("_")
    if len(parts) >= 3:
        return parts[1]  # mjsynth: <idx>_<WORD>_<tag>
    return stem  # plate crops: label is the stem


class Reader:
    """Builds the sample list + codec; yields width-bucketed batches."""

    def __init__(self, cfg: ReaderConfig, codec: Optional[LabelCodec] = None):
        self.cfg = cfg
        self.samples = self._scan()  # list of (path, text)
        if cfg.limit:
            self.samples = self.samples[: cfg.limit]
        if not self.samples:
            raise FileNotFoundError(f"no samples found under {cfg.path}")
        self.codec = codec or LabelCodec.from_texts(t for _, t in self.samples)
        rng = np.random.default_rng(cfg.shuffle_seed)
        order = rng.permutation(len(self.samples))
        n_val = int(len(self.samples) * cfg.val_fraction)
        self._val_idx = order[:n_val]
        self._train_idx = order[n_val:]
        # Persistent image-size sidecar: bucket planning (and resume's
        # skip fast-forward) needs every image's (h, w) but NOT its pixels.
        # Sizes are decoded lazily on first sight, cached here, and written
        # back to ``<path>/.crnn_sizes.json`` so later epochs/processes
        # (notably --resume, SURVEY.md §5.4) plan the whole batch stream
        # with zero image decodes. Read-only data dirs degrade gracefully
        # to the in-memory cache.
        self._sizes_path = os.path.join(cfg.path, ".crnn_sizes.json")
        self._size_cache: Dict[str, Tuple[int, int]] = {}
        self._sizes_dirty = 0
        self._pack = None
        if cfg.pack_cache:
            from crnn_ocr_torch.data.packed import PackedCache

            self._pack = PackedCache(cfg.path, cfg.height, cfg.buckets)
            self._pack_dirty = 0
        try:
            import json

            with open(self._sizes_path) as f:
                raw = json.load(f)
            self._size_cache = {k: (int(v[0]), int(v[1]))
                                for k, v in raw.items()}
        except (OSError, ValueError):
            pass

    def _size_key(self, i: int) -> str:
        return os.path.relpath(self.samples[i][0], self.cfg.path)

    def _flush_sizes(self) -> None:
        """Atomically persist newly discovered sizes (best effort)."""
        if not self._sizes_dirty:
            return
        self._sizes_dirty = 0
        try:
            import json

            tmp = self._sizes_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({k: list(v) for k, v in self._size_cache.items()},
                          f)
            os.replace(tmp, self._sizes_path)
        except OSError:
            pass  # read-only data dir: keep the in-memory cache only

    # ---- discovery ----

    def _scan(self) -> List[Tuple[str, str]]:
        cfg = self.cfg
        samples: List[Tuple[str, str]] = []
        if cfg.layout == "annotation":
            ann = os.path.join(cfg.path, cfg.annotation or "annotation.txt")
            with open(ann) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#"):
                        continue
                    for sep in ("\t", " "):
                        if sep in line:
                            rel, text = line.split(sep, 1)
                            break
                    else:
                        continue
                    p = os.path.join(cfg.path, rel)
                    if os.path.exists(p):
                        samples.append((p, text.strip()))
        elif cfg.layout == "filename":
            for root, _, files in os.walk(cfg.path):
                for fn in sorted(files):
                    if fn.lower().endswith(IMG_EXTS):
                        samples.append(
                            (os.path.join(root, fn), _parse_filename_label(fn))
                        )
        else:
            raise ValueError(f"unknown layout {cfg.layout!r}")
        return samples

    # ---- loading ----

    def _load_image(self, path: str) -> np.ndarray:
        if self._pack is not None:
            rel = os.path.relpath(path, self.cfg.path)
            row = self._pack.get(rel)
            if row is not None:
                return row  # (height, w_new) mmap view, decode-free
            img = self._decode_image(path)
            try:
                self._pack.add(rel, img)
                self._pack_dirty += 1
                if self._pack_dirty >= 1024:
                    self._pack.flush_index()
                    self._pack_dirty = 0
                # return the cached row so first-epoch pixels match every
                # later epoch (host cv2 resize once, identically)
                return self._pack.get(rel)
            except OSError:
                return img  # read-only data dir: stay uncached
        return self._decode_image(path)

    def _decode_image(self, path: str) -> np.ndarray:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"failed to read {path}")
        return img

    def bucket_of(self, img: np.ndarray) -> int:
        """Smallest bucket width >= aspect-preserved content width."""
        h, w = img.shape[:2]
        return self._bucket_for_size(h, w)

    def _bucket_for_size(self, h: int, w: int) -> int:
        w_new = int(round(w * self.cfg.height / h))
        for b in self.cfg.buckets:
            if w_new <= b:
                return b
        return int(self.cfg.buckets[-1])

    def _epoch_batches(
        self, idx: np.ndarray, rng: np.random.Generator, train: bool
    ) -> List[List[int]]:
        order = rng.permutation(idx) if train else idx
        # group by bucket for padding efficiency (C2 "width-bucketed")
        by_bucket: Dict[int, List[int]] = {}
        for i in order:
            path, _ = self.samples[int(i)]
            # bucket from stored size cache to avoid double decode
            b = self._size_bucket(int(i))
            by_bucket.setdefault(b, []).append(int(i))
        self._flush_sizes()  # persist any sizes this planning discovered
        if self._pack is not None and self._pack_dirty:
            self._pack.flush_index()
            self._pack_dirty = 0
        batches = []
        for b, lst in sorted(by_bucket.items()):
            for k in range(0, len(lst), self.cfg.batch_size):
                chunk = lst[k : k + self.cfg.batch_size]
                if train and len(chunk) < self.cfg.batch_size:
                    continue  # static shapes: drop ragged tail in training
                batches.append(chunk)
        if train:
            rng.shuffle(batches)
        return batches

    def _size_bucket(self, i: int) -> int:
        key = self._size_key(i)
        if self._pack is not None and key in self._pack:
            # bucket was pinned when the row was packed (same rounding
            # formula as _bucket_for_size, so cached == uncached streams)
            return self._pack.entries[key][0]
        size = self._size_cache.get(key)
        if size is None:
            img = self._load_image(self.samples[i][0])
            if self._pack is not None and key in self._pack:
                return self._pack.entries[key][0]  # _load_image packed it
            size = (int(img.shape[0]), int(img.shape[1]))
            self._size_cache[key] = size
            self._sizes_dirty += 1
        return self._bucket_for_size(*size)

    def run_generator(
        self, train: bool = True, epochs: Optional[int] = None,
        skip: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite (or epochs-bounded) generator of raw host batches.

        Yields dicts with images still at native size (white-padded canvas)
        plus labels; the device preprocess happens in pipeline.py.

        ``skip``: fast-forward past the first N batches WITHOUT decoding
        their images (bucket planning still consumes the seeded rng
        identically), so ``--resume`` replays the exact remaining batch
        stream (SURVEY.md §5.4 data-iterator state — here the iterator
        state is a pure function of (seed, config, global step), so the
        step already persisted in the checkpoint fully determines it).
        With a populated ``.crnn_sizes.json`` sidecar (written by any prior
        epoch or run over the same data), planning itself issues ZERO image
        decodes, so resume startup is O(1) in corpus size from the very
        first epoch; on a cold corpus only the first planning pass decodes
        (once per image), then persists.
        """
        from crnn_ocr_torch.ops.preprocess import pack_canvas

        cfg = self.cfg
        rng = np.random.default_rng(cfg.shuffle_seed + (1 if train else 2))
        idx = self._train_idx if train else self._val_idx
        epoch = 0
        to_skip = int(skip)
        while epochs is None or epoch < epochs:
            for chunk in self._epoch_batches(idx, rng, train):
                if to_skip > 0:
                    to_skip -= 1
                    continue
                images = [self._load_image(self.samples[i][0]) for i in chunk]
                texts = [self.samples[i][1] for i in chunk]
                canvas, hs, ws = pack_canvas(images)
                labels, lab_len = self.codec.encode_batch(
                    texts, cfg.max_label_len
                )
                yield {
                    "the_input": canvas,
                    "heights": hs,
                    "widths": ws,
                    "the_labels": labels,
                    "label_length": lab_len,
                    "bucket": self._size_bucket(chunk[0]),
                    "texts": texts,
                }
            epoch += 1

    def steps_per_epoch(self, train: bool = True) -> int:
        rng = np.random.default_rng(0)
        idx = self._train_idx if train else self._val_idx
        return len(self._epoch_batches(idx, rng, train))

"""A packed corpus held in device memory: batches become row indices
(``crnn_ocr_tpu/data/device_cache.py``).

Each bucket's packed shard (``data/packed.py``: rows already
height-normalized and white-padded to the bucket) is uploaded once,
beside row-ordered width, label and label-length tables, and a train call
is given (K, B) row indices instead of pixels
(``train.step.make_cached_multi_train_step``): the batch is gathered on
the device.

The batch stream (order, bucketing, shuffling, the resume skip, the
augmentation indices) is the ``pack_cache`` host path's: planning reuses
``Reader._epoch_batches`` with the same seeded generator, and the rows
gathered are the packed rows the host path copies.

Partial residency: where the pixels do not fit ``max_bytes``, as many rows
of each bucket as fit stay on the device (a prefix of its shard) and each
stack carries the rest as a miss payload, copied from the mmap shards (no
decode) and gathered beside the resident rows on the device
(``make_partial_cached_multi_train_step``); the tables always stay whole.
The bytes a step reads are the same either way.

The guards raise rather than fall back to streamed pixels: a reader
without ``pack_cache``, rows that could not be packed (a read-only data
directory), tables over the budget, and one image named twice with two
transcriptions.

Under a process mesh (``mesh=``, ``parallel/mesh.py``) each rank holds the
full tables on its own device, JAX's replicated layout (``device_cache.py:
151-154``), and each rank's K-step call gathers only its own columns of a
stack's rows (``train.step.make_cached_multi_train_step(mesh=)``). Only
rank 0 packs: the other ranks' readers must find the corpus packed
(``cli/train.py`` has rank 0 pack it before the others build theirs).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch


class DeviceResidentCorpus:
    """Uploads a packed corpus to ``device`` once.

    Per populated bucket ``W``:
      pixels  (N_resident, height, W) uint8: the shard's first rows
      widths  (N,) int32: content widths (white beyond)
      labels  (N, max_label_len) int32: the encoded texts, in row order
      lab_len (N,) int32

    ``total_bytes`` is the tables' and all pixels' size; ``partial`` and
    ``resident_fraction`` say how much of the pixels stay on the device.
    """

    # JAX's default, kept for parity: 8 GiB, about a tenth of an NVIDIA
    # H100's 80 GB
    def __init__(self, reader, max_bytes: int = 8 << 30, device="cuda",
                 mesh=None):
        if mesh is not None:  # the tables whole on the rank's device
            device = mesh.device
        if reader._pack is None:
            raise ValueError(
                "device_cache requires pack_cache=True on the Reader "
                "(the packed shards are the device tables)")
        # here, not at the top: infer.predictor imports this package
        from crnn_ocr_torch.infer.predictor import resolve_device

        self.reader = reader
        self.device = resolve_device(device)
        pack = reader._pack
        packer = mesh is None or not mesh.process or mesh.writer
        if packer:
            # pack every sample (a cold corpus decodes each image once here)
            for path, _ in reader.samples:
                reader._load_image(path)
            pack.flush_index()
        missing = [reader._size_key(i) for i in range(len(reader.samples))
                   if reader._size_key(i) not in pack.entries]
        if missing and not packer:
            raise ValueError(
                f"device_cache: rank {mesh.rank}'s reader finds "
                f"{len(missing)} of {len(reader.samples)} samples unpacked; "
                f"under a process mesh rank 0 packs the corpus, and the "
                f"other ranks build their readers after it")
        if missing:
            raise ValueError(
                f"device_cache: {len(missing)} of {len(reader.samples)} "
                f"samples could not be packed (first: {missing[0]!r}); is "
                f"the data dir read-only? The packed shards must be "
                f"writable under {pack.dir}; use the pack_cache streaming "
                f"path otherwise")

        height = reader.cfg.height
        L = reader.cfg.max_label_len
        table_bytes = sum(n * (4 * L + 8) for n in pack.counts.values() if n)
        pixel_bytes = sum(n * height * b for b, n in pack.counts.items() if n)
        self.total_bytes = table_bytes + pixel_bytes
        if table_bytes > max_bytes:
            raise ValueError(
                f"device_cache: the label and width tables alone need "
                f"~{table_bytes / 1e9:.2f} GB (> max_bytes "
                f"{max_bytes / 1e9:.2f} GB); the corpus is too large even "
                f"for partial residency: use the pack_cache streaming path")
        self.resident_fraction = min(
            1.0, (max_bytes - table_bytes) / max(pixel_bytes, 1))
        self.partial = self.resident_fraction < 1.0

        texts_by_row: Dict[int, Dict[int, str]] = {}
        for i, (_, text) in enumerate(reader.samples):
            b, row, _ = pack.entries[reader._size_key(i)]
            prev = texts_by_row.setdefault(b, {}).setdefault(row, text)
            if prev != text:
                raise ValueError(
                    f"device_cache: image {reader._size_key(i)!r} appears "
                    f"with conflicting transcriptions ({prev!r} vs "
                    f"{text!r}); the row-ordered label table holds one; use "
                    f"the pack_cache streaming path for corpora with "
                    f"duplicate image entries")

        def put(a: np.ndarray) -> torch.Tensor:  # a copy: mmaps are read-only
            return torch.from_numpy(np.array(a)).to(self.device)

        self._arrays: Dict[int, Dict[str, torch.Tensor]] = {}
        self._mm: Dict[int, np.memmap] = {}
        self._n_resident: Dict[int, int] = {}
        for b, n in sorted(pack.counts.items()):
            if not n:
                continue
            mm = np.memmap(pack._shard_path(b), dtype=np.uint8, mode="r",
                           shape=(n, height, b))
            widths = np.ones((n,), np.int32)
            texts = [""] * n
            for bb, row, w_new in pack.entries.values():
                if bb == b:
                    widths[row] = w_new
            for row, t in texts_by_row.get(b, {}).items():
                texts[row] = t
            labels, lab_len = reader.codec.encode_batch(texts, L)
            n_res = n if not self.partial else max(
                1, int(n * self.resident_fraction))
            self._mm[b] = mm
            self._n_resident[b] = n_res
            self._arrays[b] = {
                "pixels": put(mm[:n_res]),
                "widths": put(widths),
                "labels": put(labels.astype(np.int32)),
                "lab_len": put(lab_len.astype(np.int32)),
            }
        # sample index -> (bucket, row), for planning
        n_samples = len(reader.samples)
        self._row_of = np.zeros((n_samples,), np.int32)
        self._bucket_of = np.zeros((n_samples,), np.int32)
        for i in range(n_samples):
            b, row, _ = pack.entries[reader._size_key(i)]
            self._row_of[i] = row
            self._bucket_of[i] = b

    def arrays(self, bucket: int) -> Dict[str, torch.Tensor]:
        return self._arrays[int(bucket)]

    def resident_bytes(self) -> int:
        """The bytes the tables and the resident pixels take on the
        device."""
        return sum(t.numel() * t.element_size()
                   for arrs in self._arrays.values() for t in arrs.values())

    # ---- batch planning (the stream of Reader.run_generator) ----

    def index_batches(self, train: bool = True, epochs: Optional[int] = None,
                      skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yields ``{"bucket", "rows" (B,) int32}`` in the order the host
        path yields pixel batches (the same seeded generator and epoch
        planner), touching no pixel."""
        r = self.reader
        rng = np.random.default_rng(r.cfg.shuffle_seed + (1 if train else 2))
        idx = r._train_idx if train else r._val_idx
        epoch = 0
        to_skip = int(skip)
        while epochs is None or epoch < epochs:
            for chunk in r._epoch_batches(idx, rng, train):
                if to_skip > 0:
                    to_skip -= 1
                    continue
                yield {"bucket": int(self._bucket_of[chunk[0]]),
                       "rows": self._row_of[np.asarray(chunk, np.int64)]}
            epoch += 1

    def stacked_index_batches(self, n_inner: int, train: bool = True,
                              epochs: Optional[int] = None, skip: int = 0
                              ) -> Iterator[Dict[str, np.ndarray]]:
        """Same-bucket (K, B) stacks of ``index_batches`` for
        ``train.step.make_cached_multi_train_step``: the regrouping rule and
        the ``batch_index`` stream of ``data.pipeline.stack_host_batches``.
        A bounded stream flushes each bucket's partial group as a smaller
        stack. Under partial residency each stack adds ``pix_rows`` (K, B)
        int32 (``>= 0``: a resident row; ``< 0``: miss slot ``-(i + 1)``)
        and ``miss_pixels`` (cap, height, W) uint8, whose capacity is a
        steady value per (bucket, K): the expected misses plus 25 %, a
        multiple of 64, raised by 64 while short."""
        pending: Dict[int, list] = {}
        n_produced = int(skip)

        def emit(bucket, group):
            out = {
                "device_cached": True,
                "stacked": len(group),
                "bucket": bucket,
                "rows": np.stack([g[0] for g in group]),
                "batch_index": np.array([g[1] for g in group], np.int32),
            }
            if self.partial:
                rows = out["rows"]
                n_res = self._n_resident[bucket]
                mm = self._mm[bucket]
                miss_mask = rows >= n_res
                miss_rows = rows[miss_mask]
                exp_frac = 1.0 - n_res / max(mm.shape[0], 1)
                cap = max(64, -(-int(rows.size * exp_frac * 1.25) // 64) * 64)
                while cap < len(miss_rows):
                    cap += 64
                miss_px = np.zeros((cap,) + mm.shape[1:], np.uint8)
                if len(miss_rows):
                    miss_px[:len(miss_rows)] = mm[miss_rows]
                pix_rows = rows.astype(np.int32, copy=True)
                pix_rows[miss_mask] = -(
                    np.arange(len(miss_rows), dtype=np.int32) + 1)
                out["pix_rows"] = pix_rows
                out["miss_pixels"] = miss_px
            return out

        for b in self.index_batches(train=train, epochs=epochs, skip=skip):
            bucket = b["bucket"]
            group = pending.setdefault(bucket, [])
            group.append((b["rows"], n_produced))
            n_produced += 1
            if len(group) == n_inner:
                yield emit(bucket, pending.pop(bucket))
        for bucket in sorted(pending):
            if pending[bucket]:
                yield emit(bucket, pending[bucket])

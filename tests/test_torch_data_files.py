"""Port parity: the files corpus (``crnn_ocr_torch/data/{codec,reader,
packed,pipeline,fontgen}.py`` against ``crnn_ocr_tpu/data/``).

Every comparison here is exact: the port's copies of the JAX package's
host code give the same bytes.

* ``LabelCodec.from_texts`` and ``default_ocr_codec``: equal class maps.
* ``Reader`` over the same image directory (two copies, so that neither
  reads the other's sidecar or pack cache), annotation and filename
  layouts, with and without ``pack_cache``: the same batch stream over 2
  epochs (canvas bytes, heights, widths, labels, bucket, texts, order),
  and in the packed case byte-equal shards and index.
* ``run_generator(skip=n)``: the stream without its first n batches, with
  no ``cv2.imread`` for the skipped batches; a warm ``.crnn_sizes.json``
  plans with no decode at all.
* ``PackedCache``: byte-equal shards and index to JAX's for the same adds,
  and the same recovery from a build cut off after its last index flush.
* ``_prefetched`` and ``device_batches``: a producer's ``IOError`` reaches
  the consumer; ``prefetch=2`` yields what ``prefetch=0`` yields.
* ``FontTextlines.render``: byte-equal to JAX's for the same text, knobs
  and rng state.
"""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data import codec as tcodec
from crnn_ocr_torch.data import fontgen as tfont
from crnn_ocr_torch.data import packed as tpacked
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.data import reader as treader
from crnn_ocr_tpu.data import codec as jcodec
from crnn_ocr_tpu.data import fontgen as jfont
from crnn_ocr_tpu.data import packed as jpacked
from crnn_ocr_tpu.data import reader as jreader

WORDS = ["ab", "cde", "fghij", "k", "lmnopqr", "stu", "vwxyz", "0123",
         "45", "6789abc", "de f", "gh-i"]


def _write_corpus(d, layout: str, n: int = 40, seed: int = 0):
    """``n`` PNG lines of random widths (every bucket 64-256 and past it)
    and heights, with their texts in an annotation file or in their file
    names."""
    rng = np.random.default_rng(seed)
    os.makedirs(d)
    lines = []
    for i in range(n):
        h = int(rng.integers(20, 48))
        w = int(rng.integers(8, 9 * h))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        text = WORDS[i % len(WORDS)]
        if layout == "annotation":
            name = f"img{i:03d}.png"
            lines.append(f"{name}\t{text}")
        else:
            name = f"{i}_{text.replace(' ', '')}_x.png"
        assert cv2.imwrite(os.path.join(d, name), img)
    if layout == "annotation":
        with open(os.path.join(d, "annotation.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _stream(gen):
    return [
        (b["the_input"].tobytes(), b["the_input"].shape,
         b["heights"].tolist(), b["widths"].tolist(),
         b["the_labels"].tolist(), b["label_length"].tolist(),
         int(b["bucket"]), list(b["texts"]))
        for b in gen]


def _tree_bytes(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in sorted(files):
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_codec_constructors_match_jax():
    texts = ["hello world", "Zebra-42", "", "a.b,c'd"]
    assert (tcodec.LabelCodec.from_texts(texts).classes
            == jcodec.LabelCodec.from_texts(texts).classes)
    assert (tcodec.default_ocr_codec().classes
            == jcodec.default_ocr_codec().classes)


@pytest.mark.parametrize("pack_cache", [False, True])
@pytest.mark.parametrize("layout", ["annotation", "filename"])
def test_reader_stream_matches_jax(tmp_path, layout, pack_cache):
    _write_corpus(str(tmp_path / "j"), layout)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    kw = dict(layout=layout, batch_size=4, val_fraction=0.25,
              shuffle_seed=5, max_label_len=8, pack_cache=pack_cache)
    jr = jreader.Reader(jreader.ReaderConfig(path=str(tmp_path / "j"), **kw))
    tr = treader.Reader(treader.ReaderConfig(path=str(tmp_path / "t"), **kw))
    assert tr.codec.classes == jr.codec.classes
    assert [s[1] for s in tr.samples] == [s[1] for s in jr.samples]
    for train in (True, False):
        assert tr.steps_per_epoch(train) == jr.steps_per_epoch(train)
        want = _stream(jr.run_generator(train=train, epochs=2))
        got = _stream(tr.run_generator(train=train, epochs=2))
        assert got == want, f"train={train}"
        assert len({b[6] for b in want}) > 1  # batches of several buckets
    jt, tt = _tree_bytes(tmp_path / "j"), _tree_bytes(tmp_path / "t")
    assert tt.keys() == jt.keys()
    assert all(tt[k] == jt[k] for k in jt)  # sidecar, pack shards, index
    assert any(k.startswith(".crnn_pack") for k in jt) == pack_cache


@pytest.mark.parametrize("pack_cache", [False, True])
def test_skip_replays_the_stream_without_decoding_it(tmp_path, monkeypatch,
                                                     pack_cache):
    d = str(tmp_path / "c")
    _write_corpus(d, "annotation")
    cfg = treader.ReaderConfig(path=d, batch_size=4, val_fraction=0.0,
                               shuffle_seed=1, pack_cache=pack_cache)
    full = _stream(treader.Reader(cfg).run_generator(epochs=2))  # warms up
    calls = []
    real = cv2.imread
    monkeypatch.setattr(cv2, "imread",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    reader = treader.Reader(cfg)
    assert reader.steps_per_epoch() > 0 and calls == []  # warm plan
    n = len(full) // 2 + 1  # past the first epoch
    it = reader.run_generator(epochs=2, skip=n)
    first = next(it)
    # only the yielded batch's images are read (none where they are packed)
    assert len(calls) == (0 if pack_cache else len(first["texts"]))
    assert _stream([first]) + _stream(it) == full[n:]


def test_cold_skip_decodes_each_image_once_to_plan(tmp_path, monkeypatch):
    d = str(tmp_path / "c")
    _write_corpus(d, "annotation", n=12)
    calls = []
    real = cv2.imread
    monkeypatch.setattr(cv2, "imread",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    reader = treader.Reader(treader.ReaderConfig(
        path=d, batch_size=2, val_fraction=0.0))
    steps = reader.steps_per_epoch()
    assert sorted(calls) == sorted(p for p, _ in reader.samples)
    assert list(reader.run_generator(epochs=1, skip=steps)) == []
    assert len(calls) == len(reader.samples)  # the skip decoded nothing
    assert os.path.exists(os.path.join(d, ".crnn_sizes.json"))


def test_packed_cache_bytes_and_recovery_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    imgs = {f"im{i}.png": rng.integers(0, 255, (24, 40 + 37 * i))
            .astype(np.uint8) for i in range(6)}
    for name, mod in (("j", jpacked), ("t", tpacked)):
        d = str(tmp_path / name)
        os.makedirs(d)
        pc = mod.PackedCache(d, height=32, buckets=(64, 128, 192))
        for k in ("im0.png", "im1.png", "im2.png", "im4.png"):
            pc.add(k, imgs[k])
        pc.flush_index()
        pc.add("im3.png", imgs["im3.png"])  # appended, never indexed
        pc2 = mod.PackedCache(d, height=32, buckets=(64, 128, 192))  # crash
        assert len(pc2) == 4 and "im3.png" not in pc2
        for k in ("im3.png", "im5.png"):
            pc2.add(k, imgs[k])
        pc2.flush_index()
    jt, tt = _tree_bytes(tmp_path / "j"), _tree_bytes(tmp_path / "t")
    assert sorted(tt) == sorted(jt) and len(jt) >= 3
    assert all(tt[k] == jt[k] for k in jt)
    pc = tpacked.PackedCache(str(tmp_path / "t"), 32, (64, 128, 192))
    for k, img in imgs.items():
        b, _, w = pc.entries[k]
        want = cv2.resize(img, (w, 32), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(np.asarray(pc.get(k)), want)
    # a shard shorter than its index: start afresh
    with open(pc._shard_path(64), "r+b") as f:
        f.truncate(10)
    assert len(tpacked.PackedCache(str(tmp_path / "t"), 32,
                                   (64, 128, 192))) == 0


def test_prefetched_reraises_the_producers_error():
    def gen():
        yield 1
        yield 2
        raise IOError("failed to read x.png")

    it = tpipe._prefetched(gen(), 2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(IOError, match="x.png"):
        next(it)


def test_device_batches_reraises_a_corrupt_image(tmp_path):
    d = str(tmp_path / "c")
    _write_corpus(d, "annotation", n=8)
    reader = treader.Reader(treader.ReaderConfig(
        path=d, batch_size=2, val_fraction=0.0))
    reader.steps_per_epoch()  # plan (sizes) before the damage
    with open(reader.samples[0][0], "wb") as f:
        f.write(b"not a png")
    with pytest.raises(IOError, match="failed to read"):
        for _ in tpipe.device_batches(reader.run_generator(epochs=1), "cpu",
                                      ModelConfig(), prefetch=2):
            pass


def test_device_batches_prefetch_equals_inline():
    def host():
        return tpipe.synthetic_batches(batch_size=4, bucket=64, seed=3,
                                       steps=5)

    cfg = ModelConfig()
    a = list(tpipe.device_batches(host(), "cpu", cfg, prefetch=2))
    b = list(tpipe.device_batches(host(), "cpu", cfg, prefetch=0))
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and x["texts"] == y["texts"]
        for k in ("x", "input_length", "the_labels", "label_length"):
            assert torch.equal(x[k], y[k]), k


def test_closing_the_consumer_stops_the_producer():
    made = []

    def gen():
        for i in range(1000):
            made.append(i)
            yield i

    it = tpipe._prefetched(gen(), 2)
    assert next(it) == 0
    it.close()
    import time

    n, deadline = -1, time.monotonic() + 10.0
    while len(made) != n and time.monotonic() < deadline:
        n = len(made)
        time.sleep(0.3)  # the producer polls its stop flag every 0.1 s
    assert len(made) == n and n < 10


KNOBS = [
    dict(),
    dict(noise=0.05, blur=1.0, contrast_min=0.4, downscale_min=0.6),
    dict(noise=0.0, warp_shear=0.5, warp_rotate=2.0, warp_perspective=0.12),
]


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "degraded", "warped"])
def test_fontgen_render_matches_jax(knobs):
    j = jfont.FontTextlines(jfont.FontConfig(**knobs))
    t = tfont.FontTextlines(tfont.FontConfig(**knobs))
    for s, text in enumerate(["hello", "Warped", "0123 geometry"]):
        a = j.render(text, np.random.default_rng(s))
        b = t.render(text, np.random.default_rng(s))
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
    ja, jt = j.sample_batch(4, np.random.default_rng(9))
    ta, tt = t.sample_batch(4, np.random.default_rng(9))
    assert tt == jt
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(x, y)

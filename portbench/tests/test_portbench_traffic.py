"""The traffic generator: deterministic by seed, the stated bucket shares,
the same sizes for every seed, and training rows CTC can align."""

import collections

import numpy as np
import pytest

from portbench import counts, traffic
from portbench.drivers.serve import batches_of, quantize_dim

BUCKETS = (64, 128, 192, 256)


def _bucket(im):
    w = traffic.norm_width(*im.shape)
    return next((b for b in BUCKETS if w <= b), None)


@pytest.mark.parametrize("name", ["docs-mixed", "docs-beam"])
def test_documents_are_deterministic_and_hold_the_shares(name):
    mix = dict(traffic.load_mix(name), docs=2)
    a = traffic.documents(mix, 2**31 + 5)
    b = traffic.documents(mix, 2**31 + 5)
    assert all(np.array_equal(x, y) for d, e in zip(a, b)
               for x, y in zip(d, e))
    c = traffic.documents(mix, 9)
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(a[0], c[0]))
    want = traffic.class_counts(mix)
    for doc in a + c:
        assert len(doc) == mix["doc_lines"]
        got = collections.Counter(_bucket(im) for im in doc)
        assert got[64] == want["short"] and got[128] == want["b128"]
        assert got[192] == want["b192"] and got[256] == want["b256"]
        assert got[None] == want["long"]
        for im in doc:
            assert im.dtype == np.uint8 and mix["height"][0] <= \
                im.shape[0] <= mix["height"][1]
    for cls, share in mix["shares"].items():
        assert abs(want[cls] / mix["doc_lines"] - share) < 0.01


def test_every_seed_gives_the_same_batches():
    mix = dict(traffic.load_mix("docs-mixed"), docs=1)
    sizes = []
    for seed in (1, 2, 2**31 + 99):
        doc = traffic.documents(mix, seed)[0]
        layout = batches_of(doc, BUCKETS, 32, mix["batch_size"])
        sizes.append(sorted(collections.Counter(
            b for b, _ in layout).items()))
    assert sizes[0] == sizes[1] == sizes[2]


def test_quantize_dim_ladder():
    assert [quantize_dim(n) for n in (1, 17, 25, 33, 49, 65, 97, 300)] == \
        [16, 24, 32, 48, 64, 96, 128, 384]


def test_train_batches():
    import json
    import os

    from portbench import harness

    mix = traffic.load_mix("finetune-b1024")
    with open(os.path.join(harness.ROOT, "crnn_ocr_tpu", "pretrained",
                           "fonts_hard", "classes.json")) as f:
        classes = json.load(f)
    conf = {"block_pools": [[2, 2], [2, 1], [2, 1], [2, 1]]}
    a = traffic.train_batches(mix, 3, classes, counts.downsample(conf), 2)
    b = traffic.train_batches(mix, 3, classes, counts.downsample(conf), 2)
    assert len(a) == mix["pool_batches"]
    for x, y in zip(a, b):
        assert np.array_equal(x["the_input"], y["the_input"])
    rows = set()
    for batch in a[:mix["checked_steps"]]:
        assert batch["the_input"].shape[0] == mix["batch"]
        assert batch["the_labels"].shape == (mix["batch"], mix["max_label"])
        for h, w, t in zip(batch["heights"], batch["widths"], batch["texts"]):
            rows.add((t, int(h), int(w)))
            wn = min(traffic.norm_width(h, w), mix["bucket"])
            frames = min(wn // 4, mix["bucket"] // 4) - 2
            assert frames >= traffic._frames_needed(t)
    assert len(rows) == mix["batch"] * mix["checked_steps"]

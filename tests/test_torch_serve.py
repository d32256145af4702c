"""Port parity: the serving runtime (``crnn_ocr_torch/serve/``), case by
case as ``tests/test_serve.py`` holds the JAX package's, on the CPU.

The port's ``Predictor`` runs a narrow CRNN on ``device="cpu"`` with the
weights of JAX's ``create_train_state``, carried over by
``params_from_jax``. One more case holds the port's batcher to JAX's
``DynamicBatcher`` on the same images: texts equal, scores within rtol 1e-4
(atol 1e-5, ``tests/test_torch_predictor.py``'s greedy tolerance). Every
wait has a timeout.
"""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.infer.predictor import Predictor
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.serve import (
    BatcherStats,
    DynamicBatcher,
    OCRServer,
    batch_ladder,
    decode_image_bytes,
)
from crnn_ocr_tpu.data import SyntheticConfig, SyntheticTextlines
from crnn_ocr_tpu.infer import Predictor as JaxPredictor
from crnn_ocr_tpu.models import ModelConfig
from crnn_ocr_tpu.serve import DynamicBatcher as JaxBatcher
from crnn_ocr_tpu.train import create_train_state

KW = dict(width=128, stem_filters=8, block_filters=(8, 8, 8, 8),
          time_dense_size=8, n_units=8, rnn_layers=1)


@pytest.fixture(scope="module")
def predictor():
    synth = SyntheticTextlines(
        SyntheticConfig(alphabet="0123456789", min_len=2, max_len=5))
    kw = dict(KW, num_classes=synth.codec.num_classes)
    state = create_train_state(ModelConfig(**kw), jax.random.key(0))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pred = Predictor(TorchConfig(**kw),
                     params_from_jax(tree(state.params),
                                     tree(state.batch_stats)),
                     LabelCodec(synth.codec.classes), device="cpu")
    return pred, synth, state


def _npy(img) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _direct(pred, images, **kw):
    """Each image through ``Predictor.predict`` alone, at its own bucket, as
    the batcher routes it (a batch's shared bucket pads the narrower lines,
    which the backward GRU sees)."""
    return [pred.predict([im], bucket=pred.bucket_for(im), **kw)[0]
            for im in images]


def _post(url: str, data: bytes):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_batch_ladder():
    assert batch_ladder(1) == (1,)
    assert batch_ladder(8) == (1, 2, 4, 8)
    assert batch_ladder(48) == (1, 2, 4, 8, 16, 32, 48)


def test_batcher_single_and_concurrent(predictor):
    pred, synth, _ = predictor
    images, _ = synth.sample_batch(6, np.random.default_rng(0))
    b = DynamicBatcher(pred, max_batch=8, max_wait_ms=20.0).start()
    try:
        out = b.predict_sync(images[0], timeout=120)
        assert isinstance(out.text, str) and np.isfinite(out.score)
        futs = [b.submit(im) for im in images]
        res = [f.result(timeout=120) for f in futs]
        assert len(res) == 6 and all(isinstance(r.text, str) for r in res)
        snap = b.stats.snapshot()
        assert snap["requests"] == 7
        assert snap["batches"] <= 7
    finally:
        b.stop()


def test_batcher_results_match_direct_predict(predictor):
    """Batched through the queue == a direct ``Predictor.predict`` at each
    image's bucket."""
    pred, synth, _ = predictor
    images, _ = synth.sample_batch(4, np.random.default_rng(1))
    direct = _direct(pred, images)
    b = DynamicBatcher(pred, max_batch=4, max_wait_ms=50.0).start()
    try:
        queued = [f.result(timeout=120) for f in [b.submit(im)
                                                  for im in images]]
    finally:
        b.stop()
    assert [q.text for q in queued] == [d.text for d in direct]
    np.testing.assert_allclose([q.score for q in queued],
                               [d.score for d in direct], rtol=1e-5)


def test_batcher_mixed_buckets_routed(predictor):
    pred, _, _ = predictor
    b = DynamicBatcher(pred, max_batch=8, max_wait_ms=30.0).start()
    try:
        narrow = np.full((32, 40), 255, np.uint8)
        wide = np.full((32, 400), 255, np.uint8)
        futs = [b.submit(narrow), b.submit(wide), b.submit(narrow)]
        res = [f.result(timeout=120) for f in futs]
        assert all(isinstance(r.text, str) for r in res)
        assert b.stats.batches >= 2  # two buckets: two device batches
    finally:
        b.stop()


class _Failing:
    """A predictor whose ``predict`` raises: the batcher's worker must hand
    the error to every request of the batch, and the daemon answer 503."""

    def __init__(self, pred):
        self.cfg, self.buckets = pred.cfg, pred.buckets
        self.bucket_for, self.blank_row = pred.bucket_for, pred.blank_row

    def predict(self, images, **kw):
        raise RuntimeError("device fault")


def test_batcher_error_propagates(predictor):
    pred, _, _ = predictor
    b = DynamicBatcher(pred, max_batch=2, max_wait_ms=5.0).start()
    try:
        with pytest.raises(ValueError):
            b.submit(np.zeros((4, 4, 3), np.uint8))  # not grayscale
        with pytest.raises(ValueError):
            b.submit(np.zeros((0, 4), np.uint8))  # empty
    finally:
        b.stop()
    with pytest.raises(RuntimeError):
        b.submit(np.full((32, 40), 255, np.uint8))  # stopped
    b = DynamicBatcher(_Failing(pred), max_batch=4, max_wait_ms=20.0).start()
    try:
        futs = [b.submit(np.full((32, 40), 255, np.uint8)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=60)
        assert b.stats.errors == 3 and b.stats.requests == 0
    finally:
        b.stop()
    srv = OCRServer(_Failing(pred), host="127.0.0.1", port=0, max_batch=2,
                    max_wait_ms=5.0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{srv.port}/predict",
                  _npy(np.full((32, 40), 255, np.uint8)))
        assert e.value.code == 503
        assert "device fault" in json.loads(e.value.read())["error"]
    finally:
        srv.stop()


def test_decode_image_bytes_npy_and_png():
    img = (np.arange(32 * 40, dtype=np.uint8).reshape(32, 40)) % 251
    np.testing.assert_array_equal(decode_image_bytes(_npy(img)), img)
    rgb = np.stack([img] * 3, axis=-1)
    np.testing.assert_array_equal(decode_image_bytes(_npy(rgb)), img)
    import cv2

    ok, enc = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(decode_image_bytes(enc.tobytes()), img)
    with pytest.raises(ValueError):
        decode_image_bytes(b"not an image at all")


def test_http_server_round_trip(predictor):
    pred, synth, _ = predictor
    images, _ = synth.sample_batch(3, np.random.default_rng(2))
    direct = _direct(pred, images)
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=4,
                    max_wait_ms=20.0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        results = {}

        def call(i):
            results[i] = _post(base + "/predict", _npy(images[i]))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        for i in range(3):
            status, body = results[i]
            assert status == 200
            assert body["text"] == direct[i].text
            assert body["score"] == pytest.approx(direct[i].score, rel=1e-5)
            assert "candidates" not in body and "alignments" not in body
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            snap = json.loads(r.read())
        assert snap["requests"] >= 3
        assert snap["latency_ms_p50"] is not None
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/predict", b"garbage")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404
    finally:
        srv.stop()


def test_batcher_stats_window_bounded():
    s = BatcherStats()
    s._max_kept = 16
    for _ in range(100):
        s.record_batch(2, [1.0, 2.0], [0.5, 0.5])
    assert len(s.latencies_ms) <= 32
    assert len(s.queue_waits_ms) <= 32
    assert len(s.batch_sizes) <= 32
    assert s.snapshot()["latency_ms_p50"] == 1.5


def test_batcher_concurrent_stress_and_drain(predictor):
    """Threads submitting under random jitter, with a short switch
    interval; ``stop(drain=True)`` serves every queued request exactly
    once."""
    pred, synth, _ = predictor
    images, _ = synth.sample_batch(4, np.random.default_rng(7))
    b = DynamicBatcher(pred, max_batch=4, max_wait_ms=2.0).start()
    futs, lock = [], threading.Lock()

    def submitter(seed):
        r = np.random.default_rng(seed)
        for _ in range(5):
            time.sleep(float(r.uniform(0, 0.01)))
            f = b.submit(images[int(r.integers(0, 4))])
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        b.stop(drain=True)
    finally:
        sys.setswitchinterval(old)
    texts = [f.result(timeout=120).text for f in futs]
    assert len(texts) == 30 and all(isinstance(t, str) for t in texts)
    assert b.stats.requests == 30
    assert sum(b.stats.batch_sizes) == 30


def test_http_payload_cap(predictor):
    pred, _, _ = predictor
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=2,
                    max_wait_ms=5.0).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict", data=b"x", method="POST",
            headers={"Content-Length": str(64 << 20)})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
        assert "exceeds" in json.loads(e.value.read())["error"]
    finally:
        srv.stop()


def test_http_metrics_endpoint(predictor):
    pred, synth, _ = predictor
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=2,
                    max_wait_ms=5.0).start()
    try:
        images, _ = synth.sample_batch(1, np.random.default_rng(3))
        _post(f"http://127.0.0.1:{srv.port}/predict", _npy(images[0]))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert "ocr_requests_total 1" in body
        assert "ocr_batches_total 1" in body
        assert "ocr_latency_ms_p50" in body
    finally:
        srv.stop()


def test_http_alignments_mode(predictor):
    """Greedy daemon with alignments: spans join to the text, and the
    ladder's blank pad rows leak no spans into real replies."""
    pred, synth, _ = predictor
    images, _ = synth.sample_batch(2, np.random.default_rng(9))
    direct = _direct(pred, images, alignments=True)
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=4,
                    max_wait_ms=10.0,
                    decode_kw={"greedy": True, "alignments": True}).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for img, d in zip(images, direct):
            status, body = _post(base + "/predict", _npy(img))
            assert status == 200
            spans = body["alignments"]
            assert "".join(s["char"] for s in spans) == body["text"]
            assert [(s["char"], s["x0"], s["x1"]) for s in spans] == [
                (s.char, s.x0, s.x1) for s in d.spans]
            for s, want in zip(spans, d.spans):
                assert 0 <= s["x0"] < s["x1"] <= img.shape[1]
                assert s["conf"] == round(want.conf, 4)
    finally:
        srv.stop()


def test_http_beam_alignments_mode(predictor):
    """Beam daemon with alignments: the spans force-align the decoded top
    path, so the joined chars equal the beam text returned; with
    ``top_paths`` 2 the reply carries the candidates."""
    pred, synth, _ = predictor
    images, _ = synth.sample_batch(2, np.random.default_rng(17))
    kw = {"greedy": False, "beam_width": 4, "top_paths": 2,
          "merge_repeated": True, "alignments": True}
    direct = _direct(pred, images, **kw)
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=4,
                    max_wait_ms=10.0, decode_kw=kw).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for img, d in zip(images, direct):
            status, body = _post(base + "/predict", _npy(img))
            assert status == 200
            spans = body["alignments"]
            assert "".join(s["char"] for s in spans) == body["text"]
            prev = 0
            for s in spans:
                assert 0 <= s["x0"] < s["x1"] <= img.shape[1]
                assert s["x0"] >= prev
                prev = s["x1"]
            assert [c["text"] for c in body["candidates"]] == [
                t for t, _ in d.candidates]
    finally:
        srv.stop()


def test_batcher_matches_jax_batcher(predictor):
    """The same images through JAX's ``DynamicBatcher`` and the port's:
    texts equal, scores within rtol 1e-4."""
    pred, synth, state = predictor
    images, _ = synth.sample_batch(5, np.random.default_rng(11))
    images = list(images) + [np.full((32, 300), 255, np.uint8)]
    jpred = JaxPredictor(ModelConfig(**dict(
        KW, num_classes=synth.codec.num_classes)), state.params,
        state.batch_stats, synth.codec)
    out = {}
    for name, batcher in (("jax", JaxBatcher(jpred, max_batch=8,
                                             max_wait_ms=50.0)),
                          ("port", DynamicBatcher(pred, max_batch=8,
                                                  max_wait_ms=50.0))):
        batcher.start()
        try:
            out[name] = [f.result(timeout=300) for f in
                         [batcher.submit(im) for im in images]]
        finally:
            batcher.stop()
    assert [p.text for p in out["port"]] == [p.text for p in out["jax"]]
    np.testing.assert_allclose([p.score for p in out["port"]],
                               [p.score for p in out["jax"]],
                               rtol=1e-4, atol=1e-5)

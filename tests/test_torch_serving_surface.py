"""Port parity: the predictor's serving surface (``bucket_for``,
``blank_row``, ``warmup``, ``predict_many``) and the CLIs' loader
(``predictor_from_cli``) against the JAX package's, on the CPU.

``predict_many`` runs the narrow GRU CRNN of ``tests/test_keras_parity.py``
(f32, its golden ``.h5`` weights) behind both packages' predictors, on
images of mixed widths: texts and candidates equal, in the original order,
scores within rtol 1e-4 (atol 1e-5, the greedy path's tolerance in
``tests/test_torch_predictor.py``).
"""

import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.infer import init_predictor, predictor_from_cli
from crnn_ocr_torch.infer.predictor import Predictor
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_tpu.data.codec import LabelCodec as JaxCodec
from crnn_ocr_tpu.infer import predictor_from_cli as jax_predictor_from_cli
from crnn_ocr_tpu.infer.h5_import import import_keras_h5
from crnn_ocr_tpu.infer.predictor import Predictor as JaxPredictor
from crnn_ocr_tpu.models import ModelConfig

GOLDENS = pathlib.Path(__file__).parent / "goldens"
BUCKETS = (64, 96, 128)
KW = dict(num_classes=12, width=64, stem_filters=8,
          block_filters=(16, 16, 24, 24), time_dense_size=16, n_units=12,
          rnn_layers=1, rnn_cell="gru", dropout_rate=0.0)


@pytest.fixture(scope="module")
def predictors():
    jcfg = ModelConfig(**KW)
    params, stats = import_keras_h5(
        str(GOLDENS / "keras_small_gru_weights.h5"), jcfg)
    alphabet = "abcdefghijkl"
    ref = JaxPredictor(jcfg, params, stats, JaxCodec.from_alphabet(alphabet),
                       buckets=BUCKETS)
    port = Predictor(
        TorchConfig(**KW),
        params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                        jax.tree_util.tree_map(np.asarray, stats)),
        LabelCodec.from_alphabet(alphabet), buckets=BUCKETS, device="cpu")
    return ref, port


def _images():
    """Widths that route to every bucket (and past the last), in an order
    that interleaves them."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w)).astype(np.uint8)
            for h, w in ((32, 120), (32, 40), (32, 88), (16, 30), (32, 64),
                         (32, 300), (48, 100), (32, 57), (32, 96), (32, 71),
                         (24, 70), (32, 128))]


def test_bucket_for_matches_jax(predictors):
    ref, port = predictors
    for h in (1, 8, 16, 31, 32, 33, 64, 100):
        for w in (1, 7, 16, 63, 64, 65, 95, 96, 97, 127, 128, 129, 300):
            img = np.zeros((h, w), np.uint8)
            assert port.bucket_for(img) == ref.bucket_for(img), (h, w)
    for empty in (np.zeros((0, 10), np.uint8), np.zeros((10, 0), np.uint8)):
        with pytest.raises(ValueError, match="empty image"):
            ref.bucket_for(empty)
        with pytest.raises(ValueError, match="empty image"):
            port.bucket_for(empty)


def test_blank_row_matches_jax(predictors):
    ref, port = predictors
    got, want = port.blank_row(), ref.blank_row()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_warmup_runs_each_bucket(predictors, monkeypatch):
    _, port = predictors
    seen = []
    orig = port.predict_probs

    def spy(images, bucket=None):
        seen.append((len(images), bucket, images[0].shape))
        return orig(images, bucket=bucket)

    monkeypatch.setattr(port, "predict_probs", spy)
    port.warmup(batch_size=3)
    assert seen == [(3, b, (32, b)) for b in BUCKETS]
    seen.clear()
    port.warmup(batch_size=2, buckets=(96,))
    assert seen == [(2, 96, (32, 96))]


# the beam's cases in one chunk a bucket: each new batch shape is a JAX
# compile of the beam
@pytest.mark.parametrize("batch_size,kw", [
    (3, dict()),
    (3, dict(alignments=True, timing=True)),
    (16, dict(greedy=False, top_paths=2)),
    (16, dict(greedy=False, merge_repeated=True, alignments=True)),
], ids=["greedy", "greedy-align", "beam-top2", "beam-merge-align"])
def test_predict_many_matches_jax(predictors, batch_size, kw):
    ref, port = predictors
    images = _images()
    want = ref.predict_many(images, batch_size=batch_size, **kw)
    got = port.predict_many(images, batch_size=batch_size, **kw)
    assert [p.text for p in got] == [p.text for p in want]
    np.testing.assert_allclose([p.score for p in got],
                               [p.score for p in want], rtol=1e-4, atol=1e-5)
    if kw.get("top_paths", 1) > 1:
        assert ([[t for t, _ in p.candidates] for p in got]
                == [[t for t, _ in p.candidates] for p in want])
    if kw.get("alignments"):
        assert ([[(s.char, s.x0, s.x1) for s in p.spans] for p in got]
                == [[(s.char, s.x0, s.x1) for s in p.spans] for p in want])
    assert all((p.latency_ms is not None) == bool(kw.get("timing"))
               for p in got)
    # the original order: each prediction is its image's own at its bucket
    for im, p in zip(images, got):
        alone = port.predict([im], bucket=port.bucket_for(im), **kw)[0]
        assert p.text == alone.text


def test_predictor_from_cli_routes_and_refuses(tmp_path):
    with pytest.raises(SystemExit) as want:
        jax_predictor_from_cli(None, None)
    with pytest.raises(SystemExit) as got:
        predictor_from_cli(None, None, device="cpu")
    assert str(got.value) == str(want.value)
    # n_devices > 1 serves on a local mesh: of the CUDA cards (too few raise
    # JAX's message), or shards of the one CPU
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"requested a {n}-device mesh"):
        predictor_from_cli(None, "fonts-small", n_devices=n)
    assert predictor_from_cli(None, "fonts-small", n_devices=2,
                              device="cpu").mesh.size == 2
    (tmp_path / "model_config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        predictor_from_cli(str(tmp_path), None, device="cpu")
    (tmp_path / "7" / "default").mkdir(parents=True)  # orbax's layout,
    (tmp_path / "7" / "_CHECKPOINT_METADATA").write_text("{}")  # no arrays
    with pytest.raises(NotImplementedError, match="orbax.*_METADATA"):
        init_predictor(str(tmp_path), device="cpu")
    pred = predictor_from_cli(None, "fonts-small", normalize=False,
                              device="cpu")
    assert pred.normalize is False and pred.device.type == "cpu"
    pred = predictor_from_cli(str(GOLDENS / "migration_autonamed"), None,
                              device="cpu")
    assert pred.cfg.provenance == "keras_migrated"


def test_init_predictor_needs_a_class_map(tmp_path):
    """A reference ``.h5`` with no class map raises, as JAX's does."""
    src = GOLDENS / "migration_autonamed"
    for name in ("model.h5", "model.json"):
        (tmp_path / name).write_bytes((src / name).read_bytes())
    with pytest.raises(FileNotFoundError, match="class map"):
        init_predictor(str(tmp_path), device="cpu")
    os.remove(tmp_path / "model.h5")
    with pytest.raises(FileNotFoundError, match="no .h5"):
        init_predictor(str(tmp_path), device="cpu")

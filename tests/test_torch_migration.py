"""Port parity: reference-artifact loading (``crnn_ocr_torch/infer/
keras_json.py``, ``init_predictor``) against the JAX package's and Keras's,
on the CPU, for both committed artifact directories
(``tests/goldens/migration_autonamed{,_stn}/``: architecture JSON, ``.h5``
with Keras-generated layer names, ``classes.json``, and Keras's own
outputs in ``io.npz``).

* The forward pass equals Keras's ``y`` at rtol 1e-4 / atol 2e-5
  (``tests/test_keras_parity.py:160``'s bound).
* Config and parameters equal JAX's ``load_reference_model`` field by
  field and leaf by leaf where JAX reads the architecture JSON (a
  directory whose class map is ``classes.pkl``). Beside a ``classes.json``
  JAX never reads the JSON (it takes the first ``.json`` by name) and
  infers the config from the ``.h5``, which leaves ``width`` at its
  default 128: the port reads the JSON there too (``width`` 64, the input
  layer's), so that the STN variant, whose localization Dense is bound to
  the input width, loads and serves.
* Predictions equal JAX's ``init_predictor``'s: texts equal, scores within
  rtol 1e-4 (atol 1e-5).
"""

import dataclasses
import pathlib
import pickle
import shutil

import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.infer import init_predictor
from crnn_ocr_torch.infer import keras_json as tkj
from crnn_ocr_tpu.data.codec import LabelCodec as JaxCodec
from crnn_ocr_tpu.infer import init_predictor as jax_init_predictor
from crnn_ocr_tpu.infer import keras_json as jkj

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
VARIANTS = ["autonamed", "autonamed_stn"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(params=VARIANTS)
def variant(request):
    return request.param


@pytest.fixture
def pkl_dir(variant, tmp_path):
    """The artifacts laid out as the reference saves them: architecture
    JSON, ``.h5`` and a pickled class map."""
    src = GOLDENS / f"migration_{variant}"
    for name in ("model.json", "model.h5"):
        shutil.copy(src / name, tmp_path / name)
    with open(tmp_path / "classes.pkl", "wb") as f:
        pickle.dump(LabelCodec.load(str(src / "classes.json")).classes, f)
    return tmp_path


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(TorchConfig)}


def test_load_reference_model_matches_jax(variant, pkl_dir):
    want = jkj.load_reference_model(str(pkl_dir))
    got = tkj.load_reference_model(str(pkl_dir))
    assert _fields(got[0]) == _fields(want[0])
    assert got[0].provenance == "keras_migrated"
    assert got[0].use_stn == variant.endswith("stn")
    for g, w in ((got[1], want[1]), (got[2], want[2])):
        g, w = _flat(g), _flat(w)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[3].classes == want[3].classes
    # the committed layout (classes.json): the port reads the JSON, JAX
    # infers from the .h5 and keeps the default width
    mig = str(GOLDENS / f"migration_{variant}")
    got_json = tkj.load_reference_model(mig)
    assert _fields(got_json[0]) == _fields(got[0])
    with pytest.warns(UserWarning, match="WIDTH"):
        jax_h5 = jkj.load_reference_model(mig)[0]
    assert {k: v for k, v in _fields(jax_h5).items() if v != _fields(
        got[0])[k]} == {"width": 128}
    assert got[0].width == 64


def test_forward_matches_keras(variant):
    data = np.load(GOLDENS / f"migration_{variant}" / "io.npz")
    pred = init_predictor(str(GOLDENS / f"migration_{variant}"), device="cpu")
    with torch.inference_mode():
        y = torch.softmax(pred.model(torch.from_numpy(data["x"][..., 0])), -1)
    np.testing.assert_allclose(y.numpy(), data["y"], rtol=1e-4, atol=2e-5)


def test_h5_name_map_equals_json_map(variant):
    mig = GOLDENS / f"migration_{variant}"
    cfg1, nm1 = tkj.model_config_from_keras_json(str(mig / "model.json"))
    with pytest.warns(UserWarning, match="WIDTH"):
        cfg2, nm2 = tkj.infer_name_map_from_h5(str(mig / "model.h5"))
    assert nm1 == nm2
    assert (cfg2.block_filters, cfg2.n_units, cfg2.use_stn) == (
        cfg1.block_filters, cfg1.n_units, cfg1.use_stn)
    with pytest.warns(UserWarning, match="WIDTH"):
        jcfg2, jnm2 = jkj.infer_name_map_from_h5(str(mig / "model.h5"))
    assert nm2 == jnm2 and _fields(cfg2) == _fields(jcfg2)
    jcfg1, jnm1 = jkj.model_config_from_keras_json(str(mig / "model.json"))
    assert nm1 == jnm1 and _fields(cfg1) == _fields(jcfg1)


def test_init_predictor_serves_like_jax(variant, pkl_dir):
    """``init_predictor`` on the raw directory serves, with the provenance-
    keyed beam merge on; its greedy and beam outputs equal JAX's."""
    ref = jax_init_predictor(str(pkl_dir))
    port = init_predictor(str(GOLDENS / f"migration_{variant}"),
                          device="cpu")
    assert port.default_merge_repeated is True
    assert ref.default_merge_repeated is True
    assert port.buckets == ref.buckets
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (32, w)).astype(np.uint8)
              for w in (40, 64, 52)]
    for kw in (dict(), dict(greedy=False, top_paths=2)):
        want = ref.predict_many(images, **kw)
        got = port.predict_many(images, **kw)
        assert [p.text for p in got] == [p.text for p in want]
        np.testing.assert_allclose([p.score for p in got],
                                   [p.score for p in want], rtol=1e-4,
                                   atol=1e-5)


def test_pkl_class_map_loads(tmp_path):
    classes = {c: i for i, c in enumerate("0123456789ab")}
    with open(tmp_path / "classes.pkl", "wb") as f:
        pickle.dump(classes, f)
    got = LabelCodec.load(str(tmp_path / "classes.pkl"))
    want = JaxCodec.load(str(tmp_path / "classes.pkl"))
    assert got.classes == want.classes == classes
    assert got.labels_to_text([11, 0, 10]) == want.labels_to_text([11, 0, 10])

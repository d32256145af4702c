"""Port parity: the HDF5 writer (``crnn_ocr_torch/infer/hdf5.py::
H5Writer``), ``infer/weights.py::export_keras_h5`` and ``params_to_jax``,
against ``crnn_ocr_tpu/infer/h5_import.py::export_keras_h5`` (``h5py``).

For the four equal-weights cases of ``tests/test_keras_parity.py`` (their
golden ``.h5`` weights, BatchNorm statistics included) and the four
bundled models at full width, the port's ``.h5`` holds the layers, weight
names, shapes and dtypes that JAX's holds, every dataset bit for bit
(read through ``h5py``); JAX's ``import_keras_h5`` and the port's own
reader give back the source trees bit for bit; ``params_to_jax`` inverts
``params_from_jax`` bit for bit. One test (``tf_keras`` takes ~15 s to
import) loads the port's files into ``tools/keras_oracle.py``'s models,
built by ``build_keras_crnn`` and from the ``model.json`` that
``cli/migrate.py`` writes: their forward equals the port's f32 forward at
the keras-parity tolerance (rtol 1e-4 / atol 2e-5).
"""

import dataclasses
import pathlib

import h5py
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.infer.hdf5 import H5File, H5Writer
from crnn_ocr_torch.models import CRNN as TorchCRNN
from crnn_ocr_tpu.infer import load_pretrained as jax_load_pretrained
from crnn_ocr_tpu.infer.h5_import import export_keras_h5 as jax_export
from crnn_ocr_tpu.infer.h5_import import import_keras_h5 as jax_import
from chip_smoke import flat_tree
from test_keras_parity import CASES

GOLDENS = pathlib.Path(__file__).parent / "goldens"
BUNDLED = ["fonts-small", "fonts-hard", "fonts-stn", "fonts-warp-stn"]
ALL = [*sorted(CASES), *BUNDLED]


def _text(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _source(case: str):
    """(JAX config, port config, params, batch_stats) of a case: a parity
    golden's ``.h5`` through JAX's importer, or a bundled model."""
    if case in CASES:
        cfg = CASES[case]
        params, stats = jax_import(str(GOLDENS / f"keras_{case}_weights.h5"),
                                   cfg)
    else:
        ref = jax_load_pretrained(case)
        cfg, params, stats = (ref.cfg, ref._vars["params"],
                              ref._vars["batch_stats"])
    to_np = lambda t: {k: to_np(v) if isinstance(v, dict)  # noqa: E731
                       else np.asarray(v) for k, v in t.items()}
    tcfg = TorchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(TorchConfig)})
    return cfg, tcfg, to_np(params), to_np(stats)


def _h5_items(path):
    """{dataset path: array}, {group path: weight_names} and layer_names
    of a file, through ``h5py``."""
    data, names = {}, {}
    with h5py.File(path, "r") as f:
        layers = [_text(n) for n in f.attrs["layer_names"]]

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                data[name] = obj[()]
            elif "weight_names" in obj.attrs:
                names[name] = [_text(n) for n in obj.attrs["weight_names"]]

        f.visititems(visit)
        root = {k: _text(f.attrs[k]) for k in ("backend", "keras_version")}
    return data, names, layers, root


@pytest.mark.parametrize("case", ALL)
def test_export_equals_jax_export(case, tmp_path):
    cfg, tcfg, params, stats = _source(case)
    port, jax_file = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    tw.export_keras_h5(tw.params_from_jax(params, stats), tcfg, port)
    jax_export(params, stats, cfg, jax_file)
    got, want = _h5_items(port), _h5_items(jax_file)
    assert got[2] == want[2]  # layer_names, in order
    assert got[1] == want[1]  # each layer's weight_names, in order
    assert got[3] == want[3] == {"backend": "tensorflow",
                                 "keras_version": "2.21.0"}
    assert sorted(got[0]) == sorted(want[0])
    for k, w in want[0].items():
        assert got[0][k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[0][k], w, err_msg=k)


@pytest.mark.parametrize("case", ALL)
def test_export_reads_back_bit_for_bit(case, tmp_path):
    """JAX's ``import_keras_h5`` (``h5py``) and the port's (its own
    reader) of the port's file give back the source trees, rtol 0 / atol
    0; ``params_to_jax`` inverts ``params_from_jax``."""
    cfg, tcfg, params, stats = _source(case)
    sd = tw.params_from_jax(params, stats)
    p2, s2 = tw.params_to_jax(sd)
    for a, b in ((p2, params), (s2, stats)):
        fa, fb = flat_tree(a), flat_tree(b)
        assert sorted(fa) == sorted(fb)
        for k in fb:
            assert fa[k].dtype == np.float32, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    path = str(tmp_path / "port.h5")
    tw.export_keras_h5(sd, tcfg, path)
    for read in (lambda: jax_import(path, cfg),
                 lambda: tw.import_keras_h5(path, tcfg)):
        got_p, got_s = read()
        for a, b in ((got_p, params), (got_s, stats)):
            fa, fb = flat_tree(a), flat_tree(b)
            assert sorted(fa) == sorted(fb)
            for k in fb:
                np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=0,
                                           err_msg=k)
    f = H5File(path)
    data = _h5_items(path)[0]
    for k, v in data.items():
        got = f.dataset(k)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_writer_layouts_read_by_h5py_and_the_port(tmp_path):
    """Beyond the Keras files: groups past one symbol-table node (100
    members: 13 nodes), nested paths, and string and string-array
    attributes, on the root, a group and a dataset."""
    rng = np.random.default_rng(0)
    w = H5Writer()
    want = {}
    for i in range(100):
        a = rng.normal(size=(i % 4 + 1, 3)).astype(np.float32)
        w.create_dataset(f"many/item{i:03d}", a)
        want[f"many/item{i:03d}"] = a
    for name, a in {
            "deep/a/b/c/k": rng.normal(size=(2, 2, 2)).astype(np.float32),
            "deep/v": rng.normal(size=(7,)).astype(np.float32)}.items():
        w.create_dataset(name, a)
        want[name] = a
    attrs = {"/": {"s": "tensorflow", "names": ["a", "bb", "ccc"],
                   "none": []},
             "deep/a": {"weight_names": ["x/y:0"]},
             "deep/v": {"unit": "px"}}
    for path, kv in attrs.items():
        for k, v in kv.items():
            w.set_attr(path, k, v)
    path = str(tmp_path / "w.h5")
    w.save(path)
    f = H5File(path)
    with h5py.File(path, "r") as h:
        assert len(h["many"]) == 100
        for k, a in want.items():
            for got in (h[k][()], f.dataset(k)):
                assert np.asarray(got).dtype == a.dtype, k
                np.testing.assert_array_equal(got, a, err_msg=k)
        assert _text(h.attrs["s"]) == "tensorflow"
        assert [_text(v) for v in h.attrs["names"]] == ["a", "bb", "ccc"]
        assert len(h.attrs["none"]) == 0
        assert [_text(v) for v in h["deep/a"].attrs["weight_names"]] == [
            "x/y:0"]
        assert _text(h["deep/v"].attrs["unit"]) == "px"
    root = f.attrs("/")
    assert root["s"] == "tensorflow" and root["names"] == ["a", "bb", "ccc"]
    assert root["none"] == []
    assert f.attrs("deep/a")["weight_names"] == ["x/y:0"]
    assert sorted(f.keys("many")) == sorted(f"item{i:03d}"
                                            for i in range(100))


def test_writer_refuses_what_it_cannot_write(tmp_path):
    w = H5Writer()
    for a in (np.zeros(2, np.complex64), np.zeros(2, np.float64),
              np.zeros(2, np.int32), np.zeros(2, ">f4"), np.float32(2.5),
              np.zeros((0, 3), np.float32)):
        with pytest.raises(NotImplementedError, match="only non-empty"):
            w.create_dataset("c", a)
    w.create_dataset("a/x", np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="exists"):
        w.create_dataset("a/x", np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="is a dataset"):
        w.create_dataset("a/x/y", np.zeros(2, np.float32))
    with pytest.raises(KeyError):
        w.set_attr("nope", "k", "v")
    with pytest.raises(NotImplementedError, match="only str"):
        w.set_attr("a", "n", 7)
    for i in range(257):
        w.create_dataset(f"big/d{i}", np.zeros(1, np.float32))
    with pytest.raises(NotImplementedError, match="257 members"):
        w.save(str(tmp_path / "big.h5"))


def test_tf_keras_loads_the_port_files(tmp_path):
    """``tf_keras`` ``load_weights`` of the port's files: an STN model
    built by ``build_keras_crnn``, and a GRU model from the ``model.json``
    that ``cli/migrate.py`` writes; each one's forward on its golden input
    equals the port's f32 forward at rtol 1e-4 / atol 2e-5."""
    import tf_keras

    import crnn_ocr_torch.cli.migrate as migrate
    from tools.keras_oracle import build_keras_crnn

    def port_probs(tcfg, sd, x):
        model = TorchCRNN(tcfg)
        model.load_state_dict(sd)
        with torch.inference_mode():
            return torch.softmax(model.eval()(torch.from_numpy(x[..., 0])),
                                 -1).numpy()

    for case in ("small_stn", "small_gru"):
        cfg, tcfg, params, stats = _source(case)
        sd = tw.params_from_jax(params, stats)
        path = str(tmp_path / f"{case}.h5")
        tw.export_keras_h5(sd, tcfg, path)
        if cfg.use_stn:
            model = build_keras_crnn(
                num_classes=cfg.num_classes, width=cfg.width,
                stem_filters=cfg.stem_filters,
                block_filters=cfg.block_filters,
                time_dense_size=cfg.time_dense_size, n_units=cfg.n_units,
                rnn_layers=cfg.rnn_layers, rnn_cell=cfg.rnn_cell,
                use_stn=True)
        else:
            js = str(tmp_path / "model.json")
            assert migrate._write_arch_json(tcfg, js)
            model = tf_keras.models.model_from_json(open(js).read())
        model.load_weights(path)
        x = np.load(GOLDENS / f"keras_{case}_io.npz")["x"]
        want = model.predict(x, verbose=0)
        np.testing.assert_allclose(port_probs(tcfg, sd, x), want,
                                   rtol=1e-4, atol=2e-5, err_msg=case)

"""Port parity: the migrate CLI (``crnn_ocr_torch/cli/migrate.py``)
against ``crnn_ocr_tpu/cli/migrate.py`` (``tests/test_keras_parity.py``'s
``test_migrate_cli_roundtrip``, which is ``slow`` there and not here), and
the small surface that came with it: ``param_count``, ``pretrained_dir``
and ``preprocess_host``.

On each migration golden (reference artifacts with Keras-generated layer
names, with and without an STN): ``import`` prints JAX's line (the same
parameter count), and its directory serves the Keras model's outputs
(``io.npz``, rtol 1e-4 / atol 2e-5, the keras-parity tolerance);
``export`` of it gives artifacts that both packages'
``load_reference_model`` read back to the imported trees bit for bit,
with the class map's size; ``export`` of JAX's own imported directory (an
orbax checkpoint) writes the same ``model.h5``. ``model.json`` needs
``tf_keras``, whose import takes ~15 s: it is skipped here as JAX's test
skips it (``tests/test_torch_hdf5_write.py`` loads it).
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

import crnn_ocr_torch.cli.migrate as migrate
from crnn_ocr_torch.infer import init_predictor
from crnn_ocr_torch.infer import pretrained as tpretrained
from crnn_ocr_torch.infer.keras_json import load_reference_model
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.ops.preprocess import preprocess_host
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_tpu.infer import pretrained as jpretrained
from crnn_ocr_tpu.infer.keras_json import (
    load_reference_model as jax_load_reference_model,
)
from crnn_ocr_tpu.ops.preprocess import preprocess_host as jax_preprocess_host
from crnn_ocr_tpu.train.state import param_count as jax_param_count
from chip_smoke import flat_tree
from test_torch_hdf5_write import ALL, _h5_items, _source

GOLDENS = pathlib.Path(__file__).parent / "goldens"


def _assert_trees_equal(a, b):
    fa, fb = flat_tree(a), flat_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fb:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("variant", ["autonamed", "autonamed_stn"])
def test_migrate_cli_roundtrip(tmp_path, monkeypatch, capsys, variant):
    import crnn_ocr_tpu.cli.migrate as jax_migrate

    mig = GOLDENS / f"migration_{variant}"
    monkeypatch.setattr(migrate, "_write_arch_json", lambda cfg, p: False)
    monkeypatch.setattr(jax_migrate, "_write_arch_json",
                        lambda cfg, p: False)
    dest, jdest = tmp_path / "model", tmp_path / "jax_model"
    assert migrate.main(["import", "--src", str(mig), "--dest", str(dest),
                         "--device", "cpu"]) == 0
    got = _last_line(capsys)
    assert jax_migrate.main(["import", "--src", str(mig), "--dest",
                             str(jdest)]) == 0
    want = _last_line(capsys)
    assert got.replace(str(dest), "DEST") == want.replace(str(jdest), "DEST")
    assert got.startswith("imported ") and " params -> " in got

    # the imported directory serves the Keras model's outputs
    data = np.load(mig / "io.npz")
    pred = init_predictor(str(dest), device="cpu")
    assert pred.cfg.provenance == "keras_migrated"
    with torch.inference_mode():
        probs = torch.softmax(pred.model(torch.from_numpy(
            data["x"][..., 0])), -1).numpy()
    np.testing.assert_allclose(probs, data["y"], rtol=1e-4, atol=2e-5)

    # export, then either package's loader: the imported trees, bitwise
    out, jout = tmp_path / "ref_out", tmp_path / "ref_out_of_jax"
    assert migrate.main(["export", "--src", str(dest), "--dest",
                         str(out)]) == 0
    assert _last_line(capsys) == (f"exported model.h5 + classes.[pkl|json] "
                                  f"-> {out} (model.json skipped: tf_keras "
                                  "oracle builder not importable)")
    assert sorted(p.name for p in out.iterdir()) == [
        "classes.json", "classes.pkl", "model.h5"]
    _, src_p, src_s, codec = load_reference_model(str(mig))
    for load in (load_reference_model, jax_load_reference_model):
        cfg3, p3, s3, codec3 = load(str(out))
        assert codec3 is not None
        assert codec3.num_classes == codec.num_classes == cfg3.num_classes
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, p3), src_p)
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, s3), src_s)
    # the port's export of JAX's imported directory (orbax) writes the same
    assert migrate.main(["export", "--src", str(jdest), "--dest",
                         str(jout)]) == 0
    a, b = _h5_items(str(out / "model.h5")), _h5_items(str(jout / "model.h5"))
    assert a[1:] == b[1:] and sorted(a[0]) == sorted(b[0])
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)


def test_migrate_import_needs_a_class_map(tmp_path, capsys):
    import shutil

    src = tmp_path / "ref"
    src.mkdir()
    shutil.copy(GOLDENS / "migration_autonamed" / "model.h5", src)
    shutil.copy(GOLDENS / "migration_autonamed" / "model.json", src)
    assert migrate.main(["import", "--src", str(src), "--dest",
                         str(tmp_path / "d"), "--device", "cpu"]) == 1
    assert "no class map" in capsys.readouterr().err


@pytest.mark.parametrize("case", ALL)
def test_param_count_matches_jax(case):
    """``param_count`` of the port's train state equals JAX's of the same
    trees (JAX's reads ``state.params`` alone)."""
    _, tcfg, params, stats = _source(case)
    state = tstate.create_train_state(tcfg, params_from_jax(params, stats),
                                      device="cpu")
    jax_state = type("S", (), {"params": params})()
    assert tstate.param_count(state) == jax_param_count(jax_state) > 0


def test_pretrained_dir_matches_jax():
    assert sorted(tpretrained.REGISTRY) == sorted(jpretrained.REGISTRY)
    for name in jpretrained.REGISTRY:
        assert tpretrained.pretrained_dir(name) == \
            jpretrained.pretrained_dir(name)
    # a variant has no directory of its own; an unknown name neither
    for name in ("fonts-hard-lstm", "no-such-model"):
        with pytest.raises(KeyError) as want:
            jpretrained.pretrained_dir(name)
        with pytest.raises(KeyError) as got:
            tpretrained.pretrained_dir(name)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,normalize", [
    ((40, 100), True), ((20, 300), True), ((32, 128, 3), True),
    ((64, 50), False), ((1, 9), True)])
def test_preprocess_host_matches_jax(shape, normalize):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    for out_w in (128, 256):
        got = preprocess_host(img, out_w=out_w, normalize=normalize)
        want = jax_preprocess_host(img, out_w=out_w, normalize=normalize)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

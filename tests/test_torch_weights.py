"""Port weights and import hygiene.

* The port's ``import_keras_h5`` (through its own HDF5 reader,
  ``infer/hdf5.py``) returns exactly what the JAX package's returns for the
  bundled ``.h5`` files, and the reader equals ``h5py`` on every Keras
  ``.h5`` in the repo.
* ``params_from_jax`` carries a JAX parameter tree over so that the port's
  forward pass reproduces JAX's (rtol 1e-4 / atol 2e-5 on softmax outputs,
  as ``tests/test_keras_parity.py``).
* Nothing in ``crnn_ocr_torch/`` or ``chip_smoke.py`` imports JAX, flax or
  ``crnn_ocr_tpu``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.config import load_model_config
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.infer.hdf5 import H5File
from crnn_ocr_torch.models import CRNN as TorchCRNN
from crnn_ocr_tpu.infer.h5_import import import_keras_h5
from crnn_ocr_tpu.infer.pretrained import pretrained_dir
from crnn_ocr_tpu.models import CRNN, ModelConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "crnn_ocr_tpu", "h5py", "zstandard")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


BUNDLED = ["fonts-small", "fonts-hard", "fonts-stn", "fonts-warp-stn"]


@pytest.mark.parametrize("name", BUNDLED)
def test_npz_equals_import_keras_h5(name):
    """The weights the port loads (its own reader of the bundled ``.h5``)
    equal the JAX package's ``import_keras_h5``, array for array."""
    d = pretrained_dir(name)
    jcfg_d = load_model_config(os.path.join(d, "model_config.json"))
    jcfg = ModelConfig(**{k: getattr(jcfg_d, k) for k in (
        "num_classes", "block_filters", "block_pools", "rnn_layers",
        "use_stn")})
    want_p, want_s = import_keras_h5(os.path.join(d, "weights.h5"), jcfg)
    got_p, got_s = tw.import_keras_h5(os.path.join(d, "weights.h5"), jcfg_d)
    assert ("stn" in got_p) == jcfg.use_stn
    for got, want in ((got_p, want_p), (got_s, want_s)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and they load into the port's CRNN
    TorchCRNN(jcfg_d).load_state_dict(tw.params_from_jax(got_p, got_s))


def _h5_files():
    return sorted(str(p.relative_to(REPO)) for p in
                  list((REPO / "crnn_ocr_tpu" / "pretrained").rglob("*.h5"))
                  + list((REPO / "tests" / "goldens").rglob("*.h5")))


@pytest.mark.parametrize("rel", _h5_files())
def test_hdf5_reader_equals_h5py(rel):
    """Every Keras ``.h5`` in the repo: the layer and weight names and
    every array, bit for bit, against ``h5py``."""
    path = str(REPO / rel)
    f = H5File(path)
    with h5py.File(path, "r") as h:
        g = "model_weights" if "model_weights" in h else "/"

        def names(attrs, key):
            return [n.decode() if isinstance(n, bytes) else n
                    for n in attrs.get(key, [])]

        layers = names(h[g].attrs, "layer_names")
        assert f.attrs(g)["layer_names"] == layers
        assert sorted(f.keys(g)) == sorted(h[g].keys())
        n = 0
        for lname in layers:
            wnames = names(h[g][lname].attrs, "weight_names")
            assert f.attrs(f"{g}/{lname}").get("weight_names", []) == wnames
            for w in wnames:
                got = f.dataset(f"{g}/{lname}/{w}")
                want = np.asarray(h[g][lname][w])
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want, err_msg=w)
                n += 1
    assert n > 0


def test_hdf5_reader_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "chunked.h5")
    with h5py.File(path, "w") as h:
        h.create_dataset("x", data=np.arange(64, dtype=np.float32),
                         chunks=(16,), compression="gzip")
        h.create_dataset("y", data=np.arange(6, dtype=">f8").reshape(2, 3))
        h.attrs["s"] = "one"
        h.attrs["fixed"] = np.array([b"ab", b"cde"])
    f = H5File(path)
    with pytest.raises(NotImplementedError, match="chunked"):
        f.dataset("x")
    np.testing.assert_array_equal(f.dataset("y"),
                                  np.arange(6.0).reshape(2, 3))
    assert f.attrs("/") == {"s": "one", "fixed": ["ab", "cde"]}
    with pytest.raises(KeyError):
        f.dataset("z")
    (tmp_path / "no.h5").write_bytes(b"not hdf5")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        H5File(str(tmp_path / "no.h5"))


def test_params_from_jax_reproduces_jax_forward():
    """Random JAX init (with non-trivial BatchNorm statistics) carried over
    to the port gives JAX's forward pass."""
    kw = dict(num_classes=11, width=64, stem_filters=8,
              block_filters=(16, 24, 24, 32), time_dense_size=20,
              n_units=16, rnn_layers=2, dropout_rate=0.0)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 32, 64, 1)).astype(np.float32)
    jmodel = CRNN(cfg=ModelConfig(**kw))
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, x, train=False)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
        .astype(np.float32), v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    want = np.asarray(jax.nn.softmax(jmodel.apply(
        {"params": params, "batch_stats": stats}, x, train=False), -1))
    model = TorchCRNN(TorchConfig(**kw))
    model.load_state_dict(tw.params_from_jax(params, stats))
    with torch.inference_mode():
        got = torch.softmax(model.eval()(torch.from_numpy(x[..., 0])), -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def _port_sources():
    pkg = REPO / "crnn_ocr_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts)  # outputs
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert {"crnn_ocr_torch/kernels/ctc_loss.py", "crnn_ocr_torch/train/loop.py",
            "crnn_ocr_torch/train/step.py", "crnn_ocr_torch/train/state.py",
            "crnn_ocr_torch/data/pipeline.py",
            "crnn_ocr_torch/data/synthetic.py",
            "crnn_ocr_torch/utils/metrics.py",
            "crnn_ocr_torch/kernels/grid_sample.py",
            "crnn_ocr_torch/ops/grid_sample.py",
            "crnn_ocr_torch/models/stn.py",
            "crnn_ocr_torch/infer/hdf5.py",
            "crnn_ocr_torch/kernels/fused_stem_train.py",
            "crnn_ocr_torch/kernels/bigru.py",
            "crnn_ocr_torch/infer/pretrained.py",
            "crnn_ocr_torch/serve/batcher.py", "crnn_ocr_torch/serve/http.py",
            "crnn_ocr_torch/cli/predict.py", "crnn_ocr_torch/cli/serve.py",
            "crnn_ocr_torch/infer/keras_json.py",
            "crnn_ocr_torch/data/reader.py", "crnn_ocr_torch/data/packed.py",
            "crnn_ocr_torch/data/fontgen.py",
            "crnn_ocr_torch/train/checkpoint.py",
            "crnn_ocr_torch/utils/profiling.py",
            "crnn_ocr_torch/ops/editdistance.py",
            "crnn_ocr_torch/ops/augment.py",
            "crnn_ocr_torch/data/device_cache.py",
            "crnn_ocr_torch/parallel/__init__.py",
            "crnn_ocr_torch/parallel/mesh.py",
            "crnn_ocr_torch/cli/train.py", "crnn_ocr_torch/cli/migrate.py",
            "crnn_ocr_torch/train/orbax.py",
            "crnn_ocr_torch/utils/zstd.py",
            "crnn_ocr_torch/infer/h5_import.py",
            "crnn_ocr_torch/counterparts.py"} <= names
    # the host C++ the port builds is its own copy, inside the package
    for src in ("ctc_beam_tf.cc", "editdistance.cc", "imgproc.cc"):
        assert (REPO / "crnn_ocr_torch" / "native" / src).is_file(), src
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, crnn_ocr_torch, crnn_ocr_torch.kernels.bigru, "
        "crnn_ocr_torch.kernels.fused_stem, crnn_ocr_torch.ops.ctc, "
        "crnn_ocr_torch.kernels._build, crnn_ocr_torch.kernels.ctc_loss, "
        "crnn_ocr_torch.train.loop, crnn_ocr_torch.train.state, "
        "crnn_ocr_torch.train.step, crnn_ocr_torch.data.pipeline, "
        "crnn_ocr_torch.data.synthetic, crnn_ocr_torch.utils.metrics, "
        "crnn_ocr_torch.kernels.grid_sample, crnn_ocr_torch.ops.grid_sample, "
        "crnn_ocr_torch.models.stn, crnn_ocr_torch.infer.hdf5, "
        "crnn_ocr_torch.serve, crnn_ocr_torch.serve.batcher, "
        "crnn_ocr_torch.serve.http, crnn_ocr_torch.cli.predict, "
        "crnn_ocr_torch.cli.serve, crnn_ocr_torch.infer.keras_json, "
        "crnn_ocr_torch.data, crnn_ocr_torch.data.reader, "
        "crnn_ocr_torch.data.packed, crnn_ocr_torch.data.fontgen, "
        "crnn_ocr_torch.train, crnn_ocr_torch.train.checkpoint, "
        "crnn_ocr_torch.utils.profiling, crnn_ocr_torch.parallel, "
        "crnn_ocr_torch.parallel.mesh, crnn_ocr_torch.cli.train, "
        "crnn_ocr_torch.cli.migrate, crnn_ocr_torch.train.orbax, "
        "crnn_ocr_torch.utils.zstd, crnn_ocr_torch.ops, "
        "crnn_ocr_torch.models, crnn_ocr_torch.utils, "
        "crnn_ocr_torch.infer.h5_import, crnn_ocr_torch.counterparts\n"
        "p = crnn_ocr_torch.load_pretrained('fonts-small', device='cpu')\n"
        "p = crnn_ocr_torch.load_pretrained('fonts-warp-stn', device='cpu')\n"
        "p = crnn_ocr_torch.load_pretrained('fonts-hard-lstm', device='cpu')\n"
        "p = crnn_ocr_torch.infer.init_predictor("
        "'tests/goldens/migration_autonamed_stn', device='cpu')\n"
        "p = crnn_ocr_torch.infer.init_predictor("
        "'crnn_ocr_torch/testdata/orbax_small', device='cpu')\n"
        "assert 'h5py' not in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'cv2' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

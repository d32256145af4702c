"""Port weights and import hygiene.

* The committed ``crnn_ocr_torch/pretrained/*.npz`` hold exactly what the
  JAX package's ``import_keras_h5`` returns for the bundled ``.h5`` files,
  and the port's own ``.h5`` reader returns the same arrays.
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

import jax
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.config import load_model_config
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.models import CRNN as TorchCRNN
from crnn_ocr_tpu.infer.h5_import import import_keras_h5
from crnn_ocr_tpu.infer.pretrained import pretrained_dir
from crnn_ocr_tpu.models import CRNN, ModelConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "crnn_ocr_tpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", ["fonts-small", "fonts-hard"])
def test_npz_equals_import_keras_h5(name):
    d = pretrained_dir(name)
    jcfg_d = load_model_config(os.path.join(d, "model_config.json"))
    jcfg = ModelConfig(**{k: getattr(jcfg_d, k) for k in (
        "num_classes", "block_filters", "block_pools", "rnn_layers",
        "use_stn")})
    want_p, want_s = import_keras_h5(os.path.join(d, "weights.h5"), jcfg)
    got_p, got_s = tw.load_npz(os.path.join(
        tw.NPZ_DIR, f"{os.path.basename(d)}.npz"))
    for got, want in ((got_p, want_p), (got_s, want_s)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own .h5 reader (the converter's) agrees array for array
    own_p, own_s = tw.import_keras_h5(os.path.join(d, "weights.h5"), jcfg_d)
    assert _flat(own_p).keys() == _flat(want_p).keys()
    for k, v in _flat(own_p).items():
        np.testing.assert_array_equal(v, _flat(want_p)[k], err_msg=k)
    for k, v in _flat(own_s).items():
        np.testing.assert_array_equal(v, _flat(want_s)[k], err_msg=k)


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


def test_npz_round_trip(tmp_path):
    p, s = tw.load_npz(os.path.join(tw.NPZ_DIR, "fonts_small.npz"))
    path = str(tmp_path / "w.npz")
    tw.save_npz(path, p, s)
    p2, s2 = tw.load_npz(path)
    for a, b in ((p, p2), (s, s2)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


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
    assert len(_port_sources()) > 10
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, crnn_ocr_torch, crnn_ocr_torch.kernels.bigru, "
        "crnn_ocr_torch.kernels.fused_stem, crnn_ocr_torch.ops.ctc, "
        "crnn_ocr_torch.kernels._build\n"
        "p = crnn_ocr_torch.load_pretrained('fonts-small', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

"""Weights: the JAX package's parameter trees -> the port's ``state_dict``.

The bundled models ship as Keras ``.h5`` files, and the machine with the
card has no ``h5py``. So the weights reach the port as ``.npz`` files,
``crnn_ocr_torch/pretrained/<dir>.npz``, that hold the JAX package's trees
(``params`` and ``batch_stats``, as ``infer/h5_import.py::import_keras_h5``
returns them) flattened to ``"params/block0/depthwise/kernel"``-style keys.
``load_npz`` reads them back; ``params_from_jax`` maps the trees onto
``models.crnn.CRNN``:

  conv kernel (kh, kw, in, out)            -> weight (out, in, kh, kw)
  depthwise kernel (3, 3, 1, C) (grouped)  -> weight (C, 1, 3, 3)
  Dense kernel (in, out)                   -> weight (out, in)
  BiGRU kernel/recurrent_kernel/bias       -> unchanged (the kernel's layout)
  BatchNorm scale/bias + mean/var          -> weight/bias + running_mean/var

Write the ``.npz`` files (where ``h5py`` is installed) with

    python -m crnn_ocr_torch.infer.weights --convert
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_PRETRAINED = os.path.join(REPO, "crnn_ocr_tpu", "pretrained")
NPZ_DIR = os.path.join(REPO, "crnn_ocr_torch", "pretrained")
CONVERTED = ("fonts_small", "fonts_hard")


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _bn(dst: Dict[str, np.ndarray], prefix: str, p: dict, s: dict) -> None:
    dst[f"{prefix}.weight"] = p["scale"]
    dst[f"{prefix}.bias"] = p["bias"]
    dst[f"{prefix}.running_mean"] = s["mean"]
    dst[f"{prefix}.running_var"] = s["var"]


def params_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """``CRNN`` state_dict (f32 tensors) from the JAX package's trees, nested
    dicts of numpy arrays."""
    params = _tree_np(params)
    stats = _tree_np(batch_stats)
    if "stn" in params:
        raise NotImplementedError("STN weights: the STN is not ported yet")
    sd: Dict[str, np.ndarray] = {
        "stem_conv.weight": _conv(params["stem_conv"]["kernel"]),
    }
    _bn(sd, "stem_bn", params["stem_bn"], stats["stem_bn"])
    i = 0
    while f"block{i}" in params:
        p = params[f"block{i}"]
        sd[f"block{i}.depthwise.weight"] = _conv(p["depthwise"]["kernel"])
        sd[f"block{i}.pointwise.weight"] = _conv(p["pointwise"]["kernel"])
        _bn(sd, f"block{i}.bn", p["BatchNorm_0"], stats[f"block{i}"]["BatchNorm_0"])
        i += 1
    sd["time_dense.weight"] = params["time_dense"]["kernel"].T
    sd["time_dense.bias"] = params["time_dense"]["bias"]
    i = 0
    while f"birnn{i}" in params:
        for k in ("kernel", "recurrent_kernel", "bias"):
            sd[f"birnn{i}.{k}"] = params[f"birnn{i}"][k]
        _bn(sd, f"rnn_bn{i}", params[f"rnn_bn{i}"], stats[f"rnn_bn{i}"])
        i += 1
    sd["logits.weight"] = params["logits"]["kernel"].T
    sd["logits.bias"] = params["logits"]["bias"]
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flatten(tree: dict, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)


def save_npz(path: str, params: dict, batch_stats: dict) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(batch_stats, "batch_stats", flat)
    np.savez_compressed(path, **flat)


def load_npz(path: str) -> Tuple[dict, dict]:
    """(params, batch_stats) nested dicts of numpy arrays from ``path``."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = trees[parts[0]]
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return trees["params"], trees["batch_stats"]


# ---- Keras .h5 reading (converter only; needs h5py) ----


def _read_h5_layers(path: str) -> Dict[str, List[np.ndarray]]:
    """{layer_name: [weights in saved order]} from a Keras .h5."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading .h5 weights needs h5py, which is not installed; the "
            "port loads the converted .npz files instead"
        ) from e
    out: Dict[str, List[np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        for lname in g.attrs["layer_names"]:
            lname = lname.decode() if isinstance(lname, bytes) else lname
            lg = g[lname]
            wnames = [
                n.decode() if isinstance(n, bytes) else n
                for n in lg.attrs.get("weight_names", [])
            ]
            if wnames:
                out[lname] = [np.asarray(lg[w]) for w in wnames]
    return out


def import_keras_h5(path: str, cfg) -> Tuple[dict, dict]:
    """(params, batch_stats) numpy trees from a Keras .h5 with the canonical
    layer names, as ``crnn_ocr_tpu/infer/h5_import.py::import_keras_h5``
    builds them (GRU models without an STN)."""
    if cfg.use_stn:
        raise NotImplementedError("STN weights: the STN is not ported yet")
    layers = _read_h5_layers(path)

    def get(layer: str) -> List[np.ndarray]:
        if layer not in layers:
            raise KeyError(f"layer {layer!r} not in h5 (has: {sorted(layers)})")
        return layers[layer]

    params: dict = {}
    stats: dict = {}

    def bn(dst_p: dict, dst_s: dict, key: str, layer: str) -> None:
        gamma, beta, mean, var = get(layer)
        dst_p[key] = {"scale": gamma, "bias": beta}
        dst_s[key] = {"mean": mean, "var": var}

    params["stem_conv"] = {"kernel": get("stem_conv")[0]}
    bn(params, stats, "stem_bn", "stem_bn")
    for i in range(len(cfg.block_filters)):
        dw = get(f"block{i}_depthwise")[0]  # (kh, kw, C, 1)
        blk_p = {
            "depthwise": {"kernel": np.transpose(dw, (0, 1, 3, 2))},
            "pointwise": {"kernel": get(f"block{i}_pointwise")[0]},
        }
        blk_s: dict = {}
        bn(blk_p, blk_s, "BatchNorm_0", f"block{i}_bn")
        params[f"block{i}"] = blk_p
        stats[f"block{i}"] = blk_s
    k, b = get("time_dense")
    params["time_dense"] = {"kernel": k, "bias": b}
    for i in range(cfg.rnn_layers):
        w = get(f"birnn{i}")
        if len(w) != 6:
            raise ValueError(f"birnn{i}: expected 6 weight arrays (fwd/bwd x "
                             f"kernel/recurrent/bias), got {len(w)}")
        fk, fr, fb, bk, br, bb = w
        params[f"birnn{i}"] = {
            "kernel": np.stack([fk, bk]),
            "recurrent_kernel": np.stack([fr, br]),
            "bias": np.stack([fb, bb]),
        }
        bn(params, stats, f"rnn_bn{i}", f"rnn_bn{i}")
    k, b = get("logits")
    params["logits"] = {"kernel": k, "bias": b}
    as_f32 = lambda t: np.asarray(t, np.float32)  # noqa: E731
    return _tree_map(params, as_f32), _tree_map(stats, as_f32)


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def convert() -> None:
    """Write ``pretrained/<dir>.npz`` for every converted bundled model."""
    from crnn_ocr_torch.config import load_model_config

    os.makedirs(NPZ_DIR, exist_ok=True)
    for d in CONVERTED:
        src = os.path.join(JAX_PRETRAINED, d)
        cfg = load_model_config(os.path.join(src, "model_config.json"))
        params, stats = import_keras_h5(os.path.join(src, "weights.h5"), cfg)
        out = os.path.join(NPZ_DIR, f"{d}.npz")
        save_npz(out, params, stats)
        print(f"wrote {out} ({os.path.getsize(out)} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--convert", action="store_true",
                    help="write the .npz weights of the bundled models")
    args = ap.parse_args(argv)
    if not args.convert:
        ap.print_help()
        return 2
    convert()
    return 0


if __name__ == "__main__":
    sys.exit(main())

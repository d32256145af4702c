"""Weights: Keras ``.h5`` files -> the JAX package's parameter trees -> the
port's ``state_dict``.

``import_keras_h5`` reads a Keras ``.h5`` with the canonical layer names
into the trees that ``crnn_ocr_tpu/infer/h5_import.py::import_keras_h5``
returns (``params`` and ``batch_stats``, nested dicts of f32 numpy arrays),
through the port's own HDF5 reader (``infer/hdf5.py``: the machine with the
card has no ``h5py``). The bundled models are read straight from the JAX
package's ``crnn_ocr_tpu/pretrained/<dir>/weights.h5``, so no second copy
of their weights is kept. ``params_from_jax`` maps the trees onto
``models.crnn.CRNN``:

  conv kernel (kh, kw, in, out)            -> weight (out, in, kh, kw)
  depthwise kernel (3, 3, 1, C) (grouped)  -> weight (C, 1, 3, 3)
  Dense kernel (in, out)                   -> weight (out, in)
  BiGRU, BiLSTM kernel/recurrent_kernel/bias -> unchanged (the kernels'
                                              layout)
  BatchNorm scale/bias + mean/var          -> weight/bias + running_mean/var
  stn/Conv_i, Dense_0, Dense_1             -> stn.convs.i, stn.dense,
                                              stn.theta (STN models)

``params_to_jax`` is its exact inverse (transposes only, so the round
trip is bit for bit), and ``export_keras_h5`` writes a state_dict as the
Keras ``.h5`` that ``crnn_ocr_tpu/infer/h5_import.py::export_keras_h5``
writes (its layers, weight names and order, through the port's HDF5
writer): the file that ``tf_keras`` ``load_weights`` and either package's
``import_keras_h5`` read.

``seeded_rnn_params`` makes BiLSTM layers from a seed, in the same JAX
layout, for a configuration that has no weights of its own
(``infer/pretrained.py``'s variants).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crnn_ocr_torch.infer.hdf5 import H5File, H5Writer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_PRETRAINED = os.path.join(REPO, "crnn_ocr_tpu", "pretrained")


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
    sd: Dict[str, np.ndarray] = {
        "stem_conv.weight": _conv(params["stem_conv"]["kernel"]),
    }
    if "stn" in params:
        stn = params["stn"]
        i = 0
        while f"Conv_{i}" in stn:
            sd[f"stn.convs.{i}.weight"] = _conv(stn[f"Conv_{i}"]["kernel"])
            sd[f"stn.convs.{i}.bias"] = stn[f"Conv_{i}"]["bias"]
            i += 1
        # Dense_0's rows are in flax's NHWC flatten order, which STN keeps
        for key, name in (("Dense_0", "dense"), ("Dense_1", "theta")):
            sd[f"stn.{name}.weight"] = stn[key]["kernel"].T
            sd[f"stn.{name}.bias"] = stn[key]["bias"]
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


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The JAX package's (params, batch_stats) trees, nested dicts of f32
    numpy arrays, of a ``CRNN`` state_dict: ``params_from_jax`` read
    backwards."""
    a = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}

    def conv(k: str) -> np.ndarray:  # OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(a[k], (2, 3, 1, 0)))

    def dense(prefix: str) -> dict:
        return {"kernel": np.ascontiguousarray(a[f"{prefix}.weight"].T),
                "bias": a[f"{prefix}.bias"]}

    def bn(prefix: str) -> Tuple[dict, dict]:
        return ({"scale": a[f"{prefix}.weight"], "bias": a[f"{prefix}.bias"]},
                {"mean": a[f"{prefix}.running_mean"],
                 "var": a[f"{prefix}.running_var"]})

    params: dict = {}
    stats: dict = {}
    if "stn.dense.weight" in a:
        stn: dict = {}
        i = 0
        while f"stn.convs.{i}.weight" in a:
            stn[f"Conv_{i}"] = {"kernel": conv(f"stn.convs.{i}.weight"),
                                "bias": a[f"stn.convs.{i}.bias"]}
            i += 1
        stn["Dense_0"], stn["Dense_1"] = dense("stn.dense"), dense("stn.theta")
        params["stn"] = stn
    params["stem_conv"] = {"kernel": conv("stem_conv.weight")}
    params["stem_bn"], stats["stem_bn"] = bn("stem_bn")
    i = 0
    while f"block{i}.bn.weight" in a:
        p, st = bn(f"block{i}.bn")
        params[f"block{i}"] = {
            "depthwise": {"kernel": conv(f"block{i}.depthwise.weight")},
            "pointwise": {"kernel": conv(f"block{i}.pointwise.weight")},
            "BatchNorm_0": p}
        stats[f"block{i}"] = {"BatchNorm_0": st}
        i += 1
    params["time_dense"] = dense("time_dense")
    i = 0
    while f"birnn{i}.kernel" in a:
        params[f"birnn{i}"] = {k: a[f"birnn{i}.{k}"] for k in (
            "kernel", "recurrent_kernel", "bias")}
        params[f"rnn_bn{i}"], stats[f"rnn_bn{i}"] = bn(f"rnn_bn{i}")
        i += 1
    params["logits"] = dense("logits")
    return params, stats


def _keras_layers(params: dict, stats: dict, cfg
                 ) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """{layer: [(weight name, array)]} in the order and with the names
    that ``crnn_ocr_tpu/infer/h5_import.py:159-235`` writes them."""
    layers: Dict[str, List[Tuple[str, np.ndarray]]] = {}

    def bn(layer: str, p: dict, s: dict) -> None:
        layers[layer] = [(f"{layer}/gamma:0", p["scale"]),
                         (f"{layer}/beta:0", p["bias"]),
                         (f"{layer}/moving_mean:0", s["mean"]),
                         (f"{layer}/moving_variance:0", s["var"])]

    def dense(layer: str, p: dict) -> None:
        layers[layer] = [(f"{layer}/kernel:0", p["kernel"]),
                         (f"{layer}/bias:0", p["bias"])]

    if "stn" in params:
        stn = params["stn"]
        for i in range(sum(1 for k in stn if k.startswith("Conv_"))):
            dense(f"stn_conv{i}", stn[f"Conv_{i}"])
        dense("stn_dense", stn["Dense_0"])
        dense("stn_theta", stn["Dense_1"])
    layers["stem_conv"] = [("stem_conv/kernel:0",
                            params["stem_conv"]["kernel"])]
    bn("stem_bn", params["stem_bn"], stats["stem_bn"])
    for i in range(len(cfg.block_filters)):
        p, s = params[f"block{i}"], stats[f"block{i}"]
        layers[f"block{i}_depthwise"] = [(
            f"block{i}_depthwise/depthwise_kernel:0",
            np.transpose(p["depthwise"]["kernel"], (0, 1, 3, 2)))]
        layers[f"block{i}_pointwise"] = [(f"block{i}_pointwise/kernel:0",
                                          p["pointwise"]["kernel"])]
        bn(f"block{i}_bn", p["BatchNorm_0"], s["BatchNorm_0"])
    dense("time_dense", params["time_dense"])
    cell = cfg.rnn_cell
    for i in range(cfg.rnn_layers):
        p = params[f"birnn{i}"]
        layers[f"birnn{i}"] = [
            (f"birnn{i}/{d}_{cell}/{cell}_cell/{k}:0", p[k][j])
            for j, d in enumerate(("forward", "backward"))
            for k in ("kernel", "recurrent_kernel", "bias")]
        bn(f"rnn_bn{i}", params[f"rnn_bn{i}"], stats[f"rnn_bn{i}"])
    dense("logits", params["logits"])
    return layers


def export_keras_h5(state_dict: Dict[str, torch.Tensor], cfg,
                    path: str) -> None:
    """Write a ``CRNN`` state_dict as a legacy-format Keras ``.h5``: the
    root's ``layer_names``, ``backend`` and ``keras_version`` attributes,
    each layer a group with its ``weight_names`` and one f32 dataset per
    weight (``crnn_ocr_tpu/infer/h5_import.py::export_keras_h5``'s file,
    written without ``h5py``)."""
    layers = _keras_layers(*params_to_jax(state_dict), cfg)
    w = H5Writer()
    w.set_attr("/", "layer_names", list(layers))
    w.set_attr("/", "backend", "tensorflow")
    w.set_attr("/", "keras_version", "2.21.0")
    for lname, weights in layers.items():
        w.create_group(lname)
        w.set_attr(lname, "weight_names", [wn for wn, _ in weights])
        for wn, arr in weights:
            w.create_dataset(f"{lname}/{wn}", np.asarray(arr, np.float32))
    w.save(path)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _read_h5_layers(path: str) -> Dict[str, List[np.ndarray]]:
    """{layer_name: [weights in saved order]} from a Keras .h5."""
    f = H5File(path)
    g = "model_weights" if f.has("model_weights") else "/"
    out: Dict[str, List[np.ndarray]] = {}
    for lname in f.attrs(g)["layer_names"]:
        wnames = f.attrs(f"{g}/{lname}").get("weight_names", [])
        if wnames:
            out[lname] = [f.dataset(f"{g}/{lname}/{w}") for w in wnames]
    return out


def import_keras_h5(path: str, cfg,
                    name_map: Optional[Dict[str, str]] = None
                    ) -> Tuple[dict, dict]:
    """(params, batch_stats) numpy trees from a Keras .h5, as
    ``crnn_ocr_tpu/infer/h5_import.py::import_keras_h5`` builds them (GRU
    and LSTM models, with or without an STN; a direction's LSTM bias (4H,)
    stacks to (2, 4H), ``h5_import.py:15``). Layers are looked up by their
    canonical names (``stem_conv``, ``block{i}_*``, ``birnn{i}``, ...),
    each mapped to the ``.h5``'s own name through ``name_map`` where it
    has one (a reference artifact's Keras-generated names,
    ``infer/keras_json.py``)."""
    layers = _read_h5_layers(path)
    name_map = name_map or {}

    def h5_name(layer: str) -> str:
        return name_map.get(layer, layer)

    def get(layer: str) -> List[np.ndarray]:
        if h5_name(layer) not in layers:
            raise KeyError(f"layer {h5_name(layer)!r} not in h5 (has: "
                           f"{sorted(layers)})")
        return layers[h5_name(layer)]

    params: dict = {}
    stats: dict = {}

    def bn(dst_p: dict, dst_s: dict, key: str, layer: str) -> None:
        gamma, beta, mean, var = get(layer)
        dst_p[key] = {"scale": gamma, "bias": beta}
        dst_s[key] = {"mean": mean, "var": var}

    if cfg.use_stn:  # the sampler has no weights (h5_import.py:83-99)
        stn: dict = {}
        i = 0
        while h5_name(f"stn_conv{i}") in layers:
            k, b = get(f"stn_conv{i}")
            stn[f"Conv_{i}"] = {"kernel": k, "bias": b}
            i += 1
        for key, layer in (("Dense_0", "stn_dense"), ("Dense_1", "stn_theta")):
            k, b = get(layer)
            stn[key] = {"kernel": k, "bias": b}
        params["stn"] = stn
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


def seeded_rnn_params(cfg, seed: int = 0) -> dict:
    """BiLSTM layers for ``cfg`` (an LSTM config) from ``seed``, as the JAX
    package's parameter tree holds them: ``{"birnn<i>": {"kernel",
    "recurrent_kernel", "bias"}}``, f32 numpy. ``kernel`` (2, F, 4H) is
    glorot-uniform with flax's fans (the leading 2 counted as a receptive
    field), ``recurrent_kernel`` (2, H, 4H) uniform on [-1, 1) over
    sqrt(H), ``bias`` (2, 4H) Keras's unit forget bias (1.0 on [H, 2H), 0
    elsewhere, ``crnn_ocr_tpu/models/rnn.py:90-97``).

    Only elementwise uniform draws of ``np.random.default_rng(seed)`` and
    correctly rounded arithmetic go in (no QR or other LAPACK call, no
    libm function), so every machine builds the same bits."""
    if cfg.rnn_cell != "lstm":
        raise ValueError(f"seeded layers are BiLSTM ones; rnn_cell is "
                         f"{cfg.rnn_cell!r}")
    rng = np.random.default_rng(seed)
    H = cfg.n_units
    feat = cfg.time_dense_size
    out = {}
    for i in range(cfg.rnn_layers):
        limit = np.sqrt(6.0 / (2 * feat + 2 * 4 * H))
        kernel = rng.uniform(-limit, limit, (2, feat, 4 * H))
        rec = rng.uniform(-1.0, 1.0, (2, H, 4 * H)) / np.sqrt(H)
        bias = np.zeros((2, 4 * H))
        bias[:, H:2 * H] = 1.0
        out[f"birnn{i}"] = {"kernel": kernel.astype(np.float32),
                            "recurrent_kernel": rec.astype(np.float32),
                            "bias": bias.astype(np.float32)}
        feat = 2 * H
    return out


def rnn_params_digest(params: dict) -> str:
    """sha256 of a parameter tree's recurrent layers (``birnn<i>``, leaves
    in key order): tells whether two machines built the same seeded
    weights."""
    h = hashlib.sha256()
    for layer in sorted(k for k in params if k.startswith("birnn")):
        for leaf in sorted(params[layer]):
            h.update(np.ascontiguousarray(params[layer][leaf]).tobytes())
    return h.hexdigest()

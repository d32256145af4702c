"""Reference-artifact migration: Keras architecture JSON / auto-named .h5
-> ModelConfig + layer-name map, zero hand-holding (SURVEY.md C8, §8.6).

A copy of ``crnn_ocr_tpu/infer/keras_json.py`` on the port's config,
codec and HDF5 reader, with one repair in :func:`load_reference_model`: the
architecture JSON is the directory's ``.json`` that is not its class map
(the reference takes the first ``.json`` by name, so next to a
``classes.json`` it never reads the architecture JSON and falls back to
inferring the config from the ``.h5``, which cannot see the input width).

The reference persists models as architecture JSON + ``.h5`` weights +
``classes.pkl`` and reloads them via ``model_from_json`` with
``custom_objects`` for the STN sampler (SURVEY.md C8). Its layers carry
Keras auto-generated names (``conv2d_3``, ``bidirectional_1``), which the
name-keyed importer (``weights.import_keras_h5``) can't match directly.
This module closes that gap two ways:

  * :func:`model_config_from_keras_json` — parse the saved architecture
    JSON into a :class:`ModelConfig` plus the canonical->actual
    ``name_map`` for :func:`crnn_ocr_torch.infer.weights.import_keras_h5`.
  * :func:`infer_name_map_from_h5` — no JSON at all: reconstruct the map
    (and the config, where weight shapes pin it) from the .h5's stored
    layer order + weight shapes alone.
  * :func:`load_reference_model` — one-call migration: JSON (if present)
    + .h5 + classes.(json|pkl) -> (ModelConfig, params, batch_stats,
    codec).

Topology recognition is shape-driven, not name-driven: the reference's
CRNN class (SURVEY.md C4) is a linear graph
  [STN?] -> Conv2D stem -> N x (DepthwiseConv2D -> 1x1 Conv2D -> BN) ->
  Dense(time_dense) -> M x (Bidirectional(GRU/LSTM) -> BN) -> Dense(C+1)
so the k-th weighted layer's role is determined by its weight shapes
(e.g. a (3,3,C,1) kernel is depthwise; 6 arrays = bidirectional; a
bias-less (3,3,1,F) kernel is the stem while a biased early conv belongs
to the STN localization net).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.infer.weights import _read_h5_layers, import_keras_h5


def _layers_from_json(blob: dict) -> List[dict]:
    cfg = blob.get("config", blob)
    layers = cfg.get("layers")
    if layers is None:
        raise ValueError("not a Keras model JSON (no config.layers)")
    return layers


def model_config_from_keras_json(
    path_or_json: str, num_classes: Optional[int] = None
):
    """Parse Keras architecture JSON -> (ModelConfig, name_map).

    ``name_map`` maps this framework's canonical layer names
    (stem_conv/block{i}_*/time_dense/birnn{i}/rnn_bn{i}/logits/stn_*) to
    the JSON's actual layer names, ready for ``import_keras_h5``.
    """

    if os.path.exists(path_or_json):
        with open(path_or_json) as f:
            blob = json.load(f)
    else:
        blob = json.loads(path_or_json)
    layers = _layers_from_json(blob)

    name_map: Dict[str, str] = {}
    stem_filters = None
    block_filters: List[int] = []
    block_pools: List[Tuple[int, int]] = []
    time_dense = None
    n_units = None
    rnn_cell = "gru"
    rnn_layers = 0
    logits_dim = None
    height = width = None
    use_stn = False
    stn_convs = 0

    pending_dw: Optional[str] = None
    seen_stem = False
    seen_rnn = False
    dense_names: List[Tuple[str, int]] = []
    pool_since_block: List[Tuple[int, int]] = []

    for lay in layers:
        cls = lay["class_name"]
        cfg = lay.get("config", {})
        name = cfg.get("name", lay.get("name", ""))
        if cls == "InputLayer":
            shape = cfg.get("batch_input_shape") or cfg.get(
                "batch_shape"
            )
            if shape and len(shape) == 4:
                height, width = shape[1], shape[2]
        elif cls == "DepthwiseConv2D":
            pending_dw = name
        elif cls == "Conv2D":
            k = cfg.get("kernel_size", [3, 3])
            if pending_dw is not None and tuple(k) == (1, 1):
                i = len(block_filters)
                name_map[f"block{i}_depthwise"] = pending_dw
                name_map[f"block{i}_pointwise"] = name
                block_filters.append(int(cfg["filters"]))
                pending_dw = None
            elif not seen_stem:
                if cfg.get("use_bias", True):
                    # biased pre-stem conv = STN localization net
                    name_map[f"stn_conv{stn_convs}"] = name
                    stn_convs += 1
                    use_stn = True
                else:
                    name_map["stem_conv"] = name
                    stem_filters = int(cfg["filters"])
                    seen_stem = True
        elif cls == "BatchNormalization":
            if not seen_stem:
                continue
            if "stem_bn" not in name_map and not block_filters:
                name_map["stem_bn"] = name
            elif not seen_rnn and block_filters:
                name_map[f"block{len(block_filters) - 1}_bn"] = name
            else:
                name_map[f"rnn_bn{rnn_layers - 1}"] = name
        elif cls == "MaxPooling2D":
            if seen_stem and "stem_bn" in name_map:
                if not block_filters:
                    continue  # the stem's own pool
                ps = cfg.get("pool_size", [2, 2])
                if len(block_pools) < len(block_filters):
                    block_pools.append((int(ps[0]), int(ps[1])))
        elif cls == "Bidirectional":
            inner = cfg["layer"]
            rnn_cell = (
                "lstm" if inner["class_name"] == "LSTM" else "gru"
            )
            n_units = int(inner["config"]["units"])
            name_map[f"birnn{rnn_layers}"] = name
            rnn_layers += 1
            seen_rnn = True
        elif cls == "Dense":
            units = int(cfg["units"])
            if units == 6 and not seen_stem:
                name_map["stn_theta"] = name
                use_stn = True
            elif not seen_stem:
                name_map["stn_dense"] = name
                use_stn = True
            elif not seen_rnn:
                name_map["time_dense"] = name
                time_dense = units
            else:
                name_map["logits"] = name
                logits_dim = units
        # Lambda / custom sampler layers carry no weights -> ignored

    while len(block_pools) < len(block_filters):
        block_pools.append((2, 1))
    if logits_dim is None:
        raise ValueError("could not locate the logits Dense layer")
    mc = ModelConfig(
        num_classes=(
            num_classes if num_classes is not None else logits_dim - 1
        ),
        height=height or 32,
        width=width or 128,
        stem_filters=stem_filters or 64,
        block_filters=tuple(block_filters),
        block_pools=tuple(block_pools),
        time_dense_size=time_dense or 128,
        n_units=n_units or 256,
        rnn_layers=rnn_layers,
        rnn_cell=rnn_cell,
        use_stn=use_stn,
        provenance="keras_migrated",
    )
    return mc, name_map


def infer_name_map_from_h5(path: str):
    """Reconstruct (ModelConfig, name_map) from a bare .h5's layer order +
    weight shapes (auto-generated names like conv2d_1 / bidirectional)."""
    layers = _read_h5_layers(path)  # the .h5's layer_names order

    name_map: Dict[str, str] = {}
    stem_filters = None
    block_filters: List[int] = []
    time_dense = None
    n_units = None
    rnn_cell = "gru"
    rnn_layers = 0
    logits_dim = None
    use_stn = False
    stn_convs = 0
    seen_stem = False
    seen_rnn = False
    pending_dw: Optional[str] = None
    dense_after_rnn: List[str] = []
    bn_after: List[str] = []

    for name, ws in layers.items():
        shapes = [w.shape for w in ws]
        if len(ws) == 6 and all(w.ndim == 2 for w in ws[:2]):
            # bidirectional: fwd kernel/recurrent/bias + bwd triple
            H = shapes[1][0]
            gates = shapes[1][1] // H
            rnn_cell = "lstm" if gates == 4 else "gru"
            n_units = H
            name_map[f"birnn{rnn_layers}"] = name
            rnn_layers += 1
            seen_rnn = True
        elif len(ws) == 4 and all(w.ndim == 1 for w in ws):
            # BatchNorm (gamma/beta/mean/var)
            if not seen_stem:
                continue
            if "stem_bn" not in name_map and not block_filters:
                name_map["stem_bn"] = name
            elif not seen_rnn:
                name_map[f"block{len(block_filters) - 1}_bn"] = name
            else:
                name_map[f"rnn_bn{rnn_layers - 1}"] = name
        elif ws[0].ndim == 4:
            kh, kw, cin, cout = shapes[0]
            if cout == 1 and (kh, kw) != (1, 1) and seen_stem:
                pending_dw = name  # depthwise (kh,kw,C,1)
            elif (kh, kw) == (1, 1) and pending_dw is not None:
                name_map[f"block{len(block_filters)}_depthwise"] = (
                    pending_dw
                )
                name_map[f"block{len(block_filters)}_pointwise"] = name
                block_filters.append(cout)
                pending_dw = None
            elif not seen_stem and len(ws) == 1:
                name_map["stem_conv"] = name
                stem_filters = cout
                seen_stem = True
            elif not seen_stem:
                name_map[f"stn_conv{stn_convs}"] = name
                stn_convs += 1
                use_stn = True
        elif ws[0].ndim == 2:
            units = shapes[0][1]
            if not seen_stem:
                if units == 6:
                    name_map["stn_theta"] = name
                else:
                    name_map["stn_dense"] = name
                use_stn = True
            elif not seen_rnn:
                name_map["time_dense"] = name
                time_dense = units
                time_dense_in = shapes[0][0]
            else:
                name_map["logits"] = name
                logits_dim = units

    if logits_dim is None:
        raise ValueError("could not locate the logits Dense layer in h5")
    # Pools are not recoverable from bare weights; the reference's height-32
    # collapse (stem (2,2), then (2,2)(2,1)...(2,1)) is assumed — but the
    # time_dense kernel's input dim (final_h x last_filters) PINS the
    # height-pool product, so validate instead of silently guessing
    # (SURVEY.md C8; a mis-pooled model would import cleanly and decode
    # garbage otherwise).
    #
    # LIMITATION (unverifiable from weights alone): only the HEIGHT pool
    # product is pinned by a weight shape. WIDTH pools after the first
    # block are assumed (2,1); they change only the timestep count, which
    # no kernel shape records — a model with (2,2) width pools in later
    # blocks imports cleanly here and decodes garbage (wrong time axis).
    # If decodes from a bare-.h5 import are systematically wrong, provide
    # the saved architecture JSON (model_config_from_keras_json), which
    # carries the true pool ladder. Documented in MIGRATION.md; behavior
    # pinned by tests/test_predictor.py (mispooled-width fixture).
    assumed_pools = ((2, 2),) + ((2, 1),) * (len(block_filters) - 1)
    height = 32
    if block_filters and time_dense is not None:
        pool_h = 2  # stem pool
        for ph, _ in assumed_pools:
            pool_h *= ph
        final_h = height // pool_h
        expected = final_h * block_filters[-1]
        if final_h < 1 or time_dense_in != expected:
            raise ValueError(
                f"cannot infer pooling from bare .h5 weights: the "
                f"time_dense kernel input dim is {time_dense_in}, but the "
                f"assumed height-{height} pool ladder (stem (2,2) + blocks "
                f"{assumed_pools}) collapses to final_h={max(final_h, 0)} "
                f"x {block_filters[-1]} channels = {expected}. This model "
                f"uses a different pooling/height; provide the saved "
                f"architecture JSON (model_config_from_keras_json) instead."
            )
    import warnings

    warnings.warn(
        "inferring architecture from bare .h5 weights: the HEIGHT pool "
        "ladder was validated against the time_dense input dim, but WIDTH "
        f"pools are ASSUMED to be {assumed_pools} (stem (2,2) + (2,1) "
        "blocks — the reference's layout) and cannot be verified from "
        "weight shapes. A model with different width pools will import "
        "cleanly and decode garbage; if decodes are systematically wrong, "
        "provide the saved architecture JSON instead (MIGRATION.md).",
        stacklevel=2,
    )
    mc = ModelConfig(
        num_classes=logits_dim - 1,
        stem_filters=stem_filters or 64,
        block_filters=tuple(block_filters),
        block_pools=assumed_pools,
        time_dense_size=time_dense or 128,
        n_units=n_units or 256,
        rnn_layers=rnn_layers,
        rnn_cell=rnn_cell,
        use_stn=use_stn,
        provenance="keras_migrated",
    )
    return mc, name_map


def load_reference_model(
    model_dir: str,
    json_name: Optional[str] = None,
    h5_name: Optional[str] = None,
    classes_name: Optional[str] = None,
):
    """One-call reference-artifact migration (SURVEY.md C8 file layout:
    architecture JSON + .h5 weights + pickled class map).

    Returns (ModelConfig, params, batch_stats, codec): the parameter trees
    as the JAX package's, f32 numpy (``weights.params_from_jax`` maps them
    onto the port's CRNN). Files are located by extension when names
    aren't given; the architecture JSON is a ``.json`` other than the
    class map.
    """
    class_maps = {classes_name, "classes.json", "classes.pkl"} - {None}
    names = os.listdir(model_dir)

    def find(ext, given):
        if given:
            return os.path.join(model_dir, given)
        hits = [n for n in names if n.endswith(ext) and n not in class_maps]
        if not hits:
            return None
        return os.path.join(model_dir, sorted(hits)[0])

    h5 = find(".h5", h5_name)
    if h5 is None:
        raise FileNotFoundError(f"no .h5 weights in {model_dir}")
    js = find(".json", json_name)
    codec = None
    for cand in (classes_name, "classes.json", "classes.pkl"):
        if cand and os.path.exists(os.path.join(model_dir, cand)):
            codec = LabelCodec.load(os.path.join(model_dir, cand))
            break
    if js:
        mc, name_map = model_config_from_keras_json(js)
    else:
        mc, name_map = infer_name_map_from_h5(h5)
    if codec is not None and codec.num_classes != mc.num_classes:
        raise ValueError(
            f"class map size {codec.num_classes} != model logits "
            f"{mc.num_classes}"
        )
    params, batch_stats = import_keras_h5(h5, mc, name_map=name_map)
    return mc, params, batch_stats, codec

"""Model-artifact migration CLI, both ways (``crnn_ocr_tpu/cli/migrate.py``).

The reference keeps a model as an architecture JSON, ``.h5`` weights and a
pickled class map; this framework keeps a model directory:
``model_config.json``, ``classes.json`` and checkpoint steps (the port's
``<step>/checkpoint.pt``, or the JAX package's orbax steps, which the
port reads too). Two subcommands bridge them:

``import``
    A reference Keras artifact directory -> a model directory. The
    architecture and the layer names come from the Keras JSON where there
    is one, else from the ``.h5``'s weight shapes
    (``infer/keras_json.py``). It saves a full train state, with fresh
    optimizer slots, as step 0, so the directory serves
    (``cli.predict --model``) and fine-tunes (``cli.train --resume``).
    ``--device`` places the state it builds (the CUDA card unless
    ``cpu`` is asked for).

``export``
    A model directory (the port's or the JAX package's) -> reference-style
    artifacts: a legacy-format ``model.h5`` that ``tf_keras``
    ``load_weights`` reads, written by the port's own HDF5 writer,
    ``classes.pkl`` (the reference's pickle) and ``classes.json``, and,
    where ``tf_keras`` and the repo's ``tools/keras_oracle.py`` import,
    the architecture ``model.json`` for the reference's
    ``model_from_json`` (skipped otherwise, with a note).

Usage:
    python -m crnn_ocr_torch.cli.migrate import --src ref_dir --dest model_dir
    python -m crnn_ocr_torch.cli.migrate export --src model_dir \\
        --dest out_dir [--step N]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
import sys


def _do_import(args) -> int:
    from crnn_ocr_torch.infer.keras_json import load_reference_model
    from crnn_ocr_torch.infer.weights import params_from_jax
    from crnn_ocr_torch.train.checkpoint import CheckpointManager
    from crnn_ocr_torch.train.state import create_train_state, param_count

    cfg, params, batch_stats, codec = load_reference_model(
        args.src, json_name=args.json, h5_name=args.h5,
        classes_name=args.classes,
    )
    if codec is None:
        print(f"no class map (classes.pkl / classes.json) in {args.src}; "
              "pass --classes", file=sys.stderr)
        return 1
    state = create_train_state(cfg, params_from_jax(params, batch_stats),
                               device=args.device)
    mgr = CheckpointManager(args.dest)
    mgr.save(0, state, model_cfg=cfg, codec=codec)
    mgr.wait()
    print(f"imported {param_count(state):,} params -> {args.dest} "
          f"(num_classes={cfg.num_classes}, rnn={cfg.rnn_cell}, "
          f"stn={cfg.use_stn})")
    return 0


def _write_arch_json(cfg, path: str) -> bool:
    """The reference-loadable architecture JSON through the ``tf_keras``
    oracle builder; False (skipped) where ``tf_keras`` or the repo's
    ``tools/`` does not import."""
    if importlib.util.find_spec("tf_keras") is None:
        return False
    try:
        from tools.keras_oracle import build_keras_crnn
    except ImportError:
        return False
    model = build_keras_crnn(
        num_classes=cfg.num_classes,
        height=cfg.height,
        width=cfg.width,
        stem_filters=cfg.stem_filters,
        block_filters=tuple(cfg.block_filters),
        block_pools=tuple(tuple(p) for p in cfg.block_pools),
        time_dense_size=cfg.time_dense_size,
        n_units=cfg.n_units,
        rnn_layers=cfg.rnn_layers,
        rnn_cell=cfg.rnn_cell,
        use_stn=cfg.use_stn,
    )
    with open(path, "w") as f:
        f.write(model.to_json())
    return True


def _do_export(args) -> int:
    from crnn_ocr_torch.infer.weights import export_keras_h5
    from crnn_ocr_torch.train.checkpoint import (
        CheckpointManager,
        load_codec,
        load_model_config,
    )

    cfg = load_model_config(args.src)
    codec = load_codec(args.src)
    state_dict = CheckpointManager(args.src).restore_inference(step=args.step)
    os.makedirs(args.dest, exist_ok=True)
    export_keras_h5(state_dict, cfg, os.path.join(args.dest, "model.h5"))
    with open(os.path.join(args.dest, "classes.pkl"), "wb") as f:
        pickle.dump(dict(codec.classes), f)
    codec.save(os.path.join(args.dest, "classes.json"))
    wrote_json = _write_arch_json(cfg, os.path.join(args.dest, "model.json"))
    note = "" if wrote_json else (
        " (model.json skipped: tf_keras oracle builder not importable)")
    print(f"exported model.h5 + classes.[pkl|json] -> {args.dest}{note}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="crnn_ocr_torch.cli.migrate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("import",
                        help="reference Keras artifacts -> model dir")
    pi.add_argument("--src", required=True,
                    help="dir with .h5 (+ optional arch JSON + class map)")
    pi.add_argument("--dest", required=True, help="output model dir")
    pi.add_argument("--json", help="architecture JSON filename in --src")
    pi.add_argument("--h5", help=".h5 weights filename in --src")
    pi.add_argument("--classes", help="class-map filename in --src")
    pi.add_argument("--device", default="cuda",
                    help="torch device of the state it builds "
                         "(default: cuda)")
    pe = sub.add_parser("export",
                        help="model dir -> reference-style Keras artifacts")
    pe.add_argument("--src", required=True,
                    help="model dir (the port's or the JAX package's)")
    pe.add_argument("--dest", required=True, help="output artifact dir")
    pe.add_argument("--step", type=int,
                    help="checkpoint step (default: latest)")
    args = p.parse_args(argv)
    if args.cmd == "import":
        return _do_import(args)
    return _do_export(args)


if __name__ == "__main__":
    sys.exit(main())

"""Training CLI (reference L3: ``python3 train.py --flags``, SURVEY.md C10;
``crnn_ocr_tpu/cli/train.py``).

The flag set is the JAX CLI's: paths and annotations, the save directory,
steps, batch size, ``--n_units``, ``--time_dense_size``, the optimizer,
``--norm``, ``--stn``, GRU or LSTM, the dataset layout, early stopping,
the mesh size, the dtype and the loss mode. ``--dataset synthetic`` trains
on the built-in glyph task (no corpus needed); ``--dataset fonts`` renders
lines with PIL and matplotlib's fonts (the CPU machine only, as
``data/fontgen.py``). Runs on the CUDA card unless ``--device cpu`` is
given.

Data parallelism: ``--n_devices N`` > 1 spawns N ranks (the ``spawn``
start method, a file store in a temporary directory), one per card
``cuda:r`` over NCCL, or N gloo ranks on the CPU with ``--device cpu``;
each rank trains on its rows of every global batch of ``--batch_size``
(``parallel/mesh.py``). ``--n_devices 0`` means every card; asking for
more cards than the machine has raises ``make_mesh``'s message. Under
``torchrun`` (``RANK``/``WORLD_SIZE`` set) the process joins torchrun's
group instead and spawns nothing. Only rank 0 writes the checkpoints, the
metrics file and the logs.

``--dtype auto`` is bf16 on a CUDA device and f32 on the CPU: JAX's rule is
bf16 on the accelerator, and every training run counted on the H100 runs
bf16 (its kernels' fast path); the CPU has no fast bf16. ``--debug_nans``
(JAX's ``jax_debug_nans``) turns on ``torch.autograd``'s anomaly detection
and makes ``fit`` read every step's loss and raise on the first that is not
finite. ``--resume`` continues from the latest checkpoint in
``--save_path``: the port's own, or the JAX package's orbax step (its
parameters, BatchNorm statistics, optimizer slots and step,
``train/orbax.py``); the port's checkpoints then land beside orbax's
steps, which it never changes.

Examples:
  python -m crnn_ocr_torch.cli.train --dataset synthetic --steps 500 \\
      --save_path /tmp/model
  python -m crnn_ocr_torch.cli.train --path /data/iam \\
      --annotation annotation.txt --steps 20000 --save_path /models/iam \\
      --n_devices 4
  torchrun --nproc_per_node 4 -m crnn_ocr_torch.cli.train --path /data/iam \\
      --save_path /models/iam
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    # data
    p.add_argument("--dataset", default="files",
                   choices=["files", "synthetic", "fonts"])
    p.add_argument("--path", help="image directory (files dataset)")
    p.add_argument("--annotation", default="annotation.txt")
    p.add_argument(
        "--layout", default="annotation", choices=["annotation", "filename"]
    )
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--limit", type=int, default=0,
                   help="files dataset: cap the sample list (0 = all); "
                        "quick smoke runs over a large corpus")
    p.add_argument("--batch_size", type=int, default=64,
                   help="the global batch (split over --n_devices ranks)")
    p.add_argument("--max_label_len", type=int, default=32)
    p.add_argument(
        "--buckets", type=int, nargs="+", default=[64, 128, 192, 256]
    )
    p.add_argument("--no-norm", dest="norm", action="store_false",
                   help="disable per-image normalization")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--font_noise", type=float, default=0.02,
                   help="--dataset fonts: render-time noise std "
                        "(fraction of 255)")
    p.add_argument("--font_min_words", type=int, default=1,
                   help="--dataset fonts: words per line, lower bound")
    p.add_argument("--font_max_words", type=int, default=2,
                   help="--dataset fonts: words per line, upper bound")
    p.add_argument("--pack_cache", action="store_true",
                   help="files dataset: decode each image once into mmap "
                        "shards under <path>/.crnn_pack/, then feed every "
                        "epoch decode-free (data/packed.py)")
    p.add_argument("--device_cache", action="store_true",
                   help="files dataset: upload the packed corpus to the "
                        "device once and feed train steps (K, B) row-index "
                        "arrays instead of pixels (data/device_cache.py; "
                        "implies --pack_cache; combine with "
                        "--steps_per_call). The batch stream is the host "
                        "path's")
    p.add_argument("--device_cache_max_gb", type=float, default=8.0,
                   help="device-memory budget for --device_cache; corpora "
                        "over it run partially resident (the overflow "
                        "rows stream with each call)")
    # model
    p.add_argument("--n_units", type=int, default=256)
    p.add_argument("--time_dense_size", type=int, default=128)
    p.add_argument("--rnn", default="gru", choices=["gru", "lstm"])
    p.add_argument("--rnn_layers", type=int, default=2)
    p.add_argument("--stn", action="store_true")
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument(
        "--dtype", default="auto",
        choices=["auto", "float32", "bfloat16"],
        help="compute dtype (parameters stay f32). auto = bfloat16 on a "
             "CUDA device (the kernels' fast path; every training run "
             "counted on the H100 is bf16), float32 on the CPU",
    )
    # optimization
    p.add_argument("--opt", default="adam",
                   choices=["adam", "sgd", "rmsprop", "adadelta", "adamw"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "cyclic"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--steps", type=int, default=5000,
                   help="TOTAL step budget; --resume continues toward it "
                        "replaying the exact remaining batch stream")
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--early_stop_patience", type=int, default=0)
    p.add_argument("--exact_keras_loss", action="store_true")
    p.add_argument(
        "--steps_per_call", type=int, default=1,
        help="K optimizer steps per call over K same-bucket batches; the "
             "math is K single steps'; with several buckets the batch "
             "order is regrouped by bucket (the same batches)")
    # infra
    p.add_argument("--save_path", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_devices", "--G", dest="n_devices", type=int,
                   default=0,
                   help="data-parallel ranks (0 = every card; with --device "
                        "cpu, 0 = 1); --G is the reference's multi-GPU flag "
                        "name")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --save_path "
                        "(full state: parameters, optimizer, BatchNorm "
                        "statistics, step)")
    p.add_argument("--debug_nans", action="store_true",
                   help="anomaly detection in the backward pass, and stop "
                        "at the first step whose loss is not finite")
    p.add_argument("--profile_dir",
                   help="write a torch.profiler trace of ~20 early steps")
    p.add_argument("--tensorboard_dir",
                   help="stream scalars to TensorBoard (needs tensorboardX)")
    p.add_argument("--on_device_cer", action="store_true",
                   help="eval CER via the batched Levenshtein DP on the "
                        "device (ops/editdistance.py) instead of host text "
                        "edit distance: the same value")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from crnn_ocr_torch.parallel import mesh as mesh_lib

    on_cuda = torch.device(args.device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("CUDA is not available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if _under_torchrun():
        # a CUDA device without an index is the rank's cuda:<LOCAL_RANK>
        mesh = mesh_lib.init_process_mesh(device=torch.device(args.device))
        try:
            return _train(args, mesh)
        finally:
            mesh_lib.close_process_mesh(mesh)
    if on_cuda:
        try:
            world = mesh_lib.make_mesh(args.n_devices).size
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2
    else:
        world = max(args.n_devices, 1)
    if world == 1:
        return _train(args, None)
    store = tempfile.mkdtemp(prefix="crnn_train_ranks_")
    try:
        mesh_lib.spawn_ranks(
            _rank_main, world,
            args=(args, world, f"file://{os.path.join(store, 'store')}"))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return 0


def _rank_main(rank: int, args, world: int, init_method: str) -> None:
    """One spawned rank: join the group (NCCL on ``cuda:<rank>``, gloo on
    the CPU), train, leave; a non-zero return fails the rank."""
    import torch

    from crnn_ocr_torch.parallel import mesh as mesh_lib

    cpu = torch.device(args.device).type == "cpu"
    mesh = mesh_lib.init_process_mesh(
        rank, world, init_method, device="cpu" if cpu else f"cuda:{rank}")
    try:
        rc = _train(args, mesh)
    finally:
        mesh_lib.close_process_mesh(mesh)
    if rc:
        raise SystemExit(rc)


def _reader(make, mesh, warm: bool):
    """``make()``'s Reader. On a process mesh rank 0 builds it first and
    plans (and, with ``warm``, packs) every sample, then the other ranks
    build theirs from its sidecar and shards, so no two ranks write the
    same file."""
    dp = mesh is not None and mesh.process and mesh.world > 1
    if dp and not mesh.writer:
        mesh.barrier()
        return make()
    reader = make()
    if dp:
        for i in range(len(reader.samples)):
            reader._size_bucket(i)
        if warm:
            for path, _ in reader.samples:
                reader._load_image(path)
            reader._pack.flush_index()
        reader._flush_sizes()
        mesh.barrier()
    return reader


def _train(args, mesh) -> int:
    import torch

    from crnn_ocr_torch.config import ModelConfig
    from crnn_ocr_torch.data import (
        Reader,
        ReaderConfig,
        SyntheticConfig,
        SyntheticTextlines,
        device_batches,
        synthetic_batches,
    )
    from crnn_ocr_torch.infer.predictor import resolve_device
    from crnn_ocr_torch.train import FitConfig, create_train_state, fit
    from crnn_ocr_torch.train.state import param_count

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    writer = mesh is None or mesh.writer

    def say(msg: str) -> None:
        if writer:
            print(msg, file=sys.stderr)

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.dtype == "auto":
        args.dtype = "bfloat16" if dev.type == "cuda" else "float32"
        say(f"[crnn_ocr_torch] dtype: auto -> {args.dtype}")
    if args.stn:
        # the STN's localization Dense flattens a width-dependent map: an
        # STN model is bound to one width (reference C5)
        args.buckets = [max(args.buckets)]
    if args.device_cache and args.dataset != "files":
        print("--device_cache requires --dataset files", file=sys.stderr)
        return 2
    if args.device_cache:
        args.pack_cache = True  # the packed shards are the device tables

    if args.dataset in ("synthetic", "fonts"):
        if args.dataset == "fonts":
            from crnn_ocr_torch.data import FontConfig, FontTextlines

            synth = FontTextlines(FontConfig(
                noise=args.font_noise,
                min_words=args.font_min_words,
                max_words=args.font_max_words,
            ))
            bucket = max(args.buckets)
        else:
            synth = SyntheticTextlines(SyntheticConfig(augment=args.augment))
            bucket = min(128, max(args.buckets))
        codec = synth.codec

        def raw_train(skip=0):
            return synthetic_batches(
                batch_size=args.batch_size, synth=synth, seed=args.seed,
                bucket=bucket, max_label_len=args.max_label_len, skip=skip)

        def raw_eval():
            return synthetic_batches(
                batch_size=args.batch_size, synth=synth, seed=999,
                bucket=bucket, max_label_len=args.max_label_len)
    else:
        if not args.path:
            print("--path required for files dataset", file=sys.stderr)
            return 2
        reader = _reader(lambda: Reader(ReaderConfig(
            path=args.path,
            annotation=args.annotation,
            layout=args.layout,
            batch_size=args.batch_size,
            val_fraction=args.val_fraction,
            max_label_len=args.max_label_len,
            buckets=tuple(args.buckets),
            shuffle_seed=args.seed,
            pack_cache=args.pack_cache,
            limit=args.limit or None,
        )), mesh, warm=args.pack_cache)
        codec = reader.codec

        def raw_train(skip=0):
            return reader.run_generator(train=True, skip=skip)

        def raw_eval():
            return reader.run_generator(train=False, epochs=1)

    cfg = ModelConfig(
        num_classes=codec.num_classes,
        # the widest batch the model will see: conv and RNN weights do not
        # depend on it, the STN's localization Dense does (C5)
        width=(bucket if args.dataset in ("synthetic", "fonts")
               else max(args.buckets)),
        n_units=args.n_units,
        time_dense_size=args.time_dense_size,
        rnn_cell=args.rnn,
        rnn_layers=args.rnn_layers,
        use_stn=args.stn,
        dropout_rate=args.dropout,
        dtype=args.dtype,
    )
    if args.resume:
        cfg_path = os.path.join(args.save_path, "model_config.json")
        if os.path.exists(cfg_path):
            # the checkpoint pins the architecture; the CLI's architecture
            # flags only name a fresh run's
            from crnn_ocr_torch.train.checkpoint import load_model_config

            saved = load_model_config(args.save_path)
            if saved.num_classes != codec.num_classes:
                print(f"resume: checkpoint has {saved.num_classes} classes "
                      f"but the dataset codec has {codec.num_classes}",
                      file=sys.stderr)
                return 2
            adopted = dataclasses.replace(saved, dtype=args.dtype)
            if adopted != cfg:
                say("resume: using architecture from the checkpoint's "
                    "model_config.json (CLI architecture flags ignored)")
            cfg = adopted
    if mesh is not None:
        say(f"data-parallel mesh: {mesh}")

    device_corpus = None
    if args.device_cache:
        from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus

        device_corpus = DeviceResidentCorpus(
            reader, max_bytes=int(args.device_cache_max_gb * (1 << 30)),
            device=dev, mesh=mesh)
        mode = (f"partial residency {device_corpus.resident_fraction:.0%}"
                if device_corpus.partial else "fully resident")
        say(f"[crnn_ocr_torch] device cache: "
            f"{device_corpus.total_bytes / 1e6:.1f} MB, {mode} on {dev} "
            f"({len(reader.samples)} images)")

    def train_iter(skip=0):
        if device_corpus is not None:
            return device_corpus.stacked_index_batches(
                max(1, args.steps_per_call), skip=skip)
        if args.steps_per_call > 1:
            from crnn_ocr_torch.data.pipeline import stack_host_batches

            return stack_host_batches(raw_train(skip), args.steps_per_call,
                                      index_offset=skip)
        return device_batches(raw_train(skip), dev, cfg,
                              normalize=args.norm, augment=args.augment,
                              augment_seed=args.seed, augment_offset=skip)

    def eval_iter():
        return device_batches(raw_eval(), dev, cfg, normalize=args.norm)

    state = create_train_state(
        cfg, seed=args.seed, device=dev, optimizer=args.opt,
        learning_rate=args.lr, schedule=args.lr_schedule,
        total_steps=args.steps, warmup_steps=args.warmup_steps, mesh=mesh)
    if args.resume:
        from crnn_ocr_torch.train import CheckpointManager
        from crnn_ocr_torch.train.orbax import OrbaxCorruptError

        mgr = CheckpointManager(args.save_path)
        step0 = mgr.latest_step()
        if step0 is not None:
            try:
                mgr.restore(state)
            except OrbaxCorruptError as e:
                print(f"resume failed: {e}", file=sys.stderr)
                return 2
            except (ValueError, RuntimeError, KeyError) as e:
                print("resume failed: the checkpoint was written with a "
                      "different optimizer or model configuration; pass "
                      f"the same --opt and architecture flags ({e})",
                      file=sys.stderr)
                return 2
            say(f"resumed from step {step0}")
        else:
            say("no checkpoint found; starting fresh")
    say(f"device: {dev}  ranks: {mesh.size if mesh is not None else 1}  "
        f"params: {param_count(state) / 1e6:.2f}M")
    fit(
        state, cfg, train_iter(skip=int(state.step)),
        eval_iter_fn=eval_iter, codec=codec,
        cfg=FitConfig(
            steps=args.steps,
            eval_every=args.eval_every,
            log_every=args.log_every,
            checkpoint_dir=args.save_path,
            early_stop_patience=args.early_stop_patience,
            metrics_path=os.path.join(args.save_path, "metrics.jsonl"),
            seed=args.seed,
            exact_keras_loss=args.exact_keras_loss,
            mesh=mesh,
            tensorboard_dir=args.tensorboard_dir,
            profile_dir=args.profile_dir,
            on_device_cer=args.on_device_cer,
            steps_per_call=args.steps_per_call,
            normalize=args.norm,
            augment=args.augment,
            augment_seed=args.seed,
            device_corpus=device_corpus,
            debug_nans=args.debug_nans,
        ),
    )
    say(f"saved to {args.save_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

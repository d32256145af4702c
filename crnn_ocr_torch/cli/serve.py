"""Serving CLI: run a resident OCR daemon on the CUDA card
(``crnn_ocr_tpu/cli/serve.py``).

The reference stops at a batch predict script (SURVEY.md C11,
``predict.py``); this is the production counterpart — load once, run
every (batch-ladder, bucket) batch shape up front, then serve concurrent
HTTP requests through the dynamic micro-batcher (L4 serving analog).
``--device cpu`` serves on the CPU. ``--port 0`` binds a free port; the
``serving on`` line names it.

Examples:
  python -m crnn_ocr_torch.cli.serve --model ./reference_model --port 8000
  python -m crnn_ocr_torch.cli.serve --model ./checkpoints --port 8000
  python -m crnn_ocr_torch.cli.serve --pretrained fonts-small \
      --max_batch 64 --max_wait_ms 3 --beam_width 10

  curl -s -X POST --data-binary @word.png localhost:8000/predict
  curl -s localhost:8000/stats     # JSON counters + latency percentiles
  curl -s localhost:8000/metrics   # Prometheus text format
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", help="a checkpoint directory of the port "
                   "(model_config.json, classes.json, <step>/checkpoint.pt: "
                   "fit's checkpoint_dir) or a directory of reference "
                   "artifacts (Keras .h5 + class map)")
    p.add_argument("--pretrained", help="bundled pretrained model name")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=32,
                   help="largest coalesced device batch")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batching window after the first queued request")
    p.add_argument("--beam_width", type=int, default=0,
                   help="0 = greedy decode; >0 = on-device TF-exact beam. "
                        "The decode mode is fixed per daemon (not per "
                        "request) so every queued request can coalesce "
                        "into one device batch")
    p.add_argument("--top_paths", type=int, default=1)
    p.add_argument("--beam_no_merge", action="store_true",
                   help="force standard CTC beam output (TF2 semantics): "
                        "keep repeated labels across blanks")
    p.add_argument("--beam_merge", action="store_true",
                   help="force K.ctc_decode parity (TF-V1 merge, collapses "
                        "double letters). With neither flag the default is "
                        "provenance-keyed: parity for migrated Keras "
                        "artifacts, standard CTC for own-trained models")
    p.add_argument("--alignments", action="store_true",
                   help="include per-character pixel spans + confidences "
                        "in each /predict response; beam mode force-aligns "
                        "the decoded top path so spans match the returned "
                        "text (beyond-reference; Predictor alignments)")
    p.add_argument("--no-norm", dest="norm", action="store_false")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip running every batch shape ahead of requests")
    p.add_argument("--request_timeout_s", type=float, default=30.0)
    p.add_argument("--n_devices", type=int, default=1,
                   help="data-parallel serving over several cards (only 1 "
                        "is ported; more: ROADMAP item 13)")
    p.add_argument("--verbose", action="store_true",
                   help="log each HTTP request")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crnn_ocr_torch.infer import predictor_from_cli
    from crnn_ocr_torch.serve import OCRServer

    try:
        predictor = predictor_from_cli(
            args.model, args.pretrained, normalize=args.norm,
            n_devices=args.n_devices, device=args.device,
        )
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    merge = (
        False if args.beam_no_merge
        else True if args.beam_merge
        else predictor.default_merge_repeated  # provenance-keyed
    )
    decode_kw = (
        {"greedy": False, "beam_width": args.beam_width,
         "top_paths": args.top_paths,
         "merge_repeated": merge,
         "alignments": args.alignments}
        if args.beam_width > 0
        else {"greedy": True, "alignments": args.alignments}
    )
    server = OCRServer(
        predictor,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        decode_kw=decode_kw,
        request_timeout_s=args.request_timeout_s,
        quiet=not args.verbose,
    )
    if args.warmup:
        print(
            f"warmup: running {len(server.batcher.ladder)} batch sizes x "
            f"{len(predictor.buckets)} buckets ...",
            flush=True,
        )
        server.batcher.warmup()
    mode = (
        "greedy" + ("+align" if args.alignments else "")
    ) if decode_kw.get("greedy") else (
        f"beam{args.beam_width}"
        + ("-merge" if merge else "-nomerge")
        + ("+align" if args.alignments else "")
    )
    print(
        f"serving on {args.host}:{server.port} "
        f"(decode={mode}, max_batch={args.max_batch}, "
        f"window={args.max_wait_ms}ms)",
        flush=True,
    )
    import signal
    import threading

    def _graceful(signum, frame):
        # shutdown() must not run on the serve_forever thread (deadlock);
        # pending requests drain through the batcher before exit.
        threading.Thread(target=server.httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    print("shutting down", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

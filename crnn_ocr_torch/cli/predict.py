"""Inference CLI (reference L4: ``python3 predict.py --flags``, SURVEY.md C11;
``crnn_ocr_tpu/cli/predict.py``).

Loads a bundled model, a checkpoint directory of the port (``fit``'s
``checkpoint_dir``), or a directory of reference artifacts (Keras ``.h5``,
architecture JSON, class map), iterates images (a directory or an
annotated validation file), preprocesses exactly as training, predicts,
decodes (greedy or beam with confidences), writes predictions, and
optionally reports edit-distance validation + per-image timing — the
reference's whole predict.py surface. Runs on the CUDA card unless
``--device cpu`` is given. Reads image files with cv2.

Examples:
  python -m crnn_ocr_torch.cli.predict --pretrained fonts-hard \
      --image_dir ./imgs --beam_width 10 --top_paths 3 --result out.tsv
  python -m crnn_ocr_torch.cli.predict --model ./reference_model \
      --image_dir ./val --annotation annotation.txt --validate
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", help="a checkpoint directory of the port "
                   "(model_config.json, classes.json, <step>/checkpoint.pt: "
                   "fit's checkpoint_dir) or a directory of reference "
                   "artifacts (Keras .h5 + class map)")
    p.add_argument("--pretrained", help="bundled pretrained model name "
                   "(e.g. fonts-small)")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--annotation", help="annotation file for --validate")
    p.add_argument("--result", help="output TSV path (default: stdout)")
    p.add_argument("--greedy", action="store_true", default=False)
    p.add_argument("--beam_width", type=int, default=10)
    p.add_argument("--top_paths", type=int, default=1)
    p.add_argument("--exact_tf_beam", action="store_true",
                   help="bit-exact TF beam semantics (host decoder)")
    p.add_argument("--beam_no_merge", action="store_true",
                   help="force standard CTC beam output (TF2 semantics): "
                        "do NOT merge repeated labels across blanks")
    p.add_argument("--beam_merge", action="store_true",
                   help="force K.ctc_decode parity (TF-V1 "
                        "merge_repeated=True — collapses double letters "
                        "'door'->'dor'). With neither flag the default is "
                        "keyed on model provenance: parity for migrated "
                        "Keras artifacts, standard CTC for own-trained "
                        "checkpoints (the V1 merge corrupts accuracy on "
                        "those — see BASELINE.md)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--no-norm", dest="norm", action="store_false")
    p.add_argument("--n_devices", type=int, default=1,
                   help="data-parallel serving over several cards (only 1 "
                        "is ported; more: ROADMAP item 13)")
    p.add_argument("--validate", action="store_true",
                   help="compute CER/WER vs annotation")
    p.add_argument("--alignments", action="store_true",
                   help="append per-character spans to each row as "
                        "char@x0:x1(conf) — original-image pixel columns. "
                        "Greedy mode localizes the argmax runs; beam mode "
                        "force-aligns the decoded top path (constrained "
                        "Viterbi), so spans always join to the printed "
                        "text (beyond-reference)")
    p.add_argument("--time", dest="timing", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import cv2

    from crnn_ocr_torch.infer import predictor_from_cli
    from crnn_ocr_torch.utils import metrics as metrics_lib

    try:
        predictor = predictor_from_cli(
            args.model, args.pretrained, normalize=args.norm,
            n_devices=args.n_devices, device=args.device,
        )
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    # collect images (+ optional references)
    refs = {}
    if args.annotation:
        ann = os.path.join(args.image_dir, args.annotation)
        for line in open(ann):
            line = line.rstrip("\n")
            if not line:
                continue
            for sep in ("\t", " "):
                if sep in line:
                    rel, text = line.split(sep, 1)
                    refs[rel] = text.strip()
                    break
        files = sorted(refs)
    else:
        files = sorted(
            f
            for f in os.listdir(args.image_dir)
            if f.lower().endswith(
                (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".tif")
            )
        )
    if not files:
        print("no images found", file=sys.stderr)
        return 2

    out = open(args.result, "w") if args.result else sys.stdout
    preds_all, refs_all = [], []
    # decode all images up front, then run bucket-grouped batches (minimal
    # padding waste — the reference's width bucketing applied at serving
    # time)
    images, names = [], []
    for f in files:
        img = cv2.imread(
            os.path.join(args.image_dir, f), cv2.IMREAD_GRAYSCALE
        )
        if img is None:
            print(f"skipping unreadable {f}", file=sys.stderr)
            continue
        images.append(img)
        names.append(f)
    t0 = time.perf_counter()
    preds = predictor.predict_many(
        images,
        batch_size=args.batch_size,
        greedy=args.greedy,
        beam_width=args.beam_width,
        top_paths=args.top_paths,
        merge_repeated=(
            False if args.beam_no_merge
            else True if args.beam_merge
            else None  # provenance-keyed default (Predictor)
        ),
        exact_tf=args.exact_tf_beam,
        timing=args.timing,
        # spans ride along on the same forward pass in both modes (beam
        # force-aligns its own top path — see Predictor.predict)
        alignments=args.alignments,
    )
    spans_all = [p.spans for p in preds] if args.alignments else None
    n = 0
    for i, (f, pr) in enumerate(zip(names, preds)):
        row = [f, pr.text, f"{pr.score:.4f}"]
        if pr.candidates:
            for text, s in pr.candidates[1:]:
                row += [text, f"{s:.4f}"]
        if args.timing and pr.latency_ms is not None:
            row.append(f"{pr.latency_ms:.2f}ms")
        if spans_all is not None:
            row.append(" ".join(
                f"{s.char}@{s.x0}:{s.x1}({s.conf:.2f})"
                for s in spans_all[i]
            ))
        out.write("\t".join(row) + "\n")
        if f in refs:
            preds_all.append(pr.text)
            refs_all.append(refs[f])
        n += 1
    dt = time.perf_counter() - t0
    print(f"{n} images in {dt:.2f}s ({n/dt:.1f} lines/sec)", file=sys.stderr)
    if args.validate and refs_all:
        print(
            f"CER {metrics_lib.cer(preds_all, refs_all):.4f}  "
            f"WER {metrics_lib.wer(preds_all, refs_all):.4f}  "
            f"seq_acc {metrics_lib.sequence_accuracy(preds_all, refs_all):.4f}",
            file=sys.stderr,
        )
    if args.result:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

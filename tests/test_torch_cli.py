"""Port parity: the predict and serve CLIs (``crnn_ocr_torch/cli/``)
against the JAX package's, on the CPU.

* ``cli.predict.main`` of both packages on one directory of PNG lines with
  ``--model tests/goldens/migration_autonamed`` (a reference artifact
  directory): greedy, beam with ``--top_paths 2``, and ``--alignments``.
  The TSV rows are equal, texts and spans exactly, scores (printed to 4
  decimals) within rtol 1e-4 / atol 1e-4 and span confidences (2 decimals)
  within 0.01; ``--validate`` prints the same CER, WER and sequence
  accuracy.
* The serve CLI's parser defaults equal JAX's, apart from ``--device``.
* ``python -m crnn_ocr_torch.cli.serve`` as a subprocess on the CPU: it
  answers a request and exits 0 on SIGTERM. Every wait has a timeout.
"""

import io
import json
import os
import pathlib
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from crnn_ocr_torch.cli import predict as tpredict
from crnn_ocr_torch.cli import serve as tserve
from crnn_ocr_tpu.cli import predict as jpredict
from crnn_ocr_tpu.cli import serve as jserve
from crnn_ocr_tpu.data import SyntheticConfig, SyntheticTextlines

cv2 = pytest.importorskip("cv2")

REPO = pathlib.Path(__file__).resolve().parent.parent
MODEL = str(REPO / "tests" / "goldens" / "migration_autonamed")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lines")
    synth = SyntheticTextlines(
        SyntheticConfig(alphabet="0123456789ab", min_len=2, max_len=5))
    rng = np.random.default_rng(0)
    rows = []
    for i in range(10):
        imgs, texts = synth.sample_batch(1, rng)
        cv2.imwrite(str(d / f"l{i}.png"), imgs[0])
        rows.append(f"l{i}.png\t{texts[0]}")
    (d / "annotation.txt").write_text("\n".join(rows))
    return str(d)


def _run(main, argv, out, capsys, device=None):
    extra = ["--device", device] if device else []
    assert main([*argv, "--result", str(out), *extra]) == 0
    err = capsys.readouterr().err
    rows = [r.split("\t") for r in out.read_text().splitlines()]
    return rows, [ln for ln in err.splitlines() if ln.startswith("CER")]


def _assert_rows_equal(got, want, alignments):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        n = len(g) - 1 if alignments else len(g)
        # file, then (text, score) pairs: the top path and the candidates
        assert g[0] == w[0]
        assert g[1:n:2] == w[1:n:2]
        np.testing.assert_allclose(np.array(g[2:n:2], float),
                                   np.array(w[2:n:2], float),
                                   rtol=1e-4, atol=1e-4)
        if alignments:
            spans = [s.rsplit("(", 1) for s in (g[-1].split(" ")
                                                if g[-1] else [])]
            wspans = [s.rsplit("(", 1) for s in (w[-1].split(" ")
                                                 if w[-1] else [])]
            assert [s[0] for s in spans] == [s[0] for s in wspans]
            np.testing.assert_allclose(
                [float(s[1][:-1]) for s in spans],
                [float(s[1][:-1]) for s in wspans], atol=0.0100001)


@pytest.mark.parametrize("flags", [
    ["--greedy"],
    ["--beam_width", "4", "--top_paths", "2"],
    ["--greedy", "--alignments"],
    ["--beam_width", "4", "--alignments"],
], ids=["greedy", "beam-top2", "greedy-align", "beam-align"])
def test_predict_cli_matches_jax(image_dir, tmp_path, capsys, flags):
    argv = ["--model", MODEL, "--image_dir", image_dir,
            "--annotation", "annotation.txt", "--validate", *flags]
    want, want_cer = _run(jpredict.main, argv, tmp_path / "jax.tsv", capsys)
    got, got_cer = _run(tpredict.main, argv, tmp_path / "port.tsv", capsys,
                        device="cpu")
    _assert_rows_equal(got, want, "--alignments" in flags)
    assert got_cer == want_cer and len(got_cer) == 1
    if "--top_paths" in flags:
        assert all(len(r) == 5 for r in got)  # file, top1, s1, top2, s2
    if "--alignments" in flags:
        for r in got:
            assert "".join(s.split("@")[0] for s in r[-1].split(" ")
                           if s) == r[1]


def test_predict_cli_needs_a_model(image_dir, capsys):
    assert tpredict.main(["--image_dir", image_dir, "--device", "cpu"]) == 2
    assert "one of --model / --pretrained" in capsys.readouterr().err


def test_cli_parser_defaults_match_jax():
    for port, ref, argv in (
            (tserve, jserve, []),
            (tpredict, jpredict, ["--image_dir", "x"])):
        got = vars(port.build_parser().parse_args(argv))
        want = vars(ref.build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
    args = tserve.build_parser().parse_args(["--model", "/tmp/x",
                                             "--port", "0"])
    assert args.max_batch == 32 and args.beam_width == 0
    assert args.warmup and args.norm


def _npy(img) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def test_serve_cli_subprocess_answers_and_drains():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "crnn_ocr_torch.cli.serve", "--model", MODEL,
         "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
         "--no-warmup"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        port = None
        while port is None:
            ln = lines.get(timeout=120)
            if ln.startswith("serving on "):
                assert "(decode=greedy, max_batch=32" in ln
                port = int(ln.split()[2].split(":")[1])
        img = np.full((32, 60), 255, np.uint8)
        img[8:24, 10:50] = 0
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=_npy(img), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert isinstance(body["text"], str) and "score" in body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        reader.join(timeout=30)
        rest = []
        while not lines.empty():
            rest.append(lines.get_nowait())
        assert "shutting down\n" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()

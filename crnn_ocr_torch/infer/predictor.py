"""Recognition API (``crnn_ocr_tpu/infer/predictor.py``).

uint8 images -> ``pack_canvas`` -> ``preprocess_batch`` on the device ->
``CRNN`` -> softmax after the first ``ctc_time_slice`` frames -> decode ->
text. Decode modes, all on the predictor's device unless noted:

* greedy (the default): ``ops.ctc.ctc_greedy_decode``; the score is
  ``neg_sum_logits``.
* beam: the TF-exact beam (``ops/ctc_beam_device.py``), with
  ``top_paths`` candidates; or ``exact_tf=True``, the host C++ decoder of
  the same semantics (``native/ctc_beam_tf.cc``).
* ``alignments=True``: per-character pixel spans (``CharSpan``) of the
  returned text: the greedy path's argmax runs, or the beam's top path
  force-aligned (``ops.ctc.ctc_forced_alignment``).

The serving surface (``bucket_for``, ``blank_row``, ``warmup``,
``predict_many``) is what the batcher (``serve/batcher.py``) and the CLIs
call; ``init_predictor`` loads a checkpoint or reference artifacts and
``predictor_from_cli`` resolves the CLIs' ``--model``/``--pretrained``.

Data-parallel serving (``mesh=``, a local mesh of ``parallel/mesh.py``;
JAX ``predictor.py:66-87, 140-175``): one process, one model replica a
distinct device. A request batch is padded with ``blank_row()`` to a
multiple of the mesh before ``pack_canvas`` (a line's output depends on
its batch's canvas, so the global canvas is packed and preprocessed as on
one device), then its rows are split into the mesh's shards, each shard
runs on its device's replica (a device named twice runs its shards one
after another), and the outputs are concatenated on the first device with
the pad rows dropped.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.models.crnn import CRNN
from crnn_ocr_torch.ops import ctc
from crnn_ocr_torch.ops.ctc_beam_exact import ctc_beam_search_decode_exact
from crnn_ocr_torch.ops.preprocess import pack_canvas, preprocess_batch
from crnn_ocr_torch.utils.profiling import span


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent; never falls back.
    A CUDA device without an index gets the current one's, so that work
    run later on another thread (the serving batcher's worker) lands on
    the same card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class Prediction:
    text: str
    score: float
    candidates: Optional[List[Tuple[str, float]]] = None
    latency_ms: Optional[float] = None
    spans: Optional[list] = None  # List[CharSpan] when alignments=True


@dataclasses.dataclass
class CharSpan:
    """One decoded character in the ORIGINAL image: the horizontal extent of
    its frames, mapped back through the resize and the conv downsample,
    and the peak softmax probability inside them."""

    char: str
    x0: int  # inclusive, original-image pixel column
    x1: int  # exclusive
    conf: float


class Predictor:
    def __init__(
        self,
        model_cfg: ModelConfig,
        state_dict: Dict[str, torch.Tensor],
        codec: LabelCodec,
        normalize: bool = True,
        buckets: Sequence[int] = (64, 128, 192, 256),
        device="cuda",
        mesh=None,
    ):
        """``mesh``: a local mesh (``parallel.make_mesh``) to serve on, its
        first device the predictor's ``device`` (``device`` is then
        ignored)."""
        self.cfg = model_cfg
        self.codec = codec
        self.normalize = normalize
        if mesh is not None and mesh.process:
            raise ValueError("serving runs on a local mesh "
                             "(parallel.make_mesh), not a process mesh")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = (resolve_device(mesh.device) if mesh is not None
                       else resolve_device(device))
        # an STN model's localization Dense is bound to the width it was
        # trained at: it serves at that width only (JAX predictor.py:76-81)
        self.buckets = ((model_cfg.width,) if model_cfg.use_stn
                        else tuple(buckets))
        self.model = CRNN(model_cfg)
        self.model.load_state_dict(state_dict)
        self.model.eval().requires_grad_(False).to(self.device)
        # one replica a distinct device of the mesh
        self.replicas = {self.device: self.model}
        for d in (self.mesh.devices if self.mesh is not None else ()):
            if d not in self.replicas:
                self.replicas[d] = copy.deepcopy(self.model).to(d)

    def bucket_for(self, image: np.ndarray) -> int:
        """The width bucket one image routes to: the one rule for
        :meth:`predict_many` and the serving batcher."""
        shape = np.asarray(image).shape
        if shape[0] <= 0 or shape[1] <= 0:
            raise ValueError(f"empty image: shape {shape}")
        return self.resolve_bucket([image])

    def resolve_bucket(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ) -> int:
        """The smallest bucket that fits the widest height-normalized image,
        else the last bucket (wider images squeeze into it)."""
        if bucket is not None:
            return bucket
        w_need = max(
            int(round(im.shape[1] * self.cfg.height / im.shape[0]))
            for im in (np.asarray(im) for im in images)
        )
        return next((b for b in self.buckets if w_need <= b), self.buckets[-1])

    def blank_row(self) -> np.ndarray:
        """The white image that pads a batch up the batcher's ladder."""
        return np.full((self.cfg.height, 16), 255, np.uint8)

    def warmup(self, batch_size: int = 32, buckets=None) -> None:
        """One forward pass per bucket at ``batch_size`` white lines: on the
        card this builds or loads the kernels and warms cuDNN and the
        allocator before the first request."""
        for b in buckets or self.buckets:
            dummy = [np.full((self.cfg.height, b), 255, np.uint8)] * batch_size
            self.predict_probs(dummy, bucket=b)

    def preprocess(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ):
        """Grayscale uint8 images -> (x (B, height, bucket), w_new (B,)) on
        the predictor's device: packed on the host, resized and
        standardized on the device."""
        with span("crnn.predict.pack"):
            arrays = pack_canvas(list(images), quantize=True)
        bucket = self.resolve_bucket(images, bucket)
        with span("crnn.predict.upload"):
            canvas, hs, ws = (torch.from_numpy(a).to(self.device)
                              for a in arrays)
        with span("crnn.predict.resize"):
            return preprocess_batch(canvas, hs, ws, out_h=self.cfg.height,
                                    out_w=bucket, normalize=self.normalize)

    def probs(self, logits: torch.Tensor, w_new: torch.Tensor):
        """Logits -> (probs (B, T, C), input_len (B,)): softmax after the
        first ``ctc_time_slice`` frames, and the frames each line covers."""
        probs = torch.softmax(logits[:, self.cfg.ctc_time_slice:, :], dim=-1)
        T = probs.shape[1]
        input_len = torch.clamp(
            w_new // self.cfg.width_downsample - self.cfg.ctc_time_slice,
            1, T,
        )
        return probs, input_len

    @property
    def default_merge_repeated(self) -> bool:
        """The beam's output merge keyed on the model's provenance: migrated
        Keras artifacts keep ``K.ctc_decode`` parity (TF-V1 merge, which
        collapses double letters); models trained by this framework
        ("native", every bundled model) get standard CTC (no merge)."""
        return self.cfg.provenance == "keras_migrated"

    def decode_dense(
        self,
        probs: torch.Tensor,
        input_len: torch.Tensor,
        greedy: bool = True,
        beam_width: int = 10,
        top_paths: int = 1,
        merge_repeated: Optional[bool] = None,
        exact_tf: bool = False,
    ):
        """(decoded_list, scores): ``top_paths`` dense (B, T) int32 label
        tensors padded with -1 (greedy: one) on the probabilities' device
        (``exact_tf``: decoded on the host, moved there), and (B, paths)
        scores as a numpy array."""
        if greedy:
            with span("crnn.predict.decode"):
                decoded, score = ctc.ctc_greedy_decode(probs, input_len)
            with span("crnn.predict.wait"):
                return [decoded], score.cpu().numpy()
        if merge_repeated is None:
            merge_repeated = self.default_merge_repeated
        if exact_tf:
            with span("crnn.predict.wait"):
                host_probs = probs.float().cpu().numpy()
                host_len = input_len.cpu().numpy()
            with span("crnn.predict.decode"):
                dense, scores = ctc_beam_search_decode_exact(
                    host_probs, host_len, beam_width=beam_width,
                    top_paths=top_paths, merge_repeated=merge_repeated)
                # the device beam's layout: width T, so both beam paths hand
                # the aligner the same shape
                T = probs.shape[1]
                return [torch.nn.functional.pad(torch.from_numpy(d),
                                                (0, T - d.shape[1]), value=-1)
                        .to(probs.device) for d in dense], scores
        with span("crnn.predict.decode"):
            decoded_list, scores = ctc.ctc_decode(
                probs, input_len, greedy=False, beam_width=beam_width,
                top_paths=top_paths, merge_repeated=merge_repeated)
        with span("crnn.predict.wait"):
            return decoded_list, scores.cpu().numpy()

    def decode(self, probs: torch.Tensor, input_len: torch.Tensor,
               **decode_kw) -> List[Prediction]:
        """Decode on the device (greedy, or beam with ``decode_kw`` as
        :meth:`predict`'s), then labels to text on the host."""
        return self._predictions(*self.decode_dense(probs, input_len,
                                                    **decode_kw))

    def _predictions(self, decoded_list, scores) -> List[Prediction]:
        with span("crnn.predict.to_text"):
            rows_per_path = [ctc.trim_dense(d.cpu()) for d in decoded_list]
            out = []
            for b in range(scores.shape[0]):
                cands = [(self.codec.labels_to_text(rows[b]),
                          float(scores[b, min(p, scores.shape[1] - 1)]))
                         for p, rows in enumerate(rows_per_path)]
                out.append(Prediction(
                    text=cands[0][0], score=cands[0][1],
                    candidates=cands if len(cands) > 1 else None))
            return out

    @torch.inference_mode()
    def predict_probs(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ):
        """Grayscale uint8 images -> (probs (B, T, C), input_len (B,)), both
        on the predictor's device (on a mesh: the batch padded, sharded and
        gathered as the module's docstring says)."""
        if self.mesh is None:
            x, w_new = self.preprocess(images, bucket)
            with span("crnn.predict.forward"):
                return self.probs(self.model(x), w_new)
        n_req = len(images)
        size = self.mesh.size
        images = list(images) + [self.blank_row()] * (-n_req % size)
        x, w_new = self.preprocess(images, bucket)
        with span("crnn.predict.forward"):
            logits = torch.cat([
                self.replicas[d](x[self.mesh.rows(len(images), i)].to(d))
                .to(self.device) for i, d in enumerate(self.mesh.devices)])
            probs, input_len = self.probs(logits, w_new)
            return probs[:n_req], input_len[:n_req]

    def predict(
        self,
        images: Sequence[np.ndarray],
        greedy: bool = True,
        beam_width: int = 10,
        top_paths: int = 1,
        merge_repeated: Optional[bool] = None,
        exact_tf: bool = False,
        timing: bool = False,
        bucket: Optional[int] = None,
        alignments: bool = False,
    ) -> List[Prediction]:
        """Texts and scores of ``images``; with ``greedy=False`` the
        TF-exact beam (``beam_width``; ``top_paths`` > 1 fills
        ``candidates``; ``exact_tf`` decodes on the host). ``merge_repeated``
        (beam only): True is the Keras/TF-V1 output merge, False standard
        CTC, None :attr:`default_merge_repeated`. ``alignments=True`` fills
        ``spans`` from the same forward pass: the greedy path's argmax runs,
        or the beam's top path force-aligned, so spans always describe the
        returned text."""
        t0 = time.perf_counter()
        bucket = self.resolve_bucket(images, bucket)
        with span("crnn.predict", bucket=bucket, rows=len(images)):
            probs, input_len = self.predict_probs(images, bucket=bucket)
            decoded_list, scores = self.decode_dense(
                probs, input_len, greedy=greedy, beam_width=beam_width,
                top_paths=top_paths, merge_repeated=merge_repeated,
                exact_tf=exact_tf)
            spans_rows = None
            if alignments and greedy:
                spans_rows = self._spans_rows(
                    images, bucket,
                    *ctc.ctc_greedy_alignment(probs, input_len))
            elif alignments:
                dec = decoded_list[0]
                spans_rows = self._spans_rows(
                    images, bucket, dec,
                    *ctc.ctc_forced_alignment(probs, input_len,
                                              torch.clamp(dec, min=0),
                                              (dec >= 0).sum(1))[:3])
            out = self._predictions(decoded_list, scores)
        per_line = (time.perf_counter() - t0) * 1e3 / len(out)
        for b, p in enumerate(out):
            p.latency_ms = per_line if timing else None
            p.spans = spans_rows[b] if spans_rows is not None else None
        return out

    def predict_text(self, images: Sequence[np.ndarray], **kw) -> List[str]:
        return [p.text for p in self.predict(images, **kw)]

    def predict_with_alignment(
        self, images: Sequence[np.ndarray], bucket: Optional[int] = None
    ) -> List[List[CharSpan]]:
        """Greedy decode with per-character localization: one ``CharSpan``
        list per image, whose chars join to ``predict_text(greedy=True)``'s
        text at the same bucket."""
        bucket = self.resolve_bucket(images, bucket)
        probs, input_len = self.predict_probs(images, bucket=bucket)
        return self._spans_rows(
            images, bucket, *ctc.ctc_greedy_alignment(probs, input_len))

    def _spans_rows(self, images, bucket, labels, starts, ends,
                    confs) -> List[List[CharSpan]]:
        """Alignment tensors -> per-image ``CharSpan`` lists in original-image
        pixel columns (``crnn_ocr_tpu/infer/predictor.py:313``)."""
        labels, starts, ends, confs = (t.cpu().numpy() for t in
                                       (labels, starts, ends, confs))
        ds = self.cfg.width_downsample
        sl = self.cfg.ctc_time_slice
        out: List[List[CharSpan]] = []
        for b, img in enumerate(images):
            h, w = img.shape[:2]
            # preprocessing clamps the resized width to the bucket, so a
            # resized column maps back by w / w_new
            w_new = min(int(round(w * self.cfg.height / h)), bucket)
            scale = ds * w / max(w_new, 1)
            spans = []
            for j in range(labels.shape[1]):
                lab = int(labels[b, j])
                if lab < 0 or starts[b, j] < 0:
                    break
                # frame boundary k maps to floor((k + sl) * scale) on both
                # sides, so adjacent runs' spans tile without overlap
                x0 = int(np.floor((starts[b, j] + sl) * scale))
                x1 = int(np.floor((ends[b, j] + 1 + sl) * scale))
                x0 = min(x0, max(w - 1, 0))
                x1 = min(max(x1, x0 + 1), w)
                spans.append(CharSpan(char=self.codec.labels_to_text([lab]),
                                      x0=x0, x1=x1, conf=float(confs[b, j])))
            out.append(spans)
        return out

    def predict_many(
        self,
        images: Sequence[np.ndarray],
        batch_size: int = 64,
        **kw,
    ) -> List[Prediction]:
        """Bucket-grouped batched inference over any list of images: each
        image goes to its :meth:`bucket_for` bucket, each bucket runs in
        chunks of ``batch_size``, and the predictions come back in the
        original order. ``kw`` goes to :meth:`predict`."""
        groups: dict = {}
        for i, im in enumerate(images):
            groups.setdefault(self.bucket_for(im), []).append(i)
        out: List[Optional[Prediction]] = [None] * len(images)
        for bucket in sorted(groups):
            idxs = groups[bucket]
            for k in range(0, len(idxs), batch_size):
                chunk = idxs[k:k + batch_size]
                preds = self.predict([images[i] for i in chunk],
                                     bucket=bucket, **kw)
                for i, p in zip(chunk, preds):
                    out[i] = p
        return out  # type: ignore[return-value]


def init_predictor(model_dir: str, device="cuda", **kw) -> Predictor:
    """A ``Predictor`` from a model directory
    (``crnn_ocr_tpu/infer/predictor.py:389-443``):

    * a checkpoint directory (``model_config.json``, ``classes.json`` and
      step directories, ``train/checkpoint.py``): the config, the codec
      and the latest step's model tensors, whatever optimizer wrote them,
      from the port's ``<step>/checkpoint.pt`` or from the JAX package's
      orbax step (``train/orbax.py``). A config without ``provenance``
      loads as ``"native"``;
    * reference artifacts (a Keras ``.h5``, its architecture JSON if
      present, and a class map), through
      ``infer/keras_json.py::load_reference_model``.

    The port's config has no kernel-path knobs to reset
    (``config._RUNTIME_KNOBS``): on the card the stem and the recurrence
    always run their kernels. Keywords go to ``Predictor``."""
    if os.path.exists(os.path.join(model_dir, "model_config.json")):
        from crnn_ocr_torch.train.checkpoint import (
            CheckpointManager,
            load_codec,
            load_model_config,
        )

        state_dict = CheckpointManager(model_dir).restore_inference()
        return Predictor(load_model_config(model_dir), state_dict,
                         load_codec(model_dir), device=device, **kw)
    from crnn_ocr_torch.infer.keras_json import load_reference_model
    from crnn_ocr_torch.infer.weights import params_from_jax

    cfg, params, batch_stats, codec = load_reference_model(model_dir)
    if codec is None:
        raise FileNotFoundError(
            f"{model_dir}: reference .h5 found but no class map "
            "(classes.pkl / classes.json)")
    return Predictor(cfg, params_from_jax(params, batch_stats), codec,
                     device=device, **kw)


def predictor_from_cli(
    model: Optional[str],
    pretrained: Optional[str],
    normalize: bool = True,
    n_devices: int = 1,
    device="cuda",
    **kw,
) -> Predictor:
    """The CLIs' loader (predict and serve): ``--pretrained`` goes to
    ``load_pretrained``, ``--model`` to :func:`init_predictor`
    (``crnn_ocr_tpu/infer/predictor.py:478``). ``n_devices`` other than 1
    serves on a local mesh: on CUDA ``make_mesh(n_devices)`` over the
    cards (0: all of them; too few raise JAX's message), on the CPU
    ``n_devices`` shards of the one CPU device."""
    if n_devices != 1:
        from crnn_ocr_torch.parallel import make_mesh

        dev = torch.device(device)
        mesh = (make_mesh(n_devices) if dev.type == "cuda"
                else make_mesh(devices=[dev] * max(n_devices, 1)))
        if mesh.size > 1:
            kw["mesh"] = mesh
    if pretrained:
        from crnn_ocr_torch.infer.pretrained import load_pretrained

        return load_pretrained(pretrained, device=device,
                               normalize=normalize, **kw)
    if model:
        return init_predictor(model, device=device, normalize=normalize, **kw)
    raise SystemExit("one of --model / --pretrained is required")


def decode_predict_ctc(
    out,
    input_length=None,
    top_paths: int = 1,
    beam_width: int = 10,
    codec: Optional[LabelCodec] = None,
    merge_repeated: bool = True,
    device="cuda",
):
    """Reference-parity free function (``crnn_ocr_tpu/infer/predictor.py:
    446``): beam-decode (B, T, C) softmax outputs ``out`` on ``device`` to
    label sequences, or to texts when a codec is given. Returns (paths or
    texts, indexed [p][b] or [b][p], and (B, top_paths) numpy scores)."""
    dev = resolve_device(device)
    out = torch.as_tensor(out).to(dev)
    B, T, _ = out.shape
    if input_length is None:
        input_length = torch.full((B,), T, dtype=torch.int64)
    decoded_list, scores = ctc.ctc_decode(
        out, torch.as_tensor(input_length).to(dev), greedy=False,
        beam_width=beam_width, top_paths=top_paths,
        merge_repeated=merge_repeated)
    paths = [ctc.trim_dense(d.cpu()) for d in decoded_list]
    scores = scores.cpu().numpy()
    if codec is None:
        return paths, scores
    texts = [[codec.labels_to_text(paths[p][b]) for p in range(top_paths)]
             for b in range(B)]
    return texts, scores

"""Port parity: checkpoints and exact resume (``crnn_ocr_torch/train/
checkpoint.py`` and ``fit``'s ``checkpoint_dir``, ``profile_dir`` and
``tensorboard_dir``, against ``crnn_ocr_tpu/train/``).

* A save -> restore round trip is bit-exact: parameters, BatchNorm
  statistics, the optimizer's slots and step counts, and the step.
* Resume with dropout 0.2 is bit-exact on the CPU: 6 steps, checkpoint,
  restore into a fresh state, 4 more equal 10 straight, through ``fit`` on
  synthetic batches and through the files ``Reader`` with ``skip``. (The
  in-memory case, ``fit`` twice on one state, holds the dropout stream
  alone: each step's masks depend on the run's seed and the step only.)
* Rotation keeps the steps JAX's orbax-backed ``CheckpointManager`` keeps:
  the same ``best_step``, ``latest_step`` and retained steps.
* Each package's ``load_model_config`` and ``load_codec`` read the other's
  files.
* ``init_predictor`` on the port's checkpoint of ``fonts-small``'s
  weights gives JAX's ``init_predictor`` texts on its orbax checkpoint of
  the same weights, scores rtol 1e-4 (atol 1e-5).
* A save cut off after its temporary file leaves the latest step
  readable; an orbax directory raises the named error.
"""

import dataclasses
import json
import math
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import crnn_ocr_torch
from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import codec as tcodec
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.data import reader as treader
from crnn_ocr_torch.data.synthetic import SyntheticConfig, SyntheticTextlines
from crnn_ocr_torch.infer.predictor import init_predictor
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.train import checkpoint as tckpt
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_tpu.infer import init_predictor as jax_init_predictor
from crnn_ocr_tpu.infer import load_pretrained as jax_load_pretrained
from crnn_ocr_tpu.train import checkpoint as jckpt
from crnn_ocr_tpu.train import state as jstate

ALPHABET = "0123456789"
NARROW = dict(num_classes=len(ALPHABET), width=64, stem_filters=8,
              block_filters=(8, 8, 12, 12), time_dense_size=16, n_units=16,
              rnn_layers=1, dropout_rate=0.2)
GOLDENS = os.path.join(os.path.dirname(crnn_ocr_torch.__file__), "testdata",
                       "greedy_goldens.npz")


def _synth():
    return SyntheticTextlines(SyntheticConfig(alphabet=ALPHABET, min_len=2,
                                              max_len=4))


def _state(cfg, optimizer="adam", seed=0):
    return tstate.create_train_state(cfg, seed=seed, device="cpu",
                                     optimizer=optimizer, learning_rate=3e-3)


def _stream(cfg, skip=0, synth=None):
    return tpipe.device_batches(tpipe.synthetic_batches(
        batch_size=8, bucket=64, seed=11, synth=synth or _synth(),
        skip=skip), "cpu", cfg, prefetch=0)


def _assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_save_restore_round_trip_is_bitwise(tmp_path, optimizer):
    cfg = TorchConfig(**NARROW)
    state = tloop.fit(_state(cfg, optimizer), cfg, _stream(cfg),
                      cfg=tloop.FitConfig(steps=3, log_every=100))
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.step, state)
    fresh = _state(cfg, optimizer, seed=5)
    assert mgr.restore(fresh) is fresh
    _assert_states_equal(state, fresh)
    assert fresh.optimizer.state_dict()["state"]  # slots were restored
    inference = mgr.restore_inference()
    sd = state.model.state_dict()
    assert inference.keys() == sd.keys()
    assert all(torch.equal(inference[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="optimizer"):
        mgr.restore(_state(cfg, "sgd"))


@pytest.mark.parametrize("via", ["checkpoint", "memory"])
def test_resume_with_dropout_is_bitwise(tmp_path, via):
    cfg = TorchConfig(**NARROW)
    synth = _synth()

    def evals():
        return _stream(cfg, skip=1000, synth=synth)

    fitcfg = dict(log_every=100, eval_every=3, eval_batches=1)
    straight = tloop.fit(_state(cfg), cfg, _stream(cfg), evals, synth.codec,
                         tloop.FitConfig(steps=10, **fitcfg))
    ckdir = str(tmp_path / "ck")
    first = tloop.fit(_state(cfg), cfg, _stream(cfg), evals, synth.codec,
                      tloop.FitConfig(steps=6, checkpoint_dir=(
                          ckdir if via == "checkpoint" else None), **fitcfg))
    if via == "checkpoint":
        mgr = tckpt.CheckpointManager(ckdir)
        assert mgr.all_steps() == [3, 6]
        resumed = mgr.restore(_state(cfg, seed=9))
        _assert_states_equal(first, resumed)
    else:
        resumed = first
    resumed = tloop.fit(resumed, cfg, _stream(cfg, skip=6), evals,
                        synth.codec, tloop.FitConfig(steps=10, **fitcfg))
    _assert_states_equal(straight, resumed)


def test_files_resume_with_dropout_is_bitwise(tmp_path):
    """fit 4 -> checkpoint -> restore -> fit to 8 from the files Reader's
    ``run_generator(skip=4)`` == fit 8 straight (an epoch is 3 batches)."""
    d = tmp_path / "ds"
    d.mkdir()
    synth = _synth()
    rng = np.random.default_rng(5)
    lines = []
    for i in range(24):
        imgs, texts = synth.sample_batch(1, rng)
        assert cv2.imwrite(str(d / f"l{i}.png"), imgs[0])
        lines.append(f"l{i}.png\t{texts[0]}")
    (d / "annotation.txt").write_text("\n".join(lines))
    reader = treader.Reader(treader.ReaderConfig(
        path=str(d), batch_size=8, val_fraction=0.0, shuffle_seed=3,
        pack_cache=True), codec=synth.codec)
    assert reader.steps_per_epoch() == 3
    cfg = TorchConfig(**NARROW)

    def stream(skip=0):
        return tpipe.device_batches(reader.run_generator(skip=skip), "cpu",
                                    cfg, prefetch=0)

    straight = tloop.fit(_state(cfg), cfg, stream(),
                         cfg=tloop.FitConfig(steps=8, log_every=100))
    ckdir = str(tmp_path / "ck")
    tloop.fit(_state(cfg), cfg, stream(),
              cfg=tloop.FitConfig(steps=4, log_every=100,
                                  checkpoint_dir=ckdir))
    resumed = tckpt.CheckpointManager(ckdir).restore(_state(cfg, seed=1))
    assert resumed.step == 4
    resumed = tloop.fit(resumed, cfg, stream(skip=4),
                        cfg=tloop.FitConfig(steps=8, log_every=100))
    _assert_states_equal(straight, resumed)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(4, dtype=torch.float32))


def _tiny_state(step):
    model = _Tiny()
    with torch.no_grad():
        model.w += step
    return tstate.TrainState(model=model,
                             optimizer=torch.optim.Adam(model.parameters()),
                             schedule=lambda count: 1e-3, step=step)


NAN = float("nan")
SEQUENCES = {
    # tests/test_train_integration.py's, then a metric-less final save
    "best-kept": ([(1, 0.5), (2, 0.05), (3, 0.4), (4, 0.3), (5, 0.2),
                   (6, None)], 2, "cer", "min"),
    "nan-and-metricless": ([(1, 0.3), (2, NAN), (3, 0.1), (4, None),
                            (5, 0.2), (6, 0.4), (7, 0.05), (8, None)],
                           2, "cer", "min"),
    "ties-max": ([(1, 0.5), (2, 0.5), (3, 0.9), (4, 0.1), (5, 0.9),
                  (6, 0.5)], 3, "acc", "max"),
    "untracked": ([(1, 0.5), (2, 0.1), (3, None), (4, 0.3), (5, 0.2)],
                  2, None, "min"),
    "repeat-step": ([(1, 0.5), (2, 0.2), (2, None), (3, 0.4), (1, 0.0),
                     (4, 0.6)], 2, "cer", "min"),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_rotation_matches_jax(tmp_path, name):
    seq, keep, metric, mode = SEQUENCES[name]
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), max_to_keep=keep,
                                 track_metric=metric, track_mode=mode)
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), max_to_keep=keep,
                                 track_metric=metric, track_mode=mode)
    key = metric or "cer"
    for step, v in seq:
        metrics = None if v is None else {key: v, "loss": 1.0}
        jm.save(step, {"w": np.arange(4, dtype=np.float32) + step},
                metrics=metrics)
        tm.save(step, _tiny_state(step), metrics=metrics)
        jm.wait()
        assert tm.all_steps() == list(jm._mgr.all_steps()), step
        assert tm.latest_step() == jm.latest_step(), step
        assert tm.best_step() == jm.best_step(), step
    best = tm.best_step()
    got = tm.restore(_tiny_state(0), step=best)
    want = jm.restore({"w": jax.ShapeDtypeStruct((4,), np.float32)},
                      step=best)
    np.testing.assert_array_equal(got.model.w.detach().numpy(),
                                  np.asarray(want["w"]))
    # the sidecar metrics files are JAX's, NaN included
    assert (sorted(f for f in os.listdir(tmp_path / "t") if "metrics_" in f)
            == sorted(f for f in os.listdir(tmp_path / "j")
                      if "metrics_" in f))


def test_each_package_reads_the_others_config_and_codec(tmp_path):
    jcfg = jax_load_pretrained("fonts-small").cfg
    tcfg = TorchConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(TorchConfig)})
    codec = tcodec.LabelCodec.from_texts(["héllo wörld", "0123"])
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    tm.save(1, _tiny_state(1), tcfg, codec, metrics={"cer": 0.25})
    # JAX reads the port's files
    jread = jckpt.load_model_config(str(tmp_path / "t"))
    assert all(getattr(jread, f.name) == getattr(tcfg, f.name)
               for f in dataclasses.fields(TorchConfig))
    assert jckpt.load_codec(str(tmp_path / "t")).classes == codec.classes
    with open(tmp_path / "t" / "metrics_1.json") as f:
        assert json.load(f) == {"cer": 0.25}
    # the port reads JAX's (its two kernel-path knobs dropped)
    jm = jckpt.CheckpointManager(str(tmp_path / "j"))
    jm.save(1, {"w": np.zeros(2, np.float32)}, jcfg, codec)
    jm.wait()
    assert tckpt.load_model_config(str(tmp_path / "j")) == tcfg
    assert tckpt.load_codec(str(tmp_path / "j")).classes == codec.classes


def test_init_predictor_on_port_checkpoint_matches_jax(tmp_path):
    ref = jax_load_pretrained("fonts-small")
    params = jax.tree_util.tree_map(np.asarray, ref._vars["params"])
    stats = jax.tree_util.tree_map(np.asarray, ref._vars["batch_stats"])
    # JAX: its own orbax checkpoint of the bundled weights
    jcfg = dataclasses.replace(ref.cfg, use_pallas_rnn=None,
                               use_fused_stem=None)
    js = jstate.create_train_state(jcfg, jax.random.key(0))
    js = js.replace(params=ref._vars["params"],
                    batch_stats=ref._vars["batch_stats"])
    jm = jckpt.CheckpointManager(str(tmp_path / "j"))
    jm.save(7, js, jcfg, ref.codec)
    jm.wait()
    # the port: the same weights through params_from_jax, its checkpoint
    tcfg = TorchConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(TorchConfig)})
    ts = tstate.create_train_state(tcfg, params_from_jax(params, stats),
                                   device="cpu")
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    tm.save(7, ts, tcfg, tcodec.LabelCodec(ref.codec.classes))
    g = np.load(GOLDENS)
    c, hs, ws = g["small_canvas"], g["small_heights"], g["small_widths"]
    lines = [c[i, :hs[i], :ws[i]] for i in range(16)]
    want = jax_init_predictor(str(tmp_path / "j")).predict(lines)
    got = init_predictor(str(tmp_path / "t"), device="cpu").predict(lines)
    assert [p.text for p in got] == [p.text for p in want]
    assert sum(len(p.text) for p in got) > 16  # it reads text
    np.testing.assert_allclose([p.score for p in got],
                               [p.score for p in want], rtol=1e-4, atol=1e-5)
    # and a JAX orbax directory is refused by name
    with pytest.raises(tckpt.OrbaxCheckpointError, match="orbax.*item 15"):
        init_predictor(str(tmp_path / "j"), device="cpu")
    with pytest.raises(tckpt.OrbaxCheckpointError, match="orbax"):
        tckpt.CheckpointManager(str(tmp_path / "j")).restore(ts)


def test_interrupted_save_leaves_latest_readable(tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(1, _tiny_state(1))
    real = os.replace

    def cut(src, dst):
        if src.endswith(".tmp") and tckpt.CKPT_FILE in src:
            raise OSError("cut off before the rename")
        return real(src, dst)

    monkeypatch.setattr(os, "replace", cut)
    with pytest.raises(OSError, match="cut off"):
        mgr.save(2, _tiny_state(2))
    monkeypatch.setattr(os, "replace", real)
    assert os.path.exists(tmp_path / "ck" / "2" / (tckpt.CKPT_FILE + ".tmp"))
    again = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert again.latest_step() == 1 and again.all_steps() == [1]
    got = again.restore(_tiny_state(0))
    assert got.step == 1 and torch.equal(got.model.w, _tiny_state(1).model.w)
    assert again.save(2, _tiny_state(2)) and again.latest_step() == 2


def test_fit_profile_window_writes_a_trace(tmp_path):
    cfg = TorchConfig(**NARROW)
    for name, at, n in (("inside", 2, 3), ("cut", 5, 20)):
        path = tmp_path / f"{name}.jsonl"
        tloop.fit(_state(cfg), cfg, _stream(cfg), cfg=tloop.FitConfig(
            steps=8, log_every=4, metrics_path=str(path),
            profile_dir=str(tmp_path / name), profile_at=at,
            profile_steps=n))
        traces = os.listdir(tmp_path / name)
        assert len(traces) == 1 and traces[0].endswith(".json")
        with open(tmp_path / name / traces[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any("bilstm" in str(e.get("name", "")) or "bigru" in
                   str(e.get("name", "")) or "aten::" in str(e.get("name"))
                   for e in events)
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        assert [r["step"] for r in recs] == [1, 4, 8]
        assert all(r["host_step_p50_ms"] > 0 and "host_step_p90_ms" in r
                   and "host_step_mean_ms" in r for r in recs)


@pytest.mark.parametrize("writer", ["tensorboardX", "absent"])
def test_fit_tensorboard_dir(tmp_path, monkeypatch, writer):
    import sys

    if writer == "absent":
        monkeypatch.setitem(sys.modules, "tensorboardX", None)  # ImportError
    else:
        pytest.importorskip("tensorboardX")
    cfg = TorchConfig(**NARROW)
    synth = _synth()
    tb = tmp_path / "tb"
    state = tloop.fit(_state(cfg), cfg, _stream(cfg, synth=synth),
                      lambda: _stream(cfg, skip=1000, synth=synth),
                      synth.codec, tloop.FitConfig(
                          steps=4, log_every=2, eval_every=4, eval_batches=1,
                          tensorboard_dir=str(tb)))
    assert state.step == 4
    events = [f for f in (os.listdir(tb) if tb.exists() else [])
              if f.startswith("events.out.tfevents")]
    if writer == "absent":
        assert events == []
        return
    assert len(events) == 1
    from tensorboardX.proto.event_pb2 import Event

    scalars = {}
    with open(tb / events[0], "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):  # TFRecords: length, its crc, event, its crc
        n = int.from_bytes(data[pos:pos + 8], "little")
        ev = Event.FromString(data[pos + 12:pos + 12 + n])
        pos += 16 + n
        for v in ev.summary.value:
            scalars.setdefault(v.tag, []).append((ev.step, v.simple_value))
    assert {"train/loss", "train/grad_norm", "train/host_step_p50_ms",
            "eval/cer", "eval/loss"} <= set(scalars)
    assert [st for st, _ in scalars["train/loss"]] == [1, 2, 4]
    assert not math.isnan(scalars["eval/cer"][0][1])

"""Port parity: the corpus held in device memory
(``crnn_ocr_torch/data/device_cache.py``, the cached K-step calls in
``train/step.py``, ``ops/preprocess.py::preprocess_resident``) against
``crnn_ocr_tpu``'s, here on the CPU.

Tolerances: the index stream, the stacks (``rows``, ``batch_index``,
``pix_rows``, ``miss_pixels``) and the tables equal JAX's and the host
path's, byte for byte. ``preprocess_resident`` against JAX's: atol 1e-4,
as ``tests/test_torch_preprocess.py`` holds ``preprocess_batch`` (XLA sums
a frame's mean and variance in f32 in order, torch pairwise: 1.9e-5 apart
on white rows). A cached step against a streamed one, as
``tests/test_device_cache.py:83`` holds JAX's: losses rtol 1e-5 / atol
1e-6, parameters rtol 1e-3 / atol 1e-6 (``preprocess_resident`` skips the
identity resample, which rounds in f32: within 5e-7 of
``preprocess_batch`` after standardization, as JAX measured 4.8e-7).
Partial against full residency, and a resume against a straight run:
bitwise (the same bytes and the same operations).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.data.device_cache import DeviceResidentCorpus
from crnn_ocr_torch.data.reader import Reader, ReaderConfig
from crnn_ocr_torch.data.synthetic import SyntheticConfig as TSynthCfg
from crnn_ocr_torch.data.synthetic import SyntheticTextlines as TSynth
from crnn_ocr_torch.ops.preprocess import preprocess_batch, \
    preprocess_resident
from crnn_ocr_torch.parallel import Mesh, make_mesh
from crnn_ocr_torch.train import CheckpointManager
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_tpu.data import Reader as JReader
from crnn_ocr_tpu.data import ReaderConfig as JReaderConfig
from crnn_ocr_tpu.data.device_cache import DeviceResidentCorpus as JCorpus
from crnn_ocr_tpu.ops import preprocess as jprep

cv2 = pytest.importorskip("cv2")

TINY = dict(num_classes=10, width=128, stem_filters=8,
            block_filters=(8, 8, 12, 12), time_dense_size=8, n_units=8,
            rnn_layers=1, dropout_rate=0.1)
SEED = 11
# one bucket of 24 rows of 32 x 128 pixels (tables: 24 rows of 4 * 8 + 8
# bytes): about half the pixels resident
HALF = 960 + 24 * 32 * 128 // 2


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    """24 synthetic lines as PNGs with an annotation file; one copy for
    each package, so neither reads the other's packed cache."""
    synth = TSynth(TSynthCfg(alphabet="0123456789", min_len=2, max_len=4))
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("dcache") / "port"
    d.mkdir()
    lines = []
    for i in range(24):
        images, texts = synth.sample_batch(1, rng)
        assert cv2.imwrite(str(d / f"img_{i}.png"), images[0])
        lines.append(f"img_{i}.png\t{texts[0]}")
    (d / "annotation.txt").write_text("\n".join(lines))
    j = d.parent / "jax"
    shutil.copytree(d, j)
    return str(d), str(j)


def _cfg(buckets=(64, 128), batch_size=4):
    return dict(val_fraction=0.0, max_label_len=8, pack_cache=True,
                buckets=buckets, batch_size=batch_size)


def _reader(d, **kw):
    return Reader(ReaderConfig(path=d, **_cfg(**kw)))


def _corpus(d, max_bytes=8 << 30, **kw):
    return DeviceResidentCorpus(_reader(d, **kw), max_bytes=max_bytes,
                                device="cpu")


def _jcorpus(d, max_bytes=8 << 30, **kw):
    return JCorpus(JReader(JReaderConfig(path=d, **_cfg(**kw))),
                   max_bytes=max_bytes)


def test_index_stream_matches_reader_and_jax(corpus_dirs):
    """The planner is the host path's: the gathered labels, widths and
    pixel rows equal ``Reader.run_generator``'s batches, and the rows
    equal JAX's corpus's."""
    port, jdir = corpus_dirs
    corpus = _corpus(port)
    jcorpus = _jcorpus(jdir)
    host = _reader(port).run_generator(train=True, epochs=1)
    n = 0
    for ib, jb, hb in zip(corpus.index_batches(epochs=1),
                          jcorpus.index_batches(epochs=1), host):
        n += 1
        assert ib["bucket"] == jb["bucket"] == int(hb["bucket"])
        np.testing.assert_array_equal(ib["rows"], jb["rows"])
        arrs = corpus.arrays(ib["bucket"])
        rows = torch.from_numpy(ib["rows"]).long()
        for key, want in (("labels", hb["the_labels"]),
                          ("lab_len", hb["label_length"]),
                          ("widths", hb["widths"])):
            np.testing.assert_array_equal(arrs[key][rows].numpy(), want)
            np.testing.assert_array_equal(
                arrs[key].numpy(),
                np.asarray(jcorpus.arrays(ib["bucket"])[key]))
        px = arrs["pixels"][rows].numpy()
        hw = hb["the_input"].shape[2]
        np.testing.assert_array_equal(px[:, :, :hw], hb["the_input"])
        assert (px[:, :, hw:] == 255).all()
    assert n == 6
    assert corpus.total_bytes == jcorpus.total_bytes
    assert corpus.resident_bytes() == corpus.total_bytes


def _half_budget(corpus):
    """The tables and half of the pixels."""
    pixels = sum(mm.nbytes for mm in corpus._mm.values())
    return corpus.total_bytes - pixels + pixels // 2


@pytest.mark.parametrize("budget", ["full", "half"])
def test_stacked_index_batches_equal_jax(corpus_dirs, budget):
    port, jdir = corpus_dirs
    mb = 8 << 30 if budget == "full" else _half_budget(_corpus(port))
    corpus = _corpus(port, mb)
    jcorpus = _jcorpus(jdir, mb)
    assert corpus.partial == jcorpus.partial == (budget == "half")
    assert corpus.resident_fraction == jcorpus.resident_fraction
    assert corpus._n_resident == jcorpus._n_resident
    for skip in (0, 3):
        got = list(corpus.stacked_index_batches(2, epochs=2, skip=skip))
        want = list(jcorpus.stacked_index_batches(2, epochs=2, skip=skip))
        assert len(got) == len(want) > 0
        saw_miss = False
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    assert g[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(g[k], v, err_msg=k)
                else:
                    assert g[k] == v, k
            saw_miss = saw_miss or bool(
                (np.asarray(g.get("pix_rows", 0)) < 0).any())
        assert saw_miss == (budget == "half")


def _stream_step(state, cfg, host_batch, index):
    b = tpipe.produce_batch(dict(host_batch), "cpu", cfg)
    b.pop("texts"), b.pop("bucket")
    gen = torch.Generator()
    gen.manual_seed(tstep.step_seed(SEED, state.step))
    return float(tstep.make_train_step(cfg)(state, b, gen)["loss"])


def _tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in slots.items()})
    return out


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys() and a.step == b.step
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_cached_step_matches_streamed_step(corpus_dirs):
    """3 steps gathered from the corpus (K = 1 calls, so the order is the
    host path's) against 3 steps of streamed pixels."""
    port, _ = corpus_dirs
    corpus = _corpus(port)
    cfg = TorchConfig(**TINY)
    a = tstate.create_train_state(cfg, seed=0, device="cpu")
    b = tstate.create_train_state(cfg, seed=0, device="cpu")
    cached = tstep.make_cached_multi_train_step(cfg)
    host = _reader(port).run_generator(epochs=1)
    for j, (hb, ib) in enumerate(zip(host, corpus.index_batches(epochs=1))):
        if j == 3:
            break
        want = _stream_step(a, cfg, hb, j)
        arrs = corpus.arrays(ib["bucket"])
        ms = cached(b, arrs["pixels"], arrs["widths"], arrs["labels"],
                    arrs["lab_len"], ib["rows"][None], np.array([j]), SEED,
                    ib["bucket"])
        np.testing.assert_allclose(float(ms["loss"][0]), want, rtol=1e-5,
                                   atol=1e-6, err_msg=f"batch {j}")
    ta, tb = _tensors(a), _tensors(b)
    for k in ta:
        np.testing.assert_allclose(tb[k].numpy(), ta[k].numpy(), rtol=1e-3,
                                   atol=1e-6 if k.startswith("model")
                                   else 2e-5, err_msg=k)


def test_partial_residency_step_is_full_residency_bitwise(corpus_dirs):
    port, _ = corpus_dirs
    full = _corpus(port, buckets=(128,))
    part = _corpus(port, HALF, buckets=(128,))
    assert part.partial and not full.partial
    cfg = TorchConfig(**TINY)
    f_stack = next(full.stacked_index_batches(2, epochs=1))
    p_stack = next(part.stacked_index_batches(2, epochs=1))
    assert (p_stack["pix_rows"] < 0).any()
    kw = dict(augment=True, augment_seed=2)
    s_f = tstate.create_train_state(cfg, seed=0, device="cpu")
    s_p = tstate.create_train_state(cfg, seed=0, device="cpu")
    a = full.arrays(128)
    m_f = tstep.make_cached_multi_train_step(cfg, **kw)(
        s_f, a["pixels"], a["widths"], a["labels"], a["lab_len"],
        f_stack["rows"], f_stack["batch_index"], SEED, 128)
    a = part.arrays(128)
    m_p = tstep.make_partial_cached_multi_train_step(cfg, **kw)(
        s_p, a["pixels"], a["widths"], a["labels"], a["lab_len"],
        p_stack["miss_pixels"], p_stack["rows"], p_stack["pix_rows"],
        p_stack["batch_index"], SEED, 128)
    assert torch.equal(m_f["loss"], m_p["loss"])
    _assert_bitwise(s_f, s_p)


def test_guards(corpus_dirs, tmp_path):
    port, _ = corpus_dirs
    with pytest.raises(ValueError, match="partial residency"):
        _corpus(port, max_bytes=100)
    with pytest.raises(ValueError, match="pack_cache"):
        DeviceResidentCorpus(Reader(ReaderConfig(
            path=port, **dict(_cfg(), pack_cache=False))), device="cpu")
    # on a mesh the tables go to the mesh's device; a rank other than 0
    # packs nothing and refuses a corpus that rank 0 has not packed
    assert DeviceResidentCorpus(_reader(port), mesh=make_mesh(
        devices=["cpu"])).device.type == "cpu"
    cold = tmp_path / "cold"
    shutil.copytree(port, cold, ignore=shutil.ignore_patterns(".crnn_*"))
    rank1 = Mesh((torch.device("cpu"),), group=object(), rank=1, world=2)
    with pytest.raises(ValueError, match="rank 1's reader finds 24 of 24"):
        DeviceResidentCorpus(_reader(str(cold)), mesh=rank1)
    assert not (cold / ".crnn_pack" / "index.json").exists()
    if not torch.cuda.is_available():  # entry points default to cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceResidentCorpus(_reader(port))
    d = tmp_path / "dup"
    d.mkdir()
    img = np.random.default_rng(0).integers(0, 255, (32, 40)).astype(
        np.uint8)
    assert cv2.imwrite(str(d / "a.png"), img)
    (d / "annotation.txt").write_text("a.png\t12\na.png\t34")
    r = Reader(ReaderConfig(path=str(d), batch_size=1, val_fraction=0.0,
                            buckets=(64,), pack_cache=True))
    with pytest.raises(ValueError, match="conflicting"):
        DeviceResidentCorpus(r, device="cpu")


def test_unpackable_rows_raise(corpus_dirs, tmp_path, monkeypatch):
    """A read-only data directory leaves rows unpacked: the corpus
    raises instead of streaming them."""
    from crnn_ocr_torch.data.packed import PackedCache

    d = tmp_path / "ro"
    shutil.copytree(corpus_dirs[0], d, ignore=shutil.ignore_patterns(
        ".crnn_pack", ".crnn_sizes.json"))

    def refuse(self, relpath, img):
        raise OSError("read-only")

    monkeypatch.setattr(PackedCache, "add", refuse)
    with pytest.raises(ValueError, match="could not be packed"):
        DeviceResidentCorpus(_reader(str(d)), device="cpu")


@pytest.mark.parametrize("budget", ["full", "half"])
def test_resume_is_bitwise(corpus_dirs, tmp_path, budget):
    """fit 4 steps (K = 2, augmented, dropout 0.1) -> checkpoint ->
    restore -> fit to 8 from ``stacked_index_batches(skip=4)`` equals a
    straight 8-step run, bit for bit (one bucket: the stacked stream
    replays exactly)."""
    port, _ = corpus_dirs
    corpus = _corpus(port, 8 << 30 if budget == "full" else HALF,
                     buckets=(128,))
    assert corpus.partial == (budget == "half")
    cfg = TorchConfig(**TINY)

    def fresh(seed=0):
        return tstate.create_train_state(cfg, seed=seed, device="cpu")

    def run(state, steps, skip=0, ck=None):
        return tloop.fit(state, cfg, corpus.stacked_index_batches(
            2, skip=skip), cfg=tloop.FitConfig(
                steps=steps, log_every=100, seed=SEED, steps_per_call=2,
                device_corpus=corpus, augment=True, augment_seed=4,
                checkpoint_dir=ck))

    straight = run(fresh(), 8)
    ck = str(tmp_path / "ck")
    run(fresh(), 4, ck=ck)
    resumed = CheckpointManager(ck).restore(fresh(seed=1))
    assert resumed.step == 4
    resumed = run(resumed, 8, skip=4)
    _assert_bitwise(straight, resumed)


def test_preprocess_resident_matches_jax_and_preprocess_batch(corpus_dirs):
    port, _ = corpus_dirs
    corpus = _corpus(port, buckets=(128,))
    a = corpus.arrays(128)
    rows, widths = a["pixels"][:8], a["widths"][:8]
    for normalize in (True, False):
        x, w = preprocess_resident(rows, widths, normalize)
        jx, jw = jprep.preprocess_resident(jnp.asarray(rows.numpy()),
                                           jnp.asarray(widths.numpy()),
                                           normalize)
        assert x.dtype == torch.float32 and w.dtype == torch.int32
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                                   atol=1e-4)
        full, fw = preprocess_batch(rows, torch.full((8,), 32), widths,
                                    out_h=32, out_w=128, normalize=normalize)
        np.testing.assert_array_equal(fw.numpy(), w.numpy())
        assert float((full - x).abs().max()) <= 5e-7

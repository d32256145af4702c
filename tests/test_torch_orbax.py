"""Port parity: reading the JAX package's orbax checkpoints
(``crnn_ocr_torch/train/orbax.py``, ``utils/zstd.py`` and
``train/checkpoint.py``) without orbax, tensorstore or a Python zstd.

The oracles run here only: ``zstandard`` for the decompression,
tensorstore's ``KvStore.list()``/``read()`` for the OCDBT store, the JAX
package's own ``CheckpointManager`` for the directories and the step
numbers, and the JAX train state and predictor for what the port restores
from them. Tolerances: the restored tensors bit for bit; served texts
equal and scores rtol 1e-4 (f32); a train step taken from a restored
state at ``tests/test_torch_train.py``'s tolerances (loss rtol 2e-5,
parameters rtol 2e-4 / atol 2e-5 but for gradient elements at the f32
noise of their sums, at most 0.1 % of a tensor, within ``2 * lr``).
"""

import concurrent.futures
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from chip_smoke import tree_digest
from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.infer import init_predictor
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.train import checkpoint as tckpt
from crnn_ocr_torch.train import orbax
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_torch.utils import zstd
from crnn_ocr_tpu.data.codec import LabelCodec
from crnn_ocr_tpu.infer import init_predictor as jax_init_predictor
from crnn_ocr_tpu.infer import load_pretrained as jax_load_pretrained
from crnn_ocr_tpu.models import ModelConfig as JaxConfig
from crnn_ocr_tpu.train import CheckpointManager as JaxCheckpoints
from crnn_ocr_tpu.train import state as jstate

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "crnn_ocr_torch", "testdata")
GOLDENS = os.path.join(TESTDATA, "greedy_goldens.npz")
OPTIMIZERS = ("adam", "sgd", "rmsprop", "adadelta", "adamw")
SMALL = JaxConfig(num_classes=12, width=64, stem_filters=8,
                  block_filters=(16, 16, 24, 24), time_dense_size=16,
                  n_units=12, rnn_layers=1, dropout_rate=0.0)


def _torch_cfg(jcfg) -> TorchConfig:
    return TorchConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(TorchConfig)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _updated_state(cfg, opt: str, seed: int, lr: float = 1e-3,
                   params=None, stats=None):
    """JAX's train state of ``cfg`` (``create_train_state``'s optimizer
    chain) after 2 updates of ``opt`` with seeded random gradients, from
    ``params`` and ``stats``, else from random ones."""
    from crnn_ocr_tpu.models import CRNN

    rng = np.random.default_rng(seed)
    if params is None:
        params, stats = _small_init()
        params, stats = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            (params, stats))
    s = jstate.TrainState.create(
        apply_fn=CRNN(cfg=cfg).apply, params=params,
        tx=jstate.make_optimizer(opt, lr), batch_stats=stats)
    update = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), s.params)
        s = update(s, g)
    return s


def _small_init():
    """``SMALL``'s (params, batch_stats) trees: the port's seeded init
    through ``params_to_jax`` (JAX's own init compiles for seconds)."""
    from crnn_ocr_torch.infer.weights import params_to_jax

    return params_to_jax(tstate.create_train_state(
        _torch_cfg(SMALL), device="cpu").model.state_dict())


def _save(directory: str, state, cfg, codec, step: int = 2, **kw):
    mgr = JaxCheckpoints(directory, **kw)
    mgr.save(step, state, cfg, codec)
    mgr.wait()
    return mgr


# ---- zstd ----

def _payload(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    if kind == "constant":  # RLE blocks
        return bytes([7]) * 100_000
    if kind == "empty":
        return b""
    # over 128 KiB: several blocks, raw, compressed and repeated spans
    return b"".join([rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
                     bytes(60_000), b"orbax ocdbt zarr " * 6000,
                     np.arange(40_000, dtype=np.float32).tobytes()])


@pytest.mark.parametrize("checksum", [False, True],
                         ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("kind", ["random", "constant", "empty",
                                  "multiblock"])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_matches_zstandard(level, kind, checksum):
    data = _payload(kind)
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == zstandard.decompress(frame) == data
    # a frame without its content size (a zarr chunk's), and two frames
    bare = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=False).compress(data)
    assert zstd.decompress(bare) == data
    assert zstd.decompress(bare, size_hint=len(data)) == data
    assert zstd.decompress(frame + bare) == data + data


def test_zstd_refuses_corrupt_frames():
    frame = zstandard.ZstdCompressor(write_checksum=True).compress(
        _payload("multiblock"))
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(b"not a frame")
    bad = bytearray(frame)
    bad[-2] ^= 0xFF  # the checksum
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(bytes(bad))


# ---- the JAX package's checkpoints ----

@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """One JAX directory per optimizer: ``SMALL`` after 2 updates, saved
    at step 2 by the JAX package's ``CheckpointManager``."""
    root = tmp_path_factory.mktemp("orbax")
    codec = LabelCodec.from_alphabet("0123456789ab")
    out = {}
    for i, opt in enumerate(OPTIMIZERS):
        s = _updated_state(SMALL, opt, seed=i)
        _save(str(root / opt), s, SMALL, codec)
        out[opt] = (str(root / opt), s)
    return out


@pytest.fixture(scope="module")
def hard_dir(tmp_path_factory):
    """``fonts-hard`` at full width in f32, its bundled weights moved by 2
    Adam updates at lr 1e-6 (its texts kept), saved at step 2."""
    ref = jax_load_pretrained("fonts-hard")
    cfg = dataclasses.replace(ref.cfg, dtype="float32", use_pallas_rnn=None,
                              use_fused_stem=None)
    s = _updated_state(cfg, "adam", seed=11, lr=1e-6,
                       params=ref._vars["params"],
                       stats=ref._vars["batch_stats"])
    d = str(tmp_path_factory.mktemp("hard") / "model")
    _save(d, s, cfg, ref.codec)
    return d, s, cfg


def test_store_matches_tensorstore(jax_dirs, monkeypatch):
    """Every key and value of a JAX checkpoint's OCDBT store equals
    tensorstore's, values over 1,024 bytes (indirect) among them; and
    every zstd frame the port decompresses on the way (the manifest, the
    nodes, the zarr chunks) equals ``zstandard``'s output."""
    frames = []
    real = zstd.decompress

    def record(data, size_hint=None):
        out = real(data, size_hint)
        frames.append((bytes(data), out))
        return out

    monkeypatch.setattr(zstd, "decompress", record)
    item = os.path.join(jax_dirs["adam"][0], "2", "default")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{item}/"}).result()
    want = kv.list().result()
    store = orbax.OcdbtStore(item)
    assert store.list() == sorted(want)
    sizes = []
    for key in want:
        value = kv.read(key).result().value
        assert store.read(key) == value, key
        sizes.append(len(value))
    assert max(sizes) > 1024
    orbax.read_tree(os.path.join(jax_dirs["adam"][0], "2"))
    assert len(frames) > len(want) // 2
    for data, out in frames:
        assert out == zstandard.ZstdDecompressor().decompressobj(
        ).decompress(data)


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 16},
    {"compression": None, "max_decoded_node_bytes": 300},
], ids=["btree_height", "uncompressed"])
def test_store_written_by_tensorstore(tmp_path, config):
    """Stores that tensorstore writes with small nodes (a b-tree of height
    above 0, keys under interior nodes' common prefixes) and with no
    compression, over three commits: the latest version's keys and
    values equal tensorstore's."""
    root = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    rng = np.random.default_rng(3)
    for commit in range(3):
        with ts.Transaction() as txn:
            for i in range(60):
                kv.with_transaction(txn)[f"key{commit}/{i:03d}/v"] = (
                    rng.integers(0, 256, int(rng.integers(0, 400)),
                                 dtype=np.uint8).tobytes())
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{root}/").result()
                         ).result()
    if "compression" not in config:
        assert dump["versions"][-1]["root_height"] > 0
    want = kv.list().result()
    store = orbax.OcdbtStore(root)
    assert store.list() == sorted(want) and len(want) == 180
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key


def _want_slots(opt: str, s) -> dict:
    """The optax state's slots as the port's optimizer state keys, read
    straight from JAX's ``opt_state`` (``clip_by_global_norm`` first)."""
    inner = s.opt_state[1]
    if opt in ("adam", "adamw"):
        st = inner[0]
        return {"exp_avg": st.mu, "exp_avg_sq": st.nu}, int(st.count)
    if opt == "sgd":
        return {"momentum_buffer": inner[0].trace}, None
    if opt == "rmsprop":
        return {"nu": inner[0].nu}, None
    return {"square_avg": inner[1].e_g, "acc_delta": inner[1].e_x}, None


def _assert_state_bitwise(tstate_, s, opt: str):
    want = params_from_jax(_np(s.params), _np(s.batch_stats))
    got = tstate_.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert tstate_.step == int(s.step) == 2
    slots, count = _want_slots(opt, s)
    names = {id(p): n for n, p in tstate_.model.named_parameters()}
    for p in tstate_.model.parameters():
        st = tstate_.optimizer.state[p]
        for key, tree in slots.items():
            w = params_from_jax(_np(tree), _np(s.batch_stats))[names[id(p)]]
            assert torch.equal(st[key], w), (key, names[id(p)])
        if count is not None:
            assert float(st["step"]) == count


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_train_state_restores_bit_for_bit(jax_dirs, opt):
    """Parameters, BatchNorm statistics, the optimizer's slots and the step
    of each of JAX's five optimizers, restored into the port's state."""
    d, s = jax_dirs[opt]
    state = tstate.create_train_state(_torch_cfg(SMALL), device="cpu",
                                      optimizer=opt)
    mgr = tckpt.CheckpointManager(d)
    assert mgr.all_steps() == [2] and mgr.own_steps() == []
    mgr.restore(state)
    _assert_state_bitwise(state, s, opt)
    # inference reads params and batch_stats alone, whatever the optimizer
    sd = mgr.restore_inference()
    assert all(torch.equal(sd[k], v)
               for k, v in state.model.state_dict().items())


def test_restore_refuses_another_optimizer(jax_dirs):
    state = tstate.create_train_state(_torch_cfg(SMALL), device="cpu",
                                      optimizer="sgd")
    with pytest.raises(ValueError, match="optimizer is Adam, the state's SGD"):
        tckpt.CheckpointManager(jax_dirs["adam"][0]).restore(state)
    state = tstate.create_train_state(_torch_cfg(SMALL), device="cpu",
                                      optimizer="adam")
    with pytest.raises(ValueError, match="optimizer is AdamW"):
        tckpt.CheckpointManager(jax_dirs["adamw"][0]).restore(state)


def test_fonts_hard_full_width_restores_bit_for_bit(hard_dir):
    d, s, cfg = hard_dir
    state = tstate.create_train_state(_torch_cfg(cfg), device="cpu")
    tckpt.CheckpointManager(d).restore(state)
    _assert_state_bitwise(state, s, "adam")


def test_init_predictor_serves_a_jax_model_dir(hard_dir):
    """``init_predictor`` of JAX's ``fonts-hard`` directory on the 64
    golden lines (f32): JAX's ``init_predictor`` texts, scores rtol 1e-4;
    and the directory is left byte for byte as it was."""
    d = hard_dir[0]
    before = tree_digest(d)
    g = np.load(GOLDENS)
    c, hs, ws = g["hard_canvas"], g["hard_heights"], g["hard_widths"]
    lines = [c[i, :hs[i], :ws[i]] for i in range(len(hs))]
    want = jax_init_predictor(d).predict(lines)
    got = init_predictor(d, device="cpu").predict(lines)
    assert [p.text for p in got] == [p.text for p in want]
    assert sum(len(p.text) for p in got) > 64  # it reads text
    np.testing.assert_allclose([p.score for p in got],
                               [p.score for p in want], rtol=1e-4)
    assert tree_digest(d) == before


def test_steps_match_orbax(tmp_path):
    """``all_steps``, ``latest_step`` and ``best_step`` (track_metric
    "cer", saves with and without metrics, orbax's rotation) equal the JAX
    manager's; a port save lands beside orbax's steps and leaves them
    byte for byte unchanged, and rotation removes only the port's own."""
    d = str(tmp_path / "steps")
    jm = JaxCheckpoints(d, max_to_keep=2, track_metric="cer")
    tree = {"w": np.arange(3, dtype=np.float32)}
    cers = {1: 0.5, 2: None, 3: 0.2, 4: 0.4, 5: None, 6: 0.3}
    for step, cer in cers.items():
        jm.save(step, tree, metrics=None if cer is None else {"cer": cer})
        jm.wait()
        pm = tckpt.CheckpointManager(d, max_to_keep=2, track_metric="cer")
        assert pm.all_steps() == jm._mgr.all_steps()
        assert pm.latest_step() == jm.latest_step() == step
        assert pm.best_step() == jm.best_step()
    assert tckpt.CheckpointManager(d).best_step() == jm.latest_step()
    digests = {n: tree_digest(os.path.join(d, n)) for n in os.listdir(d)
               if n.isdigit()}
    pm = tckpt.CheckpointManager(d, max_to_keep=2, track_metric="cer")
    state = tstate.create_train_state(_torch_cfg(SMALL), device="cpu")
    for step, cer in ((7, 0.9), (8, 0.1), (9, None), (10, 0.05)):
        assert pm.save(step, state, metrics=None if cer is None
                       else {"cer": cer})
    assert not pm.save(10, state)  # not past the latest
    assert pm.own_steps() == [8, 9, 10]  # 7 rotated out; 9 has no metric
    assert pm.orbax_steps() == sorted(int(n) for n in digests)
    assert pm.latest_step() == 10 and pm.best_step() == 10
    assert {n: tree_digest(os.path.join(d, n)) for n in digests} == digests


def test_temporary_and_uncommitted_steps_are_not_steps(jax_dirs, tmp_path):
    d = str(tmp_path / "model")
    shutil.copytree(jax_dirs["sgd"][0], d)
    shutil.copytree(os.path.join(d, "2"),
                    os.path.join(d, "5.orbax-checkpoint-tmp-17"))
    shutil.copytree(os.path.join(d, "2"), os.path.join(d, "7"))
    os.remove(os.path.join(d, "7", orbax.COMMIT_FILE))
    assert tckpt.CheckpointManager(d).all_steps() == [2]


@pytest.mark.parametrize("fault", ["no_metadata", "zarr3", "manifest",
                                   "node", "compressor"])
def test_unreadable_checkpoints_raise(jax_dirs, tmp_path, fault):
    """What the reader does not read raises ``OrbaxCheckpointError``,
    naming it; a manifest or node without its magic is a damaged file,
    ``OrbaxCorruptError``."""
    d = str(tmp_path / "model")
    shutil.copytree(jax_dirs["sgd"][0], d)
    item = os.path.join(d, "2", "default")
    if fault == "no_metadata":
        os.remove(os.path.join(item, "_METADATA"))
        match = "_METADATA"
    elif fault == "zarr3":
        path = os.path.join(item, "_METADATA")
        meta = json.load(open(path))
        meta["use_zarr3"] = True
        json.dump(meta, open(path, "w"))
        match = "use_zarr3=True"
    elif fault == "manifest":
        with open(os.path.join(item, "manifest.ocdbt"), "r+b") as f:
            f.write(b"\0\0\0\0")
        match = "not an OCDBT manifest"
    elif fault == "node":
        # the root node's file: the one data file of the root database
        (name,) = os.listdir(os.path.join(item, "d"))
        with open(os.path.join(item, "d", name), "r+b") as f:
            f.write(b"\0\0\0\0")
        match = "not an OCDBT node"
    else:
        store = orbax.OcdbtStore(item)
        meta = json.loads(store.read(b"params.logits.kernel/.zarray"))
        meta["compressor"] = {"id": "blosc"}
        store._values[b"params.logits.kernel/.zarray"] = (
            None, json.dumps(meta).encode(), 0)
        with pytest.raises(orbax.OrbaxCheckpointError, match="blosc"):
            orbax.read_zarr(store, "params.logits.kernel")
        return
    damaged = fault in ("manifest", "node")
    state = tstate.create_train_state(_torch_cfg(SMALL), device="cpu",
                                      optimizer="sgd")
    with pytest.raises(tckpt.OrbaxCorruptError if damaged
                       else tckpt.OrbaxCheckpointError, match=match):
        tckpt.CheckpointManager(d).restore(state)
    with pytest.raises(ValueError if damaged else NotImplementedError,
                       match="damaged orbax" if damaged
                       else "unreadable orbax"):
        init_predictor(d, device="cpu")


def _flip_middle_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("fault", ["node_byte", "manifest_byte",
                                   "manifest_cut", "node_cut", "node_gone"])
def test_damaged_checkpoints_raise(jax_dirs, tmp_path, fault):
    """A damaged file raises ``OrbaxCorruptError`` (a ``ValueError``),
    naming the file: a byte changed inside a manifest or the root node
    (zstd-compressed: the crc32c, checked before the body is inflated),
    a file cut short, a node's file gone."""
    d = str(tmp_path / "model")
    shutil.copytree(jax_dirs["sgd"][0], d)
    item = os.path.join(d, "2", "default")
    (node,) = os.listdir(os.path.join(item, "d"))
    node = os.path.join(item, "d", node)
    manifest = os.path.join(item, "manifest.ocdbt")
    if fault.endswith("_byte"):
        _flip_middle_byte(node if fault == "node_byte" else manifest)
        match = "crc32c mismatch"
    elif fault.endswith("_cut"):
        path = node if fault == "node_cut" else manifest
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        match = "length field disagrees"
    else:
        os.remove(node)
        match = "No such file"
    state = tstate.create_train_state(_torch_cfg(SMALL), device="cpu",
                                      optimizer="sgd")
    with pytest.raises(orbax.OrbaxCorruptError, match=match):
        tckpt.CheckpointManager(d).restore(state)
    with pytest.raises(ValueError, match="damaged orbax checkpoint"):
        init_predictor(d, device="cpu")


def test_uncompressed_node_checked(tmp_path):
    """A store written with compression none keeps its nodes' bytes in
    the clear: a changed byte is caught by the crc32c, where it would
    otherwise read as a different key or value."""
    root = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"compression": None}}).result()
    with ts.Transaction() as txn:  # one commit: one node file
        for i in range(20):
            kv.with_transaction(txn)[f"key/{i:03d}"] = f"value {i}".encode()
    assert orbax.OcdbtStore(root).read(b"key/007") == b"value 7"
    (node,) = os.listdir(os.path.join(root, "d"))
    _flip_middle_byte(os.path.join(root, "d", node))
    with pytest.raises(orbax.OrbaxCorruptError, match="crc32c mismatch"):
        orbax.OcdbtStore(root)


@pytest.mark.parametrize("n", [0, 1, 9, 1000, 65537])
def test_crc32c_matches_google_crc32c(n):
    import google_crc32c

    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    assert orbax.crc32c(data) == int.from_bytes(
        google_crc32c.Checksum(data).digest(), "big")
    assert orbax.crc32c(b"123456789") == 0xE3069283


def test_zarr_chunk_grid_and_fill(tmp_path):
    """A general chunk grid (edge chunks stored whole), a missing chunk
    filled with ``fill_value``, and the dtypes: zarr v2 arrays that
    tensorstore writes into an OCDBT store, read back equal."""
    root = str(tmp_path / "zarr")
    base = {"driver": "ocdbt", "base": f"file://{root}/"}
    rng = np.random.default_rng(5)
    arrays = {
        "f4": rng.normal(size=(7, 5, 3)).astype(np.float32),
        "i4": rng.integers(-9, 9, (10, 4)).astype(np.int32),
        "f8": rng.normal(size=(9,)),
        "b1": rng.integers(0, 2, (6, 6)).astype(bool),
        "bf": rng.normal(size=(5, 4)).astype(np.float32),
    }
    chunks = {"f4": [3, 2, 3], "i4": [4, 3], "f8": [4], "b1": [6, 6],
              "bf": [2, 4]}
    for name, a in arrays.items():
        dtype = "bfloat16" if name == "bf" else a.dtype.name
        spec = {"driver": "zarr", "kvstore": {**base, "path": f"{name}/"},
                "metadata": {"shape": list(a.shape), "chunks": chunks[name],
                             "dtype": {"float32": "<f4", "int32": "<i4",
                                       "float64": "<f8", "bool": "|b1",
                                       "bfloat16": "bfloat16"}[dtype],
                             "fill_value": 3 if name == "i4" else None,
                             "compressor": {"id": "zstd", "level": 3}},
                "create": True}
        t = ts.open(spec).result()
        if name == "i4":  # rows 4-7 never written: their chunks are absent
            t[:4].write(a[:4]).result()
            t[8:].write(a[8:]).result()
            a[4:8] = 3
        elif name == "bf":
            t.write(a.astype(ts.bfloat16.numpy_dtype)).result()
            arrays[name] = a.astype(ts.bfloat16.numpy_dtype).astype(
                np.float32)
        else:
            t.write(a).result()
    store = orbax.OcdbtStore(root)
    for name, a in arrays.items():
        got = orbax.read_zarr(store, name)
        assert got.dtype == (np.float32 if name == "bf" else a.dtype)
        np.testing.assert_array_equal(got, a, err_msg=name)


# ---- the committed fixture and resuming a JAX run ----

def _fixture_batch(g, cfg, device="cpu"):
    truth = [str(t) for t in g["truth"]]
    codec = tckpt.load_codec(os.path.join(TESTDATA, "orbax_small"))
    labels, lab_len = codec.encode_batch(truth, 32)
    host = {"the_input": g["canvas"], "heights": g["heights"],
            "widths": g["widths"], "the_labels": labels,
            "label_length": lab_len, "bucket": int(g["bucket"]),
            "texts": truth}
    return tpipe.produce_batch(host, device, cfg)


def _assert_close_but_noise(got, want, noise, lr):
    """A state dict after the port's step against JAX's: rtol 2e-4 / atol
    2e-5, but for gradient elements at the noise of their sums (``noise``:
    a mask per parameter, from JAX's gradient), at most 0.1 % of a tensor,
    within ``2 * lr``."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        v = got[k].float().numpy()
        off = np.abs(v - w) > 2e-5 + 2e-4 * np.abs(w)
        if k not in noise:
            assert not off.any(), k
            continue
        assert not np.any(off & ~noise[k]), (k, np.abs(v - w)[off].max())
        assert off.mean() <= 1e-3, k
        assert np.all(np.abs(v - w)[off] <= 2 * lr), k


def _noise_masks(grads) -> dict:
    """Each parameter's elements whose gradient is at most 1e-5 of its
    tensor's largest (``tests/test_torch_train.py``'s rule)."""
    return {k: np.abs(v) <= 1e-5 * np.abs(v).max() for k, v in grads.items()}


def _assert_step_close(got, g, grads_named):
    """``_assert_close_but_noise`` against the fixture's JAX step:
    ``after/`` and the packed masks ``noise/``."""
    noise = {}
    for k in grads_named:
        shape = tuple(g[f"noise_shape/{k}"])
        bits = np.unpackbits(g[f"noise/{k}"])[:int(np.prod(shape))]
        noise[k] = bits.reshape(shape).astype(bool)
    _assert_close_but_noise(got, {k: g[f"after/{k}"] for k in got}, noise,
                            float(g["lr"]))


def test_committed_fixture_steps_as_jax():
    """The card's fixture (``tools/gen_torch_goldens.py --orbax``) on the
    CPU: restored into an Adam state, one f32 step of the port equals
    JAX's third step (``orbax_goldens.npz``)."""
    d = os.path.join(TESTDATA, "orbax_small")
    g = np.load(os.path.join(TESTDATA, "orbax_goldens.npz"))
    before = tree_digest(d)
    cfg = tckpt.load_model_config(d)
    state = tstate.create_train_state(cfg, device="cpu",
                                      learning_rate=float(g["lr"]))
    tckpt.CheckpointManager(d).restore(state)
    assert state.step == int(g["step"]) == 2
    m = tstep.make_train_step(cfg)(state, _fixture_batch(g, cfg))
    np.testing.assert_allclose(float(m["loss"]), float(g["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(g["grad_norm"]),
                               rtol=2e-3)
    _assert_step_close(state.model.state_dict(), g,
                       dict(state.model.named_parameters()))
    assert state.step == 3
    assert tree_digest(d) == before


RESUME_FLAGS = ["--dataset", "synthetic", "--buckets", "64",
                "--eval_every", "100", "--log_every", "1", "--batch_size",
                "8", "--n_units", "16", "--time_dense_size", "16",
                "--rnn_layers", "1", "--dropout", "0", "--lr", "1e-4",
                "--seed", "0"]


def _jax_grads(state, batch, model_cfg) -> dict:
    """JAX's gradient of the train step's loss (``_train_step_fn``'s
    ``loss_fn``: dropout 0, no mask) at ``state``, as the port's
    parameter names."""
    import jax.numpy as jnp
    from crnn_ocr_tpu.train.step import ctc_loss_vec

    def loss_fn(p):
        logits, _ = state.apply_fn(
            {"params": p, "batch_stats": state.batch_stats},
            batch["x"][..., None], train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        vec = ctc_loss_vec(logits, batch["the_labels"], batch["input_length"],
                           batch["label_length"], model_cfg.ctc_time_slice)
        return jnp.mean(jnp.minimum(vec, 1e4))

    grads = params_from_jax(_np(jax.grad(loss_fn)(state.params)),
                            _np(state.batch_stats))
    return {k: v.numpy() for k, v in grads.items()
            if not k.endswith(("running_mean", "running_var"))}


def test_cli_train_resumes_a_jax_run(tmp_path, monkeypatch, capsys):
    """JAX's ``cli.train`` runs 2 steps into an orbax directory; the
    port's ``cli.train --resume --device cpu`` takes the third from it,
    as JAX's own resume does from a copy: the logged loss rtol 2e-5, the
    saved state at the train-parity tolerances (off elements only where
    JAX's gradient of that step is at noise level, within ``2 * lr``).
    The port's step lands as ``3/checkpoint.pt`` beside orbax's step 2,
    which is left byte for byte unchanged. A resume from a damaged orbax
    step fails naming the damage, not an optimizer mismatch."""
    import itertools

    import crnn_ocr_tpu.train as jtrain
    from crnn_ocr_torch.cli.train import main as port_train
    from crnn_ocr_tpu.cli.train import main as jax_train

    jdir, jcopy = str(tmp_path / "jax"), str(tmp_path / "jax_resumed")
    assert jax_train([*RESUME_FLAGS, "--steps", "2", "--save_path",
                      jdir]) == 0
    shutil.copytree(jdir, jcopy)
    real_fit, grads = jtrain.fit, {}

    def fit_recording_grads(state, model_cfg, train_iter, **kw):
        # the resumed run's first batch, at the restored state (fit
        # donates the state's buffers)
        batch = next(train_iter)
        grads.update(_jax_grads(state, batch, model_cfg))
        return real_fit(state, model_cfg,
                        itertools.chain([batch], train_iter), **kw)

    monkeypatch.setattr(jtrain, "fit", fit_recording_grads)
    orbax_before = tree_digest(os.path.join(jdir, "2"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_train, [*RESUME_FLAGS, "--steps", "3",
                                        "--resume", "--device", "cpu",
                                        "--save_path", jdir])
        assert jax_train([*RESUME_FLAGS, "--steps", "3", "--resume",
                          "--save_path", jcopy]) == 0
        assert port.result() == 0
    assert os.path.exists(os.path.join(jdir, "3", tckpt.CKPT_FILE))
    assert tree_digest(os.path.join(jdir, "2")) == orbax_before

    def last_loss(d):
        rows = [json.loads(r) for r in open(os.path.join(d, "metrics.jsonl"))]
        return [r for r in rows if r["kind"] == "train"][-1]

    got, want = last_loss(jdir), last_loss(jcopy)
    assert got["step"] == want["step"] == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    jp, js = JaxCheckpoints(jcopy).restore_inference(None, None)
    want_sd = params_from_jax(_np(jp), _np(js))
    start = tckpt.CheckpointManager(jdir).restore_inference(step=2)
    got_sd = tckpt.CheckpointManager(jdir).restore_inference()
    assert sorted(grads) == sorted(k for k in want_sd if "running" not in k)
    _assert_close_but_noise(got_sd, {k: w.numpy() for k, w in want_sd.items()},
                            _noise_masks(grads), lr=1e-4)
    for k in grads:  # the step moved the parameters
        assert not torch.equal(got_sd[k], start[k]), k
    item = os.path.join(jcopy, "3", "default")
    (node,) = os.listdir(os.path.join(item, "d"))
    _flip_middle_byte(os.path.join(item, "d", node))
    capsys.readouterr()
    assert port_train([*RESUME_FLAGS, "--steps", "4", "--resume",
                       "--device", "cpu", "--save_path", jcopy]) == 2
    assert "resume failed: damaged orbax checkpoint" in \
        capsys.readouterr().err

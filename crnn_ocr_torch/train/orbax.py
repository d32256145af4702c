"""Read the JAX package's orbax checkpoints, in numpy and ctypes alone.

``crnn_ocr_tpu/train/checkpoint.py`` saves a whole ``TrainState`` (params,
batch_stats, opt_state, step) through orbax's ``CheckpointManager`` with
its defaults. A step directory then holds::

  <step>/_CHECKPOINT_METADATA     JSON; written last, at the commit
  <step>/metrics/metrics          JSON of the save's metrics, if any
  <step>/default/_METADATA        JSON: "tree_metadata", one entry per
                                  leaf with its key path ("key_metadata")
  <step>/default/manifest.ocdbt   an OCDBT key-value store (tensorstore's
  <step>/default/d/...            "optionally-cooperative distributed
  <step>/default/ocdbt.process_0/ B+tree"): the manifest, b-tree nodes
                                  and value files

and each leaf is a zarr v2 array inside the store, under its key path
joined by ``.``: ``params.logits.kernel/.zarray`` (JSON) and its chunks
``params.logits.kernel/0.0``. Orbax writes no other format with the JAX
package's settings; what this module does not read raises
``OrbaxCheckpointError``, naming it. A damaged file (truncated, or failing
its magic, length field or checksum) raises ``OrbaxCorruptError``.

The OCDBT store (``OcdbtStore``). The manifest and each b-tree node are
``magic (u32 big-endian) | length (u64) | version (varint, 0) |
compression (varint: 0 none, 1 zstd) | body | crc32c (u32 little-endian,
of every byte before it)``; the checksum is verified. The manifest's
body is the config (uuid, manifest kind, inline-value limit, node-size
limit, version-tree arity, compression and its level), then the
versions: a data-file table and, column by column, each version's
generation, root height and root node location (file, offset, length)
with its statistics and commit time. The latest generation's root is
read. A node's body is its height, a
data-file table (paths relative to the store, prefix-compressed, each
prefixed with the base path of the file that holds the node), then its
entries column by column: keys prefix-compressed against the previous
key; in an interior node each child's location, statistics and the
length of the key prefix that its whole subtree shares (the child's keys
omit it); in a leaf each value's length and kind, inline (in the node) or
indirect (a byte range of a data file). Values are read as stored (the
store keeps no checksum of a value; a zstd frame's own is checked where
the writer added one).

The zarr arrays (``read_zarr``): ``.zarray`` with ``zarr_format`` 2, C
order, no filters, the zstd compressor or none, any chunk grid (edge
chunks stored whole) with the ``.`` separator (a 0-d array's chunk is
``0``), a missing chunk filled with ``fill_value``; numeric numpy dtypes,
``bool`` and ``bfloat16`` (returned as f32, exactly).

The train state (``read_train_state``): the tree built from
``_METADATA``'s key paths (empty optax states kept as ``None``, so a
chain's length shows), with ``params`` and ``batch_stats`` mapped onto the
port's CRNN through ``infer.weights.params_from_jax``, and the optimizer
found from its slots (``crnn_ocr_tpu/train/state.py:71-96``: each behind
``clip_by_global_norm``) and mapped onto the port's optimizer state with
the same transposes: Adam and AdamW ``mu``/``nu``/``count`` ->
``exp_avg``/``exp_avg_sq``/``step`` (AdamW's chain has a third entry, the
weight decay), SGD ``trace`` -> ``momentum_buffer``, RMSprop ``nu`` ->
``nu``, Adadelta ``e_g``/``e_x`` -> ``square_avg``/``acc_delta`` (its
``step``, which the update never reads, from the train state's).
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crnn_ocr_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ITEM = "default"
COMMIT_FILE = "_CHECKPOINT_METADATA"
_MISSING = (1 << 64) - 1  # an empty tree's root offset and length


class OrbaxCheckpointError(NotImplementedError):
    """A file of an orbax checkpoint that the port cannot read."""

    def __str__(self) -> str:
        return f"unreadable orbax checkpoint: {super().__str__()}"


class OrbaxCorruptError(ValueError):
    """A damaged file of an orbax checkpoint: missing, truncated, or failing
    its magic, length field or checksum."""

    def __str__(self) -> str:
        return f"damaged orbax checkpoint: {super().__str__()}"


def _crc32c_table() -> List[int]:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = (c >> 1) ^ np.where(c & 1, np.uint32(0x82F63B78), np.uint32(0))
    return c.tolist()


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), which seals OCDBT's manifests and nodes."""
    t, c = _CRC32C, 0xFFFFFFFF
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OrbaxCorruptError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def le(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _decode(raw: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "node"
        raise OrbaxCorruptError(f"{what}: not an OCDBT {kind}")
    c = _Cursor(raw, what)
    c.take(4)
    if c.le(8) != len(raw):
        raise OrbaxCorruptError(f"{what}: its length field disagrees")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OrbaxCorruptError(f"{what}: crc32c mismatch")
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise OrbaxCheckpointError(f"{what}: format version {version}")
    body = raw[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OrbaxCheckpointError(f"{what}: compression {compression}")


def _file_table(c: _Cursor, base: str) -> List[Tuple[str, str]]:
    """(base path, full path) of each data file of a table."""
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    base_len = c.varints(n)
    out, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + c.take(suffix[i])
        prev = path
        out.append((base + path[:base_len[i]].decode(), base + path.decode()))
    return out


def _keys(c: _Cursor, n: int, subtree: bool):
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    common = c.varints(n) if subtree else [0] * n
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The keys and values of the OCDBT store at ``root`` (a directory), as
    its latest version holds them: ``list()`` and ``read(key)``, as
    tensorstore's ``KvStore`` gives them."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, bytes] = {}
        self._values: Dict[bytes, tuple] = {}
        raw = self._file("manifest.ocdbt")
        what = os.path.join(root, "manifest.ocdbt")
        c = _Cursor(_decode(raw, MANIFEST_MAGIC, what), what)
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            raise OrbaxCheckpointError(
                f"{what}: a numbered manifest (kind {kind}); only single")
        c.varint(), c.varint(), c.u8()  # value and node limits, arity
        method = c.varint()
        if method == 1:
            c.take(4)  # zstd level
        elif method != 0:
            raise OrbaxCheckpointError(f"{what}: compression method {method}")
        files = _file_table(c, "")
        n = c.varint()
        gen = c.varints(n)
        height = [c.u8() for _ in range(n)]
        loc = list(zip(c.varints(n), c.varints(n), c.varints(n)))
        if not n:
            return
        i = max(range(n), key=gen.__getitem__)
        fid, off, length = loc[i]
        if off != _MISSING:
            self._walk(files[fid], off, length, height[i], b"")

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            try:
                with open(path, "rb") as f:
                    self._files[rel] = f.read()
            except OSError as e:
                raise OrbaxCorruptError(f"{path}: {e}") from e
        return self._files[rel]

    def _walk(self, file: Tuple[str, str], off: int, length: int,
              height: int, prefix: bytes) -> None:
        base, path = file
        what = f"{os.path.join(self.root, path)}@{off}"
        raw = self._file(path)[off:off + length]
        c = _Cursor(_decode(raw, NODE_MAGIC, what), what)
        if c.u8() != height:
            raise OrbaxCheckpointError(f"{what}: height differs from its "
                                       "parent's record")
        files = _file_table(c, base)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)
        if height > 0:
            fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            for k, cp, fid, o, ln in zip(keys, common, fids, offs, lens):
                self._walk(files[fid], o, ln, height - 1, prefix + k[:cp])
            return
        lens = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OrbaxCheckpointError(f"{what}: value kinds {set(kinds)}")
        fids, offs = c.varints(len(indirect)), c.varints(len(indirect))
        ref = dict(zip(indirect, zip(fids, offs)))
        for i, k in enumerate(keys):
            if i in ref:
                fid, o = ref[i]
                self._values[prefix + k] = (files[fid][1], o, lens[i])
            else:
                self._values[prefix + k] = (None, c.take(lens[i]), lens[i])

    def list(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def read(self, key: bytes) -> bytes:
        path, where, length = self._values[key]
        if path is None:
            return where
        out = self._file(path)[where:where + length]
        if len(out) != length:
            raise OrbaxCorruptError(
                f"{os.path.join(self.root, path)}: value of {key!r} runs "
                "past the file's end")
        return out


def _dtype(name: str, what: str):
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise OrbaxCheckpointError(f"{what}: dtype {name!r}") from e
    if dt.kind not in "biuf":
        raise OrbaxCheckpointError(f"{what}: dtype {name!r}")
    return dt


def _fill(value):
    """zarr's JSON fill value as a number (None: zero)."""
    if value is None:
        return 0
    if isinstance(value, str):  # the JSON names of non-finite floats
        return {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}[value]
    return value


def read_zarr(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    what = f"{store.root}:{name}"
    meta = json.loads(store.read(f"{name}/.zarray".encode()))
    if meta.get("zarr_format") != 2:
        raise OrbaxCheckpointError(f"{what}: zarr format "
                                   f"{meta.get('zarr_format')}")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise OrbaxCheckpointError(f"{what}: order {meta.get('order')!r}, "
                                   f"filters {meta.get('filters')!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxCheckpointError(f"{what}: compressor {comp!r}")
    dt = _dtype(meta["dtype"], what)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    if meta["dtype"] == "bfloat16" and meta.get("fill_value") is not None:
        raise OrbaxCheckpointError(f"{what}: a bfloat16 fill value")
    out = np.full(shape, _fill(meta.get("fill_value")), dt)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{sep.join(map(str, idx)) if shape else '0'}".encode()
        if key not in store:
            continue
        raw = store.read(key)
        if comp is not None:
            try:
                raw = zstd.decompress(raw, size_hint=nbytes)
            except ValueError as e:
                raise OrbaxCorruptError(f"{what}: chunk {key!r}: {e}") from e
        if len(raw) != nbytes:
            raise OrbaxCorruptError(f"{what}: chunk {key!r} holds "
                                    f"{len(raw)} bytes, not {nbytes}")
        chunk = np.frombuffer(raw, dt).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = chunk[
            tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if meta["dtype"] == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


# ---- step directories ----

def is_step(path: str) -> bool:
    """Whether ``path`` is a committed orbax step directory (orbax writes
    ``_CHECKPOINT_METADATA`` last; its temporary directories are named
    ``<step>.orbax-checkpoint-tmp-<n>``)."""
    return os.path.isfile(os.path.join(path, COMMIT_FILE))


def read_metrics(step_dir: str) -> Optional[dict]:
    """The metrics that were saved with the step, else None."""
    try:
        with open(os.path.join(step_dir, "metrics", "metrics")) as f:
            return json.load(f)
    except OSError:
        pass
    with open(os.path.join(step_dir, COMMIT_FILE)) as f:
        return json.load(f).get("metrics") or None


def read_tree(step_dir: str, top: Optional[Tuple[str, ...]] = None) -> dict:
    """The saved pytree of ``<step_dir>/default`` as nested dicts (sequence
    entries keyed ``"0"``, ``"1"``, ...) of numpy arrays, with ``None``
    for the empty nodes that orbax records and does not store; with
    ``top``, only the subtrees under those top-level keys."""
    item = os.path.join(step_dir, ITEM)
    try:
        with open(os.path.join(item, "_METADATA")) as f:
            meta = json.load(f)
    except OSError as e:
        raise OrbaxCheckpointError(f"{item}: no readable _METADATA "
                                   f"({e})") from e
    if meta.get("use_zarr3") or not meta.get("use_ocdbt"):
        raise OrbaxCheckpointError(
            f"{item}: use_ocdbt={meta.get('use_ocdbt')}, use_zarr3="
            f"{meta.get('use_zarr3')}; only OCDBT with zarr v2")
    store = OcdbtStore(item)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if top is not None and keys[0] not in top:
            continue
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if entry["value_metadata"].get("skip_deserialize"):
            node.setdefault(keys[-1], None)
        else:
            node[keys[-1]] = read_zarr(store, ".".join(keys))
    return tree


# ---- the train state ----

# optax slot names -> the port's optimizer state keys, by optimizer class
SLOTS = {
    "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "AdamW": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "SGD": {"trace": "momentum_buffer"},
    "RMSprop": {"nu": "nu"},
    "Adadelta": {"e_g": "square_avg", "e_x": "acc_delta"},
}


def _find_optimizer(opt_state, where: str):
    """(optimizer class name, the optax state holding its slots)."""
    found = []

    def walk(node, parent):
        if not isinstance(node, dict):
            return
        keys = set(node)
        if {"mu", "nu", "count"} <= keys:
            found.append(("AdamW" if parent is not None and len(parent) == 3
                          else "Adam", node))
        elif "trace" in keys:
            found.append(("SGD", node))
        elif {"e_g", "e_x"} <= keys:
            found.append(("Adadelta", node))
        elif "nu" in keys:
            found.append(("RMSprop", node))
        else:
            for v in node.values():
                walk(v, node)

    walk(opt_state, None)
    if len(found) != 1:
        raise OrbaxCheckpointError(
            f"{where}: found {len(found)} optimizer states in opt_state; "
            "expected one of adam, adamw, sgd, rmsprop, adadelta")
    return found[0]


def state_dict_of(tree: dict) -> Dict[str, torch.Tensor]:
    """The CRNN state_dict of a saved tree's params and batch_stats."""
    from crnn_ocr_torch.infer.weights import params_from_jax

    return params_from_jax(tree["params"], tree["batch_stats"])


def optimizer_state(tree: dict, model, optimizer, where: str) -> dict:
    """The ``optimizer.state_dict()`` that the saved optax state maps to;
    raises ``ValueError`` if the saved optimizer is not ``optimizer``'s."""
    from crnn_ocr_torch.infer.weights import params_from_jax

    name, slots = _find_optimizer(tree["opt_state"], where)
    mine = type(optimizer).__name__
    if name != mine:
        raise ValueError(f"the checkpoint's optimizer is {name}, the "
                         f"state's {mine}")
    per_slot = {key: params_from_jax(slots[slot], tree["batch_stats"])
                for slot, key in SLOTS[name].items()}
    if "count" in slots:
        step = float(slots["count"])
    else:
        step = float(tree["step"])
    names = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    state = {}
    for i, p in enumerate(optimizer.param_groups[0]["params"]):
        st = {key: per_slot[key][names[id(p)]] for key in per_slot}
        if name in ("Adam", "AdamW", "Adadelta"):
            st["step"] = torch.tensor(step, dtype=torch.float32)
        state[i] = st
    return {"state": state, "param_groups": sd["param_groups"]}


def read_train_state(step_dir: str) -> dict:
    """The saved tree of an orbax step directory of a ``TrainState``."""
    tree = read_tree(step_dir)
    missing = {"params", "batch_stats", "step"} - set(tree)
    if missing:
        raise OrbaxCheckpointError(f"{step_dir}: not a train state (no "
                                   f"{sorted(missing)})")
    return tree

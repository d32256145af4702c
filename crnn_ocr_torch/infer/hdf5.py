"""A minimal HDF5 reader and writer for Keras ``.h5`` weight files, in numpy
alone.

The machine with the card has no ``h5py``, and the bundled models ship as
Keras ``.h5`` files (``crnn_ocr_tpu/pretrained/<dir>/weights.h5``). This
reads the part of the HDF5 format that ``h5py`` writes by default (the
"earliest" file format, which Keras and ``export_keras_h5`` both use):

* superblock version 0 with 8-byte offsets and lengths;
* version-1 object headers and their continuation blocks;
* groups as symbol tables (a version-1 B-tree of symbol-table nodes over a
  local heap);
* datasets of fixed-size numbers (little- or big-endian floats and
  integers) in contiguous or compact storage;
* attributes of numbers, fixed-length strings or variable-length strings
  (kept in global heap collections).

Anything else (chunked or compressed datasets, new-style groups, other
superblocks) raises ``NotImplementedError`` naming what it met.

    f = H5File(path)
    names = f.attrs("/")["layer_names"]       # list of str
    kernel = f.dataset("/stem_conv/stem_conv/kernel:0")  # np.ndarray

``H5Writer`` writes the same subset, as ``h5py`` lays it out: superblock
version 0 with 8-byte offsets, version-1 object headers (no continuation
blocks), groups as symbol tables (one version-1 B-tree node over up to 32
symbol-table nodes of 8 entries, names in byte order, over a local heap),
contiguous little-endian float32 datasets (not empty, not scalar: what
``export_keras_h5`` writes), and attributes of fixed-length (null-padded)
strings and string arrays. The port's ``H5File`` and ``h5py`` both read
its files
(``tests/test_torch_hdf5_write.py``).

    w = H5Writer()
    w.set_attr("/", "layer_names", ["stem_conv"])
    w.create_dataset("/stem_conv/stem_conv/kernel:0", kernel)
    w.save(path)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
DATASPACE, DATATYPE, LAYOUT, ATTRIBUTE, CONTINUATION, SYMBOL_TABLE = (
    0x1, 0x3, 0x8, 0xC, 0x10, 0x11)


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


class H5File:
    """Read-only view of an HDF5 file held in memory."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.path = path
        if self.buf[:8] != SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file")
        if self.buf[8] != 0:
            raise NotImplementedError(
                f"{path}: HDF5 superblock version {self.buf[8]} (only 0)")
        if self.buf[13] != 8 or self.buf[14] != 8:
            raise NotImplementedError(
                f"{path}: offsets of {self.buf[13]} and lengths of "
                f"{self.buf[14]} bytes (only 8)")
        # the root group's symbol-table entry: its object header address
        self.root = self._u(64, 8)

    def _u(self, off: int, n: int) -> int:
        return int.from_bytes(self.buf[off:off + n], "little")

    def _messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, data offset, data size) of each message of the version-1
        object header at ``addr``, continuation blocks included."""
        if self.buf[addr] != 1:
            raise NotImplementedError(
                f"{self.path}: object header version {self.buf[addr]} at "
                f"{addr} (only 1)")
        blocks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            p = start
            while p + 8 <= start + size:
                mtype, msize = self._u(p, 2), self._u(p + 2, 2)
                data = p + 8
                if mtype == CONTINUATION:
                    blocks.append((self._u(data, 8), self._u(data + 8, 8)))
                out.append((mtype, data, msize))
                p = data + msize
        return out

    def _cstring(self, off: int) -> str:
        end = self.buf.index(b"\0", off)
        return self.buf[off:end].decode()

    def _children(self, addr: int) -> Dict[str, int]:
        """{name: object header address} of the group at ``addr``."""
        msgs = [m for m in self._messages(addr) if m[0] == SYMBOL_TABLE]
        if not msgs:
            raise NotImplementedError(
                f"{self.path}: the object at {addr} is not a symbol-table "
                "group")
        data = msgs[0][1]
        btree, heap = self._u(data, 8), self._u(data + 8, 8)
        if self.buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        names_at = self._u(heap + 24, 8)
        out: Dict[str, int] = {}
        for node in self._btree_leaves(btree):
            if self.buf[node:node + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol node at {node}")
            for i in range(self._u(node + 6, 2)):
                entry = node + 8 + 40 * i
                name = self._cstring(names_at + self._u(entry, 8))
                out[name] = self._u(entry + 8, 8)
        return out

    def _btree_leaves(self, addr: int) -> List[int]:
        """The symbol-table nodes under the group B-tree node at ``addr``
        (version 1: keys and children interleaved, 8 bytes each)."""
        if self.buf[addr:addr + 4] != b"TREE":
            raise ValueError(f"{self.path}: no B-tree node at {addr}")
        level, used = self.buf[addr + 5], self._u(addr + 6, 2)
        kids = [self._u(addr + 32 + 16 * i, 8) for i in range(used)]
        if level == 0:
            return kids
        return [leaf for k in kids for leaf in self._btree_leaves(k)]

    def _lookup(self, path: str) -> int:
        addr = self.root
        for part in (p for p in path.split("/") if p):
            kids = self._children(addr)
            if part not in kids:
                raise KeyError(f"{path!r} not in {self.path} (at {part!r}: "
                               f"has {sorted(kids)})")
            addr = kids[part]
        return addr

    def keys(self, path: str = "/") -> List[str]:
        return list(self._children(self._lookup(path)))

    def has(self, path: str) -> bool:
        try:
            self._lookup(path)
        except KeyError:
            return False
        return True

    # ---- values ----

    def _shape(self, off: int) -> Tuple[int, ...]:
        """A dataspace message: version 1 (dims after 8 bytes) or 2 (after
        4; type 2 is the null dataspace, which holds no element)."""
        version, ndims = self.buf[off], self.buf[off + 1]
        if version == 1:
            first = off + 8
        elif version == 2:
            if self.buf[off + 3] == 2:
                return (0,)
            first = off + 4
        else:
            raise NotImplementedError(f"dataspace version {version}")
        return tuple(self._u(first + 8 * i, 8) for i in range(ndims))

    def _dtype(self, off: int):
        """A datatype message -> numpy dtype, or "vlen_str" / ("str", n)."""
        cls, bits, size = self.buf[off] & 0x0F, self.buf[off + 1], \
            self._u(off + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 1:  # floating point
            return np.dtype(f"{order}f{size}")
        if cls == 0:  # fixed-point: bit 3 is signed
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
        if cls == 3:
            return ("str", size)
        if cls == 9 and bits & 0x0F == 1:  # variable-length string
            return "vlen_str"
        raise NotImplementedError(f"{self.path}: datatype class {cls}")

    def _global_object(self, collection: int, index: int) -> bytes:
        if self.buf[collection:collection + 4] != b"GCOL":
            raise ValueError(f"{self.path}: no global heap at {collection}")
        end = collection + self._u(collection + 8, 8)
        p = collection + 16
        while p + 16 <= end:
            idx, size = self._u(p, 2), self._u(p + 8, 8)
            if idx == 0:
                break
            if idx == index:
                return self.buf[p + 16:p + 16 + size]
            p += 16 + _pad8(size)
        raise ValueError(f"{self.path}: no object {index} in the global "
                         f"heap at {collection}")

    def _values(self, dtype, shape, data: int, nbytes: int):
        count = int(np.prod(shape)) if shape else 1
        if dtype == "vlen_str":
            out = []
            for i in range(count):
                e = data + 16 * i  # length, collection address, index
                raw = self._global_object(self._u(e + 4, 8),
                                          self._u(e + 12, 4))
                out.append(raw[:self._u(e, 4)].decode())
            return out
        if isinstance(dtype, tuple):
            n = dtype[1]
            return [self.buf[data + n * i:data + n * (i + 1)].split(b"\0")[0]
                    .decode() for i in range(count)]
        if count * dtype.itemsize > nbytes:
            raise ValueError(f"{self.path}: {count} values of {dtype} do not "
                             f"fit {nbytes} bytes")
        arr = np.frombuffer(self.buf, dtype, count, data)
        return arr.reshape(shape).astype(dtype.newbyteorder("="))

    def dataset(self, path: str) -> np.ndarray:
        msgs = {t: (d, n) for t, d, n in self._messages(self._lookup(path))}
        if LAYOUT not in msgs:
            raise ValueError(f"{self.path}: {path!r} is not a dataset")
        shape = self._shape(msgs[DATASPACE][0])
        dtype = self._dtype(msgs[DATATYPE][0])
        lay = msgs[LAYOUT][0]
        version, cls = self.buf[lay], self.buf[lay + 1]
        if version != 3:
            raise NotImplementedError(f"{self.path}: {path!r} has a layout "
                                      f"message of version {version} (only 3)")
        if cls == 0:  # compact: the data sits in the message
            return self._values(dtype, shape, lay + 4, self._u(lay + 2, 2))
        if cls != 1:
            raise NotImplementedError(f"{self.path}: {path!r} is chunked "
                                      "(only contiguous or compact storage)")
        addr, nbytes = self._u(lay + 2, 8), self._u(lay + 10, 8)
        if addr == UNDEFINED:  # never written: the fill value, 0 here
            return np.zeros(shape, dtype)
        return self._values(dtype, shape, addr, nbytes)

    def attrs(self, path: str) -> dict:
        """{name: value}: a list for array attributes (of str for strings),
        a scalar for scalar ones."""
        out = {}
        for mtype, d, size in self._messages(self._lookup(path)):
            if mtype != ATTRIBUTE:
                continue
            version = self.buf[d]
            name_n, type_n, space_n = (self._u(d + 2, 2), self._u(d + 4, 2),
                                       self._u(d + 6, 2))
            pad = _pad8 if version == 1 else (lambda n: n)
            p = d + (9 if version == 3 else 8)
            name = self._cstring(p)
            p += pad(name_n)
            dtype = self._dtype(p)
            p += pad(type_n)
            shape = self._shape(p)
            p += pad(space_n)
            vals = self._values(dtype, shape, p, d + size - p)
            if isinstance(vals, np.ndarray):
                vals = vals.reshape(-1).tolist()
            out[name] = vals[0] if shape == () else vals
        return out


# ---- the writer ----

NIL, FILL_VALUE = 0x0, 0x5
_LEAF_K, _NODE_K = 4, 16  # symbol-table node and group B-tree node K
_SNOD_BYTES = 8 + 2 * _LEAF_K * 40
_TREE_BYTES = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
_HEAP_FREE_NULL = 1  # libhdf5's "no free block" in a local heap
# fill value message, version 2: allocation late, fill written if set,
# the library's default fill (h5py's bytes)
_FILL = b"\x02\x02\x02\x01\x00\x00\x00\x00"


class _Group:
    def __init__(self):
        self.children: Dict[str, Union["_Group", "_Dataset"]] = {}
        self.attrs: Dict[str, object] = {}


class _Dataset:
    def __init__(self, data: np.ndarray):
        self.data = data
        self.attrs: Dict[str, object] = {}


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _padded(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    """Version 1, no maximum dimensions; rank 0 is a scalar (a string
    attribute)."""
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", int(d)) for d in shape)


# little-endian IEEE f32: class 1 (floating point), version 1
_F32_TYPE = (struct.pack("<BBBBI", 0x11, 0x20, 31, 0, 4)
             + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))


def _string_type(n: int) -> bytes:
    return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, n)  # null-padded ASCII


def _attr_value(value) -> Tuple[bytes, Tuple[int, ...], bytes]:
    """(datatype, shape, data) of a string attribute: str (a scalar) or a
    list of str (an array), null-padded to the longest."""
    items = [value] if isinstance(value, str) else value
    if not (isinstance(items, (list, tuple))
            and all(isinstance(v, str) for v in items)):
        raise NotImplementedError(f"HDF5 writer: attribute {value!r} (only "
                                  "str or a list of str)")
    raw = [v.encode() for v in items]
    n = max([len(r) for r in raw] + [1])
    shape = () if isinstance(value, str) else (len(raw),)
    return _string_type(n), shape, b"".join(r.ljust(n, b"\0") for r in raw)


def _attribute(name: str, value) -> bytes:
    dtype, shape, data = _attr_value(value)
    space = _dataspace(shape)
    nm = name.encode() + b"\0"
    return _message(ATTRIBUTE, struct.pack(
        "<BBHHH", 1, 0, len(nm), len(dtype), len(space))
        + _padded(nm) + _padded(dtype) + _padded(space) + data)


class H5Writer:
    """An HDF5 file built in memory and written by ``save``: groups are
    created along a dataset's path as ``h5py`` creates them."""

    def __init__(self):
        self._root = _Group()

    def _node(self, path: str, make: bool = True):
        node = self._root
        for part in (p for p in path.split("/") if p):
            if part not in node.children:
                if not make:
                    raise KeyError(path)
                node.children[part] = _Group()
            node = node.children[part]
            if isinstance(node, _Dataset) and make:
                raise ValueError(f"{path!r}: {part!r} is a dataset")
        return node

    def create_group(self, path: str) -> None:
        self._node(path)

    def create_dataset(self, path: str, data) -> None:
        parent, _, name = path.rstrip("/").rpartition("/")
        group = self._node(parent)
        if name in group.children:
            raise ValueError(f"{path!r} exists")
        arr = np.asarray(data)
        if arr.dtype != np.float32 or arr.ndim == 0 or arr.size == 0:
            raise NotImplementedError(
                f"HDF5 writer: a {arr.dtype} dataset of shape {arr.shape} "
                "(only non-empty float32 arrays)")
        group.children[name] = _Dataset(np.ascontiguousarray(arr, "<f4"))

    def set_attr(self, path: str, name: str, value) -> None:
        node = self._node(path, make=False)
        _attr_value(value)  # refuses what it cannot write
        node.attrs[name] = value

    # ---- serialization ----

    def _alloc(self, data: bytes) -> int:
        addr = len(self._buf)
        self._buf += _padded(data)
        return addr

    def _header(self, msgs: List[bytes]) -> int:
        body = b"".join(msgs)
        return self._alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                       len(body)) + body)

    def _dataset(self, ds: _Dataset) -> int:
        arr = ds.data
        msgs = [_message(DATASPACE, _dataspace(arr.shape)),
                _message(DATATYPE, _F32_TYPE, flags=1),
                _message(FILL_VALUE, _FILL, flags=1),
                _message(LAYOUT, struct.pack("<BBQQ", 3, 1,
                                             self._alloc(arr.tobytes()),
                                             arr.nbytes))]
        msgs += [_attribute(k, v) for k, v in ds.attrs.items()]
        return self._header(msgs)

    def _group(self, g: _Group) -> Tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of ``g``, its
        children written first."""
        entries = []
        for name in sorted(g.children, key=str.encode):
            child = g.children[name]
            if isinstance(child, _Group):
                hdr, bt, heap = self._group(child)
                entries.append((name, hdr, (bt, heap)))
            else:
                entries.append((name, self._dataset(child), None))
        names = bytearray(8)  # offset 0: the empty name
        offsets = []
        for name, _, _ in entries:
            offsets.append(len(names))
            names += _padded(name.encode() + b"\0")
        heap = self._alloc(b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(names), _HEAP_FREE_NULL, len(self._buf) + 32)
            + bytes(names))
        nodes = []
        for i in range(0, len(entries), 2 * _LEAF_K):
            chunk = list(zip(entries, offsets))[i:i + 2 * _LEAF_K]
            body = b"SNOD\1\0" + struct.pack("<H", len(chunk))
            for (_, addr, cache), off in chunk:
                body += struct.pack("<QQI4x", off, addr, int(bool(cache)))
                body += struct.pack("<QQ", *cache) if cache else bytes(16)
            nodes.append((self._alloc(body.ljust(_SNOD_BYTES, b"\0")),
                          chunk[-1][1]))
        if len(nodes) > 2 * _NODE_K:
            raise NotImplementedError(
                f"HDF5 writer: a group of {len(entries)} members (at most "
                f"{2 * _NODE_K * 2 * _LEAF_K})")
        body = b"TREE\0\0" + struct.pack("<HQQQ", len(nodes), UNDEFINED,
                                          UNDEFINED, 0)
        for addr, last in nodes:
            body += struct.pack("<QQ", addr, last)
        tree = self._alloc(body.ljust(_TREE_BYTES, b"\0"))
        msgs = [_message(SYMBOL_TABLE, struct.pack("<QQ", tree, heap))]
        msgs += [_attribute(k, v) for k, v in g.attrs.items()]
        return self._header(msgs), tree, heap

    def save(self, path: str) -> None:
        self._buf = bytearray(96)  # the superblock, filled in last
        root, tree, heap = self._group(self._root)
        self._buf[:96] = (
            SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
            + struct.pack("<QQQQ", 0, UNDEFINED, len(self._buf), UNDEFINED)
            + struct.pack("<QQI4xQQ", 0, root, 1, tree, heap))
        data, self._buf = bytes(self._buf), None
        with open(path, "wb") as f:
            f.write(data)

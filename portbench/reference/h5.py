"""A frozen copy of the HDF5 reader (``H5File``) the reference reads the
Keras ``.h5`` weights with: numpy alone, the subset of the format that
h5py writes by default (superblock version 0, version-1 object headers,
symbol-table groups, contiguous or compact datasets of numbers,
attributes of numbers and strings). Anything else raises
``NotImplementedError``.

    f = H5File(path)
    names = f.attrs("/")["layer_names"]
    kernel = f.dataset("/stem_conv/stem_conv/kernel:0")
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

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



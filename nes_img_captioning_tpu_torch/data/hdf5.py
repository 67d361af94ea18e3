"""The part of HDF5 that a Karpathy-split label file uses, with numpy alone.

The reference's ``prepro_labels.py`` writes ``cocotalk_label.h5`` with h5py:
a few datasets of fixed-point numbers in the root group, stored contiguously.
``read_datasets`` reads such datasets from any file that HDF5 1.8 and later
write that way; ``write_datasets`` writes a file of that shape that h5py
opens. The guide is the HDF5 File Format Specification, version 3.0:

* superblock versions 0 and 1 (a root symbol-table entry; groups are a
  version 1 B-tree of symbol-table nodes with their names in a local heap)
  and 2 and 3 (the root object header's address), at offset 0;
* object headers version 1 and 2 (``OHDR``, continuation blocks ``OCHK``),
  checksums not verified;
* groups by symbol table (message 0x0011) or by compact hard links
  (0x0006, with link info 0x0002);
* datasets of a simple or scalar dataspace (0x0001, versions 1 and 2), a
  fixed-point or IEEE floating-point datatype of either byte order
  (0x0003) and a contiguous or compact layout (0x0008, versions 3 and 4).

Everything else raises ``ValueError`` naming the dataset and what was found
there (chunked storage, a filter pipeline, external storage, dense link
storage, another datatype class, a soft link; a user block, for the whole
file), so no array is returned that the file does not hold.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["read_datasets", "dataset_info", "write_datasets"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0000, 0x0001, 0x0002, 0x0003
_FILL, _LINK, _EXTERNAL = 0x0005, 0x0006, 0x0007
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x0008, 0x000B, 0x0010, \
    0x0011
# messages that change how a dataset's bytes are read, and what they mean
_REFUSED = {_EXTERNAL: "external storage (message 0x0007)",
            _FILTERS: "a filter pipeline (message 0x000B)"}
_MSG_SHARED = 0x02  # message flag: the data is a reference to a shared one


class _File:
    """One open file: its superblock at offset 0 (no user block, so every
    address is a file offset), the sizes of its addresses and lengths, and
    readers of its structures."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.size = os.fstat(self.f.fileno()).st_size

    def close(self):
        self.f.close()

    def read(self, at: int, n: int) -> bytes:
        self.f.seek(at)
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError(f"{self.path}: {n} bytes at {at} run past the "
                             f"end of the file ({self.size} bytes)")
        return b

    def superblock(self) -> int:
        """Reads the superblock; returns the root group's object header
        address."""
        b = self.read(0, 8 + 16) if self.size >= 24 else b""
        if b[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 signature at offset 0")
        version = b[8]
        if version in (0, 1):
            self.so, self.sl = b[13], b[14]
            at = 24 + (4 if version == 1 else 0)  # the base address
            root = at + 4 * self.so  # after free-space, end-of-file, driver
            root = self.uint(self.read(root, 2 * self.so), self.so, self.so)
        elif version in (2, 3):
            self.so, self.sl = b[9], b[10]
            at = 12  # the base address, then extension and end-of-file
            root = self.uint(self.read(at + 3 * self.so, self.so), 0, self.so)
        else:
            raise ValueError(f"{self.path}: superblock version {version}")
        base = self.uint(self.read(at, self.so), 0, self.so)
        if base:
            raise ValueError(f"{self.path}: base address {base}")
        return root

    @staticmethod
    def uint(b: bytes, at: int, n: int) -> int:
        return int.from_bytes(b[at:at + n], "little")

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.so)) - 1

    # ---- object headers --------------------------------------------------

    def messages(self, addr: int) -> list:
        """[(type, flags, data)] of the object header at ``addr``, the
        continuation blocks followed."""
        at = addr
        head = self.read(at, 16)
        out = []
        if head[:4] == b"OHDR":
            flags = head[5]
            at += 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            n = 1 << (flags & 3)
            size = self.uint(self.read(at, n), 0, n)
            blocks = [(at + n, size, flags)]
            while blocks:
                at, size, flags = blocks.pop(0)
                self._messages_v2(self.read(at, size), flags, out, blocks)
            return out
        if head[0] != 1:
            raise ValueError(f"{self.path}: object header version {head[0]} "
                             f"at {addr}")
        size = struct.unpack_from("<I", head, 8)[0]
        blocks = [(at + 16, size)]
        while blocks:
            at, size = blocks.pop(0)
            chunk, p = self.read(at, size), 0
            while p + 8 <= size:
                mtype, msize, mflags = struct.unpack_from("<HHB", chunk, p)
                data = chunk[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((self.uint(data, 0, self.so),
                                   self.uint(data, self.so, self.sl)))
                elif mtype != _NIL:
                    out.append((mtype, mflags, data))
        return out

    def _messages_v2(self, chunk: bytes, hflags: int, out: list,
                     blocks: list):
        p = 0
        if chunk[:4] == b"OCHK":
            p = 4
            chunk = chunk[:-4]  # the checksum
        head = 6 if hflags & 0x04 else 4  # creation order tracked
        while p + head <= len(chunk):
            mtype, msize, mflags = chunk[p], struct.unpack_from(
                "<H", chunk, p + 1)[0], chunk[p + 3]
            data = chunk[p + head:p + head + msize]
            p += head + msize
            if mtype == _CONTINUATION:
                blocks.append((self.uint(data, 0, self.so),
                               self.uint(data, self.so, self.sl), hflags))
            elif mtype != _NIL:
                out.append((mtype, mflags, data))

    # ---- groups ------------------------------------------------------------

    def links(self, addr: int) -> dict:
        """{name: (object header address or None, what it is)} of the group
        whose object header is at ``addr``."""
        out = {}
        for mtype, _, data in self.messages(addr):
            if mtype == _SYMBOL_TABLE:
                btree = self.uint(data, 0, self.so)
                heap = self.uint(data, self.so, self.so)
                self._btree_links(btree, self._heap_data(heap), out)
            elif mtype == _LINK:
                name, target = self._link(data)
                out[name] = target
            elif mtype == _LINK_INFO:
                fheap = self.uint(data, 2 + (8 if data[1] & 1 else 0),
                                  self.so)
                if not self.undefined(fheap):
                    out[None] = "dense link storage (a fractal heap)"
        return out

    def _heap_data(self, addr: int) -> bytes:
        b = self.read(addr, 8 + 2 * self.sl + self.so)
        if b[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {addr}")
        size = self.uint(b, 8, self.sl)
        data = self.uint(b, 8 + 2 * self.sl, self.so)
        return self.read(data, size)

    def _btree_links(self, addr: int, heap: bytes, out: dict):
        head = 8 + 2 * self.so
        b = self.read(addr, head)
        if b[:4] != b"TREE" or b[4] != 0:
            raise ValueError(f"{self.path}: no group B-tree node at {addr}")
        level, used = b[5], struct.unpack_from("<H", b, 6)[0]
        step = self.sl + self.so
        body = self.read(addr + head, used * step + self.sl)
        for i in range(used):
            child = self.uint(body, self.sl + i * step, self.so)
            if level:
                self._btree_links(child, heap, out)
            else:
                self._snod_links(child, heap, out)

    def _snod_links(self, addr: int, heap: bytes, out: dict):
        b = self.read(addr, 8)
        if b[:4] != b"SNOD":
            raise ValueError(f"{self.path}: no symbol table node at {addr}")
        n = struct.unpack_from("<H", b, 6)[0]
        size = 2 * self.so + 24
        body = self.read(addr + 8, n * size)
        for i in range(n):
            off = self.uint(body, i * size, self.so)
            name = heap[off:heap.index(b"\0", off)].decode()
            entry_type = struct.unpack_from("<I", body, i * size + 2 * self.so)
            target = self.uint(body, i * size + self.so, self.so)
            # cache type 2: a soft link, its value in the scratch pad
            out[name] = ((None, "a soft link") if entry_type[0] == 2
                         else (target, "an object"))

    def _link(self, data: bytes) -> tuple:
        if data[0] != 1:
            raise ValueError(f"{self.path}: link message version {data[0]}")
        flags, p = data[1], 2
        kind = 0
        if flags & 0x08:
            kind, p = data[p], p + 1
        if flags & 0x04:
            p += 8  # creation order
        if flags & 0x10:
            p += 1  # character set
        n = 1 << (flags & 3)
        length, p = self.uint(data, p, n), p + n
        name, p = data[p:p + length].decode(), p + length
        if kind != 0:
            what = {1: "a soft link", 64: "an external link"}.get(
                kind, f"a link of type {kind}")
            return name, (None, what)
        return name, (self.uint(data, p, self.so), "an object")

    # ---- datasets ------------------------------------------------------------

    def dataset(self, addr: int, name: str) -> dict:
        """{'shape', 'dtype', 'layout', 'offset', 'nbytes', 'inline'} of the
        dataset whose object header is at ``addr``."""
        def refuse(what: str):
            raise ValueError(f"{self.path}: dataset {name!r}: {what}")

        found = {}
        for mtype, mflags, data in self.messages(addr):
            if mtype in _REFUSED:
                refuse(_REFUSED[mtype])
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT):
                if mflags & _MSG_SHARED:
                    refuse(f"a shared message of type {mtype:#06x}")
                found[mtype] = data
        for mtype, what in ((_DATASPACE, "dataspace"),
                            (_DATATYPE, "datatype"), (_LAYOUT, "layout")):
            if mtype not in found:
                refuse(f"no {what} message (not a dataset?)")
        shape = self._dataspace(found[_DATASPACE], refuse)
        dtype = self._datatype(found[_DATATYPE], refuse)
        out = {"shape": shape, "dtype": dtype}
        out.update(self._layout(found[_LAYOUT], refuse))
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if out["nbytes"] != want:
            refuse(f"{out['layout']} storage of {out['nbytes']} bytes for "
                   f"{want} bytes of data")
        if out["layout"] == "contiguous" and out["offset"] is None and want:
            refuse("contiguous storage never allocated")
        return out

    def _dataspace(self, d: bytes, refuse) -> tuple:
        version, rank, flags = d[0], d[1], d[2]
        if version == 1:
            if flags & 0x02:
                refuse("a dataspace with a permutation index")
            p = 8
        elif version == 2:
            if d[3] == 2:
                refuse("a null dataspace")
            p = 4
        else:
            refuse(f"dataspace message version {version}")
        return tuple(self.uint(d, p + i * self.sl, self.sl)
                     for i in range(rank))

    def _datatype(self, d: bytes, refuse) -> np.dtype:
        cls, bits = d[0] & 0x0F, d[1] | d[2] << 8 | d[3] << 16
        size = struct.unpack_from("<I", d, 4)[0]
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            offset, precision = struct.unpack_from("<HH", d, 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                refuse(f"a fixed-point type of {size} bytes, bit offset "
                       f"{offset}, precision {precision}")
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:  # floating-point
            if size not in (4, 8) or bits & 0x40:
                refuse(f"a floating-point type of {size} bytes, bit field "
                       f"{bits:#x}")
            dt = np.dtype(f"{order}f{size}")
            finfo = np.finfo(dt)
            props = struct.unpack_from("<HHBBBBI", d, 8)
            ieee = (0, 8 * size, finfo.nmant, finfo.nexp, 0, finfo.nmant,
                    -finfo.minexp + 1)
            if props != ieee or (bits >> 8) & 0xFF != 8 * size - 1:
                refuse(f"a floating-point type that is not IEEE 754 "
                       f"binary{8 * size}: {props}")
            return dt
        names = {2: "time", 3: "string", 4: "bit field", 5: "opaque",
                 6: "compound", 7: "reference", 8: "enumeration",
                 9: "variable-length", 10: "array"}
        refuse(f"a datatype of class {cls} ({names.get(cls, 'unknown')})")

    def _layout(self, d: bytes, refuse) -> dict:
        version, cls = d[0], d[1]
        if version not in (3, 4):
            refuse(f"layout message version {version}")
        if cls == 0:
            n = struct.unpack_from("<H", d, 2)[0]
            return {"layout": "compact", "offset": None, "nbytes": n,
                    "inline": d[4:4 + n]}
        if cls == 1:
            addr = self.uint(d, 2, self.so)
            return {"layout": "contiguous", "nbytes": self.uint(
                        d, 2 + self.so, self.sl), "inline": None,
                    "offset": None if self.undefined(addr)
                    else addr}
        refuse({2: "chunked storage", 3: "virtual storage"}.get(
            cls, f"layout class {cls}"))


def _locate(f: _File, root: int, names) -> dict:
    groups, out = {}, {}
    for name in names:
        parts = [p for p in name.split("/") if p]
        addr = root
        for part in parts:
            if addr not in groups:
                groups[addr] = f.links(addr)
            links = groups[addr]
            if part not in links:
                if None in links:
                    raise ValueError(f"{f.path}: dataset {name!r}: its group "
                                     f"uses {links[None]}")
                raise ValueError(f"{f.path}: dataset {name!r}: no such "
                                 "dataset")
            addr, what = links[part]
            if addr is None:
                raise ValueError(f"{f.path}: dataset {name!r}: {what}")
        out[name] = f.dataset(addr, name)
    return out


def dataset_info(path: str, names) -> dict:
    """{name: {'shape', 'dtype', 'layout' ('contiguous' or 'compact'),
    'offset' (the data's byte offset in the file, None when compact or
    empty), 'nbytes'}} of the named datasets ('/'-separated paths from the
    root group). Raises ValueError for anything this module cannot read."""
    f = _File(path)
    try:
        info = _locate(f, f.superblock(), names)
    finally:
        f.close()
    return {k: {key: v[key] for key in ("shape", "dtype", "layout",
                                         "offset", "nbytes")}
            for k, v in info.items()}


def read_datasets(path: str, names) -> dict[str, np.ndarray]:
    """{name: array} of the named datasets, each in the file's own dtype
    and shape. Raises ValueError for anything this module cannot read."""
    f = _File(path)
    try:
        info = _locate(f, f.superblock(), names)
        out = {}
        for name, d in info.items():
            count = int(np.prod(d["shape"], dtype=np.int64))
            if d["layout"] == "compact":
                arr = np.frombuffer(d["inline"], d["dtype"], count).copy()
            elif count == 0:
                arr = np.empty(0, d["dtype"])
            else:
                f.f.seek(d["offset"])
                arr = np.fromfile(f.f, d["dtype"], count)
                if arr.size != count:
                    raise ValueError(f"{path}: dataset {name!r}: the file "
                                     "ends inside its data")
            out[name] = arr.reshape(d["shape"])
    finally:
        f.close()
    return out


# ---- the writer: superblock version 0, one symbol-table node --------------

_LEAF_K, _NODE_K = 4, 16   # HDF5's defaults: group leaf and internal node K
_UNDEF = 0xFFFFFFFFFFFFFFFF
_HEAP_FREE_NONE = 1        # a local heap's free-list head when none is free


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _v1_message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype_message(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" or (
        dt.byteorder == "=" and not np.little_endian) else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bits.to_bytes(3, "little"),
                           dt.itemsize, 0, 8 * dt.itemsize)
    fi = np.finfo(dt)
    bits = order | 0x20 | (8 * dt.itemsize - 1) << 8
    return struct.pack("<B3sIHHBBBBI", 0x11, bits.to_bytes(3, "little"),
                       dt.itemsize, 0, 8 * dt.itemsize, fi.nmant, fi.nexp, 0,
                       fi.nmant, -fi.minexp + 1)


def _dataset_header(arr: np.ndarray, data_addr: int) -> bytes:
    dims = b"".join(struct.pack("<Q", n) for n in arr.shape)
    # version 1; the maximum dimensions (those of the data) follow
    space = struct.pack("<BBB5x", 1, arr.ndim, 1 if arr.ndim else 0) \
        + dims + dims
    # the fill value h5py writes: allocated late, written if set, defined
    # as the default (zero)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, data_addr if arr.nbytes else _UNDEF,
                         arr.nbytes)
    body = (_v1_message(_DATASPACE, space)
            + _v1_message(_DATATYPE, _datatype_message(arr.dtype), 1)
            + _v1_message(_FILL, fill, 1) + _v1_message(_LAYOUT, layout))
    return struct.pack("<BBHII4x", 1, 0, 4, 1, len(body)) + body


def write_datasets(path: str, arrays: dict):
    """Write ``{name: array}`` as datasets of the root group of a new HDF5
    file at ``path``: superblock version 0, the root group one B-tree leaf
    over one symbol-table node, each dataset a version 1 object header with
    contiguous storage. Integer arrays of 1, 2, 4 or 8 bytes and float
    arrays of 4 or 8, of either byte order; at most 2 x 4 = 8 datasets (one
    symbol-table node)."""
    names = sorted(arrays, key=lambda n: n.encode())
    if not names or len(names) > 2 * _LEAF_K:
        raise ValueError(f"write_datasets: {len(names)} datasets; one "
                         f"symbol-table node holds 1 to {2 * _LEAF_K}")
    arrs = {}
    for name in names:
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"write_datasets: dataset name {name!r}")
        a = np.asarray(arrays[name])
        if a.dtype.kind not in "iuf" or a.dtype.itemsize not in (
                (1, 2, 4, 8) if a.dtype.kind in "iu" else (4, 8)):
            raise ValueError(f"write_datasets: dataset {name!r} of dtype "
                             f"{a.dtype}: integers of 1, 2, 4 or 8 bytes and "
                             "floats of 4 or 8 only")
        arrs[name] = a

    # the local heap's data: the empty name at 0, then each name, 8-aligned
    heap, name_at = b"\0" * 8, {}
    for name in names:
        name_at[name] = len(heap)
        heap += _pad8(name.encode() + b"\0")

    root_oh = 96  # after the superblock's 96 bytes
    root_size = 16 + 8 + 16
    btree = root_oh + root_size
    btree_size = 8 + 2 * 8 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
    heap_hdr = btree + btree_size
    heap_data = heap_hdr + 32
    snod = heap_data + len(heap)
    snod_size = 8 + 2 * _LEAF_K * 40
    at = snod + snod_size
    headers = {}
    for name in names:  # the headers' sizes do not depend on the address
        headers[name] = at
        at += len(_dataset_header(arrs[name], 0))
    data_at = {}
    for name in names:
        at += -at % 8
        data_at[name] = at
        at += arrs[name].nbytes
    eof = at

    out = bytearray(eof)

    def put(addr: int, b: bytes):
        out[addr:addr + len(b)] = b

    put(0, SIGNATURE + struct.pack(
        "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0))
    put(24, struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF))
    # the root's symbol-table entry: cache type 1, B-tree and heap cached
    put(56, struct.pack("<QQII", 0, root_oh, 1, 0)
        + struct.pack("<QQ", btree, heap_hdr))
    put(root_oh, struct.pack("<BBHII4x", 1, 0, 1, 1, 24)
        + _v1_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_hdr)))
    # one leaf: key 0 the empty name, child 0 the node, key 1 the last name
    put(btree, b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
        + struct.pack("<QQQ", 0, snod, name_at[names[-1]]))
    put(heap_hdr, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                         _HEAP_FREE_NONE, heap_data))
    put(heap_data, heap)
    put(snod, b"SNOD" + struct.pack("<BxH", 1, len(names)) + b"".join(
        struct.pack("<QQII16x", name_at[n], headers[n], 0, 0)
        for n in names))
    for name in names:
        put(headers[name], _dataset_header(arrs[name], data_at[name]))
        put(data_at[name], arrs[name].tobytes())
    with open(path, "wb") as f:
        f.write(out)

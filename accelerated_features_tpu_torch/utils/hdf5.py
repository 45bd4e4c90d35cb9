"""A reader of the HDF5 files that MegaDepth's depth maps and the
rendered depth datasets are stored in, without h5py: `struct`, `zlib` and
numpy.

`read_dataset(path_or_bytes, name="depth")` returns one dataset as a numpy
array, bit for bit what `h5py.File(...)[name][()]` gives, for the subset
of the format that h5py writes with its default `libver="earliest"`:

* superblock version 0 (found at offset 0 or at a user-block size 512,
  1024, 2048, ...), 8-byte offsets and lengths;
* version 1 object headers, with continuation blocks;
* groups by symbol table: a version 1 B-tree of group nodes (`TREE`,
  node type 0), symbol nodes (`SNOD`) and a local heap (`HEAP`) for the
  names; a path "a/b/c" walks the groups;
* a simple dataspace (message version 1 or 2);
* little-endian IEEE floats of 32 and 64 bits (datatype class 1);
* the contiguous layout (class 1, h5py's default) and the chunked one
  (class 2) with a version 1 B-tree chunk index (node type 1) and a
  filter pipeline of deflate (id 1) and shuffle (id 2); edge chunks are
  stored at full chunk size and cropped here. Chunks that were never
  written read as 0, h5py's default fill value.

Any other superblock, header, datatype, layout or filter raises
`ValueError` naming what it met. Nothing falls back to h5py.

`write_dataset(path, array, name="depth", compression=None)` writes the
other direction: a file of one float32 or float64 dataset that h5py and
`read_dataset` read back equal, laid out as h5py lays out
`h5py.File(path, "w").create_dataset(name, data=array,
compression=compression)`: superblock 0, a root group by symbol table, and
contiguous storage, or with `compression="gzip"` deflate at level 4 in
chunks of h5py's `guess_chunk` shape, no shuffle. The bytes need not be
h5py's.

Format reference: the HDF5 File Format Specification, version 2 (which
documents superblock 0, object header 1 and B-tree 1).
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types this reader reads
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = \
    0x01, 0x03, 0x08, 0x0B, 0x10, 0x11
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset"}


class _File:
    """The bytes of one file and the walk through them."""

    def __init__(self, data: bytes):
        self.data = data
        self.base = self._superblock()

    def _superblock(self) -> int:
        at = 0
        while at + 8 <= len(self.data):
            if self.data[at:at + 8] == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        else:
            raise ValueError("not an HDF5 file (no signature at 0, 512, "
                             "1024, ...)")
        version = self.data[at + 8]
        if version != 0:
            raise ValueError(f"HDF5 superblock version {version}; only "
                             f"version 0 (h5py's libver='earliest') is read")
        size_off, size_len = self.data[at + 13], self.data[at + 14]
        if (size_off, size_len) != (8, 8):
            raise ValueError(f"HDF5 offsets of {size_off} and lengths of "
                             f"{size_len} bytes; only 8 and 8 are read")
        base = self._u64(at + 24)
        # the root group's symbol table entry follows the four addresses
        self.root = self._u64(at + 56 + 8)
        return base

    def _u64(self, pos: int) -> int:
        return struct.unpack_from("<Q", self.data, pos)[0]

    def _addr(self, a: int) -> int:
        return self.base + a

    def _signature(self, pos: int, sig: bytes) -> None:
        if self.data[pos:pos + 4] != sig:
            raise ValueError(f"expected an HDF5 {sig.decode()} structure at "
                             f"{pos}, found {self.data[pos:pos + 4]!r}")

    # ---- object headers ---------------------------------------------------
    def messages(self, header: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, body) of every message of a version 1 object
        header, continuation blocks included."""
        pos = self._addr(header)
        version = self.data[pos]
        if version != 1:
            raise ValueError(f"HDF5 object header version {version} at "
                             f"{header}; only version 1 is read")
        n_msgs, _refs, size = struct.unpack_from("<HII", self.data, pos + 2)
        blocks = [(pos + 16, size)]
        out: List[Tuple[int, int, bytes]] = []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            p, end = start, start + length
            while p + 8 <= end and len(out) < n_msgs:
                kind, msize, flags = struct.unpack_from("<HHB", self.data, p)
                body = self.data[p + 8:p + 8 + msize]
                out.append((kind, flags, body))
                if kind == _CONTINUATION:
                    off, ln = struct.unpack_from("<QQ", body)
                    blocks.append((self._addr(off), ln))
                p += 8 + msize
        return out

    # ---- groups -----------------------------------------------------------
    def _heap_name(self, heap: int, offset: int) -> str:
        pos = self._addr(heap)
        self._signature(pos, b"HEAP")
        data_addr = self._u64(pos + 24)
        start = self._addr(data_addr) + offset
        return self.data[start:self.data.index(b"\0", start)].decode()

    def _group_entries(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of every link of a group."""
        out: Dict[str, int] = {}
        pos = self._addr(btree)
        self._signature(pos, b"TREE")
        node_type, level, used = struct.unpack_from("<BBH", self.data,
                                                    pos + 4)
        if node_type != 0:
            raise ValueError(f"a group B-tree node of type {node_type}")
        p = pos + 8 + 16 + 8          # past both siblings and key 0
        for _ in range(used):
            child = self._u64(p)
            p += 16                   # child, then the next key
            if level > 0:
                out.update(self._group_entries(child, heap))
                continue
            sp = self._addr(child)
            self._signature(sp, b"SNOD")
            n_sym = struct.unpack_from("<H", self.data, sp + 6)[0]
            for i in range(n_sym):
                e = sp + 8 + 40 * i
                name_off, obj = struct.unpack_from("<QQ", self.data, e)
                out[self._heap_name(heap, name_off)] = obj
        return out

    def lookup(self, name: str) -> int:
        """The object header address of the object at path `name`."""
        header = self.root
        for part in [x for x in name.split("/") if x]:
            table = [m for m in self.messages(header)
                     if m[0] == _SYMBOL_TABLE]
            if not table:
                raise ValueError(f"HDF5 object on the way to {name!r} is "
                                 f"not a group with a symbol table (newer "
                                 f"link storage is not read)")
            btree, heap = struct.unpack_from("<QQ", table[0][2])
            entries = self._group_entries(btree, heap)
            if part not in entries:
                raise KeyError(f"no HDF5 object {part!r} in the file "
                               f"(it has {sorted(entries)})")
            header = entries[part]
        return header

    # ---- datasets ---------------------------------------------------------
    def dataset(self, name: str) -> np.ndarray:
        msgs = {}
        for kind, flags, body in self.messages(self.lookup(name)):
            if kind in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                if flags & 0x02:
                    raise ValueError(f"HDF5 shared message of type {kind} "
                                     f"in {name!r}; not read")
                msgs[kind] = body
        if _DATASPACE not in msgs or _DATATYPE not in msgs or \
                _LAYOUT not in msgs:
            raise ValueError(f"HDF5 object {name!r} is not a dataset")
        shape = _dataspace(msgs[_DATASPACE])
        dtype = _datatype(msgs[_DATATYPE])
        filters = _filters(msgs[_FILTERS]) if _FILTERS in msgs else []
        body = msgs[_LAYOUT]
        version, cls = body[0], body[1]
        if version != 3:
            raise ValueError(f"HDF5 data layout message version {version}; "
                             f"only version 3 is read")
        n = int(np.prod(shape, dtype=np.int64))
        if cls == 1:
            if filters:
                raise ValueError("HDF5 filters on a contiguous dataset")
            addr, size = struct.unpack_from("<QQ", body, 2)
            if addr == UNDEFINED:
                return np.zeros(shape, dtype)
            start = self._addr(addr)
            return np.frombuffer(self.data, dtype, n, start).reshape(
                shape).copy()
        if cls == 2:
            return self._chunked(body, shape, dtype, filters)
        kind = {0: "compact"}.get(cls, f"class {cls}")
        raise ValueError(f"HDF5 data layout {kind}; only contiguous (1) and "
                         f"chunked (2) are read")

    def _chunked(self, body: bytes, shape: Tuple[int, ...], dtype: np.dtype,
                 filters: List[int]) -> np.ndarray:
        rank = body[2] - 1
        btree = struct.unpack_from("<Q", body, 3)[0]
        chunk = struct.unpack_from(f"<{rank}I", body, 11)
        if rank != len(shape):
            raise ValueError(f"HDF5 chunk rank {rank} for a dataset of rank "
                             f"{len(shape)}")
        out = np.zeros(shape, dtype)
        if btree == UNDEFINED:
            return out
        count = int(np.prod(chunk, dtype=np.int64))
        for offsets, size, mask, addr in self._chunks(btree, rank):
            raw = self.data[self._addr(addr):self._addr(addr) + size]
            for i in reversed(range(len(filters))):
                if mask >> i & 1:
                    continue
                raw = _unfilter(filters[i], raw, dtype.itemsize)
            block = np.frombuffer(raw, dtype, count).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _chunks(self, btree: int, rank: int):
        """(offsets, stored size, filter mask, address) of every chunk
        under a version 1 B-tree node of type 1."""
        pos = self._addr(btree)
        self._signature(pos, b"TREE")
        node_type, level, used = struct.unpack_from("<BBH", self.data,
                                                    pos + 4)
        if node_type != 1:
            raise ValueError(f"a chunk B-tree node of type {node_type}")
        key = 8 + 8 * (rank + 1)
        p = pos + 24
        for _ in range(used):
            size, mask = struct.unpack_from("<II", self.data, p)
            offsets = struct.unpack_from(f"<{rank}Q", self.data, p + 8)
            child = self._u64(p + key)
            if level > 0:
                yield from self._chunks(child, rank)
            else:
                yield offsets, size, mask, child
            p += key + 8


def _dataspace(body: bytes) -> Tuple[int, ...]:
    version, rank = body[0], body[1]
    if version == 1:
        start = 8
    elif version == 2:
        if body[3] != 1:
            raise ValueError(f"HDF5 dataspace of type {body[3]}; only "
                             f"simple (1) is read")
        start = 4
    else:
        raise ValueError(f"HDF5 dataspace message version {version}")
    return struct.unpack_from(f"<{rank}Q", body, start)


def _datatype(body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = body[1]
    size = struct.unpack_from("<I", body, 4)[0]
    if cls != 1 or version != 1:
        raise ValueError(f"HDF5 datatype class {cls} version {version}; "
                         f"only IEEE floats (class 1, version 1) are read")
    if bits & 0x41:
        raise ValueError("HDF5 big-endian or VAX float; only little-endian "
                         "IEEE floats are read")
    offset, precision = struct.unpack_from("<HH", body, 8)
    layout = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
    got = (offset, precision) + struct.unpack_from("<BBBBI", body, 12)
    if size not in layout or got != layout[size]:
        raise ValueError(f"HDF5 float of {size} bytes with fields {got}; "
                         f"only IEEE float32 and float64 are read")
    return np.dtype("<f4" if size == 4 else "<f8")


def _filters(body: bytes) -> List[int]:
    """Filter ids of a pipeline message, in the order they were applied
    when the data was written."""
    version, n = body[0], body[1]
    if version not in (1, 2):
        raise ValueError(f"HDF5 filter pipeline message version {version}")
    p = 8 if version == 1 else 2
    ids = []
    for _ in range(n):
        fid = struct.unpack_from("<H", body, p)[0]
        if version == 1 or fid >= 256:
            name_len, _flags, n_vals = struct.unpack_from("<HHH", body, p + 2)
            p += 8
        else:
            name_len = 0
            _flags, n_vals = struct.unpack_from("<HH", body, p + 2)
            p += 6
        if version == 1:
            p += (name_len + 7) // 8 * 8 + 4 * n_vals + 4 * (n_vals % 2)
        else:
            p += name_len + 4 * n_vals
        if fid not in (1, 2):
            raise ValueError(f"HDF5 filter {_FILTER_NAMES.get(fid, fid)!r} "
                             f"(id {fid}); only deflate (1) and shuffle (2) "
                             f"are read")
        ids.append(fid)
    return ids


def _unfilter(fid: int, raw: bytes, itemsize: int) -> bytes:
    if fid == 1:
        return zlib.decompress(raw)
    n = len(raw) // itemsize   # shuffle: byte k of every element together
    head = np.frombuffer(raw, np.uint8, n * itemsize)
    return head.reshape(itemsize, n).T.tobytes() + raw[n * itemsize:]


def read_dataset(source: Union[str, Path, bytes], name: str = "depth"
                 ) -> np.ndarray:
    """The dataset at path `name` of an HDF5 file, or of its bytes, as
    h5py reads it. Raises FileNotFoundError for a missing file, KeyError
    for a missing dataset and ValueError for what this reader does not
    read."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        data = Path(source).read_bytes()
    return _File(data).dataset(name)


# ---- the writer -------------------------------------------------------------
GZIP_LEVEL = 4                   # h5py's compression_opts for "gzip"
_GROUP_LEAF_K, _GROUP_NODE_K = 4, 16
_CHUNK_K = 32                    # superblock 0 keeps the default chunk K


def guess_chunk(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """h5py's `filters.guess_chunk` for a dataset of fixed `shape`: halve
    the axes in turn until a chunk is under PyTables' target size (16 KiB
    x 2^log10(MiB of the dataset), within 8 KiB..1 MiB) or within half of
    it."""
    chunks = [float(x) for x in shape]
    dset = math.prod(chunks) * itemsize
    target = min(max(16 * 1024 * 2 ** math.log10(dset / (1024.0 * 1024)),
                     8 * 1024), 1024 * 1024)
    idx = 0
    while True:
        nbytes = math.prod(chunks) * itemsize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) \
                and nbytes < 1024 * 1024:
            break
        if math.prod(chunks) == 1:
            break
        chunks[idx % len(chunks)] = math.ceil(chunks[idx % len(chunks)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", kind, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _btree_node(node_type: int, level: int, keys: List[bytes],
                children: List[int], left: int, right: int, k: int) -> bytes:
    """A version 1 B-tree node of `len(children)` entries, allocated at its
    full size (2k children) as readers read it."""
    out = [b"TREE", struct.pack("<BBHQQ", node_type, level, len(children),
                                left, right)]
    for key, child in zip(keys, children):
        out += [key, struct.pack("<Q", child)]
    out.append(keys[len(children)])
    size = 24 + 2 * k * 8 + (2 * k + 1) * len(keys[0])
    node = b"".join(out)
    return node + b"\0" * (size - len(node))


def write_dataset(path: Union[str, Path], array: np.ndarray,
                  name: str = "depth", compression: Optional[str] = None
                  ) -> None:
    """Write `array` (float32 or float64, any rank >= 1) as the dataset
    `name` of a new HDF5 file at `path`, contiguous or, with
    `compression="gzip"`, deflate-compressed (level 4) in chunks of
    `guess_chunk`'s shape, as h5py's `create_dataset(name, data=array,
    compression=compression)` stores it. h5py and `read_dataset` read it
    back equal."""
    a = np.asarray(array)
    if a.dtype not in (np.float32, np.float64) or a.ndim == 0 \
            or 0 in a.shape:
        raise ValueError(f"write_dataset takes a non-empty float32 or "
                         f"float64 array of rank >= 1, not {a.shape} "
                         f"{a.dtype}")
    if compression not in (None, "gzip"):
        raise ValueError(f"compression={compression!r}; None or 'gzip'")
    if not name or "/" in name or len(name) > 255:
        raise ValueError(f"dataset name {name!r}: one level, no '/'")
    a = np.ascontiguousarray(a, a.dtype.newbyteorder("<"))
    item = a.dtype.itemsize
    rank = a.ndim

    # fixed layout: superblock, root header, group B-tree, local heap,
    # dataset header, symbol node, then the data (and chunk B-tree)
    root_at = 96
    gtree_at = root_at + 16 + 8 + 16
    gtree_size = 24 + 2 * _GROUP_NODE_K * 8 + (2 * _GROUP_NODE_K + 1) * 8
    heap_at = gtree_at + gtree_size
    name_b = name.encode() + b"\0"
    name_b += b"\0" * (-len(name_b) % 8)
    seg = b"\0" * 8 + name_b
    free = max(88 - len(seg), 16)        # one free block, as h5py leaves
    seg += struct.pack("<QQ", 1, free) + b"\0" * (free - 16)
    seg_at = heap_at + 32

    space = struct.pack("<BBBB4x", 1, rank, 1, 0) + struct.pack(
        f"<{2 * rank}Q", *a.shape, *a.shape)
    bits = 32 if item == 4 else 64
    exp_at, exp_bits, mant, bias = (23, 8, 23, 127) if item == 4 else \
        (52, 11, 52, 1023)
    dtype_b = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, bits - 1, 0, item, 0,
                          bits, exp_at, exp_bits, 0, mant, bias)
    chunked = compression == "gzip"
    fill = struct.pack("<BBBBI", 2, 3 if chunked else 2, 2, 1, 0)
    # the layout's addresses are patched in below: its size is fixed
    if chunked:
        chunk = guess_chunk(a.shape, item)
        pipeline = struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1) + \
            b"deflate\0" + struct.pack("<II", GZIP_LEVEL, 0)
        layout_len = 3 + 8 + 4 * (rank + 1)
    else:
        layout_len = 2 + 16
    msgs = lambda layout: [                                   # noqa: E731
        _message(0x01, space), _message(0x03, dtype_b, 1),
        _message(0x05, fill, 1)] + (
        [_message(0x0B, pipeline, 1)] if chunked else []) + [
        _message(0x08, layout)]
    ds_at = seg_at + len(seg)
    ds_len = len(_object_header(msgs(b"\0" * layout_len)))
    snod_at = ds_at + ds_len
    data_at = snod_at + 8 + 2 * _GROUP_LEAF_K * 40

    tail = []
    if chunked:
        grid = [-(-n // c) for n, c in zip(a.shape, chunk)]
        keys, addrs = [], []
        at = data_at
        for idx in np.ndindex(*grid):
            lo = [i * c for i, c in zip(idx, chunk)]
            block = np.zeros(chunk, a.dtype)
            src = a[tuple(slice(o, o + c) for o, c in zip(lo, chunk))]
            block[tuple(slice(0, n) for n in src.shape)] = src
            raw = zlib.compress(block.tobytes(), GZIP_LEVEL)
            keys.append(struct.pack(f"<II{rank + 1}Q", len(raw), 0, *lo, 0))
            addrs.append(at)
            tail.append(raw)
            at += len(raw)
        # the key past the last chunk: one chunk on along every axis
        end_key = struct.pack(f"<II{rank + 1}Q", 0, 0,
                              *[g * c for g, c in zip(grid, chunk)], item)
        key_len = len(end_key)
        node_size = 24 + 2 * _CHUNK_K * 8 + (2 * _CHUNK_K + 1) * key_len
        level = 0
        while True:
            groups = [list(range(i, min(i + 2 * _CHUNK_K, len(keys))))
                      for i in range(0, len(keys), 2 * _CHUNK_K)]
            firsts = [at + j * node_size for j in range(len(groups))]
            for j, g in enumerate(groups):
                nk = [keys[i] for i in g]
                nk.append(keys[g[-1] + 1] if g[-1] + 1 < len(keys)
                          else end_key)
                tail.append(_btree_node(
                    1, level, nk, [addrs[i] for i in g],
                    firsts[j - 1] if j else UNDEFINED,
                    firsts[j + 1] if j + 1 < len(groups) else UNDEFINED,
                    _CHUNK_K))
            at += len(groups) * node_size
            keys = [keys[g[0]] for g in groups]
            addrs = firsts
            level += 1
            if len(groups) == 1:
                break
        layout = struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, addrs[0],
                             *chunk, item)
        eof = at
    else:
        raw = a.tobytes()
        tail.append(raw)
        layout = struct.pack("<BBQQ", 3, 1, data_at, len(raw))
        eof = data_at + len(raw)

    head = bytearray()
    head += SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
    head += struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
    head += struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
    head += struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack(
        "<QQ", gtree_at, heap_at)
    head += _object_header([_message(0x11, struct.pack("<QQ", gtree_at,
                                                       heap_at))])
    head += _btree_node(0, 0, [struct.pack("<Q", 0), struct.pack("<Q", 8)],
                        [snod_at], UNDEFINED, UNDEFINED, _GROUP_NODE_K)
    head += b"HEAP" + struct.pack("<B3xQQQ", 0, len(seg), 8 + len(name_b),
                                  seg_at) + seg
    head += _object_header(msgs(layout))
    head += b"SNOD" + struct.pack("<BxH", 1, 1) + struct.pack(
        "<QQII16x", 8, ds_at, 0, 0)
    head += b"\0" * (data_at - len(head))
    if len(head) != data_at:
        raise AssertionError("HDF5 writer layout is off")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(head)
        for part in tail:
            f.write(part)
    os.replace(tmp, path)


__all__ = ["guess_chunk", "read_dataset", "write_dataset"]

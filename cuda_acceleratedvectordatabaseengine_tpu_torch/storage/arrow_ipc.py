"""The Arrow IPC file format for two fixed schemas, read and written with
numpy alone (the card's machine has no ``pyarrow``).

The JAX package writes its snapshots through ``pyarrow``
(``storage/arrow_store.py``); this module reads and writes the same files:

- the magic ``ARROW1`` padded to 8 bytes;
- encapsulated messages: ``0xFFFFFFFF``, an int32 metadata length, a
  flatbuffer ``Message`` (version V5; header ``Schema`` or
  ``RecordBatch``; ``bodyLength``) padded to 8 bytes, then the body, each
  buffer 8-byte aligned;
- the end-of-stream marker ``0xFFFFFFFF 0x00000000``;
- a flatbuffer ``Footer`` (the schema, and a ``Block{offset,
  metaDataLength, bodyLength}`` per record batch), its int32 length and
  ``ARROW1``.

The schemas: ``id: uint64`` plus ``vector: list<item: float32>`` or
``code: list<item: uint8>``, int32 list offsets. A batch's field nodes and
buffers come in pre-order: id (validity, values), list (validity,
offsets), item (validity, values). The reader follows each buffer's
``{offset, length}`` entry and assumes no fixed layout (``pyarrow`` may
pad to 64 bytes or write zero-length validity buffers), reads the body
through ``np.memmap`` so a slice of rows reads only those rows, and
refuses nulls, body compression, dictionaries and any other schema.

Int32 offsets address at most 2³¹ − 1 values per batch, so the writer
puts at most ``ROW_VALUES_MAX // width`` rows in a batch (the JAX writer
builds its offsets with ``np.arange(..., dtype=np.int32)`` over the whole
table, which wraps negative past 2³¹ values: 2.79M rows at D 768).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"ARROW1"
ROW_VALUES_MAX = 2**31 - 1      # values one batch's int32 offsets address
_CONTINUATION = b"\xff\xff\xff\xff"
_V5 = 4                         # MetadataVersion.V5
_HEADER_SCHEMA, _HEADER_RECORD_BATCH = 1, 3      # MessageHeader union
_TYPE_INT, _TYPE_FLOAT, _TYPE_LIST = 2, 3, 12    # Type union
_PRECISION_SINGLE = 1

# flatbuffer structs (little-endian, 8-byte aligned)
_BLOCK = np.dtype([("offset", "<i8"), ("meta", "<i4"), ("pad", "<i4"),
                   ("body", "<i8")])
_FIELD_NODE = np.dtype([("length", "<i8"), ("null_count", "<i8")])
_BUFFER = np.dtype([("offset", "<i8"), ("length", "<i8")])

# schema name → (list field name, item numpy dtype, item Arrow type)
SCHEMAS = {
    "vector": ("vector", np.dtype("<f4"), (_TYPE_FLOAT, _PRECISION_SINGLE)),
    "code": ("code", np.dtype("u1"), (_TYPE_INT, 8, False)),
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# --------------------------------------------------------------------------- #
# flatbuffers: a minimal front-to-back writer and a table reader
# --------------------------------------------------------------------------- #

_SCALAR = {"u8": "<B", "bool": "<B", "i16": "<h", "i32": "<i", "i64": "<q"}


class _Builder:
    """Writes one flatbuffer front to back: the root offset, then each
    table (its vtable just before it) followed by its children, so every
    unsigned offset points forward as the format requires. A table is a
    list of fields indexed by vtable slot, each ``None`` or ``(kind,
    value)``: a scalar kind of ``_SCALAR``, ``"table"`` (a field list),
    ``"str"``, ``"tables"`` (a list of field lists) or ``"structs"``
    (``bytes`` of 8-byte-aligned structs, and their count)."""

    def __init__(self):
        self.buf = bytearray(4)         # the root offset, patched last

    def _pad(self, align: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % align:
            self.buf.append(0)

    def _put_u32(self, pos: int, value: int) -> None:
        struct.pack_into("<I", self.buf, pos, value)

    def finish(self, root: list) -> bytes:
        self._put_u32(0, self._table(root))
        self._pad(8)
        return bytes(self.buf)

    def _table(self, fields: list) -> int:
        sizes = [None if f is None else
                 struct.calcsize(_SCALAR[f[0]]) if f[0] in _SCALAR else 4
                 for f in fields]
        layout, end = {}, 4             # the vtable soffset comes first
        for slot in sorted((i for i, z in enumerate(sizes) if z),
                           key=lambda i: -sizes[i]):
            end = _round_up(end, sizes[slot])
            layout[slot] = end
            end += sizes[slot]
        align = max([4] + [z for z in sizes if z])
        self._pad(2)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<{2 + len(fields)}H", 4 + 2 * len(fields),
                                end, *[layout.get(i, 0)
                                       for i in range(len(fields))])
        self._pad(align)
        table = len(self.buf)
        self.buf += bytes(end)
        struct.pack_into("<i", self.buf, table, table - vtable)
        children = []
        for slot, off in layout.items():
            kind, value = fields[slot]
            if kind in _SCALAR:
                struct.pack_into(_SCALAR[kind], self.buf, table + off, value)
            else:
                children.append((table + off, kind, value))
        for at, kind, value in children:
            self._put_u32(at, self._child(kind, value) - at)
        return table

    def _child(self, kind: str, value) -> int:
        if kind == "table":
            return self._table(value)
        if kind == "str":
            raw = value.encode()
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(raw)) + raw + b"\0"
            return pos
        if kind == "structs":
            raw, count = value
            self._pad(8, extra=4)       # elements 8-aligned after the length
            pos = len(self.buf)
            self.buf += struct.pack("<I", count) + raw
            return pos
        if kind == "tables":
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(value)) + bytes(4 * len(value))
            for i, sub in enumerate(value):
                at = pos + 4 + 4 * i
                self._put_u32(at, self._table(sub) - at)
            return pos
        raise ValueError(f"unknown flatbuffer field kind {kind!r}")


class _Table:
    """Read access to one flatbuffer table at ``pos`` of ``buf``."""

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vtable)[0]

    @classmethod
    def root(cls, buf, pos: int) -> "_Table":
        return cls(buf, pos + struct.unpack_from("<I", buf, pos)[0])

    def _at(self, slot: int) -> int:
        o = 4 + 2 * slot
        if o >= self.vt_size:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vtable + o)[0]
        return self.pos + off if off else 0

    def scalar(self, slot: int, kind: str, default=0):
        at = self._at(slot)
        return struct.unpack_from(_SCALAR[kind], self.buf, at)[0] if at \
            else default

    def _target(self, slot: int) -> int:
        at = self._at(slot)
        return at + struct.unpack_from("<I", self.buf, at)[0] if at else 0

    def table(self, slot: int) -> "_Table | None":
        at = self._target(slot)
        return _Table(self.buf, at) if at else None

    def _vector(self, slot: int) -> tuple[int, int]:
        at = self._target(slot)
        if not at:
            return 0, 0
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def string(self, slot: int) -> str:
        start, n = self._vector(slot)
        return bytes(self.buf[start:start + n]).decode() if n else ""

    def tables(self, slot: int) -> list["_Table"]:
        start, n = self._vector(slot)
        return [_Table.root(self.buf, start + 4 * i) for i in range(n)]

    def structs(self, slot: int, dtype: np.dtype) -> np.ndarray:
        start, n = self._vector(slot)
        return np.frombuffer(self.buf, dtype, count=n, offset=start) if n \
            else np.zeros(0, dtype)


# --------------------------------------------------------------------------- #
# schema
# --------------------------------------------------------------------------- #

def _type_fields(arrow_type) -> tuple[int, list]:
    """``(Type union tag, the type table's fields)``."""
    if arrow_type[0] == _TYPE_INT:
        return _TYPE_INT, [("i32", arrow_type[1]), ("bool", arrow_type[2])]
    if arrow_type[0] == _TYPE_FLOAT:
        return _TYPE_FLOAT, [("i16", arrow_type[1])]
    return _TYPE_LIST, []


def _field(name: str, arrow_type, children=()) -> list:
    tag, type_fields = _type_fields(arrow_type)
    return [("str", name), ("bool", 1), ("u8", tag), ("table", type_fields),
            None, ("tables", list(children))]


def _schema(schema: str) -> list:
    list_name, _, item_type = SCHEMAS[schema]
    return [None, ("tables", [
        _field("id", (_TYPE_INT, 64, False)),
        _field(list_name, (_TYPE_LIST,), [_field("item", item_type)]),
    ])]


def _read_type(field: _Table):
    tag = field.scalar(2, "u8")
    t = field.table(3)
    if tag == _TYPE_INT and t is not None:
        return (_TYPE_INT, t.scalar(0, "i32"), bool(t.scalar(1, "bool")))
    if tag == _TYPE_FLOAT and t is not None:
        return (_TYPE_FLOAT, t.scalar(0, "i16"))
    return (tag,)


def _check_schema(schema: _Table, expected: str, path: str) -> None:
    list_name, _, item_type = SCHEMAS[expected]
    found = []
    for f in schema.tables(1):
        if f.table(4) is not None:
            raise ValueError(f"{path}: dictionary-encoded field "
                             f"{f.string(0)!r} is not supported")
        found.append((f.string(0), _read_type(f),
                      [(c.string(0), _read_type(c)) for c in f.tables(5)]))
    want = [("id", (_TYPE_INT, 64, False), []),
            (list_name, (_TYPE_LIST,), [("item", item_type)])]
    # the item field's name is free in Arrow; compare its type only
    strip = [(n, t, [ct for _, ct in ch]) for n, t, ch in found]
    if strip != [(n, t, [ct for _, ct in ch]) for n, t, ch in want]:
        raise ValueError(
            f"{path}: schema {found} is not the {expected!r} schema "
            f"(id: uint64, {list_name}: list<{np.dtype(SCHEMAS[expected][1])}"
            f">)")


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #

class IpcFileWriter:
    """Writes an Arrow IPC file of the ``schema`` (``"vector"`` or
    ``"code"``) batch by batch; :meth:`close` writes the footer."""

    def __init__(self, path: str, schema: str):
        self.schema = schema
        self._dtype = SCHEMAS[schema][1]
        self._blocks: list[tuple[int, int, int]] = []
        self._width: int | None = None
        self.rows = 0
        self._f = open(path, "wb")
        self._f.write(MAGIC + b"\0\0")
        self._message(_HEADER_SCHEMA, _schema(schema), 0)

    def _message(self, header_type: int, header: list, body_len: int) -> int:
        """Write one encapsulated message's metadata; returns its length
        (continuation and length prefix included)."""
        fb = _Builder().finish([("i16", _V5), ("u8", header_type),
                                ("table", header), ("i64", body_len)])
        self._f.write(_CONTINUATION + struct.pack("<i", len(fb)) + fb)
        return 8 + len(fb)

    def write(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Append rows ``ids [n]`` (uint64) with ``values [n, width]``, in
        batches of at most ``ROW_VALUES_MAX // width`` rows."""
        values = np.ascontiguousarray(values, self._dtype)
        ids = np.ascontiguousarray(ids, np.uint64)
        n, width = values.shape
        if ids.shape != (n,):
            raise ValueError(f"ids {ids.shape} do not match {n} rows")
        if self._width is None:
            self._width = width
        elif width != self._width:
            raise ValueError(f"row width {width} != {self._width} of the "
                             f"rows already written")
        step = max(ROW_VALUES_MAX // max(width, 1), 1)
        for r0 in range(0, n, step) if n else [0]:
            self._batch(ids[r0:r0 + step], values[r0:r0 + step])
        self.rows += n

    def _batch(self, ids: np.ndarray, values: np.ndarray) -> None:
        n, width = values.shape
        offsets = np.arange(n + 1, dtype=np.int64) * width
        if offsets[-1] > ROW_VALUES_MAX:
            raise ValueError(f"{n} rows of {width} values overflow int32 "
                             f"list offsets")
        data = [None, ids, None, offsets.astype("<i4"), None, values]
        buffers, pos = [], 0
        for b in data:
            length = 0 if b is None else b.nbytes
            buffers.append((pos, length))
            pos += _round_up(length, 8)
        nodes = np.array([(n, 0), (n, 0), (n * width, 0)], _FIELD_NODE)
        rb = [("i64", n), ("structs", (nodes.tobytes(), 3)),
              ("structs", (np.array(buffers, _BUFFER).tobytes(), 6))]
        start = self._f.tell()
        meta = self._message(_HEADER_RECORD_BATCH, rb, pos)
        for b in data:
            if b is not None and b.nbytes:
                self._f.write(memoryview(b.reshape(-1)).cast("B"))
                self._f.write(bytes(_round_up(b.nbytes, 8) - b.nbytes))
        self._blocks.append((start, meta, pos))

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.write(_CONTINUATION + b"\0\0\0\0")        # end of stream
        blocks = np.array([(o, m, 0, b) for o, m, b in self._blocks],
                          _BLOCK)
        footer = _Builder().finish([
            ("i16", _V5), ("table", _schema(self.schema)),
            ("structs", (b"", 0)), ("structs", (blocks.tobytes(),
                                                len(blocks)))])
        self._f.write(footer + struct.pack("<i", len(footer)) + MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------- #
# reader
# --------------------------------------------------------------------------- #

class IpcFileReader:
    """Reads rows of an Arrow IPC file of the ``schema`` through a
    read-only ``np.memmap``: only the footer and the messages' metadata
    are parsed up front; :meth:`read` touches the rows it returns."""

    def __init__(self, path: str, schema: str):
        self.path = path
        self._dtype = SCHEMAS[schema][1]
        mm = np.memmap(path, np.uint8, mode="r")
        size = mm.size
        if (size < 18 or bytes(mm[:6]) != MAGIC
                or bytes(mm[size - 6:]) != MAGIC):
            raise ValueError(f"{path}: not an Arrow IPC file")
        flen = struct.unpack_from("<i", mm, size - 10)[0]
        footer = _Table.root(mm, size - 10 - flen)
        schema_t = footer.table(1)
        if schema_t is None:
            raise ValueError(f"{path}: the footer holds no schema")
        _check_schema(schema_t, schema, path)
        if footer.structs(2, _BLOCK).size:
            raise ValueError(f"{path}: dictionary batches are not supported")
        self._mm = mm
        # per batch: (first row, rows, file offset of its ids, of its values)
        self._batches = []
        self.width: int | None = None
        row = 0
        for blk in footer.structs(3, _BLOCK):
            b = self._parse_batch(int(blk["offset"]), int(blk["meta"]))
            b = (row,) + b
            row += b[1]
            self._batches.append(b)
        self.num_rows = row

    def _parse_batch(self, at: int, meta_len: int):
        mm = self._mm
        fb = at + 8 if bytes(mm[at:at + 4]) == _CONTINUATION else at + 4
        msg = _Table.root(mm, fb)
        if msg.scalar(1, "u8") != _HEADER_RECORD_BATCH:
            raise ValueError(f"{self.path}: block at {at} is not a record "
                             f"batch")
        rb = msg.table(2)
        if rb.table(3) is not None:
            raise ValueError(f"{self.path}: compressed record batch bodies "
                             f"are not supported")
        n = rb.scalar(0, "i64")
        nodes = rb.structs(1, _FIELD_NODE)
        bufs = rb.structs(2, _BUFFER)
        if len(nodes) != 3 or len(bufs) != 6:
            raise ValueError(f"{self.path}: batch at {at} has {len(nodes)} "
                             f"field nodes and {len(bufs)} buffers, not 3 "
                             f"and 6")
        if nodes["null_count"].any():
            raise ValueError(f"{self.path}: nulls (null counts "
                             f"{nodes['null_count'].tolist()}) are not "
                             f"supported")
        body = at + meta_len
        ids_at = body + int(bufs[1]["offset"])
        offs_at = body + int(bufs[3]["offset"])
        vals_at = body + int(bufs[5]["offset"])
        if n:
            o = np.frombuffer(mm, "<i4", count=n + 1, offset=offs_at)
            width, rem = divmod(int(o[-1]) - int(o[0]), n)
            if rem or (o[1:] - o[:-1] != width).any():
                raise ValueError(f"{self.path}: rows of unequal width")
            if self.width is None:
                self.width = width
            elif width != self.width:
                raise ValueError(f"{self.path}: row width {width} != "
                                 f"{self.width} of an earlier batch")
            vals_at += int(o[0]) * self._dtype.itemsize
        return n, ids_at, vals_at

    def read(self, offset: int = 0, length: int | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Rows ``[offset, offset + length)`` (to the end for ``None``),
        across batch boundaries: ``(ids [n] uint64, values [n, width])``,
        copies. A file of no rows gives ``[0, 0]`` values."""
        end = self.num_rows if length is None else min(
            offset + length, self.num_rows)
        width = self.width or 0
        ids_out, vals_out = [], []
        for first, n, ids_at, vals_at in self._batches:
            r0, r1 = max(offset, first), min(end, first + n)
            if r0 >= r1:
                continue
            r0 -= first
            r1 -= first
            ids_out.append(np.frombuffer(self._mm, "<u8", count=r1 - r0,
                                         offset=ids_at + 8 * r0))
            vals_out.append(np.frombuffer(
                self._mm, self._dtype, count=(r1 - r0) * width,
                offset=vals_at + r0 * width * self._dtype.itemsize,
            ).reshape(r1 - r0, width))
        if not ids_out:
            return np.zeros(0, np.uint64), np.zeros((0, width), self._dtype)
        return np.concatenate(ids_out), np.concatenate(vals_out)

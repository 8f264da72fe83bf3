"""Avro object-container IO — stdlib-only encoder/decoder.

The port's own copy of ``transmogrifai_tpu/utils/avro_io.py``: the same
bytes for the same records (the sync marker is fixed unless one is
given), and each package reads the other's files. Host-side replacement
for the reference's Avro stack
(utils/src/main/scala/com/salesforce/op/utils/io/avro/AvroInOut.scala,
readers/.../AvroReaders.scala, CSVToAvro in utils/.../io/csv/): the
environment ships no avro library, so the object container file format
(magic ``Obj\\x01`` + metadata map + sync-marker framed blocks) and the
binary encoding (zigzag varints, length-prefixed bytes/strings, blocked
arrays/maps, union indices) are implemented directly. Supported codecs:
``null`` and ``deflate`` (zlib). Schema support covers what tabular
pipelines use: records of primitives, nullable unions, enums, arrays,
maps, and nested records.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Tuple

__all__ = ["read_avro", "write_avro", "iter_avro", "infer_avro_schema",
           "AvroError"]

_MAGIC = b"Obj\x01"


class AvroError(ValueError):
    pass


# ---------------------------------------------------------------------------
# binary primitives
# ---------------------------------------------------------------------------

def _read_long(buf: io.BytesIO) -> int:
    """Zigzag-encoded variable-length long."""
    shift, acc = 0, 0
    while True:
        b = buf.read(1)
        if not b:
            raise AvroError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, v: int) -> None:
    v = (v << 1) ^ (v >> 63) if v >= 0 else ((-v - 1) << 1 | 1)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise AvroError("truncated bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# schema-driven (de)coding
# ---------------------------------------------------------------------------

def _decode(schema, buf: io.BytesIO, names: Dict[str, Any]):
    if isinstance(schema, str):
        if schema in names:                      # named-type reference
            return _decode(names[schema], buf, names)
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            return buf.read(1) != b"\x00"
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if t == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if t == "bytes":
            return _read_bytes(buf)
        if t == "string":
            return _read_bytes(buf).decode("utf-8")
        raise AvroError(f"unsupported avro type {t!r}")
    if isinstance(schema, list):                 # union: index then value
        idx = _read_long(buf)
        if not 0 <= idx < len(schema):
            raise AvroError(f"union index {idx} out of range")
        return _decode(schema[idx], buf, names)
    t = schema["type"]
    if t == "record":
        names[schema["name"]] = schema
        return {f["name"]: _decode(f["type"], buf, names)
                for f in schema["fields"]}
    if t == "enum":
        names[schema["name"]] = schema
        return schema["symbols"][_read_long(buf)]
    if t == "array":
        out = []
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:                        # block with byte size
                count = -count
                _read_long(buf)
            for _ in range(count):
                out.append(_decode(schema["items"], buf, names))
        return out
    if t == "map":
        out = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                count = -count
                _read_long(buf)
            for _ in range(count):
                k = _read_bytes(buf).decode("utf-8")
                out[k] = _decode(schema["values"], buf, names)
        return out
    if t == "fixed":
        names[schema["name"]] = schema
        return buf.read(schema["size"])
    return _decode(t, buf, names)                # {"type": "string"} form


def _encode(schema, v, out: io.BytesIO, names: Dict[str, Any]) -> None:
    if isinstance(schema, str):
        if schema in names:
            return _encode(names[schema], v, out, names)
        t = schema
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if v else b"\x00")
        elif t in ("int", "long"):
            _write_long(out, int(v))
        elif t == "float":
            out.write(struct.pack("<f", float(v)))
        elif t == "double":
            out.write(struct.pack("<d", float(v)))
        elif t == "bytes":
            _write_bytes(out, bytes(v))
        elif t == "string":
            _write_bytes(out, str(v).encode("utf-8"))
        else:
            raise AvroError(f"unsupported avro type {t!r}")
        return
    if isinstance(schema, list):
        for i, branch in enumerate(schema):
            bt = branch if isinstance(branch, str) else branch["type"]
            if (v is None) == (bt == "null"):
                if v is None or _matches(branch, v):
                    _write_long(out, i)
                    return _encode(branch, v, out, names)
        raise AvroError(f"no union branch for {v!r} in {schema}")
    t = schema["type"]
    if t == "record":
        names[schema["name"]] = schema
        for f in schema["fields"]:
            _encode(f["type"], (v or {}).get(f["name"]), out, names)
    elif t == "enum":
        _write_long(out, schema["symbols"].index(v))
    elif t == "array":
        if v:
            _write_long(out, len(v))
            for item in v:
                _encode(schema["items"], item, out, names)
        _write_long(out, 0)
    elif t == "map":
        if v:
            _write_long(out, len(v))
            for k, item in v.items():
                _write_bytes(out, str(k).encode("utf-8"))
                _encode(schema["values"], item, out, names)
        _write_long(out, 0)
    elif t == "fixed":
        out.write(bytes(v))
    else:
        _encode(t, v, out, names)


def _matches(branch, v) -> bool:
    t = branch if isinstance(branch, str) else branch.get("type")
    if t == "boolean":
        return isinstance(v, bool)
    if t in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if t in ("float", "double"):
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if t == "string":
        return isinstance(v, str)
    if t == "bytes":
        return isinstance(v, bytes)
    if t == "array":
        return isinstance(v, (list, tuple))
    if t in ("map", "record"):
        return isinstance(v, dict)
    return True


# ---------------------------------------------------------------------------
# container files
# ---------------------------------------------------------------------------

def iter_avro(path: str) -> Iterator[dict]:
    """Stream records from an Avro object container file. Reads the
    sync-framed blocks incrementally off the file handle (the binary
    primitives above only need ``.read``), so peak memory is one block
    — the property the streaming readers rely on."""
    with open(path, "rb") as fh:
        if fh.read(4) != _MAGIC:
            raise AvroError(f"{path}: not an Avro container file")
        meta: Dict[str, bytes] = {}
        while True:
            count = _read_long(fh)
            if count == 0:
                break
            if count < 0:
                count = -count
                _read_long(fh)
            for _ in range(count):
                k = _read_bytes(fh).decode("utf-8")
                meta[k] = _read_bytes(fh)
        sync = fh.read(16)
        schema = json.loads(meta["avro.schema"].decode("utf-8"))
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise AvroError(f"unsupported codec {codec!r}")
        names: Dict[str, Any] = {}
        while True:
            try:
                n_records = _read_long(fh)
            except AvroError:
                break                              # clean EOF
            size = _read_long(fh)
            block = fh.read(size)
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            bbuf = io.BytesIO(block)
            for _ in range(n_records):
                yield _decode(schema, bbuf, names)
            if fh.read(16) != sync:
                raise AvroError("sync marker mismatch")


def read_avro(path: str) -> List[dict]:
    """All records of an Avro container file (reference AvroInOut.read)."""
    return list(iter_avro(path))


def infer_avro_schema(records: List[dict], name: str = "Row") -> dict:
    """Nullable-union record schema from sample dicts (the role of
    CSVToAvro's schema application / CSVAutoReaders inference)."""
    #: type-widening lattice: null < boolean|long < double < string
    _RANK = {"null": 0, "boolean": 1, "long": 1, "double": 2, "string": 3}
    types: Dict[str, str] = {}

    def widen(k: str, t: str) -> None:
        cur = types.setdefault(k, "null")
        if _RANK[t] > _RANK[cur]:
            types[k] = t
        elif _RANK[t] == _RANK[cur] and t != cur:
            types[k] = "string"   # boolean vs long — no numeric widening

    for r in records:
        for k, v in (r or {}).items():
            if v is None:
                widen(k, "null")
            elif isinstance(v, bool):
                widen(k, "boolean")
            elif isinstance(v, int):
                widen(k, "long")
            elif isinstance(v, float):
                widen(k, "double")
            else:
                widen(k, "string")
    fields = [{"name": k,
               "type": ["null", t] if t != "null" else ["null", "string"],
               "default": None}
              for k, t in sorted(types.items())]
    return {"type": "record", "name": name, "fields": fields}


def write_avro(path: str, records: List[dict],
               schema: Optional[dict] = None, codec: str = "null",
               sync: bytes = b"\x00" * 16) -> dict:
    """Write records as an Avro object container file; returns the
    schema used (inferred when not given)."""
    schema = schema or infer_avro_schema(records)
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported codec {codec!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    names: Dict[str, Any] = {}
    body = io.BytesIO()
    for r in records:
        _encode(schema, r, body, names)
    block = body.getvalue()
    if codec == "deflate":
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        block = co.compress(block) + co.flush()
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        meta = io.BytesIO()
        _write_long(meta, 2)
        _write_bytes(meta, b"avro.schema")
        _write_bytes(meta, json.dumps(schema).encode("utf-8"))
        _write_bytes(meta, b"avro.codec")
        _write_bytes(meta, codec.encode())
        _write_long(meta, 0)
        fh.write(meta.getvalue())
        fh.write(sync)
        out = io.BytesIO()
        _write_long(out, len(records))
        _write_long(out, len(block))
        fh.write(out.getvalue())
        fh.write(block)
        fh.write(sync)
    return schema

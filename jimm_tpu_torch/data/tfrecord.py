"""Zero-dependency TFRecord + ``tf.train.Example`` codec; the port's copy of
``jimm_tpu/data/tfrecord.py`` (no tensorflow or protobuf import). The two
write byte-identical shards for the same examples. The CRC32C runs on the
native library (``jimm_tpu_torch.data.native``), as the JAX package's does
where it is built; ``crc32c_plain`` is its Python version.

TFRecord framing (per record):
  uint64le  length
  uint32le  masked_crc32c(length bytes)
  bytes     payload
  uint32le  masked_crc32c(payload)

``Example`` wire format (the subset every TF data tool emits):
  Example   { Features features = 1; }
  Features  { map<string, Feature> feature = 1; }
  Feature   { oneof { BytesList = 1; FloatList = 2; Int64List = 3; } }
  BytesList { repeated bytes value = 1; }
  FloatList { repeated float value = 1 [packed]; }
  Int64List { repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, BinaryIO, Iterable, Iterator

import numpy as np

from jimm_tpu_torch.data import native

# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------


def _castagnoli_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = 0x82F63B78 ^ (c >> 1) if c & 1 else c >> 1
        table.append(c)
    return table


#: the byte-at-a-time table as Python ints: the writer checksums every
#: payload byte, and indexing a list is several times cheaper than a numpy
#: array scalar per byte
_CRC_TABLE = _castagnoli_table()


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli), on the native library (slice-by-8)."""
    return native.load().jimm_crc32c(bytes(data), len(data))


def crc32c_plain(data: bytes) -> int:
    """Python version of :func:`crc32c`, table-driven."""
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

class TFRecordWriter:
    def __init__(self, path: str | Path):
        self._f: BinaryIO = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_tfrecord(path: str | Path, records: Iterable[bytes]) -> int:
    with TFRecordWriter(path) as w:
        n = 0
        for rec in records:
            w.write(rec)
            n += 1
    return n


def read_tfrecord(path: str | Path, *, verify: bool = True
                  ) -> Iterator[bytes]:
    """Yield raw record payloads; ``verify`` checks both framing CRCs."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,), (len_crc,) = (struct.unpack("<Q", header[:8]),
                                     struct.unpack("<I", header[8:]))
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise ValueError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record body")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise ValueError(f"{path}: truncated record crc")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if verify and masked_crc32c(data) != data_crc:
                raise ValueError(f"{path}: corrupt record crc")
            yield data


# ---------------------------------------------------------------------------
# Minimal protobuf wire helpers
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:  # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------------------
# tf.train.Example encode / decode
# ---------------------------------------------------------------------------

def encode_example(features: dict[str, Any]) -> bytes:
    """dict -> serialized ``tf.train.Example``. Value types: ``bytes``/``str``
    (or list thereof) -> BytesList; ints -> Int64List; floats -> FloatList."""
    feat_entries = []
    for name, value in features.items():
        if isinstance(value, (bytes, str, int, float, np.integer, np.floating)):
            value = [value]
        value = list(value)
        if not value:
            raise ValueError(f"feature {name!r} is empty")
        first = value[0]
        if isinstance(first, (bytes, str)):
            payload = b"".join(
                _len_delim(1, v.encode() if isinstance(v, str) else v)
                for v in value)
            feature = _len_delim(1, payload)  # BytesList
        elif isinstance(first, (int, np.integer)):
            # plain int64 varints (two's complement)
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                              for v in value)
            feature = _len_delim(3, _len_delim(1, packed))  # Int64List packed
        elif isinstance(first, (float, np.floating)):
            packed = np.asarray(value, "<f4").tobytes()
            feature = _len_delim(2, _len_delim(1, packed))  # FloatList packed
        else:
            raise TypeError(f"feature {name!r}: {type(first)}")
        entry = _len_delim(1, name.encode()) + _len_delim(2, feature)
        feat_entries.append(_len_delim(1, entry))  # map entry
    features_msg = b"".join(feat_entries)
    return _len_delim(1, features_msg)  # Example.features


def _decode_feature(buf: bytes) -> list:
    for field, _, val in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList
            out: list = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    out.extend(np.frombuffer(v, "<f4").tolist())
                else:  # unpacked 32-bit
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List
            out = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        n, pos = _read_varint(v, pos)
                        out.append(n - (1 << 64) if n >= 1 << 63 else n)
                else:
                    out.append(v - (1 << 64) if v >= 1 << 63 else v)
            return out
    return []


def decode_example(buf: bytes) -> dict[str, list]:
    """Serialized ``tf.train.Example`` -> ``{name: list-of-values}``."""
    out: dict[str, list] = {}
    for field, _, features_msg in _iter_fields(buf):
        if field != 1:
            continue
        for f, _, entry in _iter_fields(features_msg):
            if f != 1:
                continue
            name, feature = "", b""
            for ef, _, ev in _iter_fields(entry):
                if ef == 1:
                    name = ev.decode()
                elif ef == 2:
                    feature = ev
            out[name] = _decode_feature(feature)
    return out

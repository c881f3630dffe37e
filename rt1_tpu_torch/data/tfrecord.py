"""TFRecord files and `tf.train.Example` messages without TensorFlow.

A TFRecord file is a run of records, each framed as

    uint64 length (little endian)
    uint32 masked CRC32C of the length's 8 bytes
    byte   data[length]
    uint32 masked CRC32C of the data

(`tensorflow/core/lib/io/record_writer.cc`). `read_records` checks both
CRCs and raises `DataLossError`, as TF's reader does, on a mismatch or a
truncated record.

`parse_example` decodes the protobuf wire format of `tf.train.Example`
(`tensorflow/core/example/{example,feature}.proto`): an `Example` holds
`Features` (field 1), whose `feature` map (field 1) holds entries of a key
(field 1) and a `Feature` (field 2), which is one of `bytes_list` (1),
`float_list` (2) or `int64_list` (3), each a repeated field 1. Floats and
int64s may come packed (one length-delimited run) or one by one; packed
floats are read with `np.frombuffer` and packed varints are decoded
vectorised. The result maps each key to a list of bytes, a float32 array
or an int64 array.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

import numpy as np

from rt1_tpu_torch.data import codecs

FeatureValue = Union[List[bytes], np.ndarray]


class DataLossError(IOError):
    """A corrupt or truncated TFRecord (TF's `DataLossError`)."""


def read_records(path: str) -> Iterator[bytes]:
    """The records of one TFRecord file, in order."""
    with open(path, "rb") as f:
        offset = 0
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise DataLossError(f"{path}: truncated record header at byte {offset}")
            length, length_crc = struct.unpack("<QI", header)
            if codecs.masked_crc32c(header[:8]) != length_crc:
                raise DataLossError(f"{path}: corrupted record at byte {offset} (length CRC)")
            body = f.read(length + 4)
            if len(body) < length + 4:
                raise DataLossError(f"{path}: truncated record at byte {offset}")
            data = body[:length]
            if codecs.masked_crc32c(data) != struct.unpack("<I", body[length:])[0]:
                raise DataLossError(f"{path}: corrupted record at byte {offset} (data CRC)")
            offset += 12 + length + 4
            yield data


def _varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise DataLossError("truncated varint in an Example")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise DataLossError("varint longer than 10 bytes in an Example")


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message
    (`buf`, a memoryview, so that nested messages are never copied); the
    value is an int for varints, a memoryview otherwise."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise DataLossError(f"unsupported wire type {wire} in an Example")
        if pos > end:
            raise DataLossError("truncated field in an Example")
        yield field, wire, value


def decode_varints(buf: bytes) -> np.ndarray:
    """A packed run of varints -> int64 (two's complement, as protobuf's
    int64 encodes negatives), vectorised over the run."""
    b = np.frombuffer(buf, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.int64)
    last = b < 0x80
    if not last[-1]:
        raise DataLossError("truncated packed varint in an Example")
    ends = np.flatnonzero(last)
    starts = np.concatenate([[0], ends[:-1] + 1])
    lengths = ends - starts + 1
    if lengths.max() > 10:
        raise DataLossError("varint longer than 10 bytes in an Example")
    place = np.arange(b.size) - np.repeat(starts, lengths)
    parts = (b & 0x7F).astype(np.uint64) << (7 * place).astype(np.uint64)
    # The parts of one varint occupy disjoint bits: their sum is their OR.
    return np.add.reduceat(parts, starts).view(np.int64)


def _feature(buf: bytes) -> FeatureValue:
    kind_value = None
    for field, wire, value in _fields(buf):
        if field in (1, 2, 3) and wire == 2:
            kind_value = (field, value)
    if kind_value is None:  # an empty Feature: TF reads it as no values
        return np.zeros(0, np.float32)
    kind, body = kind_value
    if kind == 1:
        return [bytes(v) for f, w, v in _fields(body) if f == 1 and w == 2]
    chunks = []
    for f, w, v in _fields(body):
        if f != 1:
            continue
        if kind == 2:
            chunks.append(np.frombuffer(v, "<f4"))
        elif w == 2:
            chunks.append(decode_varints(v))
        else:
            chunks.append(np.array([v], np.uint64).view(np.int64))
    dtype = np.float32 if kind == 2 else np.int64
    if not chunks:
        return np.zeros(0, dtype)
    return np.concatenate(chunks).astype(dtype, copy=False)


def parse_example(buf: bytes) -> Dict[str, FeatureValue]:
    """One serialized `tf.train.Example` -> {key: list of bytes | float32
    array | int64 array}. A key repeated in the map keeps its last value,
    as protobuf's map parsing does."""
    out: Dict[str, FeatureValue] = {}
    for field, wire, features in _fields(memoryview(buf)):
        if field != 1 or wire != 2:
            continue
        for f, w, entry in _fields(features):
            if f != 1 or w != 2:
                continue
            key, value = "", np.zeros(0, np.float32)
            for ef, ew, ev in _fields(entry):
                if ef == 1 and ew == 2:
                    key = bytes(ev).decode("utf-8")
                elif ef == 2 and ew == 2:
                    value = _feature(ev)
            out[key] = value
    return out

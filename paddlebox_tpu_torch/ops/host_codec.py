"""Host-wire codecs: delta+varint key streams, narrow-int row ids, chunked
zlib frames.

Port of the JAX package's ``ops/host_codec.py``, pure numpy and the same
bytes: a frame either package encodes, the other decodes.

The device plane already compresses its traffic (``ops/wire_quant.py`` rows,
the bf16/int8 mesh all_to_all in ``parallel/sharded_pullpush.py``); this
module is the HOST plane's counterpart — the open rebuild of the byte
formats the reference's closed ``boxps::PaddleShuffler`` key-exchange tier
ships between nodes. Three codecs, all pure numpy, all round-trip exact:

- **Sorted-u64 delta+varint** (``encode_sorted_u64``): the working-set
  exchange moves *sorted unique* uint64 feasign streams. Gaps between
  consecutive keys are tiny compared to the absolute 64-bit values (CTR
  sign spaces are dense), so delta + LEB128 varint lands at ~1-2 bytes/key
  instead of 8 — the SparCML observation that sparse-stream *index*
  compression is the dominant win for this exchange shape. Non-monotonic
  input is rejected at encode time; a decoded stream that wraps uint64 is
  rejected at decode time, so a malformed buffer can never round-trip
  silently.
- **Narrow-int row ids** (``encode_row_ids``): global rows are
  ``shard * capacity + rank`` — bounded by ``n_mesh_shards * capacity``,
  which in practice fits uint32 (often uint16). The encoder picks the
  narrowest width that holds the declared bound and *asserts* every value
  fits, so an overflow is a loud codec error, never a truncated id.
- **Chunked zlib frame** (``compress_chunked``): a generic byte-stream
  codec for the transport's frame payloads (shuffle chunks, anything
  opaque). Input is compressed in bounded chunks so peak codec RAM stays
  ~chunk-sized on both ends; the header pins the exact raw length and every
  chunk's compressed length, so truncation and length lies are caught
  before (or during) inflate and surface as :class:`HostCodecError`.

``parallel/transport.py`` (PBTX v3) frames these on the wire — the codec
byte in the frame header says how the payload is encoded, the frame CRC32
covers the *compressed* body so corruption is caught before inflate, and
the ``wire.host_*`` counters at that choke point measure what it saves.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


class HostCodecError(ValueError):
    """Malformed host-wire codec input — rejected, never silently decoded."""


# ---------------------------------------------------------------------------
# sorted uint64 streams: delta + LEB128 varint
# ---------------------------------------------------------------------------

_U64_HDR = struct.Struct("<Q")  # value count

_SEVEN = np.uint64(7)
_LOW7 = np.uint64(0x7F)


def _varint_encode(vals: np.ndarray) -> np.ndarray:
    """uint64 values -> LEB128 byte stream (vectorized; <=10 passes)."""
    n = len(vals)
    if n == 0:
        return np.zeros(0, np.uint8)
    # bytes per value: ceil(bit_length / 7), minimum 1
    nb = np.ones(n, np.int64)
    v = vals >> _SEVEN
    while v.any():
        nb += v > 0
        v >>= _SEVEN
    starts = np.zeros(n, np.int64)
    np.cumsum(nb[:-1], out=starts[1:])
    out = np.zeros(int(nb.sum()), np.uint8)
    cur = vals
    j = 0
    while True:
        m = nb > j
        if not m.any():
            break
        more = nb[m] > j + 1
        out[starts[m] + j] = (cur[m] & _LOW7).astype(np.uint8) | (
            more.astype(np.uint8) << 7
        )
        cur = cur >> _SEVEN
        j += 1
    return out


def _varint_decode(buf: np.ndarray, n: int) -> np.ndarray:
    """LEB128 byte stream -> exactly ``n`` uint64 values (vectorized)."""
    if n == 0:
        if len(buf):
            raise HostCodecError(
                f"varint stream: header says 0 values but {len(buf)} "
                "payload bytes follow"
            )
        return np.zeros(0, np.uint64)
    if len(buf) == 0:
        raise HostCodecError(f"varint stream truncated: 0 bytes for {n} values")
    ends = (buf & 0x80) == 0  # bytes without a continuation bit terminate
    n_vals = int(ends.sum())
    if n_vals != n or not ends[-1]:
        raise HostCodecError(
            f"varint stream holds {n_vals} terminated values, header says "
            f"{n} (truncated or corrupt)"
        )
    group_starts = np.zeros(n, np.int64)
    group_starts[1:] = np.nonzero(ends)[0][:-1] + 1
    gid = np.zeros(len(buf), np.int64)
    gid[1:] = np.cumsum(ends[:-1])
    within = np.arange(len(buf), dtype=np.int64) - group_starts[gid]
    if int(within.max()) > 9:
        raise HostCodecError("varint longer than 10 bytes cannot fit uint64")
    # the 10th byte carries bits [63, 70): anything above bit 63 overflows
    if np.any((within == 9) & ((buf & 0x7F) > 1)):
        raise HostCodecError("varint value overflows uint64")
    contrib = (buf.astype(np.uint64) & _LOW7) << (
        _SEVEN * within.astype(np.uint64)
    )
    # per-group bit fields are disjoint, so the reduceat sum is exact
    return np.add.reduceat(contrib, group_starts)


def encode_sorted_u64(keys: np.ndarray) -> bytes:
    """Sorted (non-decreasing) uint64 stream -> delta+varint bytes."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    if n == 0:
        return _U64_HDR.pack(0)
    if n > 1 and np.any(keys[1:] < keys[:-1]):
        raise HostCodecError(
            "encode_sorted_u64 requires a non-decreasing key stream"
        )
    deltas = np.empty(n, np.uint64)
    deltas[0] = keys[0]
    np.subtract(keys[1:], keys[:-1], out=deltas[1:])
    return _U64_HDR.pack(n) + _varint_encode(deltas).tobytes()


def decode_sorted_u64(data: bytes) -> np.ndarray:
    """Inverse of :func:`encode_sorted_u64`; rejects malformed buffers."""
    if len(data) < _U64_HDR.size:
        raise HostCodecError(
            f"key stream shorter than its {_U64_HDR.size}-byte header"
        )
    (n,) = _U64_HDR.unpack_from(data)
    buf = np.frombuffer(data, np.uint8, offset=_U64_HDR.size)
    deltas = _varint_decode(buf, n)
    keys = np.cumsum(deltas, dtype=np.uint64)
    # deltas are non-negative, so any decrease means the cumsum wrapped
    # uint64 — a malformed stream, not a representable key set
    if len(keys) > 1 and np.any(keys[1:] < keys[:-1]):
        raise HostCodecError("key stream overflows uint64 (corrupt deltas)")
    return keys


# ---------------------------------------------------------------------------
# self-describing key-stream wrapper (raw ablation interoperates with codec)
# ---------------------------------------------------------------------------

KEYS_RAW = 0  # marker + raw little-endian uint64 bytes
KEYS_DELTA = 1  # marker + delta+varint


def encode_key_stream(keys: np.ndarray, codec: bool) -> bytes:
    """One sorted-u64 payload for the working-set exchange. The leading
    marker byte makes the format self-describing, so a codec-on rank and a
    raw-ablation rank decode each other's frames identically."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if codec:
        return bytes([KEYS_DELTA]) + encode_sorted_u64(keys)
    return bytes([KEYS_RAW]) + keys.tobytes()


def decode_key_stream(data: bytes) -> np.ndarray:
    if len(data) < 1:
        raise HostCodecError("key stream payload missing its marker byte")
    marker, body = data[0], data[1:]
    if marker == KEYS_DELTA:
        return decode_sorted_u64(body)
    if marker == KEYS_RAW:
        if len(body) % 8:
            raise HostCodecError(
                f"raw key stream length {len(body)} is not a multiple of 8"
            )
        return np.frombuffer(body, dtype=np.uint64)
    raise HostCodecError(f"unknown key stream marker {marker}")


# ---------------------------------------------------------------------------
# row ids: narrowest unsigned width that holds the declared bound
# ---------------------------------------------------------------------------

_ROW_HDR = struct.Struct("<BQ")  # itemsize, count
_ROW_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def row_id_dtype(max_value: int):
    """Narrowest unsigned dtype holding ``[0, max_value]``."""
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_value <= int(np.iinfo(dt).max):
            return dt
    raise HostCodecError(f"row id bound {max_value} exceeds uint64")


def encode_row_ids(rows: np.ndarray, max_value: int) -> bytes:
    """Global row ids -> narrow-int bytes. ``max_value`` is the declared
    inclusive bound (``n_mesh_shards * capacity - 1``); any value outside
    ``[0, max_value]`` is an overflow and raises rather than truncating."""
    rows = np.ascontiguousarray(rows)
    if len(rows):
        lo, hi = int(rows.min()), int(rows.max())
        if lo < 0 or hi > max_value:
            raise HostCodecError(
                f"row id range [{lo}, {hi}] outside declared bound "
                f"[0, {max_value}]"
            )
    arr = rows.astype(row_id_dtype(max_value))
    return _ROW_HDR.pack(arr.dtype.itemsize, len(arr)) + arr.tobytes()


def decode_row_ids(data: bytes) -> np.ndarray:
    """Inverse of :func:`encode_row_ids`; always returns int64."""
    if len(data) < _ROW_HDR.size:
        raise HostCodecError(
            f"row id payload shorter than its {_ROW_HDR.size}-byte header"
        )
    width, n = _ROW_HDR.unpack_from(data)
    if width not in _ROW_DTYPES:
        raise HostCodecError(f"row id width {width} not in {{1,2,4,8}}")
    body = len(data) - _ROW_HDR.size
    if body != width * n:
        raise HostCodecError(
            f"row id payload holds {body} bytes, header says {n} x {width}"
        )
    return np.frombuffer(
        data, _ROW_DTYPES[width], count=n, offset=_ROW_HDR.size
    ).astype(np.int64)


# ---------------------------------------------------------------------------
# chunked zlib frames (opaque byte payloads: shuffle chunks etc.)
# ---------------------------------------------------------------------------

_ZFRAME_HDR = struct.Struct("<QII")  # raw_len, chunk_bytes, n_chunks
_ZCHUNK_LEN = struct.Struct("<I")

DEFAULT_CHUNK_BYTES = 1 << 20


def compress_chunked(
    data: bytes, level: int = 1, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> bytes:
    """zlib-compress ``data`` in bounded chunks. The header records the
    exact raw length and per-chunk compressed lengths, so the decoder can
    bound every read and verify every inflated size."""
    if chunk_bytes <= 0:
        raise HostCodecError(f"chunk_bytes must be positive, got {chunk_bytes}")
    chunks = [
        zlib.compress(data[i : i + chunk_bytes], level)
        for i in range(0, len(data), chunk_bytes)
    ]
    return b"".join(
        [_ZFRAME_HDR.pack(len(data), chunk_bytes, len(chunks))]
        + [_ZCHUNK_LEN.pack(len(c)) for c in chunks]
        + chunks
    )


def decompress_chunked(data: bytes) -> bytes:
    """Inverse of :func:`compress_chunked`; truncation, length lies, and
    corrupt deflate streams all raise :class:`HostCodecError`."""
    if len(data) < _ZFRAME_HDR.size:
        raise HostCodecError(
            f"zlib frame shorter than its {_ZFRAME_HDR.size}-byte header"
        )
    raw_len, chunk_bytes, n_chunks = _ZFRAME_HDR.unpack_from(data)
    if chunk_bytes <= 0:
        raise HostCodecError(f"zlib frame declares chunk_bytes {chunk_bytes}")
    expect_chunks = max(0, -(-raw_len // chunk_bytes))
    if n_chunks != expect_chunks:
        raise HostCodecError(
            f"zlib frame declares {n_chunks} chunks for {raw_len} raw bytes "
            f"at {chunk_bytes}/chunk (expected {expect_chunks})"
        )
    off = _ZFRAME_HDR.size
    lens = []
    for _ in range(n_chunks):
        if off + _ZCHUNK_LEN.size > len(data):
            raise HostCodecError("zlib frame truncated inside its chunk table")
        (clen,) = _ZCHUNK_LEN.unpack_from(data, off)
        lens.append(clen)
        off += _ZCHUNK_LEN.size
    if off + sum(lens) != len(data):
        raise HostCodecError(
            f"zlib frame holds {len(data) - off} chunk bytes, chunk table "
            f"says {sum(lens)}"
        )
    out = []
    for i, clen in enumerate(lens):
        want = min(chunk_bytes, raw_len - i * chunk_bytes)
        try:
            raw = zlib.decompress(data[off : off + clen])
        except zlib.error as e:
            raise HostCodecError(f"corrupt zlib chunk {i}: {e}") from e
        if len(raw) != want:
            raise HostCodecError(
                f"zlib chunk {i} inflated to {len(raw)} bytes, expected {want}"
            )
        out.append(raw)
        off += clen
    return b"".join(out)

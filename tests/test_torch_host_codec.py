"""The port's host-wire codecs (``ops/host_codec.py``) against the JAX
package's, bitwise.

The cases of ``tests/test_host_codec.py``: every encoder's bytes equal the
JAX package's on the same numpy input, each package decodes the other's
bytes to the same arrays, and every malformed input the JAX decoder
rejects the port's rejects too (with its own ``HostCodecError``, a
``ValueError``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddlebox_tpu.ops import host_codec as jhc
from paddlebox_tpu_torch.ops import host_codec as hc

torch.set_num_threads(1)


def both_keys(keys):
    """Encode with both packages, check the bytes and the cross-decodes."""
    enc, jenc = hc.encode_sorted_u64(keys), jhc.encode_sorted_u64(keys)
    assert enc == jenc
    for out in (hc.decode_sorted_u64(jenc), jhc.decode_sorted_u64(enc)):
        assert out.dtype == np.uint64
        np.testing.assert_array_equal(out, keys)
    return enc


def both_reject(fn_name, data):
    with pytest.raises(hc.HostCodecError):
        getattr(hc, fn_name)(data)
    with pytest.raises(jhc.HostCodecError):
        getattr(jhc, fn_name)(data)


# ---- sorted-u64 delta+varint ------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000, 50_000])
def test_sorted_u64_roundtrip_exact(n):
    rng = np.random.default_rng(n)
    both_keys(np.unique(rng.integers(0, 2**63, n).astype(np.uint64)))


def test_single_key_and_empty_stream():
    both_keys(np.zeros(0, np.uint64))
    both_keys(np.array([2**64 - 1], np.uint64))


def test_max_gap_uint64_deltas():
    both_keys(np.array([0, 1, 2**63, 2**64 - 1], np.uint64))


def test_duplicate_keys_roundtrip():
    both_keys(np.array([5, 5, 5, 9, 9], np.uint64))


def test_dense_keyspace_compresses_hard():
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 10**6, 100_000).astype(np.uint64))
    assert keys.nbytes / len(both_keys(keys)) > 4.0


def test_non_monotonic_input_rejected():
    with pytest.raises(hc.HostCodecError):
        hc.encode_sorted_u64(np.array([7, 3], np.uint64))
    with pytest.raises(jhc.HostCodecError):
        jhc.encode_sorted_u64(np.array([7, 3], np.uint64))


def test_truncated_stream_rejected():
    keys = np.unique(np.random.default_rng(1).integers(0, 10**9, 500).astype(np.uint64))
    enc = both_keys(keys)
    for cut in (len(enc) - 1, len(enc) // 2, hc._U64_HDR.size - 1, 0):
        both_reject("decode_sorted_u64", enc[:cut])


def test_count_lie_rejected():
    enc = bytearray(both_keys(np.arange(10, dtype=np.uint64)))
    enc[:8] = hc._U64_HDR.pack(11)
    both_reject("decode_sorted_u64", bytes(enc))


def test_overlong_varint_rejected():
    both_reject("decode_sorted_u64", hc._U64_HDR.pack(1) + b"\x80" * 11 + b"\x00")


def test_uint64_overflow_rejected():
    both_reject("decode_sorted_u64", hc._U64_HDR.pack(1) + b"\xff" * 9 + b"\x7f")
    vals = np.array([2**64 - 1, 2**64 - 1], np.uint64)
    varint = hc._varint_encode(vals).tobytes()
    assert varint == jhc._varint_encode(vals).tobytes()
    both_reject("decode_sorted_u64", hc._U64_HDR.pack(2) + varint)


# ---- the key-stream wrapper ---------------------------------------------------


def test_key_stream_wrapper_both_markers():
    keys = np.unique(np.random.default_rng(2).integers(0, 10**7, 3000).astype(np.uint64))
    for codec in (True, False):
        enc = hc.encode_key_stream(keys, codec)
        assert enc == jhc.encode_key_stream(keys, codec)
        np.testing.assert_array_equal(jhc.decode_key_stream(enc), keys)
        np.testing.assert_array_equal(hc.decode_key_stream(jhc.encode_key_stream(keys, codec)), keys)
    assert len(hc.encode_key_stream(keys, True)) < len(hc.encode_key_stream(keys, False))


def test_key_stream_wrapper_rejects_garbage():
    for data in (b"", bytes([99]) + b"whatever", bytes([hc.KEYS_RAW]) + b"12345"):
        both_reject("decode_key_stream", data)


# ---- narrow-int row ids -------------------------------------------------------


@pytest.mark.parametrize("bound,width", [(200, 1), (65_535, 2), (65_536, 4), (2**32 - 1, 4), (2**32, 8)])
def test_row_ids_narrowest_width(bound, width):
    rng = np.random.default_rng(bound % 97)
    rows = rng.integers(0, bound + 1, 257).astype(np.int64)
    enc = hc.encode_row_ids(rows, bound)
    assert enc == jhc.encode_row_ids(rows, bound)
    assert len(enc) == hc._ROW_HDR.size + width * len(rows)
    assert hc.row_id_dtype(bound) == jhc.row_id_dtype(bound)
    for out in (hc.decode_row_ids(jhc.encode_row_ids(rows, bound)), jhc.decode_row_ids(enc)):
        assert out.dtype == np.int64
        np.testing.assert_array_equal(out, rows)


def test_row_ids_empty_roundtrip():
    enc = hc.encode_row_ids(np.zeros(0, np.int64), 1000)
    assert enc == jhc.encode_row_ids(np.zeros(0, np.int64), 1000)
    assert len(hc.decode_row_ids(enc)) == len(jhc.decode_row_ids(enc)) == 0


def test_row_ids_overflow_asserts():
    for rows in (np.array([70_000], np.int64), np.array([-1], np.int64)):
        with pytest.raises(hc.HostCodecError):
            hc.encode_row_ids(rows, 65_535)
        with pytest.raises(jhc.HostCodecError):
            jhc.encode_row_ids(rows, 65_535)


def test_row_ids_malformed_rejected():
    enc = hc.encode_row_ids(np.arange(10, dtype=np.int64), 1000)
    bad = bytearray(enc)
    bad[0] = 3
    for data in (enc[:-1], enc[: hc._ROW_HDR.size - 1], bytes(bad)):
        both_reject("decode_row_ids", data)


# ---- chunked zlib frames ------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 511, 4096, 3_000_000])
def test_chunked_zlib_roundtrip(size):
    rng = np.random.default_rng(size % 101)
    blob = bytes(rng.integers(0, 8, size, dtype=np.uint8))
    enc = hc.compress_chunked(blob, level=1)
    assert enc == jhc.compress_chunked(blob, level=1)
    assert hc.decompress_chunked(enc) == jhc.decompress_chunked(enc) == blob


def test_chunked_zlib_multi_chunk_bounded():
    blob = b"paddlebox" * 5000
    enc = hc.compress_chunked(blob, level=1, chunk_bytes=len(blob) // 10 + 1)
    assert enc == jhc.compress_chunked(blob, level=1, chunk_bytes=len(blob) // 10 + 1)
    assert hc.decompress_chunked(enc) == jhc.decompress_chunked(enc) == blob


def test_chunked_zlib_truncation_rejected():
    enc = hc.compress_chunked(b"hello world" * 500, level=1)
    for cut in (len(enc) - 2, hc._ZFRAME_HDR.size + 1, 3):
        both_reject("decompress_chunked", enc[:cut])


def test_chunked_zlib_bitflip_rejected():
    enc = bytearray(hc.compress_chunked(b"hello world" * 500, level=1))
    enc[hc._ZFRAME_HDR.size + 6] ^= 0xFF
    both_reject("decompress_chunked", bytes(enc))


def test_chunked_zlib_length_lie_rejected():
    enc = bytearray(hc.compress_chunked(b"x" * 1000, level=1))
    enc[: hc._ZFRAME_HDR.size] = hc._ZFRAME_HDR.pack(999, hc.DEFAULT_CHUNK_BYTES, 1)
    both_reject("decompress_chunked", bytes(enc))

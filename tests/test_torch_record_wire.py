"""The record store's wire (``ColumnarRecords.to_bytes`` / ``from_bytes``)
against the JAX package's, byte for byte.

The stores of ``tests/test_record_store.py`` (with and without logkey
metadata and instance ids, empty, and a large one), built from the same
numpy records in both packages: ``to_bytes`` equal, each package's
``from_bytes`` reading the other's bytes to the same columns, the legacy
v1 ``np.savez`` payload read by both, and the malformed payloads the JAX
decoder rejects rejected by the port's too.
"""

import io

import numpy as np
import pytest
import torch

from paddlebox_tpu.data.record_store import ColumnarRecords as JColumnarRecords
from paddlebox_tpu.data.slot_record import SlotRecord as JSlotRecord
from paddlebox_tpu.data.slot_schema import SlotInfo as JSlotInfo
from paddlebox_tpu.data.slot_schema import SlotSchema as JSlotSchema
from paddlebox_tpu_torch.data import SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.record_store import ColumnarRecords
from paddlebox_tpu_torch.data.slot_record import SlotRecord

torch.set_num_threads(1)

NS = 5
WIRE_COLS = ("u64_values", "u64_offsets", "u64_base", "f_values", "f_offsets", "f_base", "search_ids", "cmatch", "rank")


def schema(info_cls, schema_cls, with_logkey):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)] + [info_cls(f"s{i}") for i in range(NS)],
                      label_slot="label", parse_logkey=with_logkey)


def records(rec_cls, seed, n, with_meta):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lens = rng.integers(1, 4, NS)
        out.append(rec_cls(
            u64_values=rng.integers(1, 1000, int(lens.sum())).astype(np.uint64),
            u64_offsets=np.concatenate([[0], np.cumsum(lens)]).astype(np.uint32),
            f_values=np.array([float(rng.integers(0, 2))], np.float32),
            f_offsets=np.array([0, 1], np.uint32),
            ins_id=f"ins{i}" if with_meta else "",
            search_id=int(rng.integers(0, 50)) if with_meta else 0,
            cmatch=int(rng.integers(0, 4)) if with_meta else 0,
            rank=int(rng.integers(0, 3)) if with_meta else 0,
        ))
    return out


def stores(seed, n, with_meta):
    """The same store in both packages: (port, JAX)."""
    port = ColumnarRecords.from_records(records(SlotRecord, seed, n, with_meta), schema(SlotInfo, SlotSchema, with_meta))
    jax_ = JColumnarRecords.from_records(records(JSlotRecord, seed, n, with_meta),
                                         schema(JSlotInfo, JSlotSchema, with_meta))
    return port, jax_


def assert_same(a, b):
    for col in WIRE_COLS:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col), err_msg=col)
    assert (a.ins_id_off is None) == (b.ins_id_off is None)
    if a.ins_id_off is not None:
        np.testing.assert_array_equal(a.ins_id_off, b.ins_id_off)
    assert bytes(a.ins_id_chars) == bytes(b.ins_id_chars)


@pytest.mark.parametrize("with_meta", [False, True])
@pytest.mark.parametrize("n", [1, 23, 5000])
def test_to_bytes_bitwise_and_cross_decodes(with_meta, n):
    port, jax_ = stores(7 + n, n, with_meta)
    blob, jblob = port.to_bytes(), jax_.to_bytes()
    assert blob[:4] == ColumnarRecords._WIRE_MAGIC
    assert blob == jblob
    back, jback = ColumnarRecords.from_bytes(jblob), JColumnarRecords.from_bytes(blob)
    assert_same(back, port)
    assert_same(jback, jax_)
    assert back.record(0).ins_id == jax_.record(0).ins_id
    assert back.u64_values.flags.writeable  # slots_shuffle rewrites keys in place
    assert back.to_bytes() == blob


def test_empty_store_bitwise():
    port, jax_ = ColumnarRecords.empty(NS, 1), JColumnarRecords.empty(NS, 1)
    assert port.to_bytes() == jax_.to_bytes()
    back = ColumnarRecords.from_bytes(jax_.to_bytes())
    assert len(back) == 0 and back.n_sparse == NS and back.n_float == 1


def test_select_and_concat_ship_alike():
    """The shuffle router's chunks: a selection of a concatenation."""
    (p1, j1), (p2, j2) = stores(1, 30, True), stores(2, 17, True)
    idx = np.array([0, 3, 5, 29, 31, 46], np.int64)
    part = ColumnarRecords.concat([p1, p2]).select(idx)
    jpart = JColumnarRecords.concat([j1, j2]).select(idx)
    assert part.to_bytes() == jpart.to_bytes()


def test_v1_npz_payload_decodes_in_both():
    port, jax_ = stores(11, 12, True)
    bio = io.BytesIO()
    np.savez(bio, **{c: getattr(jax_, c) for c in WIRE_COLS}, ins_id_off=jax_.ins_id_off,
             ins_id_chars=np.frombuffer(jax_.ins_id_chars, np.uint8))
    assert_same(ColumnarRecords.from_bytes(bio.getvalue()), port)
    assert_same(JColumnarRecords.from_bytes(bio.getvalue()), jax_)


def test_v2_header_and_rejections_match():
    port, _ = stores(13, 8, True)
    blob = port.to_bytes()
    hdr = ColumnarRecords._WIRE_HDR.unpack_from(blob)
    assert hdr == JColumnarRecords._WIRE_HDR.unpack_from(blob)
    assert hdr[1] == ColumnarRecords._WIRE_VERSION == JColumnarRecords._WIRE_VERSION == 2
    bad = bytearray(blob)
    bad[4] = 99  # unsupported version
    for data in (b"garbage-not-a-payload", blob[:-3], blob + b"xx", bytes(bad)):
        with pytest.raises(ValueError):
            ColumnarRecords.from_bytes(data)
        with pytest.raises(ValueError):
            JColumnarRecords.from_bytes(data)

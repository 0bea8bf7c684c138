"""The port's working set and batch packer against the JAX package: the
arrays must be byte-equal (same values, same dtypes)."""

import numpy as np
import pytest

from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.data.device_pack import pack_batch as jpack_batch
from paddlebox_tpu.data.parser import parse_line as jparse_line
from paddlebox_tpu.data.slot_record import build_batch as jbuild_batch
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.table.sparse_table import merge_unique_keys as jmerge_unique_keys
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu_torch.data import SlotInfo, SlotSchema, build_batch, pack_batch, parse_line
from paddlebox_tpu_torch.table.sparse_table import PassWorkingSet, merge_unique_keys
from paddlebox_tpu_torch.table.value_layout import ValueLayout

S, B = 5, 8


class _Rows:
    """A row source both working sets can pull from: row = f(key)."""

    def __init__(self, layout):
        self.layout = layout

    def pull_or_create(self, keys):
        k = keys.astype(np.float64)[:, None]
        cols = np.arange(self.layout.width, dtype=np.float64)[None, :]
        return np.sin(k * 0.001 + cols).astype(np.float32)


def _lines(seed, n=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [f"1 {float(rng.integers(0, 2))}"]
        for _ in range(S):
            k = int(rng.integers(1, 4))
            parts.append(f"{k} " + " ".join(str(int(v)) for v in rng.integers(1, 60, k)))
        out.append(" ".join(parts))
    return out


def _schemas():
    def mk(info, schema):
        return schema(
            [info("label", type="float", dense=True, dim=1)]
            + [info(f"s{i}") for i in range(S)],
            label_slot="label",
        )

    return mk(JSlotInfo, JSlotSchema), mk(SlotInfo, SlotSchema)


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _finalized(n_shards, round_to, seed):
    lines = _lines(seed)
    jschema, schema = _schemas()
    jbatch = jbuild_batch([jparse_line(ln, jschema) for ln in lines], jschema)
    batch = build_batch([parse_line(ln, schema) for ln in lines], schema)
    jws, ws = JPassWorkingSet(n_mesh_shards=n_shards), PassWorkingSet(n_mesh_shards=n_shards)
    jws.add_keys(jbatch.keys)
    ws.add_keys(batch.keys)
    jdev = jws.finalize(_Rows(JValueLayout(embedx_dim=4)), round_to=round_to)
    dev = ws.finalize(_Rows(ValueLayout(embedx_dim=4)), round_to=round_to)
    return (jbatch, jws, jdev, jschema), (batch, ws, dev, schema)


@pytest.mark.parametrize("n_shards,round_to", [(1, 8), (4, 16), (1, 256)])
def test_finalize_byte_equal(n_shards, round_to):
    (jbatch, jws, jdev, _), (batch, ws, dev, _) = _finalized(n_shards, round_to, n_shards)
    _assert_same(batch.keys, jbatch.keys)
    _assert_same(dev, np.asarray(jdev))
    _assert_same(ws.sorted_keys, jws.sorted_keys)
    _assert_same(ws.row_of_sorted, jws.row_of_sorted)
    assert (ws.capacity, ws.padding_row, ws.n_keys) == (jws.capacity, jws.padding_row, jws.n_keys)
    _assert_same(ws.lookup(batch.keys), jws.lookup(jbatch.keys))


@pytest.mark.parametrize("dedup", [True, False])
def test_pack_batch_byte_equal(dedup):
    (jbatch, jws, _, jschema), (batch, ws, _, schema) = _finalized(1, 8, 11)
    jdb = jpack_batch(jbatch, jws, jschema, bucket=16, dedup=dedup)
    db = pack_batch(batch, ws, schema, bucket=16, dedup=dedup)
    jd, d = jdb.as_dict(), db.as_dict()
    assert sorted(jd) == sorted(d)
    for k in d:
        _assert_same(d[k], np.asarray(jd[k]))
    assert (db.n_keys, db.n_uniq, db.batch_size, db.num_slots) == (
        jdb.n_keys, jdb.n_uniq, jdb.batch_size, jdb.num_slots
    )
    # the seqpool precondition: segments never decrease, pads at the tail
    assert np.all(np.diff(db.segments) >= 0) and db.segments[-1] == S * B


def test_lookup_of_absent_key_raises_like_jax():
    (_, jws, _, _), (_, ws, _, _) = _finalized(1, 8, 3)
    absent = np.array([10_000_000], dtype=np.uint64)
    with pytest.raises(KeyError):
        jws.lookup(absent)
    with pytest.raises(KeyError):
        ws.lookup(absent)


def test_merge_unique_keys_threaded_byte_equal():
    rng = np.random.default_rng(9)
    chunks = [np.unique(rng.integers(0, 1 << 40, 100_000).astype(np.uint64)) for _ in range(3)]
    _assert_same(merge_unique_keys(chunks, threads=4), jmerge_unique_keys(chunks, threads=4))
    _assert_same(merge_unique_keys(chunks, threads=4), np.unique(np.concatenate(chunks)))


@pytest.mark.parametrize("n_records", [0, 1, 37])
def test_build_batch_byte_equal(n_records):
    """The slot-major batch, byte for byte the JAX package's: slots of 0-3
    keys, a float slot of 0-2 values, and an empty batch."""
    from paddlebox_tpu.data.slot_record import SlotRecord as JSlotRecord
    from paddlebox_tpu_torch.data.slot_record import SlotRecord

    rng = np.random.default_rng(n_records)
    infos = [("w", "float"), ("s0", "uint64"), ("s1", "uint64"), ("s2", "uint64")]
    jschema = JSlotSchema([JSlotInfo(n, type=t) for n, t in infos])
    schema = SlotSchema([SlotInfo(n, type=t) for n, t in infos])
    recs, jrecs = [], []
    for _ in range(n_records):
        u_off = np.concatenate([[0], np.cumsum(rng.integers(0, 4, 3))]).astype(np.uint32)
        f_off = np.concatenate([[0], np.cumsum(rng.integers(0, 3, 1))]).astype(np.uint32)
        u = rng.integers(1, 1 << 62, int(u_off[-1]), dtype=np.uint64)
        f = rng.random(int(f_off[-1])).astype(np.float32)
        recs.append(SlotRecord(u64_values=u, u64_offsets=u_off, f_values=f, f_offsets=f_off))
        jrecs.append(JSlotRecord(u64_values=u, u64_offsets=u_off, f_values=f, f_offsets=f_off))
    got, want = build_batch(recs, schema), jbuild_batch(jrecs, jschema)
    assert got.batch_size == want.batch_size == n_records
    for name in ("keys", "key_offsets", "float_values", "float_offsets"):
        _assert_same(getattr(got, name), getattr(want, name))

"""The port's mesh packers and mesh wire against the JAX package's, exact.

``pack_batch_sharded`` and ``BatchPacker.pack_sharded`` at world 2 and 4
(``req_ranks``, ``inverse``, ``segments``, ``labels``, ``dense`` byte-equal
over a pass of batches with the trainer's sticky pads; the packer's K
frozen by ``freeze_shapes(n_devices=)`` as the JAX packer's lockstep
branch freezes it, here through a one-process transport), with the adaptive
mesh wire's hot-first buckets and ``wire.ici_hot_overflow_keys``; the
working set's hot bits; ``ici_wire_nbytes`` over a grid. Packing is host
numpy, so these run in one process: no ranks are spawned.
"""

import contextlib

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.data.device_pack import BatchPacker as JBatchPacker
from paddlebox_tpu.data.device_pack import pack_batch_sharded as jpack_sharded
from paddlebox_tpu.data.slot_record import build_batch as jbuild_batch
from paddlebox_tpu.ops import wire_quant as jwq
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.utils import native as jnative
from paddlebox_tpu.utils.monitor import STAT_GET as JSTAT_GET
from paddlebox_tpu.utils.monitor import STAT_RESET as JSTAT_RESET
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BatchPacker, SlotInfo, SlotSchema, build_batch
from paddlebox_tpu_torch.data.device_pack import block_pad_stats, pack_batch_sharded
from paddlebox_tpu_torch.ops import wire_quant as wq
from paddlebox_tpu_torch.table import PassWorkingSet, ValueLayout
from paddlebox_tpu_torch.utils import native
from paddlebox_tpu_torch.utils.monitor import STAT_GET, STAT_RESET

torch.set_num_threads(2)

S, D, DENSE_DIM, N_REC, B = 5, 4, 3, 128, 16


def _schema(info_cls, schema_cls):
    return schema_cls(
        [info_cls("label", type="float", dense=True, dim=1), info_cls("d", type="float", dense=True, dim=DENSE_DIM)]
        + [info_cls(f"s{i}") for i in range(S)],
        label_slot="label",
    )


def _lines(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [f"1 {float(rng.random() < 0.3)}", f"{DENSE_DIM} " + " ".join(f"{v:.6g}" for v in rng.normal(size=DENSE_DIM))]
        for _ in range(S):
            k = int(rng.integers(1, 4))
            parts.append(f"{k} " + " ".join(str(int(v)) for v in rng.integers(1, 400, k)))
        out.append(" ".join(parts))
    return out


class _Rows:
    """A row source: the show column is key % 5, so some rows are hot."""

    def __init__(self, layout):
        self.layout = layout

    def pull_or_create(self, keys):
        rows = np.zeros((len(keys), self.layout.width), np.float32)
        rows[:, self.layout.SHOW] = (keys % 5).astype(np.float32)
        return rows


@contextlib.contextmanager
def _flags(**kw):
    before = [(m, k, m.get_flag(k)) for m in (config, jconfig) for k in kw]
    for m in (config, jconfig):
        for k, v in kw.items():
            m.set_flag(k, v)
    try:
        yield
    finally:
        for m, k, v in before:
            m.set_flag(k, v)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _setup(n):
    """Both packages' store, finalized working set (n mesh shards) and
    schema over the same bytes."""
    data = "\n".join(_lines(n, N_REC)).encode()
    schema, jschema = _schema(SlotInfo, SlotSchema), _schema(JSlotInfo, JSlotSchema)
    store = native.parse_buffer_columnar(data, schema)
    jstore = jnative.parse_buffer_columnar(data, jschema)
    ws, jws = PassWorkingSet(n_mesh_shards=n), JPassWorkingSet(n_mesh_shards=n)
    ws.add_keys(store.u64_values)
    jws.add_keys(jstore.u64_values)
    ws.finalize(_Rows(ValueLayout(embedx_dim=D)), round_to=8)
    jws.finalize(_Rows(JValueLayout(embedx_dim=D)), round_to=8)
    return (store, ws, schema), (jstore, jws, jschema)


class _OneProcessTransport:
    """What the JAX packer's lockstep branch asks of a transport, on one
    process: it then freezes K from its exact scan, as the port does."""

    n_ranks = 2

    @staticmethod
    def allreduce_max(value, tag):
        return value


WIRES = {"fp32": dict(ici_wire_dtype="fp32"), "adaptive": dict(ici_wire_dtype="adaptive", ici_hot_frac=0.25)}


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("n", [2, 4])
def test_pack_batch_sharded_matches_jax(n, wire):
    with _flags(**WIRES[wire]):
        (store, ws, schema), (jstore, jws, jschema) = _setup(n)
        if wire == "adaptive":
            _same(ws.hot_rows, jws.hot_rows)
            assert ws.hot_rows.any() and not ws.hot_rows.all()
        else:
            assert ws.hot_rows is None and jws.hot_rows is None
        STAT_RESET("wire.ici_hot_overflow_keys")
        JSTAT_RESET("wire.ici_hot_overflow_keys")
        pads, jpads = [-1, 0], [-1, 0]
        for i in range(N_REC // B):
            recs = [store.record(j) for j in range(i * B, (i + 1) * B)]
            jrecs = [jstore.record(j) for j in range(i * B, (i + 1) * B)]
            db = pack_batch_sharded(build_batch(recs, schema), ws, schema, n, dense_slot="d",
                                    dense_dim=DENSE_DIM, bucket=8, k_floor=pads[0], l_floor=pads[1])
            jdb = jpack_sharded(jbuild_batch(jrecs, jschema), jws, jschema, n, dense_slot="d",
                                dense_dim=DENSE_DIM, bucket=8, k_floor=jpads[0], l_floor=jpads[1])
            for k, v in jdb.as_dict().items():
                _same(db.as_dict()[k], v)
            pads = [db.req_ranks.shape[2], db.inverse.shape[1]]
            jpads = [jdb.req_ranks.shape[2], jdb.inverse.shape[1]]
        assert STAT_GET("wire.ici_hot_overflow_keys") == JSTAT_GET("wire.ici_hot_overflow_keys")


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("n", [2, 4])
def test_pack_sharded_matches_jax(n, wire):
    with _flags(**WIRES[wire]):
        (store, ws, schema), (jstore, jws, jschema) = _setup(n)
        p = BatchPacker(store, ws, schema, dense_slot="d", dense_dim=DENSE_DIM, bucket=8)
        jp = JBatchPacker(jstore, jws, jschema, dense_slot="d", dense_dim=DENSE_DIM, bucket=8)
        order = np.random.default_rng(5).permutation(N_REC)
        parts = [order[i * B : (i + 1) * B] for i in range(N_REC // B)]
        p.freeze_shapes(parts, n_devices=n)
        jp.freeze_shapes(parts, n_devices=n, transport=_OneProcessTransport())
        assert p._K_pad == jp._K_pad
        STAT_RESET("wire.ici_hot_overflow_keys")
        JSTAT_RESET("wire.ici_hot_overflow_keys")
        for idx in parts:
            db, jdb = p.pack_sharded(idx, n), jp.pack_sharded(idx, n)
            for k, v in jdb.as_dict().items():
                _same(db.as_dict()[k], v)
        got, want = STAT_GET("wire.ici_hot_overflow_keys"), JSTAT_GET("wire.ici_hot_overflow_keys")
        assert got == want
        if wire == "adaptive":
            assert got > 0  # the hot-first order and its overflow both ran
        p.close()
        jp.close()


def test_pack_sharded_needs_frozen_k():
    """The packer raises before ``freeze_shapes(n_devices=)``, and on a
    batch past the frozen pads, rather than grow K on one rank."""
    (store, ws, schema), _ = _setup(2)
    p = BatchPacker(store, ws, schema, bucket=8)
    order = np.random.default_rng(5).permutation(N_REC)
    parts = [order[i * B : (i + 1) * B] for i in range(N_REC // B)]
    with pytest.raises(RuntimeError, match="freeze_shapes"):
        p.pack_sharded(parts[0], 2)
    p.freeze_shapes(parts[:1], n_devices=2)
    p.pack_sharded(parts[0], 2)
    with pytest.raises(RuntimeError, match="frozen"):
        p.pack_sharded(order[: 4 * B], 2)
    p.close()


@pytest.mark.parametrize("n", [2, 4])
def test_block_pad_stats_native_matches_numpy(n):
    """``block_pad_stats``' one native sweep and its numpy loop give the
    same (L, most unique rows of one shard) for every rank's block."""
    (store, ws, _), _ = _setup(n)
    rows = store.resolve_rows(ws)
    order = np.random.default_rng(5).permutation(N_REC)
    slices = [order[i * 4 : (i + 1) * 4] for i in range(N_REC // 4)]
    got = {}
    for flag in (True, False):
        with _flags(enable_native_parser=flag):
            got[flag] = block_pad_stats(rows, store.u64_base, store.key_counts(), slices, ws.capacity, n)
    for a, b in zip(got[True], got[False]):
        _same(a, b)
    assert len(set(got[True][1].tolist())) > 1


def test_ici_wire_nbytes_matches_jax():
    for mode in ("fp32", "bf16", "int8", "adaptive"):
        for n, K, W, head, secs, hot in [(2, 16, 11, 2, 1, 0), (4, 24, 15, 2, 2, 3), (4, 8, 21, 5, 1, 8), (8, 40, 7, 2, 1, 39)]:
            assert wq.ici_wire_nbytes(n, K, W, head, secs, mode, hot) == jwq.ici_wire_nbytes(n, K, W, head, secs, mode, hot)
    for K in (1, 7, 8, 16, 100):
        for frac in (0.0, 0.125, 0.5, 1.0):
            with _flags(ici_hot_frac=frac):
                assert wq.ici_hot_slots(K) == jwq.ici_hot_slots(K)


def test_ici_mode_flags_match_jax():
    for mode, gate in [("fp32", True), ("bf16", True), ("int8", False), ("adaptive", True), ("adaptive", False)]:
        with _flags(ici_wire_dtype=mode, ici_wire_adaptive=gate):
            assert wq.ici_effective_mode() == jwq.ici_effective_mode()
            assert wq.ici_adaptive_engaged() == jwq.ici_adaptive_engaged()
    with pytest.raises(ValueError, match="ici wire dtype"):
        config.set_flag("ici_wire_dtype", "fp8")
    with pytest.raises(ValueError, match="wire dtype"):
        config.set_flag("wire_dtype", "adaptive")
    assert config.get_flag("ici_wire_dtype") == "fp32"

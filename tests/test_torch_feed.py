"""The port's fast feeds: ``BatchPacker`` against the JAX package's,
``prefetch``, and the three feeds of ``CTRTrainer.train_pass`` against
each other.

The packer's arrays and its frozen pad shapes must be byte-equal to the
JAX package's. Within the port, the resident feed (K = 4 and K = 1), the
packer feed and the slow feed must train bitwise the same table, params,
Adam moments and losses: the unique rows come in another order on each
(first occurrence from the native packer, sorted from ``np.unique`` and
the resident build), but the step's merge sums each row's gradients over
the same keys in the same flat order whatever the order.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.data.device_pack import BatchPacker as JBatchPacker
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.utils import native as jnative
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BatchPacker, BoxPSDataset, SlotInfo, SlotSchema, prefetch
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.table import HostSparseTable, PassWorkingSet, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils import native
from paddlebox_tpu_torch.utils.monitor import STAT_GET

torch.set_num_threads(2)

S, B, D = 5, 8, 4
DENSE_DIM = 3
HIDDEN = (16, 8)
SPARSE = dict(embedx_threshold=1.0, shrink_threshold=0.5)


def _schema(info_cls, schema_cls, dense=False):
    """A label, with ``dense`` a dense float slot "d" of DENSE_DIM, then
    S sparse slots."""
    extra = [info_cls("d", type="float", dense=True, dim=DENSE_DIM)] if dense else []
    return schema_cls(
        [info_cls("label", type="float", dense=True, dim=1)] + extra + [info_cls(f"s{i}") for i in range(S)],
        label_slot="label",
    )


def _lines(seed, n, nan_at=None, dense=False):
    """1-3 keys a slot from a vocabulary of 59 keys (cross-slot and
    in-batch duplicates); record ``nan_at`` gets a NaN label."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        label = "nan" if i == nan_at else f"{float(rng.random() < 0.3)}"
        parts = [f"1 {label}"]
        if dense:
            parts.append(f"{DENSE_DIM} " + " ".join(f"{v:.6g}" for v in rng.normal(size=DENSE_DIM)))
        for _ in range(S):
            k = int(rng.integers(1, 4))
            parts.append(f"{k} " + " ".join(str(int(v)) for v in rng.integers(1, 60, k)))
        out.append(" ".join(parts))
    return out


def _write_files(tmp_path, n_files=2, n_rec=32, nan_at=None):
    files = []
    for fi in range(n_files):
        path = tmp_path / f"part-{fi:03d}.txt"
        path.write_text("\n".join(_lines(fi, n_rec, nan_at if fi == 1 else None)) + "\n")
        files.append(str(path))
    return files


@contextlib.contextmanager
def _flags(cfg_module, **kw):
    before = {k: cfg_module.get_flag(k) for k in kw}
    for k, v in kw.items():
        cfg_module.set_flag(k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            cfg_module.set_flag(k, v)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---- BatchPacker against the JAX package's ---------------------------------


class _Rows:
    def __init__(self, layout):
        self.layout = layout

    def pull_or_create(self, keys):
        return np.zeros((len(keys), self.layout.width), np.float32)


def _packers(native_pack, dedup, bucket, dense=False):
    data = "\n".join(_lines(3, 96, dense=dense)).encode()
    schema, jschema = _schema(SlotInfo, SlotSchema, dense), _schema(JSlotInfo, JSlotSchema, dense)
    store = native.parse_buffer_columnar(data, schema)
    jstore = jnative.parse_buffer_columnar(data, jschema)
    ws, jws = PassWorkingSet(), JPassWorkingSet()
    ws.add_keys(store.u64_values)
    jws.add_keys(jstore.u64_values)
    ws.finalize(_Rows(ValueLayout(embedx_dim=D)), round_to=8)
    jws.finalize(_Rows(JValueLayout(embedx_dim=D)), round_to=8)
    flags = dict(enable_native_parser=native_pack, enable_pullpush_dedup_keys=dedup)
    kw = dict(dense_slot="d", dense_dim=DENSE_DIM) if dense else {}
    with _flags(config, **flags), _flags(jconfig, **flags):
        p = BatchPacker(store, ws, schema, bucket=bucket, **kw)
        jp = JBatchPacker(jstore, jws, jschema, bucket=bucket, **kw)
    return p, jp


@pytest.mark.parametrize(
    "native_pack,dedup,dense", [(True, True, False), (False, True, False), (True, False, False), (True, True, True)],
    ids=["native_dedup", "numpy_dedup", "no_dedup", "native_dedup_dense"],
)
def test_batch_packer_matches_jax_bitwise(native_pack, dedup, dense):
    p, jp = _packers(native_pack, dedup, bucket=16, dense=dense)
    order = np.random.default_rng(4).permutation(96)
    parts = [order[i * 12 : (i + 1) * 12] for i in range(8)]  # 8 batches of 12
    p.freeze_shapes(parts[:6])
    jp.freeze_shapes(parts[:6])
    assert p._L_pad == jp._L_pad
    for idx in parts:
        got, want = p.pack(idx), jp.pack(idx)
        assert sorted(got.as_dict()) == sorted(want.as_dict())
        assert ("dense" in got.as_dict()) == dense
        for k, v in got.as_dict().items():
            _same(v, want.as_dict()[k])
        assert (got.n_keys, got.n_uniq, got.batch_size, got.num_slots) == (
            want.n_keys, want.n_uniq, want.batch_size, want.num_slots
        )
        assert (p._L_pad, p._U_pad) == (jp._L_pad, jp._U_pad)
    p.close()
    jp.close()


def test_batch_packer_threads_each_get_their_own_native_handle():
    p, _ = _packers(True, True, bucket=16)
    idx = np.arange(12)
    want = p.pack(idx).as_dict()
    got = list(prefetch([idx] * 6, lambda i: p.pack(i).as_dict(), workers=3, depth=6))
    for g in got:
        for k in want:
            _same(g[k], want[k])
    assert len(p._all_native) >= 2  # the main thread's and at least one worker's
    p.close()
    assert p._all_native == []


# ---- prefetch ----------------------------------------------------------------


def test_prefetch_keeps_order_under_uneven_work():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, 40)

    def fn(j):
        time.sleep(delays[j])
        return j * j

    assert list(prefetch(range(40), fn, workers=4, depth=5)) == [j * j for j in range(40)]


def test_prefetch_retries_a_failed_job_in_place_then_surfaces_a_persistent_one():
    fails = {3: 1, 5: 10}  # job -> how many times it fails
    lock = threading.Lock()

    def fn(j):
        with lock:
            left = fails.get(j, 0)
            if left:
                fails[j] = left - 1
        if left:
            raise IOError(f"job {j} failed")
        return j

    before = STAT_GET("pipeline_prefetch_retries")
    out = []
    with pytest.raises(IOError, match="job 5"):
        for v in prefetch(range(8), fn, workers=2, depth=3, retries=1):
            out.append(v)
    assert out == [0, 1, 2, 3, 4]  # job 3 healed by its retry, in order
    assert STAT_GET("pipeline_prefetch_retries") - before == 2


def test_prefetch_occupancy_gauge_matches_the_jax_package():
    """The same jobs, workers and depth through both packages' prefetch:
    the first ``workers`` jobs block until all of them run at once, so the
    high-water mark reaches ``workers`` and never passes it; a reset while
    they run restarts the mark from them, one after the window from 0."""
    from paddlebox_tpu.data import pipeline as jpipeline
    from paddlebox_tpu_torch.data import pipeline as tpipeline

    workers, depth = 3, 6
    got = {}
    for name, mod in (("jax", jpipeline), ("torch", tpipeline)):
        seen, at_barrier = [], []
        barrier = threading.Barrier(
            workers, action=lambda: at_barrier.append((mod.prefetch_inflight(), mod.prefetch_inflight_hwm(True))),
            timeout=30,
        )

        def fn(j):
            if j < workers:
                barrier.wait()
            seen.append(mod.prefetch_inflight())
            return j

        mod.prefetch_inflight_hwm(reset=True)
        out = list(mod.prefetch(range(12), fn, workers=workers, depth=depth))
        hwm = mod.prefetch_inflight_hwm(reset=True)
        after = (mod.prefetch_inflight(), mod.prefetch_inflight_hwm())
        one = list(mod.prefetch(range(4), lambda j: j, workers=1, depth=2))
        got[name] = (out, at_barrier, max(seen) <= workers, hwm, after, one, mod.prefetch_inflight_hwm())
    assert got["torch"] == got["jax"]
    assert got["torch"] == (list(range(12)), [(workers, workers)], True, workers, (0, 0), list(range(4)), 1)


def test_prefetch_occupancy_gauge_loses_no_update_under_many_workers():
    """More workers than cores and a short switch interval: a lost update
    of the gauge would leave jobs counted in flight after the window."""
    import sys

    from paddlebox_tpu_torch.data import pipeline as tpipeline

    workers = 4 * (os.cpu_count() or 1) + 4
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tpipeline.prefetch_inflight_hwm(reset=True)
        assert list(prefetch(range(3000), lambda j: j + 1, workers=workers, depth=2 * workers)) == list(
            range(1, 3001))
    finally:
        sys.setswitchinterval(prev)
    assert tpipeline.prefetch_inflight() == 0
    assert 1 <= tpipeline.prefetch_inflight_hwm() <= workers


# ---- the three feeds of train_pass -------------------------------------------

FEEDS = {
    "resident_k4": dict(enable_native_parser=True, enable_resident_feed=1, resident_scan_batches=4),
    "resident_k1": dict(enable_native_parser=True, enable_resident_feed=1, resident_scan_batches=1),
    "packer": dict(enable_native_parser=True, enable_resident_feed=0, resident_scan_batches=8),
    "slow": dict(enable_native_parser=False, enable_resident_feed=0, resident_scan_batches=8),
}


def train_with_feed(files, feed, n_batches, check_nan=False, prepare=None):
    """One pass on ``feed`` from a fresh native table; returns (pass
    metrics, per-step losses, the trainer's final state, the host table's
    keys and rows after end_pass)."""
    with _flags(config, **FEEDS[feed]):
        lay = ValueLayout(embedx_dim=D)
        table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
        assert table.native
        ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local",
                          seed=5, read_threads=2)
        ds.set_filelist(files)
        ds.load_into_memory()
        assert (ds.store is not None) == (feed != "slow")
        ds.begin_pass(round_to=16)
        cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                              auc_buckets=1000, check_nan=check_nan)
        model = DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
        tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu")
        if prepare is not None:
            tr.prepare_pass(ds, n_batches=prepare)
        losses = []
        out = tr.train_pass(ds, n_batches=n_batches, on_batch=lambda i, m: losses.append(m["loss"]))
        state = tr._state
        ds.end_pass(tr.trained_table())
        keys = np.sort(table.keys())
        return out, torch.stack(losses), state, keys, table.pull_or_create(keys)


def _assert_bitwise(a, b, what):
    out_a, loss_a, st_a, keys_a, rows_a = a
    out_b, loss_b, st_b, keys_b, rows_b = b
    _same(loss_a.numpy(), loss_b.numpy())  # bytes: a skipped batch's NaN loss too
    assert torch.equal(st_a.table, st_b.table), what
    for k in st_a.params:
        assert torch.equal(st_a.params[k], st_b.params[k]), (what, k)
        assert torch.equal(st_a.opt_state.mu[k], st_b.opt_state.mu[k]), (what, k)
        assert torch.equal(st_a.opt_state.nu[k], st_b.opt_state.nu[k]), (what, k)
    assert torch.equal(st_a.auc.pos, st_b.auc.pos) and torch.equal(st_a.auc.neg, st_b.auc.neg), what
    assert int(st_a.step) == int(st_b.step)
    for k in ("loss", "auc", "batches", "nan_batches"):
        assert out_a[k] == out_b[k], (what, k)
    _same(keys_a, keys_b)
    _same(rows_a, rows_b)


@pytest.fixture
def native_store(monkeypatch):
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "1")


@pytest.mark.parametrize(
    "n_batches,nan_at", [(8, None), (13, None), (8, 17)], ids=["one_pass", "wrap_13_of_8", "check_nan"]
)
def test_three_feeds_train_bitwise_equal(tmp_path, native_store, n_batches, nan_at):
    files = _write_files(tmp_path, nan_at=nan_at)
    runs = {f: train_with_feed(files, f, n_batches, check_nan=nan_at is not None) for f in FEEDS}
    ref = runs["resident_k4"]
    assert ref[0]["batches"] == n_batches
    if nan_at is not None:
        assert ref[0]["nan_batches"] == 1.0
    assert np.isfinite(ref[0]["loss"])
    for feed, run in runs.items():
        _assert_bitwise(ref, run, feed)


def test_prepare_pass_uploads_the_index_partition_once(tmp_path, native_store):
    """prepare_pass freezes the pads and uploads the partition; a later
    train_pass over a prefix of it slices that upload and changes nothing
    in what is trained."""
    files = _write_files(tmp_path)
    plain = train_with_feed(files, "resident_k4", 6)
    with _flags(config, **FEEDS["resident_k4"]):
        lay = ValueLayout(embedx_dim=D)
        ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), HostSparseTable(lay, SparseOptimizerConfig(**SPARSE),
                          n_shards=4, seed=0), batch_size=B, shuffle_mode="local", seed=5)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.begin_pass(round_to=16)
        cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                              auc_buckets=1000)
        tr = CTRTrainer(DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(0)),
                        cfg, dense_opt=Adam(1e-2), device="cpu")
        tr.prepare_pass(ds, n_batches=8)
        assert tr.last_prepare_s > 0
        rp, dev = tr.resident.rp, tr.resident.index
        assert dev.shape == (8, B) and dev.dtype == torch.int32
        L_pad, U_pad = rp.L_pad, rp.U_pad
        tr.train_pass(ds, n_batches=6)
        assert tr.resident.index is dev  # no second upload
        assert (rp.L_pad, rp.U_pad) == (L_pad, U_pad)
        assert torch.equal(tr._state.table, plain[2].table)

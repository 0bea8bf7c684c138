"""The port's resident feed against the JAX package's.

``build_device_batch`` is integer work (a ragged gather, a stable sort, a
first-occurrence scan and scatters), so its arrays must be bitwise equal
to the JAX package's jitted build, in both resident representations (base
plus uint8 counts, and the offset matrix when a slot holds more than 255
keys); ``ResidentPass.ensure`` must freeze the same pads. Then one pass of
each package on its native tier and resident feed, ending in end_pass,
within ``test_torch_trainer.py``'s tolerances: host rows rtol 1e-3 / atol
2e-5, the kept keys and the show/clk counters exact, pass loss rtol 1e-3.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.table.sparse_table import PassWorkingSet as JPassWorkingSet
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train.resident_step import ResidentPass as JResidentPass
from paddlebox_tpu.train.resident_step import build_device_batch as jbuild_device_batch
from paddlebox_tpu.utils import native as jnative
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.record_store import _ragged_indices
from paddlebox_tpu_torch.metrics import auc_init
from paddlebox_tpu_torch.models import DeepFM, deepfm_params_from_jax
from paddlebox_tpu_torch.table import HostSparseTable, PassWorkingSet, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import (
    Adam,
    CTRTrainer,
    ResidentPass,
    TrainState,
    TrainStepConfig,
    build_device_batch,
    make_resident_superstep,
)
from paddlebox_tpu_torch.utils import native

torch.set_num_threads(2)

S, D = 5, 4
DENSE_DIM = 3
HIDDEN = (32, 16)
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
LOSS_RTOL = 1e-3
SPARSE = dict(embedx_threshold=2.0, shrink_threshold=1.5)


def _schema(info_cls, schema_cls, dense=False):
    """A label, with ``dense`` a dense float slot "d" of DENSE_DIM, then
    S sparse slots."""
    extra = [info_cls("d", type="float", dense=True, dim=DENSE_DIM)] if dense else []
    return schema_cls(
        [info_cls("label", type="float", dense=True, dim=1)] + extra + [info_cls(f"s{i}") for i in range(S)],
        label_slot="label",
    )


def _lines(seed, n, wide_at=None, dense=False):
    """1-3 keys a slot from 59 keys; record ``wide_at`` holds 300 keys in
    slot 0 (past uint8 counts)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = [f"1 {float(rng.random() < 0.3)}"]
        if dense:
            parts.append(f"{DENSE_DIM} " + " ".join(f"{v:.6g}" for v in rng.normal(size=DENSE_DIM)))
        for s in range(S):
            k = 300 if (i == wide_at and s == 0) else int(rng.integers(1, 4))
            parts.append(f"{k} " + " ".join(str(int(v)) for v in rng.integers(1, 60, k)))
        out.append(" ".join(parts))
    return out


class _Rows:
    def __init__(self, layout):
        self.layout = layout

    def pull_or_create(self, keys):
        return np.zeros((len(keys), self.layout.width), np.float32)


def _passes(wide_at, n=64, dense=False):
    data = "\n".join(_lines(7, n, wide_at, dense)).encode()
    schema, jschema = _schema(SlotInfo, SlotSchema, dense), _schema(JSlotInfo, JSlotSchema, dense)
    store = native.parse_buffer_columnar(data, schema)
    jstore = jnative.parse_buffer_columnar(data, jschema)
    ws, jws = PassWorkingSet(n_mesh_shards=2), JPassWorkingSet(n_mesh_shards=2)
    ws.add_keys(store.u64_values)
    jws.add_keys(jstore.u64_values)
    ws.finalize(_Rows(ValueLayout(embedx_dim=D)), round_to=8)
    jws.finalize(_Rows(JValueLayout(embedx_dim=D)), round_to=8)
    kw = dict(dense_slot="d", dense_dim=DENSE_DIM) if dense else {}
    rp = ResidentPass(store, ws, schema, torch.device("cpu"), bucket=16, **kw)
    jrp = JResidentPass(jstore, jws, jschema, bucket=16, **kw)
    return rp, jrp


@pytest.mark.parametrize(
    "wide_at,dense", [(None, False), (5, False), (None, True)],
    ids=["uint8_counts", "offset_matrix", "uint8_counts_dense"],
)
def test_build_device_batch_matches_jax_bitwise(wide_at, dense):
    rp, jrp = _passes(wide_at, dense=dense)
    assert (rp.off is None) == (wide_at is None) == (jrp.off is None)
    assert (rp.dense is None) == (not dense) == (jrp.dense is None)
    if dense:
        assert rp.dense.numpy().tobytes() == np.asarray(jrp.dense).tobytes()
    B = 8
    order = np.random.default_rng(1).permutation(64)
    blocks = [order[i * B : (i + 1) * B].astype(np.int32) for i in range(8)]
    blocks.append(np.arange(B, dtype=np.int32))  # a block repeated below
    blocks.append(np.arange(B, dtype=np.int32))
    rp.ensure(blocks)
    jrp.ensure(blocks)
    assert (rp.L_pad, rp.U_pad) == (jrp.L_pad, jrp.U_pad)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=ValueLayout(embedx_dim=D))
    jcfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=JValueLayout(embedx_dim=D))
    jbuild = jax.jit(lambda idx: jbuild_device_batch(jrp, jcfg, idx))
    for idx in blocks:
        got = build_device_batch(rp, cfg, torch.from_numpy(idx))
        want = jbuild(idx)
        # and the push merge's order, which the JAX package's step sorts for itself
        assert sorted(got) == sorted([*want, "merge_order", "merge_offsets"])
        for k in ("uniq_rows", "inverse", "segments"):
            g = got[k].numpy()
            assert g.dtype == np.int32, k
            np.testing.assert_array_equal(g, np.asarray(want[k]).astype(np.int32), err_msg=k)
        for k in ("labels", "dense") if dense else ("labels",):
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
        # every flat key sees its own row through the dedup
        u, inv = got["uniq_rows"].numpy(), got["inverse"].numpy()
        valid = got["segments"].numpy() < S * B
        rows = rp._host_rows
        lens = np.diff(rp.store.u64_offsets[idx].astype(np.int64), axis=1)
        flat = [rows[_ragged_indices(rp.store.u64_base[idx] + rp.store.u64_offsets[idx, s], lens[:, s])]
                for s in range(S)]
        np.testing.assert_array_equal(u[inv[valid]], np.concatenate(flat))
        assert len(np.unique(u[u != rp.pad_row])) == int((u != rp.pad_row).sum())


@pytest.mark.parametrize("native_sweep", [True, False], ids=["native", "numpy"])
def test_ensure_freezes_the_jax_pads(native_sweep):
    rp, jrp = _passes(None)
    parts = [np.arange(i, i + 12, dtype=np.int32) for i in range(0, 48, 12)]
    parts.append(np.arange(5, dtype=np.int32))  # ragged: the numpy sweep takes it
    before = config.get_flag("enable_native_parser")
    config.set_flag("enable_native_parser", native_sweep)
    try:
        for upto in (2, len(parts)):  # grows, never shrinks
            rp.ensure(parts[:upto])
            jrp.ensure(parts[:upto])
            assert (rp.L_pad, rp.U_pad) == (jrp.L_pad, jrp.U_pad)
        assert rp._uniq_cache == jrp._uniq_cache
    finally:
        config.set_flag("enable_native_parser", before)


def test_superstep_stacks_metrics_along_k():
    rp, _ = _passes(None)
    B, K = 8, 3
    idx = torch.arange(K * B, dtype=torch.int32).reshape(K, B)
    rp.ensure([b.numpy() for b in idx])
    lay = ValueLayout(embedx_dim=D)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100)
    model = DeepFM(S, lay.pull_width, D, hidden=(8,), generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = Adam(1e-3)
    sstep = make_resident_superstep(lambda p, x, d: functional_call(model, p, (x, d)), opt, cfg, rp)
    st = TrainState(
        table=torch.zeros((rp.n_table_rows, lay.width)), params=params, opt_state=opt.init(params),
        auc=auc_init(100, device="cpu"), step=torch.zeros((), dtype=torch.int32),
    )
    st, m = sstep(st, idx)
    assert m["loss"].shape == (K,) and bool(torch.isfinite(m["loss"]).all())
    assert int(st.step) == K and int(st.opt_state.count) == K


# ---- one pass of each package on the native tier and the resident feed ------


def _write_files(tmp_path, n_files=3, n_rec=40, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        keys = rng.integers(1, 120, (n_rec, S))
        labels = (rng.random(n_rec) < 0.3).astype(int)
        path = os.path.join(str(tmp_path), f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            for i in range(n_rec):
                f.write(f"1 {labels[i]}.0 " + " ".join(f"1 {k}" for k in keys[i]) + "\n")
        files.append(path)
    return files


def test_one_resident_pass_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "1")
    assert config.get_flag("enable_native_parser") and jconfig.get_flag("enable_native_parser")
    assert config.get_flag("enable_resident_feed") and jconfig.get_flag("enable_resident_feed")
    files = _write_files(tmp_path)
    B = 16
    jlay, lay = JValueLayout(embedx_dim=D), ValueLayout(embedx_dim=D)
    jmodel = JDeepFM(S, jlay.pull_width, D, hidden=HIDDEN)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(3)))

    jtable = JHostSparseTable(jlay, JSparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    jds = JBoxPSDataset(_schema(JSlotInfo, JSlotSchema), jtable, batch_size=B, shuffle_mode="local", seed=5)
    jds.set_filelist(files)
    jds.load_into_memory()
    jds.begin_pass(round_to=64)
    jtr = JCTRTrainer(
        jmodel, JTrainStepConfig(num_slots=S, batch_size=B, layout=jlay,
                                 sparse_opt=JSparseOptimizerConfig(**SPARSE), auc_buckets=1000),
        dense_opt=optax.adam(1e-3),
    )
    jtr.init_params(jax.random.PRNGKey(0))
    jtr.params = jparams
    jtr.prepare_pass(jds)
    jout = jtr.train_pass(jds)
    assert jtr._resident_cache is not None and jtable._native is not None
    jended = jds.end_pass(np.asarray(jtr.trained_table()))

    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                      read_threads=2)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    model = DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(deepfm_params_from_jax(jax.tree.map(np.asarray, jparams)))
    tr = CTRTrainer(
        model, TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                               auc_buckets=1000),
        dense_opt=Adam(1e-3), device="cpu",
    )
    tr.prepare_pass(ds)
    out = tr.train_pass(ds, profile=True)
    assert tr._resident_cache is not None and table.native
    assert set(out["profile"]) == {"feed_wait_s", "step_dispatch_s", "device_step_s", "host_metrics_s"}
    ended = ds.end_pass(tr.trained_table())

    assert out["batches"] == jout["batches"] == 7.0
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=LOSS_RTOL)
    assert out["ins_num"] == jout["ins_num"]
    assert ended["dropped"] == jended["dropped"]
    keys, jkeys = np.sort(table.keys()), np.sort(jtable.keys())
    np.testing.assert_array_equal(keys, jkeys)
    rows, jrows = table.pull_or_create(keys), jtable.pull_or_create(jkeys)
    np.testing.assert_array_equal(rows[:, [lay.SHOW, lay.CLK]], jrows[:, [lay.SHOW, lay.CLK]])
    np.testing.assert_allclose(rows, jrows, rtol=ROWS_RTOL, atol=ROWS_ATOL)


def test_resident_rebuild_over_the_same_store_keeps_the_unique_counts(tmp_path, monkeypatch):
    """A new working set over the same store (a retried pass) rebuilds the
    ResidentPass but keeps its per-block unique-row counts, and the pads
    it freezes are those of a cold build."""
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "1")
    B = 16
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(_write_files(tmp_path))
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE))
    tr = CTRTrainer(DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(0)),
                    cfg, device="cpu")
    tr.prepare_pass(ds)
    old = tr._resident_cache[2]
    ws = PassWorkingSet()
    ws.add_keys(ds.store.u64_values)
    ws.finalize(table, round_to=64)
    ds.ws = ws
    new = tr._get_resident(ds)  # before any sweep of its own
    assert new is not old and new.ws is ws
    assert new._uniq_cache == old._uniq_cache and len(new._uniq_cache) == ds.num_batches()
    tr.prepare_pass(ds)
    assert tr._resident_cache[2] is new
    assert (new.L_pad, new.U_pad) == (old.L_pad, old.U_pad)

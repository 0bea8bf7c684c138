"""Dense features on every feed: a ``CTRTrainer(dense_slot, dense_dim)``
pass of the port against the JAX trainer's pass.

Files carry a logkey column (queries of 1-4 ads), a label, a dense float
slot "d" of DD values and S sparse slots. The model is a Wide&Deep whose
``dense_dim`` is DD (its deep input and its wide dense linear read the
slot), from the JAX weights. The JAX package trains the flat pass on its
resident feed and the join phase (``preprocess_instance``, a plain model:
no rank tower) on its resident pv feed, once each; the port trains each
on every one of its feeds: resident, packer and slow (native parser off:
a pass held as SlotRecords), and resident pv, pv packer and pv records.
Tolerances follow ``test_torch_trainer.py``: the pass table by key within
rtol 1e-3 / atol 2e-5 with the show/clk counters exact, the pass loss
within rtol 1e-3, ``ins_num`` exact. ``pack_bucket`` reaches the slow
feed's packing.
"""

import contextlib
import os

import jax
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu import config as jconfig
from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.models import WideDeep as JWideDeep
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema, pack_batch
from paddlebox_tpu_torch.models import WideDeep, wide_deep_params_from_jax
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

S, B, D, DD = 3, 16, 4, 3
HIDDEN = (16, 8)
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
LOSS_RTOL = 1e-3
SPARSE = dict(embedx_threshold=0.0)
FEEDS = {
    # the port's feed -> (its flags, the phase: 1 join, 0 flat)
    "resident": (dict(enable_resident_feed=1, enable_native_parser=True), 0),
    "packer": (dict(enable_resident_feed=0, enable_native_parser=True), 0),
    "slow": (dict(enable_resident_feed=1, enable_native_parser=False), 0),
    "resident_pv": (dict(enable_resident_feed=1, enable_native_parser=True), 1),
    "pv_packer": (dict(enable_resident_feed=0, enable_native_parser=True), 1),
    "pv_records": (dict(enable_resident_feed=1, enable_native_parser=False), 1),
}


def _logkey(sid, rank):
    return "0" * 11 + format(222, "03x") + format(rank, "02x") + format(sid, "016x")


def _write_files(tmp_path, n_files=2, n_queries=30, seed=0):
    rng = np.random.default_rng(seed)
    files, sid = [], 1
    for fi in range(n_files):
        lines = []
        for _ in range(n_queries):
            for r in range(1, int(rng.integers(1, 5)) + 1):
                keys = rng.integers(1, 150, S)
                dense = rng.normal(size=DD)
                label = 1.0 if dense[0] + (keys % 5 == 0).sum() > 0.8 else 0.0
                lines.append(" ".join(
                    [f"1 {_logkey(sid, r)}", f"1 {label}", f"{DD} " + " ".join(f"{v:.4f}" for v in dense)]
                    + [f"1 {k}" for k in keys]
                ))
            sid += 1
        path = os.path.join(str(tmp_path), f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def _schema(info, schema):
    slots = [info("label", type="float", dense=True, dim=1), info("d", type="float", dense=True, dim=DD)]
    return schema(slots + [info(f"s{i}") for i in range(S)], label_slot="label", parse_logkey=True)


@contextlib.contextmanager
def _flags(cfg, **kw):
    before = {k: cfg.get_flag(k) for k in kw}
    for k, v in kw.items():
        cfg.set_flag(k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            cfg.set_flag(k, v)


def _by_key(ws, table):
    return ws.sorted_keys.copy(), np.asarray(table).reshape(-1, table.shape[-1])[ws.row_of_sorted]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The files, the JAX weights and the JAX package's flat and join
    passes, each on its resident feed."""
    files = _write_files(tmp_path_factory.mktemp("dense"))
    lay = JValueLayout(embedx_dim=D)
    jmodel = JWideDeep(S, lay.pull_width, dense_dim=DD, hidden=HIDDEN)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(3)))
    out = {"files": files, "jparams": jax.tree.map(np.asarray, jparams)}
    for phase in (0, 1):
        table = JHostSparseTable(lay, JSparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
        ds = JBoxPSDataset(_schema(JSlotInfo, JSlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
        ds.set_filelist(files)
        with _flags(jconfig, enable_native_parser=True, enable_resident_feed=True):
            ds.load_into_memory()
            ds.begin_pass(round_to=64)
            if phase == 1:
                ds.set_current_phase(1)
                ds.preprocess_instance(max_rank=3)
            cfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=lay,
                                   sparse_opt=JSparseOptimizerConfig(**SPARSE), auc_buckets=1000)
            tr = JCTRTrainer(jmodel, cfg, dense_opt=optax.adam(1e-3), dense_slot="d", dense_dim=DD)
            tr.params = jparams
            tr.opt_state = optax.adam(1e-3).init(jparams)
            jout = tr.train_pass(ds)
        assert ds.store is not None
        out[phase] = (jout, _by_key(ds.ws, tr.trained_table()))
    return out


def _port_pass(ref, flags, phase, pack_bucket=None):
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(ref["files"])
    with _flags(config, **flags):
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        if phase == 1:
            ds.set_current_phase(1)
            ds.preprocess_instance(max_rank=3)
        model = WideDeep(S, lay.pull_width, dense_dim=DD, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
        model.load_state_dict(wide_deep_params_from_jax(ref["jparams"]))
        cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                              auc_buckets=1000)
        tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device="cpu", dense_slot="d", dense_dim=DD,
                        pack_bucket=pack_bucket)
        out = tr.train_pass(ds)
    return ds, tr, out


@pytest.mark.parametrize("feed", list(FEEDS))
def test_dense_pass_matches_jax_on_each_feed(ref, feed):
    flags, phase = FEEDS[feed]
    ds, tr, out = _port_pass(ref, flags, phase)
    assert tr.last_feed == feed
    jout, (jkeys, jrows) = ref[phase]
    keys, rows = _by_key(ds.ws, tr.trained_table())
    assert out["batches"] == jout["batches"] and out["ins_num"] == jout["ins_num"]
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(keys, jkeys)
    lay = ValueLayout(embedx_dim=D)
    np.testing.assert_array_equal(rows[:, [lay.SHOW, lay.CLK]], jrows[:, [lay.SHOW, lay.CLK]])
    np.testing.assert_allclose(rows, jrows, rtol=ROWS_RTOL, atol=ROWS_ATOL)


def test_dense_features_reach_the_model(ref):
    """The same pass with the dense slot zeroed in the wide and deep
    weights that read it trains another table: the feature is used."""
    flags, phase = FEEDS["packer"]
    _, tr, out = _port_pass(ref, flags, phase)
    ref2 = dict(ref)
    jp = jax.tree.map(np.copy, ref["jparams"])
    jp["wide_dense"]["w"][:] = 0.0
    jp["mlp"][0]["w"][-DD:] = 0.0
    ref2["jparams"] = jp
    _, tr2, out2 = _port_pass(ref2, flags, phase)
    assert out["loss"] != out2["loss"]


def test_pack_bucket_reaches_the_slow_feed(ref):
    flags, phase = FEEDS["slow"]
    ds, tr, out = _port_pass(ref, flags, phase, pack_bucket=8)
    assert tr.last_feed == "slow"
    jout, _ = ref[phase]
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=LOSS_RTOL)
    batch = next(iter(ds.batches(1)))
    got = tr._pack(batch, ds)
    want = pack_batch(batch, ds.ws, ds.schema, dense_slot="d", dense_dim=DD, bucket=8).as_dict()
    assert got.keys() == want.keys() and "dense" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["segments"].shape[0] % 8 == 0
    default = pack_batch(batch, ds.ws, ds.schema, dense_slot="d", dense_dim=DD).as_dict()
    assert default["segments"].shape != got["segments"].shape

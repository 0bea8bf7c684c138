"""The port's join/update training day against the JAX package's.

One pass over a few pv files (about 60 pvs of 1-4 ads, logkeys parsed):
the join phase (``preprocess_instance(max_rank=3)``, a RankDeepFM with
``model_takes_rank_offset``) trains the pass, hands its table to an update
trainer (the join trainer's params, a fresh Adam state), the update phase
(``postprocess_instance``) trains the flat pass, and ``end_pass`` writes
it back. The JAX package runs the day once, on its native tier and its
resident feeds; the port runs it on each of its join feeds: the resident
pv feed, the pv packer feed (resident feed off) and the record-level pv
feed (native parser off: a pass held as SlotRecords). Both start from the
same dense weights. Tolerances follow ``test_torch_trainer.py``: rows
rtol 1e-3 / atol 2e-5, the kept keys and the show/clk counters exact,
pass loss rtol 1e-3, the AUC's ``ins_num`` exact (the real instances:
ghosts are masked). The port's feeds against each other, and an eval pass
against the state it leaves, are bitwise.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.models import RankDeepFM as JRankDeepFM
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import (
    DeepFM,
    RankDeepFM,
    rank_deepfm_params_from_jax,
    rank_deepfm_params_to_jax,
)
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

S, B, D = 3, 16, 4
HIDDEN = (32, 16)
MAX_RANK = 3
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
LOSS_RTOL = 1e-3
SPARSE = dict(embedx_threshold=0.0)
FEEDS = {
    # feed name -> (port flags, the update phase's feed)
    "resident_pv": (dict(enable_resident_feed=1, enable_native_parser=True), "resident"),
    "pv_packer": (dict(enable_resident_feed=0, enable_native_parser=True), "packer"),
    "pv_records": (dict(enable_resident_feed=1, enable_native_parser=False), "slow"),
}


def _logkey(sid, cmatch, rank):
    return "0" * 11 + format(cmatch, "03x") + format(rank, "02x") + format(sid, "016x")


def _write_files(tmp_path, n_files=2, n_queries=30, seed=0):
    rng = np.random.default_rng(seed)
    files, sid = [], 1
    for fi in range(n_files):
        lines = []
        for _ in range(n_queries):
            for r in range(1, int(rng.integers(1, 5)) + 1):
                keys = rng.integers(1, 150, S)
                label = 1.0 if (keys % 5 == 0).any() else 0.0
                cm = 222 if rng.random() > 0.1 else 223
                lines.append(" ".join([f"1 {_logkey(sid, cm, r)}", f"1 {label}"] + [f"1 {k}" for k in keys]))
            sid += 1
        path = os.path.join(str(tmp_path), f"pv-{fi:03d}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def _slots(info):
    return [info("label", type="float", dense=True, dim=1)] + [info(f"s{i}") for i in range(S)]


def _by_key(ws, table):
    """The pass table's rows in key order (the two packages may place rows
    differently)."""
    return ws.sorted_keys.copy(), np.asarray(table).reshape(-1, table.shape[-1])[ws.row_of_sorted]


def _contents(table):
    keys = np.sort(table.keys())
    return keys, table.pull_or_create(keys)


@pytest.fixture(scope="module")
def day(tmp_path_factory):
    """The pv files, the JAX weights and the JAX package's day, run once."""
    files = _write_files(tmp_path_factory.mktemp("pv"))
    lay = JValueLayout(embedx_dim=D)
    jmodel = JRankDeepFM(JDeepFM(S, lay.pull_width, D, hidden=HIDDEN), S * lay.pull_width, max_rank=MAX_RANK)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(3)))
    table = JHostSparseTable(lay, JSparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = JBoxPSDataset(JSlotSchema(_slots(JSlotInfo), label_slot="label", parse_logkey=True), table,
                       batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    ds.set_current_phase(1)
    n_pvs = ds.preprocess_instance(max_rank=MAX_RANK)
    cfg = dict(num_slots=S, batch_size=B, layout=lay, sparse_opt=JSparseOptimizerConfig(**SPARSE), auc_buckets=1000)
    tr = JCTRTrainer(jmodel, JTrainStepConfig(**cfg, model_takes_rank_offset=True), dense_opt=optax.adam(1e-3))
    tr.init_params(jax.random.PRNGKey(0))
    tr.params = jparams
    tr.opt_state = optax.adam(1e-3).init(jparams)
    jout = tr.train_pass(ds)
    n_records = ds.memory_data_size()
    join_rows = _by_key(ds.ws, tr.trained_table())
    tr.handoff_table(ds)
    ds.postprocess_instance()
    ds.set_current_phase(0)
    tr2 = JCTRTrainer(jmodel, JTrainStepConfig(**cfg), dense_opt=optax.adam(1e-3))
    tr2.params = tr.params
    tr2.opt_state = optax.adam(1e-3).init(tr.params)
    uout = tr2.train_pass(ds)
    ended = ds.end_pass(tr2.trained_table())
    return {
        "files": files, "jparams": jax.tree.map(np.asarray, jparams), "n_pvs": n_pvs,
        "n_records": n_records, "join_out": jout, "join_rows": join_rows,
        "upd_out": uout, "ended": ended, "host": _contents(table),
    }


@pytest.fixture
def port_flags():
    """Set port flags for a test, restored after."""
    before = {}

    def set_flags(**kw):
        for k, v in kw.items():
            before.setdefault(k, config.get_flag(k))
            config.set_flag(k, v)

    yield set_flags
    for k, v in before.items():
        config.set_flag(k, v)


def _port_pass(day, feed, port_flags):
    """The port's dataset at the join phase and a join trainer on the JAX
    weights, through ``feed``'s flags."""
    port_flags(**FEEDS[feed][0])
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = BoxPSDataset(SlotSchema(_slots(SlotInfo), label_slot="label", parse_logkey=True), table,
                      batch_size=B, shuffle_mode="local", seed=5, read_threads=2)
    ds.set_filelist(day["files"])
    ds.load_into_memory()
    assert (ds.store is None) == (feed == "pv_records")
    ds.begin_pass(round_to=64)
    ds.set_current_phase(1)
    assert ds.preprocess_instance(max_rank=MAX_RANK) == day["n_pvs"]
    g = torch.Generator().manual_seed(0)
    model = RankDeepFM(DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=g), S * lay.pull_width,
                       max_rank=MAX_RANK, generator=g)
    model.load_state_dict(rank_deepfm_params_from_jax(day["jparams"]))
    cfg = dict(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE), auc_buckets=1000)
    tr = CTRTrainer(model, TrainStepConfig(**cfg, model_takes_rank_offset=True), dense_opt=Adam(1e-3), device="cpu")
    tr.init_params()
    return table, ds, tr, model, cfg


def _state(tr):
    return (
        tr.trained_table().copy(), {k: v.clone() for k, v in tr.params.items()},
        {k: v.clone() for k, v in tr.opt_state.mu.items()}, {k: v.clone() for k, v in tr.opt_state.nu.items()},
        int(tr.opt_state.count),
    )


def _same_state(a, b):
    return (
        a[0].tobytes() == b[0].tobytes() and a[4] == b[4]
        and all(torch.equal(a[i][k], b[i][k]) for i in (1, 2, 3) for k in a[1])
    )


def _assert_rows(got, want):
    (keys, rows), (jkeys, jrows) = got, want
    np.testing.assert_array_equal(keys, jkeys)
    lay = ValueLayout(embedx_dim=D)
    np.testing.assert_array_equal(rows[:, [lay.SHOW, lay.CLK]], jrows[:, [lay.SHOW, lay.CLK]])
    np.testing.assert_allclose(rows, jrows, rtol=ROWS_RTOL, atol=ROWS_ATOL)


@pytest.mark.parametrize("feed", list(FEEDS))
def test_join_pass_matches_jax(day, feed, port_flags):
    _, ds, tr, _, _ = _port_pass(day, feed, port_flags)
    out = tr.train_pass(ds)
    assert tr.last_feed == feed
    jout = day["join_out"]
    assert out["batches"] == jout["batches"] == ds.num_pv_batches()
    assert out["ins_num"] == jout["ins_num"] == ds.memory_data_size() == day["n_records"]
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=LOSS_RTOL)
    _assert_rows(_by_key(ds.ws, tr.trained_table()), day["join_rows"])


@pytest.mark.parametrize("feed", list(FEEDS))
def test_join_update_day_matches_jax(day, feed, port_flags):
    table, ds, tr, model, cfg = _port_pass(day, feed, port_flags)
    tr.train_pass(ds)
    tr.handoff_table(ds)
    joined = tr.trained_table().copy()
    ds.postprocess_instance()
    ds.set_current_phase(0)
    tr2 = CTRTrainer(model, TrainStepConfig(**cfg), dense_opt=Adam(1e-3), device="cpu")
    tr2.params = {k: v.clone() for k, v in tr.params.items()}
    tr2.opt_state = tr2.dense_opt.init(tr2.params)
    out = tr2.train_pass(ds)
    assert tr2.last_feed == FEEDS[feed][1]
    np.testing.assert_array_equal(tr.trained_table(), joined)  # the join trainer's table stays intact
    uout = day["upd_out"]
    assert out["batches"] == uout["batches"]
    assert out["ins_num"] == uout["ins_num"]
    np.testing.assert_allclose(out["loss"], uout["loss"], rtol=LOSS_RTOL)
    # an update-phase eval pass leaves the state bitwise, on its flat feed
    before = _state(tr2)
    tr2.set_test_mode(True)
    assert tr2.train_pass(ds)["ins_num"] == out["ins_num"]
    tr2.set_test_mode(False)
    assert tr2.last_feed == FEEDS[feed][1] and _same_state(_state(tr2), before)
    ended = ds.end_pass(tr2.trained_table())
    assert ended["dropped"] == day["ended"]["dropped"]
    _assert_rows(_contents(table), day["host"])


@pytest.mark.parametrize("feed", list(FEEDS))
def test_join_eval_pass_leaves_the_state_bitwise(day, feed, port_flags):
    _, ds, tr, _, _ = _port_pass(day, feed, port_flags)
    tr.train_pass(ds)
    before = _state(tr)
    tr.set_test_mode(True)
    out = tr.train_pass(ds)
    tr.set_test_mode(False)
    assert tr.last_feed == feed
    assert out["ins_num"] == ds.memory_data_size()
    assert _same_state(_state(tr), before)


@pytest.mark.parametrize("feed", list(FEEDS))
def test_join_eval_preds_equal_the_training_forward_bitwise(day, feed, port_flags):
    """``tests/test_eval_mode.py``'s case on a join batch: from one state,
    the eval step's preds are the training step's forward, bitwise."""
    _, ds, tr, model, cfg = _port_pass(day, feed, port_flags)
    preds = {}
    for eval_mode in (True, False):
        t = CTRTrainer(model, TrainStepConfig(**cfg, model_takes_rank_offset=True), dense_opt=Adam(1e-3),
                       device="cpu")
        t.params = {k: v.clone() for k, v in tr.params.items()}
        t.opt_state = t.dense_opt.init(t.params)
        t.set_test_mode(eval_mode)
        got = []
        t.train_pass(ds, n_batches=1, on_batch=lambda i, m: got.append(m["preds"].clone()))
        preds[eval_mode] = got[0]
    assert torch.equal(preds[True], preds[False])


def test_three_join_feeds_train_bitwise_equal(day, port_flags):
    got = {}
    for feed in FEEDS:
        _, ds, tr, _, _ = _port_pass(day, feed, port_flags)
        losses = []
        tr.train_pass(ds, on_batch=lambda i, m: losses.append(m["loss"]))
        assert tr.last_feed == feed
        got[feed] = (_by_key(ds.ws, tr.trained_table()), _state(tr)[1:], torch.stack(losses))
    ref = got["resident_pv"]
    for feed, g in got.items():
        assert np.array_equal(g[0][0], ref[0][0]) and g[0][1].tobytes() == ref[0][1].tobytes(), feed
        assert _same_state((np.zeros(0), *g[1]), (np.zeros(0), *ref[1])), feed
        assert torch.equal(g[2], ref[2]), feed


def test_join_save_dense_loads_in_the_jax_package_and_back(day, port_flags, tmp_path):
    _, ds, tr, _, _ = _port_pass(day, "resident_pv", port_flags)
    tr.train_pass(ds)
    path = str(tmp_path / "dense.npz")
    tr.save_dense(path)
    lay = JValueLayout(embedx_dim=D)
    jmodel = JRankDeepFM(JDeepFM(S, lay.pull_width, D, hidden=HIDDEN), S * lay.pull_width, max_rank=MAX_RANK)
    jtr = JCTRTrainer(jmodel, JTrainStepConfig(num_slots=S, batch_size=B, layout=lay, model_takes_rank_offset=True),
                      dense_opt=optax.adam(1e-3))
    jtr.init_params(jax.random.PRNGKey(1))
    jtr.load_dense(path)
    want = rank_deepfm_params_to_jax(tr.params)
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, jtr.params)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    assert int(jtr.opt_state[0].count) == int(tr.opt_state.count) > 0
    back = str(tmp_path / "back.npz")
    jtr.save_dense(back)
    tr2 = CTRTrainer(tr.model, tr.cfg, dense_opt=Adam(1e-3), device="cpu")
    tr2.init_params()
    tr2.load_dense(back)
    assert _same_state((np.zeros(0), *[tr2.params, tr2.opt_state.mu, tr2.opt_state.nu], int(tr2.opt_state.count)),
                       (np.zeros(0), *_state(tr)[1:]))

"""The port's metric registry against the JAX package's.

Every metric class, through ``init_metric`` as a user reaches it, is fed
the same numpy preds, labels, cmatch, rank, mask and ins_weight in both
packages: the bucket tables must be equal, ``get_metric`` within 1e-12 and
the log line equal. Then the phase filter, the ghost mask and the errors.
Last, a registry on a join + update day (a join pass, a join eval pass,
the update pass) against the JAX package's registry on the same day, the
JAX package on its resident feeds and the port on each of its join feeds
(the resident pv feed, the pv packer, the record-level feed): each metric's ``ins_num`` and actual CTR exact (the same
labels under the same masks), its AUC within 2e-3 and its predicted CTR
within 1e-4 (the two packages' preds differ in the last float bits, which
may move an instance across one of the 1,000 buckets).
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
from paddlebox_tpu.metrics import registry as jreg
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.models import RankDeepFM as JRankDeepFM
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.metrics import registry as reg
from paddlebox_tpu_torch.models import DeepFM, RankDeepFM, rank_deepfm_params_from_jax
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

BUCKETS = 1000
N = 64
METRICS = {
    "auc": dict(method="auc"),
    "mask_auc": dict(method="mask_auc", mask_var="mask"),
    "cmatch_rank": dict(method="cmatch_rank_auc", cmatch_rank_group="222:1,222:2,223"),
    "cmatch_only": dict(method="cmatch_rank_auc", cmatch_rank_group="222:1", ignore_rank=True),
    "multi_task": dict(method="multi_task_auc", cmatch_rank_group="223,224"),
    "cmatch_rank_mask": dict(method="auc", cmatch_rank_group="222_2,223", mask_var="mask"),
    "other_vars": dict(method="auc", label_var="y", pred_var="p", phase=1),
}


def _batches(seed=0, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.random(N).astype(np.float32)
        p[:3] = [0.0, 1.0, 0.9999999]  # the edge buckets
        b = {
            "preds": p, "labels": (rng.random(N) < 0.3).astype(np.float32),
            "cmatch": rng.choice([222, 223, 224, 999], N).astype(np.int32),
            "rank": rng.integers(0, 4, N).astype(np.int32), "mask": rng.integers(0, 2, N).astype(np.int32),
        }
        b["p"], b["y"] = b["preds"], b["labels"]
        if i % 2:
            b["ins_weight"] = np.where(rng.random(N) < 0.2, 0.0, 1.0).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("group", ["401:0,401:1", "401_0", "401", " 401:2 , 5 ,", "", "7_1,8:-1,9"])
def test_parse_cmatch_rank_group_matches_jax(group):
    assert reg.parse_cmatch_rank_group(group) == jreg.parse_cmatch_rank_group(group)


@pytest.mark.parametrize("name", list(METRICS))
def test_each_metric_matches_jax(name):
    r, jr = reg.MetricRegistry(device="cpu"), jreg.MetricRegistry()
    m = r.init_metric(name, bucket_size=BUCKETS, **METRICS[name])
    jm = jr.init_metric(name, bucket_size=BUCKETS, **METRICS[name])
    assert type(m).__name__ == type(jm).__name__
    for b in _batches():
        assert r.add_all(b, phase=1) == jr.add_all(b, phase=1) == 1
    np.testing.assert_array_equal(m.state.pos.numpy(), np.asarray(jm.state.pos))
    np.testing.assert_array_equal(m.state.neg.numpy(), np.asarray(jm.state.neg))
    assert 0 < int(m.state.pos.sum() + m.state.neg.sum()) < 4 * N or name in ("auc", "other_vars")
    got, want = m.get_metric(), jm.get_metric()
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert int(m.state.pos.sum() + m.state.neg.sum()) == 0  # reset
    for b in _batches(seed=1):
        r.add_all(b, phase=1)
        jr.add_all(b, phase=1)
    assert r.get_metric_msg(name) == jr.get_metric_msg(name)


def test_phase_filter_and_ghost_mask():
    r = reg.MetricRegistry(device="cpu")
    join = r.init_metric("join", phase=1, bucket_size=BUCKETS)
    upd = r.init_metric("upd", phase=0, bucket_size=BUCKETS)
    every = r.init_metric("every", bucket_size=BUCKETS)
    b = _batches()[1]  # carries ins_weight
    assert r.add_all(b, phase=1) == 2  # join and every
    assert r.add_all(b, phase=0) == 2  # upd and every
    assert r.add_all(b) == 3  # phase -1 feeds every metric
    real = int((b["ins_weight"] > 0).sum())
    assert real < N
    for m, times in ((join, 2), (upd, 2), (every, 3)):
        assert int(m.state.pos.sum() + m.state.neg.sum()) == times * real  # ghosts never count
    assert r.names() == ["join", "upd", "every"] and r["join"] is join
    assert not join.add_data(b, phase=0) and join.metric_phase() == 1


def test_registry_errors_match_jax():
    for mod, kw in ((reg, dict(device="cpu")), (jreg, {})):
        r = mod.MetricRegistry(**kw)
        with pytest.raises(ValueError, match="unknown metric method"):
            r.init_metric("x", method="wuauc")
        with pytest.raises(ValueError, match="mask_var"):
            r.init_metric("x", method="mask_auc")
        with pytest.raises(ValueError, match="empty cmatch_rank group"):
            r.init_metric("x", method="cmatch_rank_auc", cmatch_rank_group=" , ")
        r.init_metric("c", method="cmatch_rank_auc", cmatch_rank_group="222:1", bucket_size=BUCKETS)
        b = {k: v for k, v in _batches()[0].items() if k != "rank"}
        with pytest.raises(KeyError, match="'rank'"):
            r.add_all(b)


def test_registry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.MetricRegistry()


# ---- a registry on a join + update day --------------------------------------

S, B, D, MAX_RANK = 3, 16, 4, 3
DAY_METRICS = {
    "join": dict(phase=1),
    "update": dict(phase=0),
    "every": dict(),
    "cmatch_rank": dict(method="cmatch_rank_auc", cmatch_rank_group="222:1,222:2"),
}


def _logkey(sid, cmatch, rank):
    return "0" * 11 + format(cmatch, "03x") + format(rank, "02x") + format(sid, "016x")


def _write_files(tmp_path, n_queries=60, seed=1):
    rng = np.random.default_rng(seed)
    lines = []
    for sid in range(1, n_queries + 1):
        for r in range(1, int(rng.integers(1, 5)) + 1):
            keys = rng.integers(1, 150, S)
            label = 1.0 if (keys % 4 == 0).any() else 0.0
            cm = 222 if rng.random() > 0.2 else 223
            lines.append(" ".join([f"1 {_logkey(sid, cm, r)}", f"1 {label}"] + [f"1 {k}" for k in keys]))
    path = os.path.join(str(tmp_path), "pv-000.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return [path]


def _day(pkg, files, jparams):
    """One join + update day of ``pkg`` ("jax" or "port") with a registry
    of DAY_METRICS; returns each metric's stat block, read at the end."""
    jax_side = pkg == "jax"
    info, schema_cls, table_cls, ds_cls = (
        (JSlotInfo, JSlotSchema, JHostSparseTable, JBoxPSDataset) if jax_side
        else (SlotInfo, SlotSchema, HostSparseTable, BoxPSDataset)
    )
    lay = JValueLayout(embedx_dim=D) if jax_side else ValueLayout(embedx_dim=D)
    sparse = (JSparseOptimizerConfig if jax_side else SparseOptimizerConfig)(embedx_threshold=0.0)
    registry = jreg.MetricRegistry() if jax_side else reg.MetricRegistry(device="cpu")
    for name, kw in DAY_METRICS.items():
        registry.init_metric(name, bucket_size=BUCKETS, **kw)
    table = table_cls(lay, sparse, n_shards=2, seed=0)
    slots = [info("label", type="float", dense=True, dim=1)] + [info(f"s{i}") for i in range(S)]
    ds = ds_cls(schema_cls(slots, label_slot="label", parse_logkey=True), table, batch_size=B,
                shuffle_mode="local", seed=5)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    ds.set_current_phase(1)
    ds.preprocess_instance(max_rank=MAX_RANK)
    cfg_cls = JTrainStepConfig if jax_side else TrainStepConfig
    cfg = dict(num_slots=S, batch_size=B, layout=lay, sparse_opt=sparse, auc_buckets=BUCKETS)
    if jax_side:
        model = JRankDeepFM(JDeepFM(S, lay.pull_width, D, hidden=(16,)), S * lay.pull_width, max_rank=MAX_RANK)
        make = lambda c: JCTRTrainer(model, c, dense_opt=optax.adam(1e-3), metric_registry=registry)  # noqa: E731
    else:
        g = torch.Generator().manual_seed(0)
        model = RankDeepFM(DeepFM(S, lay.pull_width, D, hidden=(16,), generator=g), S * lay.pull_width,
                           max_rank=MAX_RANK, generator=g)
        model.load_state_dict(rank_deepfm_params_from_jax(jparams))
        make = lambda c: CTRTrainer(model, c, dense_opt=Adam(1e-3), device="cpu", metric_registry=registry)  # noqa: E731
    tr = make(cfg_cls(**cfg, model_takes_rank_offset=True))
    if jax_side:
        tr.init_params(jax.random.PRNGKey(0))
        tr.params = jparams
        tr.opt_state = optax.adam(1e-3).init(jparams)
    else:
        tr.init_params()
    n_real = ds.memory_data_size()
    tr.train_pass(ds)
    tr.set_test_mode(True)
    tr.train_pass(ds)  # a join eval pass counts too
    tr.set_test_mode(False)
    mid = {k: int(registry[k].state.pos.sum() + registry[k].state.neg.sum()) for k in DAY_METRICS}
    tr.handoff_table(ds)
    ds.postprocess_instance()
    ds.set_current_phase(0)
    tr2 = make(cfg_cls(**cfg))
    tr2.params = tr.params
    tr2.opt_state = (optax.adam(1e-3).init(tr.params) if jax_side else tr2.dense_opt.init(tr.params))
    tr2.train_pass(ds)
    n_upd = B * (n_real // B)  # the update phase's full batches
    ds.end_pass(tr2.trained_table())
    return {k: registry.get_metric(k) for k in DAY_METRICS}, mid, n_real, n_upd


@pytest.fixture(scope="module")
def jax_day(tmp_path_factory):
    """The pv file, the JAX weights and the JAX package's day, run once."""
    files = _write_files(tmp_path_factory.mktemp("reg"))
    lay = JValueLayout(embedx_dim=D)
    jmodel = JRankDeepFM(JDeepFM(S, lay.pull_width, D, hidden=(16,)), S * lay.pull_width, max_rank=MAX_RANK)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(2)))
    return files, jax.tree.map(np.asarray, jparams), _day("jax", files, jparams)


# the port's join feed -> its flags (the update phase then takes the
# resident, the packer or the slow feed)
PORT_FEEDS = {
    "resident_pv": dict(enable_resident_feed=1, enable_native_parser=True),
    "pv_packer": dict(enable_resident_feed=0, enable_native_parser=True),
    "pv_records": dict(enable_resident_feed=1, enable_native_parser=False),
}


@pytest.mark.parametrize("feed", list(PORT_FEEDS))
def test_registry_on_a_join_update_day_matches_jax(jax_day, feed):
    files, jparams, (jgot, jmid, n_real, n_upd) = jax_day
    before = {k: config.get_flag(k) for k in PORT_FEEDS[feed]}
    for k, v in PORT_FEEDS[feed].items():
        config.set_flag(k, v)
    try:
        got, mid, n_real2, _ = _day("port", files, jparams)
    finally:
        for k, v in before.items():
            config.set_flag(k, v)
    assert n_real == n_real2
    # the join phase: two epochs of real instances (training, eval); the
    # update metric counts nothing until the update phase
    assert mid == jmid
    assert mid["join"] == 2 * n_real and mid["update"] == 0 and mid["every"] == 2 * n_real
    assert got["update"]["ins_num"] == n_upd
    assert got["every"]["ins_num"] == 2 * n_real + n_upd
    for k in DAY_METRICS:
        assert got[k]["ins_num"] == jgot[k]["ins_num"], k
        assert got[k]["actual_ctr"] == jgot[k]["actual_ctr"], k
        assert abs(got[k]["auc"] - jgot[k]["auc"]) <= 2e-3, k
        assert abs(got[k]["predicted_ctr"] - jgot[k]["predicted_ctr"]) <= 1e-4, k

"""The join/update day on a world-2 mesh against the JAX package's
``CTRTrainer(plan=make_mesh(2))`` over the same pv files, on the port's
three join feeds.

The port's two ranks are spawned once (gloo on the CPU, a ``file://``
rendezvous, one thread a rank). Every rank loads the same pv files (bench
logkeys parsed) into its own ``HostSparseTable`` and
``BoxPSDataset(n_mesh_shards=2)`` (global batch 32, 16 a rank), groups
them (``preprocess_instance(max_rank=3)``) and trains the join pass with
a rank model: ``RankDeepFM`` over the fp32 tower of
``test_torch_mesh_step.py`` (``model_takes_rank_offset``), on each join
feed: "resident_pv" (the rank's block of the pv plan on its device),
"pv_packer" (``enable_resident_feed`` off) and "pv_records" (the native
parser off: ``pv_batches(n_devices=2)``). An eval pass follows, then the
table is handed to an update trainer, the update phase trains the flat
pass and ``end_pass(trained_table())`` writes it back. A last resident
pass takes ``resident_scan_batches`` 1 for the superstep's K.

Bounds (``test_torch_mesh_trainer.py``'s): tables rtol 1e-3 atol 1e-5,
params atol 2e-4, pass losses rtol 1e-3 against the JAX trainer on the
same feed; the AUC instance counts exact (ghosts masked); the port's
three feeds, and K 1 against K 8, bitwise among themselves; an eval pass
leaves the state bitwise; both ranks' host tables bitwise alike.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.models import RankDeepFM
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_mesh_step import LAY, S, JTower, Tower, tower_params

torch.set_num_threads(2)

B, WORLD, MAX_RANK, LR = 32, 2, 3, 1e-3
SPARSE = dict(embed_lr=0.3, embedx_lr=0.3, embedx_threshold=0.0)
TABLE_RTOL, TABLE_ATOL, PARAMS_ATOL, LOSS_RTOL = 1e-3, 1e-5, 2e-4, 1e-3
FEEDS = {  # join feed -> (flags in both packages, the update phase's feed)
    "resident_pv": (dict(enable_native_parser=True, enable_resident_feed=1), "resident"),
    "pv_packer": (dict(enable_native_parser=True, enable_resident_feed=0), "packer"),
    "pv_records": (dict(enable_native_parser=False, enable_resident_feed=1), "slow"),
}
IN_DIM = S * LAY.pull_width


def logkey(sid, cmatch, rank):
    return "0" * 11 + format(cmatch, "03x") + format(rank, "02x") + format(sid, "016x")


def write_pv_files(d, n_files=2, n_queries=40, seed=0):
    """pv files: queries of 1-4 ads (cmatch 222 or 223), S slots of 1-3
    keys, labels a function of the keys."""
    rng = np.random.default_rng(seed)
    files, sid = [], 1
    for fi in range(n_files):
        lines = []
        for _ in range(n_queries):
            for r in range(1, int(rng.integers(1, 5)) + 1):
                slots, label = [], 0.0
                for _ in range(S):
                    keys = rng.integers(1, 120, int(rng.integers(1, 4)))
                    label = 1.0 if (keys % 5 == 0).any() else label
                    slots.append(f"{len(keys)} " + " ".join(str(k) for k in keys))
                cm = 222 if rng.random() > 0.2 else 223
                lines.append(" ".join([f"1 {logkey(sid, cm, r)}", f"1 {label}"] + slots))
            sid += 1
        path = os.path.join(d, f"pv-{seed}-{fi:03d}.txt")
        with fs_open_write(path) as f:
            f.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def rank_param():
    rng = np.random.default_rng(7)
    return (0.05 * rng.normal(size=(MAX_RANK * MAX_RANK * IN_DIM, 1))).astype(np.float32)


def jax_params():
    return {"base": tower_params(), "rank_param": rank_param()}


def schema(info_cls, schema_cls):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)] + [info_cls(f"s{i}") for i in range(S)],
                      label_slot="label", parse_logkey=True)


def set_flags(cfg_module, flags):
    for k, v in flags.items():
        cfg_module.set_flag(k, v)


def rank_model():
    model = RankDeepFM(Tower(), IN_DIM, max_rank=MAX_RANK, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.rank_param.copy_(torch.from_numpy(rank_param()))
    return model


def port_join(plan, files, **trainer_kw):
    """The port's dataset at the join phase (one mesh rank, or one device
    with ``plan`` None) and a join trainer: (table, ds, trainer, cfg)."""
    world = 1 if plan is None else plan.world
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                      read_threads=2, n_mesh_shards=world)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    ds.set_current_phase(1)
    ds.preprocess_instance(max_rank=MAX_RANK)
    cfg = dict(num_slots=S, batch_size=B // world, layout=LAY, sparse_opt=SparseOptimizerConfig(**SPARSE),
               auc_buckets=1000)
    where = {"device": "cpu"} if plan is None else {"plan": plan}
    tr = CTRTrainer(rank_model(), TrainStepConfig(**cfg, model_takes_rank_offset=True), dense_opt=Adam(LR),
                    **where, **trainer_kw)
    tr.init_params()
    return table, ds, tr, cfg


def _params(tr, prefix, res):
    for k, v in tr.params.items():
        res[f"{prefix}:p:{k}"] = v.numpy()


def rank_main(plan, d: str, files) -> None:
    res = {}
    for feed, (flags, _) in FEEDS.items():
        set_flags(config, flags)
        table, ds, tr, cfg = port_join(plan, files)
        losses = []
        out = tr.train_pass(ds, on_batch=lambda i, m: losses.append(float(m["loss"])))
        res[f"{feed}:last_feed"] = np.array(tr.last_feed)
        res[f"{feed}:join_trained"] = tr.trained_table()
        res[f"{feed}:join_loss"] = np.float64(out["loss"])
        res[f"{feed}:join_losses"] = np.array(losses)
        res[f"{feed}:join_ins_num"] = np.float64(out["ins_num"])
        res[f"{feed}:join_batches"] = np.float64(out["batches"])
        res[f"{feed}:n_records"] = np.int64(ds.memory_data_size())
        _params(tr, f"{feed}:join", res)
        # an eval pass leaves the table and the dense side as they were
        opt_before = [t.clone() for t in (tr.opt_state.count, *tr.opt_state.mu.values(), *tr.opt_state.nu.values())]
        tr.set_test_mode(True)
        eout = tr.train_pass(ds)
        tr.set_test_mode(False)
        res[f"{feed}:eval_ins_num"] = np.float64(eout["ins_num"])
        res[f"{feed}:eval_same"] = np.array(
            tr.last_feed == feed
            and np.array_equal(tr.trained_table(), res[f"{feed}:join_trained"])
            and all(np.array_equal(v.numpy(), res[f"{feed}:join:p:{k}"]) for k, v in tr.params.items())
            and all(torch.equal(a, b) for a, b in zip(
                opt_before, (tr.opt_state.count, *tr.opt_state.mu.values(), *tr.opt_state.nu.values())))
        )
        tr.handoff_table(ds)
        ds.postprocess_instance()
        ds.set_current_phase(0)
        tr2 = CTRTrainer(tr.model, TrainStepConfig(**cfg), dense_opt=Adam(LR), plan=plan)
        tr2.params = {k: v.clone() for k, v in tr.params.items()}
        tr2.opt_state = tr2.dense_opt.init(tr2.params)
        uout = tr2.train_pass(ds)
        res[f"{feed}:upd_last_feed"] = np.array(tr2.last_feed)
        res[f"{feed}:upd_trained"] = tr2.trained_table()
        res[f"{feed}:upd_loss"] = np.float64(uout["loss"])
        res[f"{feed}:upd_ins_num"] = np.float64(uout["ins_num"])
        _params(tr2, f"{feed}:upd", res)
        ds.end_pass(tr2.trained_table())
        keys = np.sort(table.keys())
        res[f"{feed}:host_keys"], res[f"{feed}:host_rows"] = keys, table.pull_or_create(keys)
    # one batch a superstep on the resident pv feed
    set_flags(config, dict(FEEDS["resident_pv"][0], resident_scan_batches=1))
    _, ds, tr, _ = port_join(plan, files)
    out = tr.train_pass(ds)
    res["k1:join_trained"], res["k1:join_loss"] = tr.trained_table(), np.float64(out["loss"])
    _params(tr, "k1:join", res)
    set_flags(config, dict(FEEDS["resident_pv"][0], resident_scan_batches=8))
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_join")
    files = write_pv_files(str(d))  # before the ranks read them
    spawn(rank_main, WORLD, f"file://{d}/rdv", backend="gloo", device="cpu", args=(str(d), files),
          threads=1, timeout_s=300)
    return files, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def jax_day(files, feed):
    """The JAX mesh trainer's join/update day on a feed's flags."""
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.models import RankDeepFM as JRankDeepFM
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    flags = FEEDS[feed][0]
    before = {k: jconfig.get_flag(k) for k in flags}
    set_flags(jconfig, flags)
    try:
        lay = JLayout(embedx_dim=LAY.embedx_dim)
        table = JHostSparseTable(lay, JOpt(**SPARSE), n_shards=4, seed=0)
        ds = JBoxPSDataset(schema(JSlotInfo, JSlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                           n_mesh_shards=WORLD)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        ds.set_current_phase(1)
        ds.preprocess_instance(max_rank=MAX_RANK)
        plan = make_mesh(WORLD)
        cfg = dict(num_slots=S, batch_size=B // WORLD, layout=lay, sparse_opt=JOpt(**SPARSE), auc_buckets=1000,
                   axis_name="dp")
        model = JRankDeepFM(JTower(), IN_DIM, max_rank=MAX_RANK)
        tr = JCTRTrainer(model, JCfg(**cfg, model_takes_rank_offset=True), dense_opt=optax.adam(LR), plan=plan)
        tr.init_params(jax.random.PRNGKey(0))
        tr.params = jax.tree.map(jax.numpy.asarray, jax_params())
        tr.opt_state = optax.adam(LR).init(tr.params)
        jout = tr.train_pass(ds)
        out = {"join_out": jout, "join_trained": np.asarray(tr.trained_table()),
               "join_params": jax.tree.map(np.asarray, tr.params)}
        tr.handoff_table(ds)
        ds.postprocess_instance()
        ds.set_current_phase(0)
        tr2 = JCTRTrainer(model, JCfg(**cfg), dense_opt=optax.adam(LR), plan=plan)
        tr2.params = tr.params
        tr2.opt_state = optax.adam(LR).init(tr.params)
        out["upd_out"] = tr2.train_pass(ds)
        out["upd_trained"] = np.asarray(tr2.trained_table())
        out["upd_params"] = jax.tree.map(np.asarray, tr2.params)
        ds.end_pass(out["upd_trained"])
        keys = np.sort(table.keys())
        out["host"] = (keys, table.pull_or_create(keys))
        return out
    finally:
        set_flags(jconfig, before)


@pytest.fixture(scope="module")
def jax_days(ranks):
    files, _ = ranks
    return {feed: jax_day(files, feed) for feed in FEEDS}


def _assert_params(got_prefix, r, jparams):
    from paddlebox_tpu_torch.models import params_from_jax

    for k, v in params_from_jax(jparams).items():
        np.testing.assert_allclose(r[f"{got_prefix}:p:{k}"], v.numpy(), atol=PARAMS_ATOL, err_msg=k)


@pytest.mark.parametrize("feed", list(FEEDS))
def test_mesh_join_pass_matches_jax(ranks, jax_days, feed):
    _, res = ranks
    j = jax_days[feed]
    for r in res:
        assert str(r[f"{feed}:last_feed"]) == feed
        assert float(r[f"{feed}:join_batches"]) == j["join_out"]["batches"]
        assert float(r[f"{feed}:join_ins_num"]) == j["join_out"]["ins_num"] == int(r[f"{feed}:n_records"])
        np.testing.assert_allclose(float(r[f"{feed}:join_loss"]), j["join_out"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[f"{feed}:join_trained"], j["join_trained"], rtol=TABLE_RTOL, atol=TABLE_ATOL)
        _assert_params(f"{feed}:join", r, j["join_params"])


@pytest.mark.parametrize("feed", list(FEEDS))
def test_mesh_join_update_day_matches_jax(ranks, jax_days, feed):
    _, res = ranks
    j = jax_days[feed]
    for r in res:
        assert str(r[f"{feed}:upd_last_feed"]) == FEEDS[feed][1]
        assert float(r[f"{feed}:upd_ins_num"]) == j["upd_out"]["ins_num"]
        np.testing.assert_allclose(float(r[f"{feed}:upd_loss"]), j["upd_out"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[f"{feed}:upd_trained"], j["upd_trained"], rtol=TABLE_RTOL, atol=TABLE_ATOL)
        _assert_params(f"{feed}:upd", r, j["upd_params"])
        np.testing.assert_array_equal(r[f"{feed}:host_keys"], j["host"][0])
        np.testing.assert_allclose(r[f"{feed}:host_rows"], j["host"][1], rtol=TABLE_RTOL, atol=TABLE_ATOL)


def test_mesh_join_feeds_bitwise_and_ranks_agree(ranks):
    _, res = ranks
    ref = "resident_pv"
    for r in res:
        keys = [k.split(":", 1)[1] for k in r if k.startswith(f"{ref}:") and not k.endswith("last_feed")]
        for feed in FEEDS:
            for key in keys:
                np.testing.assert_array_equal(r[f"{feed}:{key}"], r[f"{ref}:{key}"], err_msg=f"{feed}:{key}")
        for key in ("join_trained", "join_loss") + tuple(k.split(":", 1)[1] for k in r if k.startswith("k1:join:p:")):
            np.testing.assert_array_equal(r[f"k1:{key}"], r[f"{ref}:{key}"], err_msg=f"K=1 {key}")
    for feed in FEEDS:  # every rank's host table and losses the same
        for key in ("host_keys", "host_rows", "join_losses", "join_trained"):
            np.testing.assert_array_equal(res[0][f"{feed}:{key}"], res[1][f"{feed}:{key}"])


@pytest.mark.parametrize("feed", list(FEEDS))
def test_mesh_join_eval_pass_leaves_state_bitwise(ranks, feed):
    _, res = ranks
    for r in res:
        assert bool(r[f"{feed}:eval_same"])
        assert float(r[f"{feed}:eval_ins_num"]) == int(r[f"{feed}:n_records"])

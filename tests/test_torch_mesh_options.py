"""The mesh trainer's options against the JAX package's mesh trainer at
world 2: a metric registry on a join/update day, dumps, async dense and
``check_nan`` with those consumers.

The port's two ranks are spawned once (gloo on the CPU, one thread a
rank) and every rank runs every case with the same options, as a mesh
must; the inputs are ``test_torch_mesh_join.py``'s pv files, its rank
model over the fp32 tower and its flags.

- Registry: metrics for the join phase, the update phase, every phase and
  two (cmatch, rank) pairs, fed by a join pass, a join eval pass and the
  update pass, on each join feed. The JAX single-host registry sees the
  global batch; so must every rank's: the instance counts and the actual
  CTR exact against JAX, the AUC within 2e-3 and the predicted CTR within
  1e-4 (``test_torch_registry.py``'s bounds), and both ranks' bucket
  tables bitwise alike.
- Dumps: an eval pass (the JAX weights as loaded) with the param dump at
  its end: rank 0's part file holds every global instance once, in the
  JAX trainer's order, preds within 1e-5 of its, and the param lines its
  bytes; rank 1 writes nothing. A training pass dumps steps x the global
  batch lines.
- Async dense: rank 0 holds the ``AsyncDenseTable`` (``merge_limit=1``,
  rank 1 passes None) and waits in ``on_batch`` for each update, the JAX
  side spins on ``n_updates``: the final params within 2e-4 of JAX's,
  the loss rtol 1e-3, the trained table rtol 1e-3 atol 1e-5; the params
  every rank trained on at every step bitwise alike; two runs bitwise.
- ``check_nan``: a record with a NaN label poisons one batch, which both
  packages skip; the registry's instance counts equal JAX's and the dump
  has no line of that batch.
"""

import glob
import os
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.metrics import MetricRegistry
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
from paddlebox_tpu_torch.train import Adam, AsyncDenseTable, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils.dump import DumpWorkerPool
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_mesh_join import (
    B,
    FEEDS,
    LAY,
    LR,
    MAX_RANK,
    S,
    SPARSE,
    WORLD,
    JTower,
    Tower,
    jax_params,
    port_join,
    schema,
    set_flags,
    write_pv_files,
)
from test_torch_mesh_step import tower_params

torch.set_num_threads(2)

BUCKETS = 1000
METRICS = {
    "join": dict(phase=1),
    "update": dict(phase=0),
    "every": dict(),
    "cmatch_rank": dict(method="cmatch_rank_auc", cmatch_rank_group="222:1,222:2"),
}
FLAT_METRICS = ("every", "join")  # a flat pass has no logkeys; its phase is the default 1
STATS = ("ins_num", "actual_ctr", "auc", "predicted_ctr")
AUC_ATOL, PCTR_ATOL = 2e-3, 1e-4
PRED_ATOL, PARAMS_ATOL, LOSS_RTOL, TABLE_RTOL, TABLE_ATOL = 1e-5, 2e-4, 1e-3, 1e-3, 1e-5
ASYNC_LR, ASYNC_BATCHES, WAIT_S = 0.05, 6, 60.0
NAN_BATCHES = 8  # the whole pass: 256 records, the NaN one among them


def write_flat_files(d, nan_record=None, n_rec=256, seed=3):
    """Flat files (no logkeys): S slots of 1-2 keys; record ``nan_record``
    gets a NaN label."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_rec):
        label = "nan" if i == nan_record else f"{float(rng.random() < 0.3)}"
        slots = []
        for _ in range(S):
            keys = rng.integers(1, 200, int(rng.integers(1, 3)))
            slots.append(f"{len(keys)} " + " ".join(str(k) for k in keys))
        lines.append(f"1 {label} " + " ".join(slots))
    path = os.path.join(d, f"flat-{seed}-{nan_record}.txt")
    with fs_open_write(path) as f:
        f.write("\n".join(lines) + "\n")
    return [path]


def flat_schema(info_cls, schema_cls):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)] + [info_cls(f"s{i}") for i in range(S)],
                      label_slot="label")


def _registry(jax_side=False, names=tuple(METRICS)):
    if jax_side:
        from paddlebox_tpu.metrics import registry as jreg

        reg = jreg.MetricRegistry()
    else:
        reg = MetricRegistry(device="cpu")
    for name in names:
        reg.init_metric(name, bucket_size=BUCKETS, **METRICS[name])
    return reg


def _read_metrics(reg, res, prefix):
    for name in reg.names():
        st = reg[name].state
        res[f"{prefix}:{name}:pos"], res[f"{prefix}:{name}:neg"] = np.asarray(st.pos), np.asarray(st.neg)
        m = reg.get_metric(name)
        res[f"{prefix}:{name}:stats"] = np.array([m[k] for k in STATS], np.float64)


def _registry_day(plan, files, res, feed):
    set_flags(config, FEEDS[feed][0])
    reg = _registry()
    _, ds, tr, cfg = port_join(plan, files, metric_registry=reg)
    tr.train_pass(ds)
    tr.set_test_mode(True)
    tr.train_pass(ds)
    tr.set_test_mode(False)
    tr.handoff_table(ds)
    ds.postprocess_instance()
    ds.set_current_phase(0)
    tr2 = CTRTrainer(tr.model, TrainStepConfig(**cfg), dense_opt=Adam(LR), plan=plan, metric_registry=reg)
    tr2.params = {k: v.clone() for k, v in tr.params.items()}
    tr2.opt_state = tr2.dense_opt.init(tr2.params)
    tr2.train_pass(ds)
    res[f"reg:{feed}:n_records"] = np.int64(ds.memory_data_size())
    _read_metrics(reg, res, f"reg:{feed}")
    ds.end_pass(tr2.trained_table())


def _dump_lines(root):
    lines = []
    for p in sorted(glob.glob(os.path.join(root, "part-*"))):
        with open(p) as f:
            lines += [ln for ln in f.read().split("\n") if ln]
    return lines


def _dump_passes(plan, d, files, res):
    set_flags(config, FEEDS["resident_pv"][0])
    for what, eval_mode in (("eval", True), ("train", False)):
        root = os.path.join(d, f"dump-{what}-rank{plan.rank}")
        pool = DumpWorkerPool(root, n_threads=1)
        _, ds, tr, _ = port_join(plan, files, dump_pool=pool, dump_params_at_end=eval_mode)
        tr.set_test_mode(eval_mode)
        out = tr.train_pass(ds)
        pool.finalize()
        res[f"dump:{what}:batches"] = np.float64(out["batches"])
        res[f"dump:{what}:lines"] = np.array(_dump_lines(root))


def _async_pass(plan, files, res, tag):
    set_flags(config, FEEDS["pv_packer"][0])
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(flat_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                      read_threads=2, n_mesh_shards=plan.world)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = TrainStepConfig(num_slots=S, batch_size=B // plan.world, layout=LAY,
                          sparse_opt=SparseOptimizerConfig(**SPARSE), auc_buckets=1000, dense_sync_mode="async")
    adt = AsyncDenseTable(tower_params(), base_lr=ASYNC_LR, merge_limit=1) if plan.rank == 0 else None
    tr = CTRTrainer(Tower(), cfg, plan=plan, async_dense=adt)
    tr.init_params()
    seen = []
    pull = tr._async_params

    def recorded(like):
        out = pull(like)
        seen.append(np.concatenate([out[k].numpy().reshape(-1) for k in sorted(out)]))
        return out

    tr._async_params = recorded

    def wait(i, m):
        if adt is not None:
            assert adt.wait_for_updates(i + 1, timeout=WAIT_S), f"update {i + 1} never applied"

    out = tr.train_pass(ds, n_batches=ASYNC_BATCHES, on_batch=wait)
    res[f"{tag}:last_feed"] = np.array(tr.last_feed)
    res[f"{tag}:seen"] = np.stack(seen)
    res[f"{tag}:loss"] = np.float64(out["loss"])
    res[f"{tag}:trained"] = tr.trained_table()
    for k, v in tr.params.items():
        res[f"{tag}:p:{k}"] = v.numpy()
    if adt is not None:
        res[f"{tag}:n_updates"] = np.int64(adt.n_updates)
        adt.finalize()
    ds.end_pass(tr.trained_table())


def _nan_pass(plan, d, files, res):
    set_flags(config, FEEDS["pv_packer"][0])
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(flat_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                      read_threads=2, n_mesh_shards=plan.world)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = TrainStepConfig(num_slots=S, batch_size=B // plan.world, layout=LAY,
                          sparse_opt=SparseOptimizerConfig(**SPARSE), auc_buckets=1000, check_nan=True)
    reg = _registry(names=FLAT_METRICS)
    root = os.path.join(d, f"dump-nan-rank{plan.rank}")
    pool = DumpWorkerPool(root, n_threads=1)
    tr = CTRTrainer(Tower(), cfg, plan=plan, metric_registry=reg, dump_pool=pool)
    tr.init_params()
    out = tr.train_pass(ds, n_batches=NAN_BATCHES)
    pool.finalize()
    res["nan:nan_batches"] = np.float64(out["nan_batches"])
    res["nan:lines"] = np.array(_dump_lines(root))
    _read_metrics(reg, res, "nan")
    ds.end_pass(tr.trained_table())


def rank_main(plan, d: str, pv_files, flat_files, nan_files) -> None:
    res = {}
    for feed in FEEDS:
        _registry_day(plan, pv_files, res, feed)
    _dump_passes(plan, d, pv_files, res)
    _async_pass(plan, flat_files, res, "async")
    _async_pass(plan, flat_files, res, "async_twin")
    _nan_pass(plan, d, nan_files, res)
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_options")
    pv_files = write_pv_files(str(d))
    flat_files = write_flat_files(str(d))
    nan_files = write_flat_files(str(d), nan_record=37)
    spawn(rank_main, WORLD, f"file://{d}/rdv", backend="gloo", device="cpu",
          args=(str(d), pv_files, flat_files, nan_files), threads=1, timeout_s=300)
    return (pv_files, flat_files, nan_files, str(d)), [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_mesh():
    from paddlebox_tpu.parallel import make_mesh

    return make_mesh(WORLD)


def _jax_dataset(files, flat=False):
    from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout

    lay = JLayout(embedx_dim=LAY.embedx_dim)
    table = JHostSparseTable(lay, JOpt(**SPARSE), n_shards=4, seed=0)
    sch = flat_schema(JSlotInfo, JSlotSchema) if flat else schema(JSlotInfo, JSlotSchema)
    ds = JBoxPSDataset(sch, table, batch_size=B, shuffle_mode="local", seed=5, n_mesh_shards=WORLD)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    if not flat:
        ds.set_current_phase(1)
        ds.preprocess_instance(max_rank=MAX_RANK)
    return lay, ds


def _jax_cfg(lay, **kw):
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    return JCfg(num_slots=S, batch_size=B // WORLD, layout=lay, sparse_opt=JOpt(**SPARSE), auc_buckets=1000,
                axis_name="dp", **kw)


def _jax_join_trainer(lay, **kw):
    import jax
    import optax

    from paddlebox_tpu.models import RankDeepFM as JRankDeepFM
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer

    model = JRankDeepFM(JTower(), S * LAY.pull_width, max_rank=MAX_RANK)
    tr = JCTRTrainer(model, _jax_cfg(lay, model_takes_rank_offset=True), dense_opt=optax.adam(LR), plan=_jax_mesh(),
                     **kw)
    tr.init_params(jax.random.PRNGKey(0))
    tr.params = jax.tree.map(jax.numpy.asarray, jax_params())
    tr.opt_state = optax.adam(LR).init(tr.params)
    return model, tr


def _jax_stats(reg):
    out = {}
    for name in reg.names():
        m = reg.get_metric(name)  # computes and resets
        out[name] = np.array([m[k] for k in STATS], np.float64)
    return out


@pytest.mark.parametrize("feed", list(FEEDS))
def test_mesh_registry_on_a_join_update_day_matches_jax(ranks, feed):
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer

    (pv_files, _, _, _), res = ranks
    before = {k: jconfig.get_flag(k) for k in FEEDS[feed][0]}
    set_flags(jconfig, FEEDS[feed][0])
    try:
        lay, ds = _jax_dataset(pv_files)
        reg = _registry(jax_side=True)
        model, tr = _jax_join_trainer(lay, metric_registry=reg)
        tr.train_pass(ds)
        tr.set_test_mode(True)
        tr.train_pass(ds)
        tr.set_test_mode(False)
        tr.handoff_table(ds)
        ds.postprocess_instance()
        ds.set_current_phase(0)
        tr2 = JCTRTrainer(model, _jax_cfg(lay), dense_opt=optax.adam(LR), plan=tr.plan, metric_registry=reg)
        tr2.params = tr.params
        tr2.opt_state = optax.adam(LR).init(tr.params)
        tr2.train_pass(ds)
        want = _jax_stats(reg)
    finally:
        set_flags(jconfig, before)
    n_real = int(res[0][f"reg:{feed}:n_records"])
    assert want["join"][0] == 2 * n_real  # a training and an eval epoch of real instances
    for r in res:
        for name in METRICS:
            got = r[f"reg:{feed}:{name}:stats"]
            np.testing.assert_array_equal(got[:2], want[name][:2], err_msg=name)
            assert abs(got[2] - want[name][2]) <= AUC_ATOL, name
            assert abs(got[3] - want[name][3]) <= PCTR_ATOL, name
    for name in METRICS:  # every rank's registry reads the same
        for k in ("pos", "neg", "stats"):
            np.testing.assert_array_equal(res[0][f"reg:{feed}:{name}:{k}"], res[1][f"reg:{feed}:{name}:{k}"])


def _parse(lines):
    ids, preds = [], []
    for ln in lines:
        ins, *fields = ln.split("\t")
        ids.append(ins)
        for f in fields:
            name, vals = f.split(":", 1)
            if name == "preds":
                preds.append(float(vals))
    return ids, np.array(preds)


def test_mesh_dump_matches_jax_and_is_written_once(ranks, tmp_path):
    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.utils.dump import DumpWorkerPool as JDumpWorkerPool

    (pv_files, _, _, _), res = ranks
    before = {k: jconfig.get_flag(k) for k in FEEDS["resident_pv"][0]}
    set_flags(jconfig, FEEDS["resident_pv"][0])
    try:
        lay, ds = _jax_dataset(pv_files)
        pool = JDumpWorkerPool(str(tmp_path / "jdump"), n_threads=1)
        _, tr = _jax_join_trainer(lay, dump_pool=pool, dump_params_at_end=True)
        tr.set_test_mode(True)
        jout = tr.train_pass(ds)
        pool.finalize()
        want = _dump_lines(str(tmp_path / "jdump"))
    finally:
        set_flags(jconfig, before)
    r0, r1 = res
    assert len(r1["dump:eval:lines"]) == len(r1["dump:train:lines"]) == 0  # rank 1 writes nothing
    got = list(r0["dump:eval:lines"])
    n_inst = int(jout["batches"]) * B
    ins_lines = [ln for ln in got if "\tpreds:" in ln]
    want_ins = [ln for ln in want if "\tpreds:" in ln]
    assert len(ins_lines) == len(want_ins) == n_inst
    ids, preds = _parse(ins_lines)
    jids, jpreds = _parse(want_ins)
    assert ids == jids
    np.testing.assert_allclose(preds, jpreds, atol=PRED_ATOL)
    # the param dump: the JAX package's lines byte for byte
    assert [ln for ln in got if "\tpreds:" not in ln] == [ln for ln in want if "\tpreds:" not in ln]
    assert len(r0["dump:train:lines"]) == int(r0["dump:train:batches"]) * B


def test_mesh_async_dense_matches_jax_and_ranks_share_params(ranks):
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.train import AsyncDenseTable as JAsyncDenseTable
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer

    (_, flat_files, _, _), res = ranks
    before = {k: jconfig.get_flag(k) for k in FEEDS["pv_packer"][0]}
    set_flags(jconfig, FEEDS["pv_packer"][0])
    try:
        lay, ds = _jax_dataset(flat_files, flat=True)
        jparams = jax.tree.map(jax.numpy.asarray, tower_params())
        adt = JAsyncDenseTable(jparams, base_lr=ASYNC_LR, merge_limit=1)
        tr = JCTRTrainer(JTower(), _jax_cfg(lay, dense_sync_mode="async"), dense_opt=optax.adam(LR),
                         async_dense=adt, plan=_jax_mesh())
        tr.params = jparams
        tr.opt_state = optax.adam(LR).init(jparams)

        def wait(i, m):
            deadline = time.monotonic() + WAIT_S
            while adt.n_updates < i + 1:  # spin: the JAX table has no wait call
                if time.monotonic() > deadline:
                    raise TimeoutError(f"update {i + 1} never applied")

        jout = tr.train_pass(ds, n_batches=ASYNC_BATCHES, on_batch=wait)
        jtrained = np.asarray(tr.trained_table())
        final = jax.tree.map(np.asarray, adt.finalize())
    finally:
        set_flags(jconfig, before)
    r0, r1 = res
    assert int(r0["async:n_updates"]) == ASYNC_BATCHES
    for r in res:
        assert str(r["async:last_feed"]) == "packer"  # async stays off the resident feed
        np.testing.assert_allclose(float(r["async:loss"]), jout["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["async:trained"], jtrained, rtol=TABLE_RTOL, atol=TABLE_ATOL)
        for k, v in final.items():
            np.testing.assert_allclose(r[f"async:p:{k}"], v, atol=PARAMS_ATOL, err_msg=k)
    moved = max(float(np.abs(r0[f"async:p:{k}"] - v).max()) for k, v in tower_params().items())
    assert moved > ASYNC_LR / 10  # the table trained the params
    # every step's params (and the pass-end pull) the same bits on both ranks
    assert r0["async:seen"].shape[0] == ASYNC_BATCHES + 1
    np.testing.assert_array_equal(r0["async:seen"], r1["async:seen"])
    for key in ("seen", "trained", "loss"):  # the drive is deterministic
        np.testing.assert_array_equal(r0[f"async_twin:{key}"], r0[f"async:{key}"])


def test_mesh_nan_skipped_batch_reaches_no_registry_and_no_dump(ranks, tmp_path):
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer

    (_, _, nan_files, _), res = ranks
    before = {k: jconfig.get_flag(k) for k in FEEDS["pv_packer"][0]}
    set_flags(jconfig, FEEDS["pv_packer"][0])
    try:
        lay, ds = _jax_dataset(nan_files, flat=True)
        reg = _registry(jax_side=True, names=FLAT_METRICS)
        tr = JCTRTrainer(JTower(), _jax_cfg(lay, check_nan=True), dense_opt=optax.adam(LR), plan=_jax_mesh(),
                         metric_registry=reg)
        tr.params = jax.tree.map(jax.numpy.asarray, tower_params())
        tr.opt_state = optax.adam(LR).init(tr.params)
        jout = tr.train_pass(ds, n_batches=NAN_BATCHES)
        want = _jax_stats(reg)
    finally:
        set_flags(jconfig, before)
    assert jout["nan_batches"] == 1.0
    for r in res:
        assert float(r["nan:nan_batches"]) == 1.0
        for name in FLAT_METRICS:
            got = r[f"nan:{name}:stats"]
            assert got[0] == want[name][0] == (NAN_BATCHES - 1) * B, name
            assert got[1] == want[name][1], name
            assert abs(got[2] - want[name][2]) <= AUC_ATOL, name
    assert len(res[0]["nan:lines"]) == (NAN_BATCHES - 1) * B and len(res[1]["nan:lines"]) == 0

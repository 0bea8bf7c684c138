"""The carried pass boundary on a world-2 mesh against the classic one and
against the JAX package's carried mesh run.

The port's two ranks are spawned once (gloo on the CPU, one thread a
rank). Each rank trains two passes (keys 1-199, then 100-299: keys leave,
stay and arrive at the boundary) with the fp32 tower of
``test_torch_mesh_step.py`` on the resident feed, four ways: "classic"
(``end_pass(trainer.trained_table())``), "carried"
(``end_pass(trainer.trained_table_device())``: each rank's shard stays on
its device), "eager" (carried, ``carried_eager_flush`` on: the mesh
carrier flushes on the main thread right after the splice) and "delta"
(carried, but the first boundary saves a delta, so the shard goes back the
classic way). After the second pass ``BoxPSDataset.flush_carried`` (every
rank alike) flushes what is owed; before it, a save that reaches the
pending mesh carrier raises at once, on rank 0 alone and on a side thread
of every rank, rather than wait for a collective no other rank joins.

Checks: the carried runs' second pass table (this rank's shard after the
splice), their losses and their drained host tables bitwise the classic
run's; both ranks' host tables bitwise alike, also between the boundary
and the flush (the departing rows reach both); the delta run's first
boundary saved a delta. Against the JAX package's carried mesh run
(``tests/test_carrier.py``'s mesh case on two of the suite's virtual CPU
devices): losses rtol 1e-3, the drained host rows rtol 1e-3 atol 1e-5.
"""

import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_mesh_join import LAY, LR, S, WORLD, JTower, Tower, set_flags
from test_torch_mesh_step import tower_params

torch.set_num_threads(2)

B, N_REC = 32, 128
SPARSE = dict(embed_lr=0.3, embedx_lr=0.3, embedx_threshold=0.0, shrink_threshold=0.0)
PASSES = ((1, 200), (100, 300))  # key ranges of the two passes
MODES = {  # mode -> (end_pass takes the device shard, flags, the first boundary saves a delta)
    "classic": (False, dict(enable_carried_table=1, carried_eager_flush=0), False),
    "carried": (True, dict(enable_carried_table=1, carried_eager_flush=0), False),
    "eager": (True, dict(enable_carried_table=1, carried_eager_flush=1), False),
    "delta": (True, dict(enable_carried_table=1, carried_eager_flush=0), True),
}
LOSS_RTOL, TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-3, 1e-5


def write_pass_files(d):
    files = []
    for i, (lo, hi) in enumerate(PASSES):
        rng = np.random.default_rng(i)
        path = os.path.join(d, f"pass-{i}.txt")
        with fs_open_write(path) as f:
            for _ in range(N_REC):
                keys = rng.integers(lo, hi, S)
                f.write(f"1 {float(keys[0] % 3 == 0)} " + " ".join(f"1 {k}" for k in keys) + "\n")
        files.append(path)
    return files


def schema(info_cls, schema_cls):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)] + [info_cls(f"s{i}") for i in range(S)],
                      label_slot="label")


def host_contents(table):
    keys = np.sort(table.keys())
    return keys, table.pull_or_create(keys)


def digest(table) -> str:
    keys, rows = host_contents(table)
    return hashlib.blake2b(keys.tobytes() + rows.tobytes(), digest_size=16).hexdigest()


def refused(fn) -> str:
    """The RuntimeError ``fn`` raised ('' if it returned)."""
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return ""


def refused_on_thread(fn) -> str:
    out = []
    th = threading.Thread(target=lambda: out.append(refused(fn)))
    th.start()
    th.join()
    return out[0]


def run_mode(plan, d, files, mode, res):
    carried, flags, delta = MODES[mode]
    set_flags(config, dict(flags, enable_native_parser=True, enable_resident_feed=1))
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="none", read_threads=1,
                      n_mesh_shards=plan.world)
    cfg = TrainStepConfig(num_slots=S, batch_size=B // plan.world, layout=LAY,
                          sparse_opt=SparseOptimizerConfig(**SPARSE), auc_buckets=100)
    tr = CTRTrainer(Tower(), cfg, dense_opt=Adam(LR), plan=plan)
    tr.init_params()
    losses = []
    for i, f in enumerate(files):
        ds.set_filelist([f])
        ds.load_into_memory()
        dev = ds.begin_pass(round_to=16)
        if i == 1:
            shard = dev if isinstance(dev, torch.Tensor) else torch.from_numpy(dev[plan.rank])
            res[f"{mode}:pass2_table"] = shard.reshape(-1, LAY.width).numpy().copy()
            res[f"{mode}:pass2_spliced"] = np.array(isinstance(dev, torch.Tensor))
            res[f"{mode}:boundary_host"] = np.array(digest(table))
        out = tr.train_pass(ds)
        losses.append(out["loss"])
        kw = {}
        if delta and i == 0:
            kw = dict(need_save_delta=True, delta_dir=os.path.join(d, f"delta-{mode}-rank{plan.rank}"))
        saved = ds.end_pass(tr.trained_table_device() if carried else tr.trained_table(), **kw)
        if delta and i == 0:
            res[f"{mode}:delta_keys"] = np.int64(saved["delta_keys"])
    base = os.path.join(d, f"base-{mode}-rank{plan.rank}")
    if mode == "carried":
        if plan.rank == 0:  # rank 1 never joins this save
            res["carried:alone_save"] = np.array(refused(lambda: table.save_base(base)))
        res["carried:thread_save"] = np.array(refused_on_thread(lambda: table.save_delta(base)))
    res[f"{mode}:pending_before_drain"] = np.int64(ds.flush_carried())
    if mode == "carried":
        res["carried:save_after_flush"] = np.array(refused(lambda: table.save_base(base)))
    res[f"{mode}:losses"] = np.array(losses)
    res[f"{mode}:host_keys"], res[f"{mode}:host_rows"] = host_contents(table)


def rank_main(plan, d: str, files) -> None:
    res = {}
    for mode in MODES:
        run_mode(plan, d, files, mode, res)
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_carrier")
    files = write_pass_files(str(d))
    spawn(rank_main, WORLD, f"file://{d}/rdv", backend="gloo", device="cpu", args=(str(d), files),
          threads=1, timeout_s=300)
    return files, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("mode", ["carried", "eager", "delta"])
def test_mesh_carried_boundary_is_bitwise_classic(ranks, mode):
    _, res = ranks
    for r in res:
        assert bool(r[f"{mode}:pass2_spliced"]) == (mode != "delta")
        assert not bool(r["classic:pass2_spliced"])
        for key in ("pass2_table", "losses", "host_keys", "host_rows"):
            np.testing.assert_array_equal(r[f"{mode}:{key}"], r[f"classic:{key}"], err_msg=key)
    # the second boundary's carrier is owed until the drain; at the first
    # boundary the host holds the classic rows once the eager flush or the
    # classic writeback ran, and the pre-pass rows of the carried keys else
    assert int(res[0][f"{mode}:pending_before_drain"]) > 0
    same = str(res[0][f"{mode}:boundary_host"]) == str(res[0]["classic:boundary_host"])
    assert same == (mode != "carried")


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_ranks_host_tables_alike(ranks, mode):
    _, res = ranks
    for key in ("boundary_host", "host_keys", "host_rows", "losses"):
        np.testing.assert_array_equal(res[0][f"{mode}:{key}"], res[1][f"{mode}:{key}"], err_msg=key)


def test_mesh_save_with_a_pending_carrier_raises(ranks):
    _, res = ranks
    assert "flush_carried" in str(res[0]["carried:alone_save"])
    for r in res:
        assert "flush_carried" in str(r["carried:thread_save"])
        assert str(r["carried:save_after_flush"]) == ""


def test_mesh_delta_boundary_saves_the_pass_keys(ranks):
    _, res = ranks
    for r in res:
        assert int(r["delta:delta_keys"]) > 0


def test_mesh_carried_boundary_matches_jax(ranks):
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    files, res = ranks
    flags = dict(enable_carried_table=1, carried_eager_flush=0, enable_native_parser=True, enable_resident_feed=1)
    before = {k: jconfig.get_flag(k) for k in flags}
    set_flags(jconfig, flags)
    try:
        lay = JLayout(embedx_dim=LAY.embedx_dim)
        table = JHostSparseTable(lay, JOpt(**SPARSE), n_shards=4, seed=0)
        ds = JBoxPSDataset(schema(JSlotInfo, JSlotSchema), table, batch_size=B, shuffle_mode="none",
                           n_mesh_shards=WORLD)
        plan = make_mesh(WORLD)
        cfg = JCfg(num_slots=S, batch_size=B // WORLD, layout=lay, sparse_opt=JOpt(**SPARSE), auc_buckets=100,
                   axis_name="dp")
        tr = JCTRTrainer(JTower(), cfg, dense_opt=optax.adam(LR), plan=plan)
        tr.init_params(jax.random.PRNGKey(0))
        tr.params = jax.tree.map(jax.numpy.asarray, tower_params())
        tr.opt_state = optax.adam(LR).init(tr.params)
        losses = []
        for f in files:
            ds.set_filelist([f])
            ds.load_into_memory()
            ds.begin_pass(round_to=16)
            losses.append(tr.train_pass(ds)["loss"])
            ds.end_pass(tr.trained_table_device())
        table.drain_pending()
        keys, rows = host_contents(table)
    finally:
        set_flags(jconfig, before)
    for r in res:
        np.testing.assert_allclose(r["carried:losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(r["carried:host_keys"], keys)
        np.testing.assert_allclose(r["carried:host_rows"], rows, rtol=TABLE_RTOL, atol=TABLE_ATOL)

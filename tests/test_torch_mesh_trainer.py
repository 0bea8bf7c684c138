"""``CTRTrainer(plan=...)`` at world 2 against the JAX package's
``CTRTrainer(plan=make_mesh(2))`` over the same native slot files, on the
three flat feeds.

The port's two ranks are spawned once (gloo on the CPU, a ``file://``
rendezvous, one thread a rank). Every rank loads the same two files into
its own ``HostSparseTable`` and ``BoxPSDataset(n_mesh_shards=2)`` (batch
256, 128 a rank), trains one pass a feed with the fp32 tower of
``test_torch_mesh_step.py`` and ends it with ``trained_table()``:
"resident" (the native parser and ``enable_resident_feed``), "packer"
(``enable_resident_feed`` off) and "slow" (``enable_native_parser`` off).
After the resident pass an eval pass (``set_test_mode``) must leave the
table, params and optimizer state bitwise. Then a pass in kstep
(``param_sync_step=2``) and one in ZeRO-1 mode, each ending in
``save_dense``; then a packer pass with ``feed_pipeline_workers=3`` and
a bucket of 4, small enough that K, the mesh's request bucket, differs
from batch to batch; last, rank 1 loads a different file list and
``train_pass`` must raise the replica-digest mismatch on both ranks.

Bounds (``test_torch_mesh_step.py``'s): the trained table rtol 1e-3 atol
1e-5, params atol 2e-4, pass loss rtol 1e-3 against the JAX trainer on
the same feed; the AUC instance count exact; the port's three feeds
bitwise among themselves (table, params, loss, host rows after end_pass);
``last_feed`` the feed the JAX trainer took (its resident or packer
cache, else the slow feed); after end_pass both ranks' host tables
bitwise the same. kstep and ZeRO-1: params within 2e-4 of the JAX
trainer's and bitwise alike on both ranks; the dense file's leaves those
of the JAX trainer's file (shapes exact, params 2e-4, counts exact,
moments rtol 5e-2 / atol 1e-6). The threaded packer pass: K frozen at
the largest batch's need on both ranks, and the state bitwise the
resident pass's.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.device_pack import block_pad_stats
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_mesh_step import JTower, Tower

torch.set_num_threads(2)

S, D, B, N_REC, WORLD = 4, 4, 256, 256, 2
LR = 1e-3
SPARSE = dict(embed_lr=0.3, embedx_lr=0.3, embedx_threshold=2.0, shrink_threshold=0.5)
FEEDS = {  # feed -> flags in both packages
    "resident": dict(enable_native_parser=True, enable_resident_feed=1),
    "packer": dict(enable_native_parser=True, enable_resident_feed=0),
    "slow": dict(enable_native_parser=False, enable_resident_feed=1),
}
TABLE_RTOL, TABLE_ATOL, PARAMS_ATOL, LOSS_RTOL = 1e-3, 1e-5, 2e-4, 1e-3
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-6
KSTEP = 2
THREADS_BUCKET = 4


def _write_files(d, n_files=2, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        keys = rng.integers(1, 300, (N_REC, S))
        labels = (rng.random(N_REC) < 0.3).astype(int)
        path = os.path.join(d, f"part-{seed}-{fi:03d}.txt")
        with fs_open_write(path) as f:
            for i in range(N_REC):
                f.write(f"1 {labels[i]}.0 " + " ".join(f"1 {k}" for k in keys[i]) + "\n")
        files.append(path)
    return files


def _schema(info_cls, schema_cls):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)] + [info_cls(f"s{i}") for i in range(S)],
                      label_slot="label")


def _set_flags(cfg_module, flags):
    for k, v in flags.items():
        cfg_module.set_flag(k, v)


def _port_pass(plan, files, mode="step", pack_bucket=None):
    """One pass of the port's mesh trainer in a dense sync mode ("step",
    "kstep" or "zero"): (trainer, dataset, table, out)."""
    import dataclasses

    from paddlebox_tpu_torch.fleet import Zero1Optimizer

    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                      read_threads=2, n_mesh_shards=plan.world)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = TrainStepConfig(num_slots=S, batch_size=B // plan.world, layout=lay,
                          sparse_opt=SparseOptimizerConfig(**SPARSE), auc_buckets=1000)
    if mode == "kstep":
        cfg = dataclasses.replace(cfg, dense_sync_mode="kstep", param_sync_step=KSTEP)
    opt = Zero1Optimizer(Adam(LR), n_dev=plan.world) if mode == "zero" else Adam(LR)
    tr = CTRTrainer(Tower(), cfg, dense_opt=opt, plan=plan, pack_bucket=pack_bucket)
    tr.prepare_pass(ds)
    out = tr.train_pass(ds)
    return tr, ds, table, out


def rank_main(plan, d: str, files, other_files) -> None:
    res = {}
    for feed, flags in FEEDS.items():
        _set_flags(config, flags)
        tr, ds, table, out = _port_pass(plan, files)
        res[f"{feed}:trained"] = tr.trained_table()
        res[f"{feed}:loss"] = np.float64(out["loss"])
        res[f"{feed}:ins_num"] = np.float64(out["ins_num"])
        res[f"{feed}:last_feed"] = np.array(tr.last_feed)
        for k, v in tr.params.items():
            res[f"{feed}:p:{k}"] = v.numpy()
        if feed == "resident":  # an eval pass leaves the table and the dense side as they were
            opt_before = [t.clone() for t in (tr.opt_state.count, *tr.opt_state.mu.values())]
            tr.set_test_mode(True)
            eout = tr.train_pass(ds)
            tr.set_test_mode(False)
            res["eval:ins_num"] = np.float64(eout["ins_num"])
            res["eval:same"] = np.array(
                np.array_equal(tr.trained_table(), res[f"{feed}:trained"])
                and all(np.array_equal(v.numpy(), res[f"{feed}:p:{k}"]) for k, v in tr.params.items())
                and all(torch.equal(a, b) for a, b in zip(opt_before, (tr.opt_state.count, *tr.opt_state.mu.values())))
            )
        ds.end_pass(tr.trained_table())
        keys = np.sort(table.keys())
        res[f"{feed}:keys"] = keys
        res[f"{feed}:rows"] = table.pull_or_create(keys)
    _set_flags(config, FEEDS["resident"])
    for mode in ("kstep", "zero"):
        tr, ds, _, out = _port_pass(plan, files, mode)
        res[f"{mode}:loss"] = np.float64(out["loss"])
        for k, v in tr.params.items():
            res[f"{mode}:p:{k}"] = v.numpy()
        tr.save_dense(os.path.join(d, f"{mode}-rank{plan.rank}.npz"))
        ds.end_pass(tr.trained_table())
    # three prefetch threads pack at a bucket that lets K vary by batch
    _set_flags(config, dict(FEEDS["packer"], feed_pipeline_workers=3))
    tr, ds, _, out = _port_pass(plan, files, pack_bucket=THREADS_BUCKET)
    packer = tr._get_packer(ds)
    needs = []
    for idx in ds.batch_indices():
        b = len(idx) // plan.world
        _, bmax = block_pad_stats(packer._rows, ds.store.u64_base, ds.store.key_counts(),
                                  [idx[d * b : (d + 1) * b] for d in range(plan.world)],
                                  ds.ws.capacity, ds.ws.n_mesh_shards)
        needs.append(-(-(int(bmax.max()) + 1) // THREADS_BUCKET) * THREADS_BUCKET)
    res.update({"threads:K": np.int64(packer._K_pad), "threads:needs": np.array(needs),
                "threads:trained": tr.trained_table(), "threads:loss": np.float64(out["loss"]),
                "threads:last_feed": np.array(tr.last_feed)})
    for k, v in tr.params.items():
        res[f"threads:p:{k}"] = v.numpy()
    ds.end_pass(tr.trained_table())
    _set_flags(config, FEEDS["resident"])
    # one rank's file list differs: the digest check must stop every rank
    other = files if plan.rank == 0 else other_files
    try:
        _port_pass(plan, other)
        res["digest_error"] = np.array("")
    except RuntimeError as e:
        res["digest_error"] = np.array(str(e))
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_trainer")
    files, other = _write_files(str(d)), _write_files(str(d), seed=1)  # before the ranks read them
    spawn(rank_main, WORLD, f"file://{d}/rdv", backend="gloo", device="cpu", args=(str(d), files, other),
          threads=1, timeout_s=300)
    return files, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_pass(files, feed, mode="step", dense_path=None):
    """The JAX mesh trainer's pass on a feed in a dense sync mode:
    (trained table, params, out, the feed it took); with ``dense_path``
    its ``save_dense`` lands there."""
    import dataclasses
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.data import BoxPSDataset as JBoxPSDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    before = {k: jconfig.get_flag(k) for k in FEEDS[feed]}
    _set_flags(jconfig, FEEDS[feed])
    try:
        lay = JLayout(embedx_dim=D)
        table = JHostSparseTable(lay, JOpt(**SPARSE), n_shards=4, seed=0)
        ds = JBoxPSDataset(_schema(JSlotInfo, JSlotSchema), table, batch_size=B, shuffle_mode="local", seed=5,
                           n_mesh_shards=WORLD)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        plan = make_mesh(WORLD)
        cfg = JCfg(num_slots=S, batch_size=B // WORLD, layout=lay, sparse_opt=JOpt(**SPARSE), auc_buckets=1000,
                   axis_name="dp")
        if mode == "kstep":
            cfg = dataclasses.replace(cfg, dense_sync_mode="kstep", param_sync_step=KSTEP)
        opt = JZero(optax.adam(LR), axis_name="dp", n_dev=WORLD) if mode == "zero" else optax.adam(LR)
        tr = JCTRTrainer(JTower(), cfg, dense_opt=opt, plan=plan)
        tr.init_params(jax.random.PRNGKey(0))
        tr.prepare_pass(ds)
        out = tr.train_pass(ds)
        took = "resident" if getattr(tr, "_resident_cache", None) else "packer" if getattr(tr, "_packer_cache", None) else "slow"
        trained = np.asarray(tr.trained_table())
        params = jax.tree.map(np.asarray, tr.params)
        if dense_path is not None:
            tr.save_dense(dense_path)
        ds.end_pass(trained)
        return trained, params, out, took
    finally:
        _set_flags(jconfig, before)


@pytest.mark.parametrize("feed", list(FEEDS))
def test_mesh_trainer_matches_jax(ranks, feed):
    from paddlebox_tpu_torch.models import params_from_jax

    files, res = ranks
    trained, params, out, took = _jax_pass(files, feed)
    for r in res:
        assert str(r[f"{feed}:last_feed"]) == took == feed
        np.testing.assert_allclose(r[f"{feed}:trained"], trained, rtol=TABLE_RTOL, atol=TABLE_ATOL)
        np.testing.assert_allclose(float(r[f"{feed}:loss"]), out["loss"], rtol=LOSS_RTOL)
        assert float(r[f"{feed}:ins_num"]) == out["ins_num"] == 2 * N_REC
        for k, v in params_from_jax(params).items():
            np.testing.assert_allclose(r[f"{feed}:p:{k}"], v.numpy(), atol=PARAMS_ATOL, err_msg=k)


def test_mesh_feeds_bitwise_and_ranks_agree(ranks):
    _, res = ranks
    for r in res:
        for feed in ("packer", "slow"):
            for key in ("trained", "loss", "keys", "rows") + tuple(k.split(":", 1)[1] for k in r if k.startswith("resident:p:")):
                np.testing.assert_array_equal(r[f"{feed}:{key}"], r[f"resident:{key}"], err_msg=f"{feed}:{key}")
    for feed in FEEDS:  # every rank's host table the same after end_pass
        np.testing.assert_array_equal(res[0][f"{feed}:keys"], res[1][f"{feed}:keys"])
        np.testing.assert_array_equal(res[0][f"{feed}:rows"], res[1][f"{feed}:rows"])


def test_mesh_packer_threads_freeze_k(ranks):
    """The packer feed's K is frozen before its prefetch threads start: at
    the largest need of the pass's batches, the same on both ranks, while
    the batches' own needs differ; the pass is bitwise the resident's."""
    _, res = ranks
    for r in res:
        needs = r["threads:needs"]
        assert len(set(needs.tolist())) > 1, needs
        assert int(r["threads:K"]) == needs.max() == int(res[0]["threads:K"])
        assert str(r["threads:last_feed"]) == "packer"
        for key in ("trained", "loss") + tuple(k.split(":", 1)[1] for k in r if k.startswith("resident:p:")):
            np.testing.assert_array_equal(r[f"threads:{key}"], r[f"resident:{key}"], err_msg=key)


def test_replica_digest_raises_when_a_rank_loads_other_files(ranks):
    _, res = ranks
    for r in res:
        assert "replica digest mismatch" in str(r["digest_error"])


def test_mesh_refusals(tmp_path):
    """What the mesh still refuses, on a plan that never runs a
    collective: ``use_expand`` on a layout without an expand block, async
    dense without a table on rank 0, async with ZeRO-1, ZeRO-1 without a
    plan and a rank's table shard at end_pass on a dataset no mesh trainer
    bound are ``ValueError``s. Async dense, a rank-offset model, a metric
    registry and ``use_expand`` on an expand layout are taken."""
    import dataclasses

    from paddlebox_tpu_torch.fleet import Zero1Optimizer
    from paddlebox_tpu_torch.metrics import MetricRegistry
    from paddlebox_tpu_torch.parallel import MeshPlan
    from paddlebox_tpu_torch.train import AsyncDenseTable

    plan = MeshPlan(rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    plan1 = MeshPlan(rank=1, world=2, device=torch.device("cpu"), backend="gloo")
    lay = ValueLayout(embedx_dim=D)
    cfg = TrainStepConfig(num_slots=S, batch_size=B // 2, layout=lay, auc_buckets=1000)
    with pytest.raises(ValueError, match="expand block"):
        CTRTrainer(Tower(), dataclasses.replace(cfg, use_expand=True), plan=plan)
    CTRTrainer(Tower(), dataclasses.replace(cfg, use_expand=True, layout=ValueLayout(embedx_dim=D, expand_embed_dim=2)),
               plan=plan)
    acfg = dataclasses.replace(cfg, dense_sync_mode="async")
    with pytest.raises(ValueError, match="AsyncDenseTable"):
        CTRTrainer(Tower(), acfg, plan=plan)
    CTRTrainer(Tower(), acfg, plan=plan1)  # only rank 0 holds the table
    adt = AsyncDenseTable(Tower().state_dict(), base_lr=1e-3)
    CTRTrainer(Tower(), acfg, async_dense=adt, plan=plan)
    with pytest.raises(ValueError, match="ZeRO"):
        CTRTrainer(Tower(), acfg, dense_opt=Zero1Optimizer(Adam(LR), n_dev=2), async_dense=adt, plan=plan)
    adt.finalize()
    CTRTrainer(Tower(), dataclasses.replace(cfg, model_takes_rank_offset=True), plan=plan)
    CTRTrainer(Tower(), cfg, plan=plan, metric_registry=MetricRegistry(device="cpu"))
    with pytest.raises(ValueError, match="mesh plan"):
        CTRTrainer(Tower(), cfg, dense_opt=Zero1Optimizer(Adam(LR), n_dev=2), device="cpu")

    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, read_threads=1, n_mesh_shards=2)
    ds.set_filelist(_write_files(str(tmp_path), n_files=1))
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    shard = torch.zeros((ds.ws.capacity, lay.width))
    with pytest.raises(ValueError, match="bound to the mesh plan"):
        ds.end_pass(shard)


def test_mesh_eval_pass_leaves_state_bitwise(ranks):
    _, res = ranks
    for r in res:
        assert bool(r["eval:same"])
        assert float(r["eval:ins_num"]) == 2 * N_REC


@pytest.mark.parametrize("mode", ["kstep", "zero"])
def test_mesh_trainer_dense_modes_match_jax(ranks, mode, tmp_path):
    """kstep (the pass-end sync, rank 0's moments kept) and ZeRO-1 (the
    chunk states gathered into the stacked state) through a pass on the
    resident feed: params within the step bounds of the JAX trainer's,
    alike on both ranks, and ``save_dense`` holding the JAX file's leaves
    (ZeRO: params, the stacked count and moments) within the bounds."""
    from paddlebox_tpu_torch.models import params_from_jax

    files, res = ranks
    d = os.path.dirname(files[0])
    jpath = str(tmp_path / "jax.npz")
    _, params, out, _ = _jax_pass(files, "resident", mode, dense_path=jpath)
    want = params_from_jax(params)
    for r in res:
        np.testing.assert_allclose(float(r[f"{mode}:loss"]), out["loss"], rtol=LOSS_RTOL)
        for k, v in want.items():
            np.testing.assert_allclose(r[f"{mode}:p:{k}"], v.numpy(), atol=PARAMS_ATOL, err_msg=k)
            np.testing.assert_array_equal(r[f"{mode}:p:{k}"], res[0][f"{mode}:p:{k}"])
    with np.load(jpath) as jf:
        jleaves = [jf[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in jf.files))]
    n_params = len(want)
    for rank in range(WORLD):
        with np.load(os.path.join(d, f"{mode}-rank{rank}.npz")) as f:
            leaves = [f[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in f.files))]
        assert [a.shape for a in leaves] == [a.shape for a in jleaves]
        for i, (a, b) in enumerate(zip(leaves, jleaves)):
            if i < n_params:
                np.testing.assert_allclose(a, b, atol=PARAMS_ATOL)
            elif a.dtype.kind == "i":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=MOMENT_RTOL, atol=MOMENT_ATOL)

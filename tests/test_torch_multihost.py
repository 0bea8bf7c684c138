"""Training over several hosts: ``BoxPSDataset(transport=...)`` and
``CTRTrainer(plan=...)`` in host processes of their own, against the JAX
package's single-process pass and the port's single-host mesh.

The counterparts of ``tests/test_multihost.py``'s modes, at its sizes (4
slots, embedx 4, global batch 64). The port runs one process a card, so a
host is one rank: a cluster is spawned once a module (gloo on the CPU, a
``file://`` rendezvous, one thread a rank), and every rank opens its own
``TcpTransport`` on a free localhost port, its node of the host plane, and
closes it in a ``finally``. Each rank loads only its stripe of the files
into its own ``HostSparseTable``; its pass working set is a
``DistributedWorkingSet`` and its host table ends holding its own keys.
The line sampler stays at rate 1 (its per-process hash would read other
lines in each process).

The reference for a pass is the JAX trainer on one process over the
suite's virtual CPU devices, ``CTRTrainer(plan=make_mesh(n))``, over all
the files with the global batches composed as the hosts compose them (the
hosts' blocks in rank order, ``tests/test_multihost.py:122-206``: the
record order is set on the dataset). The tower is
``test_torch_mesh_step.py``'s fp32 one (the zoo's bf16 towers part XLA and
torch by up to lr a step).

The ins_id shuffle pass and the join/update day are held against the
same JAX trainer fed each host's routed records in its batch order (the
join phase: the hosts' pv plans side by side, by search id and rank).

Bounds (``tests/test_multihost.py``'s ``_check_train_matches_reference``):
the pass layout (capacity, every referenced key's global row) and the
batch counts exact; the trained table assembled from the hosts' blocks at
rtol 2e-3 atol 1e-4; the hosts' keys disjoint and their union exact, the
values at rtol 2e-3 atol 1e-4; the AUC within 5e-3 of the reference and
the same on every host. Carried against classic: losses rtol 1e-6, host
tables rtol 1e-5 (``test_multihost.py``'s). A two-host pass against the
port's single-host replicated mesh (the same ranks, no transport, the same
global batches): bitwise.
"""

import os
import socket

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.fleet.launch import spawn
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils.fs import fs_open_write
from test_torch_mesh_step import LAY, JTower, Tower, tower_params

torch.set_num_threads(2)

NS, D = 4, 4
GLOBAL_BATCH = 64
LR = 1e-3
SPARSE = dict(embed_lr=0.2, embedx_lr=0.2, embedx_threshold=0.0, initial_range=0.01)
# decay on, shrink off: carried == classic holds bitwise only at shrink 0
DECAY = dict(SPARSE, show_clk_decay=0.95, shrink_threshold=0.0)
TABLE_RTOL, TABLE_ATOL, AUC_TOL = 2e-3, 1e-4, 5e-3
PARAMS_ATOL, MOMENT_RTOL, MOMENT_ATOL = 2e-4, 5e-2, 1e-6
ROUND_TO = 32
MAX_RANK = 3
IN_DIM = NS * LAY.pull_width
FEED_FLAGS = {"resident": dict(enable_resident_feed=1), "packer": dict(enable_resident_feed=0)}


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _line(keys, label, pre=""):
    return pre + f"1 {label}.0 " + " ".join(f"1 {k}" for k in keys) + "\n"


def write_files(d, sizes, with_ins_id=False, prefix="part"):
    """``tests/test_multihost.py``'s flat files: one line a record, NS
    one-key slots, an optional ins_id column."""
    rng = np.random.default_rng(7)
    files, rec_id = [], 0
    for fi, n in enumerate(sizes):
        path = os.path.join(d, f"{prefix}-{fi}.txt")
        with fs_open_write(path) as f:
            for _ in range(n):
                keys = rng.integers(1, 500, NS)
                f.write(_line(keys, int(keys[0]) % 2, f"1 ins{rec_id:05d} " if with_ins_id else ""))
                rec_id += 1
        files.append(path)
    return files


def write_overlapping_pass_files(d, n_passes, files_per_pass, n=48):
    """Per-pass file groups whose key ranges overlap pass to pass (the CTR
    stream the carried boundary uses)."""
    rng = np.random.default_rng(23)
    files = []
    for p in range(n_passes):
        lo, hi = 1 + 80 * p, 400 + 80 * p
        for fi in range(files_per_pass):
            path = os.path.join(d, f"pass{p}-part{fi}.txt")
            with fs_open_write(path) as f:
                for _ in range(n):
                    keys = rng.integers(lo, hi, NS)
                    f.write(_line(keys, int(keys[0]) % 2))
            files.append(path)
    return files


def write_pv_files(d, n_even_queries, n_odd_queries, n_files=2, seed=11):
    """Logkey'd pv files whose search ids split unevenly by parity: after
    the search_id shuffle rank 0 owns about ``n_even_queries`` pvs and
    rank 1 ``n_odd_queries``, so the join batch counts differ by host."""
    rng = np.random.default_rng(seed)
    sids = [2 * (i + 1) for i in range(n_even_queries)] + [2 * (i + 1) + 1 for i in range(n_odd_queries)]
    rng.shuffle(sids)
    files = [os.path.join(d, f"pv-{i}.txt") for i in range(n_files)]
    lines = [[] for _ in files]
    for qi, sid in enumerate(sids):
        for rank in range(1, int(rng.integers(1, 4)) + 1):
            keys = rng.integers(1, 500, NS)
            cmatch = 222 if rng.random() < 0.8 else 999
            logkey = "0" * 11 + f"{cmatch:03x}" + f"{rank:02x}" + f"{sid:016x}"
            lines[qi % n_files].append(_line(keys, int(keys[0]) % 2, f"1 {logkey} "))
    for path, body in zip(files, lines):
        with fs_open_write(path) as f:
            f.write("".join(body))
    return files, sum(len(b) for b in lines)


def schema(info_cls, schema_cls, **kw):
    return schema_cls([info_cls("label", type="float", dense=True, dim=1)] + [info_cls(f"s{i}") for i in range(NS)],
                      label_slot="label", **kw)


def compose_order(files, n_ranks, local_batch, counts):
    """The store order of a dataset over all ``files`` (loaded in file
    order) whose batch i is the hosts' batch i in rank order: host r reads
    ``files[r::n_ranks]``."""
    off = np.concatenate([[0], np.cumsum(counts)])
    stripes = [
        np.concatenate([np.arange(off[f], off[f + 1]) for f in range(r, len(files), n_ranks)])
        for r in range(n_ranks)
    ]
    n_batches = min(len(s) for s in stripes) // local_batch
    blocks = [s[i * local_batch : (i + 1) * local_batch] for i in range(n_batches) for s in stripes]
    return np.concatenate(blocks).astype(np.int64), n_batches


# ---- the port's ranks ------------------------------------------------------


def _transport(plan, ports):
    from paddlebox_tpu_torch.parallel.transport import TcpTransport

    return TcpTransport(plan.rank, [f"127.0.0.1:{p}" for p in ports], timeout=120.0)


def _host_ds(plan, tp, router, table, local_batch, shuffle_mode="none", **schema_kw):
    return BoxPSDataset(schema(SlotInfo, SlotSchema, **schema_kw), table, batch_size=local_batch,
                        n_mesh_shards=plan.world, rank=plan.rank, nranks=plan.world, shuffle_mode=shuffle_mode,
                        router=router, transport=tp, seed=0, read_threads=2)


def _trainer(plan, local_batch, sparse, dense_opt=None, model=None, **cfg_kw):
    cfg = TrainStepConfig(num_slots=NS, batch_size=local_batch, layout=LAY, sparse_opt=SparseOptimizerConfig(**sparse),
                          auc_buckets=1000, **cfg_kw)
    tr = CTRTrainer(model if model is not None else Tower(), cfg, dense_opt=dense_opt or Adam(LR), plan=plan)
    tr.init_params()
    return tr


def _host_rows(table):
    table.drain_pending()
    keys = np.sort(table.keys())
    return keys, table.pull_or_create(keys)


def _train_mode(plan, tp, res, files, local_batch, feed, prefix):
    """One striped pass on a feed: the layout, the trained block, the host
    table after end_pass and the metrics."""
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter

    config.set_flag("enable_resident_feed", FEED_FLAGS[feed]["enable_resident_feed"])
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = _host_ds(plan, tp, TcpShuffleRouter(tp), table, local_batch)
    ds.set_filelist(files)
    ds.set_date("20260101")
    ds.load_into_memory()
    nb = ds.num_batches()
    ds.begin_pass(round_to=ROUND_TO)
    tr = _trainer(plan, local_batch, SPARSE)
    tr.prepare_pass(ds)
    out = tr.train_pass(ds)
    res.update({
        f"{prefix}:sorted_keys": ds.ws.sorted_keys, f"{prefix}:rows": ds.ws.row_of_sorted,
        f"{prefix}:capacity": np.int64(ds.ws.capacity), f"{prefix}:num_batches": np.int64(nb),
        f"{prefix}:batches": np.float64(out["batches"]), f"{prefix}:auc": np.float64(out["auc"]),
        f"{prefix}:loss": np.float64(out["loss"]), f"{prefix}:last_feed": np.array(tr.last_feed),
        f"{prefix}:local_table": tr.trained_table(), f"{prefix}:exchange_s": np.float64(ds.ws.exchange_s),
    })
    for k, v in tr.params.items():
        res[f"{prefix}:p:{k}"] = v.numpy()
    ds.end_pass(tr.trained_table(), shrink=False)
    res[f"{prefix}:host_keys"], res[f"{prefix}:host_vals"] = _host_rows(table)


def _replicated_mode(plan, res, files, local_batch, counts):
    """The same global batches on the port's single-host replicated mesh
    (every rank loads every file, no transport)."""
    config.set_flag("enable_resident_feed", 1)
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(schema(SlotInfo, SlotSchema), table, batch_size=local_batch * plan.world,
                      n_mesh_shards=plan.world, read_threads=2)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=ROUND_TO)
    ds._order, _ = compose_order(files, plan.world, local_batch, counts)
    tr = _trainer(plan, local_batch, SPARSE)
    out = tr.train_pass(ds)
    res["repl:trained"] = tr.trained_table()
    res["repl:loss"] = np.float64(out["loss"])
    res["repl:auc"] = np.float64(out["auc"])
    for k, v in tr.params.items():
        res[f"repl:p:{k}"] = v.numpy()
    ds.end_pass(None)


def _shuffle_mode(plan, tp, res, files):
    """ins_id global shuffle over TcpShuffleRouter with unequal stripes:
    the record multiset, the routing and the wrapped lockstep pass."""
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter

    config.set_flag("enable_resident_feed", 1)
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = _host_ds(plan, tp, TcpShuffleRouter(tp), table, 16, shuffle_mode="ins_id", parse_ins_id=True)
    ds.set_filelist(files)
    ds.set_date("20260101")
    ds.load_into_memory()
    n_local = ds.memory_data_size()
    nb = ds.num_batches()
    ds.begin_pass(round_to=ROUND_TO)
    tr = _trainer(plan, 16, SPARSE)
    out = tr.train_pass(ds)
    res.update({
        "shuffle:ins_ids": np.array(sorted(ds.store.ins_id(i) for i in range(len(ds.store)))),
        # the records in this host's batch order (its batches wrap around it)
        "shuffle:order": np.array([ds.store.ins_id(int(j)) for j in ds._order]),
        "shuffle:n_records": np.int64(n_local), "shuffle:num_batches": np.int64(nb),
        "shuffle:batches": np.float64(out["batches"]), "shuffle:loss": np.float64(out["loss"]),
        "shuffle:auc": np.float64(out["auc"]), "shuffle:last_feed": np.array(tr.last_feed),
        "shuffle:local_table": tr.trained_table(), "shuffle:capacity": np.int64(ds.ws.capacity),
        "shuffle:sorted_keys": ds.ws.sorted_keys, "shuffle:rows": ds.ws.row_of_sorted,
    })
    ds.end_pass(tr.trained_table(), shrink=False)
    res["shuffle:host_keys"], res["shuffle:host_vals"] = _host_rows(table)


def _zero_mode(plan, tp, d, res, files, local_batch):
    """ZeRO-1 over two passes: each host updates its chunk of the moments,
    the chunked state carried across passes; the dense file at the end."""
    from paddlebox_tpu_torch.fleet import Zero1Optimizer
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter

    config.set_flag("enable_resident_feed", 1)
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = _host_ds(plan, tp, TcpShuffleRouter(tp), table, local_batch)
    ds.set_filelist(files)
    tr = _trainer(plan, local_batch, SPARSE, dense_opt=Zero1Optimizer(Adam(LR), n_dev=plan.world))
    for p in range(2):
        ds.set_date(f"2026010{p + 1}")
        ds.load_into_memory()
        ds.begin_pass(round_to=ROUND_TO)
        out = tr.train_pass(ds)
        if p == 1:
            res["zero:local_table"] = tr.trained_table()
        ds.end_pass(tr.trained_table(), shrink=False)
    res["zero:loss"], res["zero:auc"] = np.float64(out["loss"]), np.float64(out["auc"])
    for k, v in tr.params.items():
        res[f"zero:p:{k}"] = v.numpy()
    tr.save_dense(os.path.join(d, f"zero-rank{plan.rank}.npz"))
    res["zero:host_keys"], res["zero:host_vals"] = _host_rows(table)


def _carried_mode(plan, tp, res, files, files_per_pass, carried, local_batch):
    """A day of passes over overlapping files, each boundary handing
    end_pass the live device block: carried (a MultiHostCarrier splice) or
    classic (full writeback), by the flag alone."""
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter

    prefix = "car" if carried else "cls"
    config.set_flag("enable_resident_feed", 1)
    config.set_flag("enable_carried_table", int(carried))
    table = HostSparseTable(LAY, SparseOptimizerConfig(**DECAY), n_shards=4, seed=0)
    ds = _host_ds(plan, tp, TcpShuffleRouter(tp), table, local_batch)
    tr = _trainer(plan, local_batch, DECAY)
    losses, aucs, splice = [], [], {"common": 0, "new": 0, "departed": 0}
    spliced = 0
    for p in range(len(files) // files_per_pass):
        ds.set_filelist(files[p * files_per_pass : (p + 1) * files_per_pass])
        ds.set_date(f"202601{p + 1:02d}")
        ds.load_into_memory()
        ds.begin_pass(round_to=ROUND_TO)
        bs = getattr(ds.ws, "boundary_stats", None)
        if bs is not None:
            spliced += 1
            for k in splice:
                splice[k] += bs[k]
        out = tr.train_pass(ds)
        losses.append(out["loss"])
        aucs.append(out["auc"])
        ds.end_pass(tr.trained_table_device())
    config.set_flag("enable_carried_table", 1)
    res[f"{prefix}:losses"], res[f"{prefix}:aucs"] = np.array(losses), np.array(aucs)
    res[f"{prefix}:spliced_passes"] = np.int64(spliced)
    for k, v in splice.items():
        res[f"{prefix}:splice_{k}"] = np.int64(v)
    res[f"{prefix}:host_keys"], res[f"{prefix}:host_vals"] = _host_rows(table)


def rank_model():
    from paddlebox_tpu_torch.models import RankDeepFM

    rng = np.random.default_rng(7)
    model = RankDeepFM(Tower(), IN_DIM, max_rank=MAX_RANK, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.rank_param.copy_(torch.from_numpy(
            (0.05 * rng.normal(size=(MAX_RANK * MAX_RANK * IN_DIM, 1))).astype(np.float32)))
    return model


def _pv_mode(plan, tp, res, files, local_batch, feed):
    """The join then update day: search_id shuffle (a query's ads on its
    owner host), pv batch counts and pads locksteped (ghost batches on the
    short host), then the update phase on the join-trained table."""
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter

    prefix = f"pv_{feed}"
    config.set_flag("enable_resident_feed", FEED_FLAGS[feed]["enable_resident_feed"])
    table = HostSparseTable(LAY, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = _host_ds(plan, tp, TcpShuffleRouter(tp), table, local_batch, shuffle_mode="search_id", parse_logkey=True)
    ds.set_filelist(files)
    ds.set_date("20260101")
    ds.load_into_memory()
    ds.begin_pass(round_to=ROUND_TO)
    ds.set_current_phase(1)
    n_pvs = ds.preprocess_instance(max_rank=MAX_RANK)
    local_pv_batches = ds.num_pv_batches(n_devices=1)
    model = rank_model()
    join_tr = _trainer(plan, local_batch, SPARSE, model=model, model_takes_rank_offset=True)
    out_j = join_tr.train_pass(ds)
    res[f"{prefix}:join_feed"] = np.array(join_tr.last_feed)
    # the join plan this host trained (its lockstep count cached), by
    # (search id, rank): a record's identity in every package's store
    pvp = join_tr._pv_locked_plan(ds)
    st = ds.store
    res.update({f"{prefix}:plan_sid": st.search_ids[pvp.idx], f"{prefix}:plan_rank": st.rank[pvp.idx],
                f"{prefix}:plan_ro": pvp.rank_offset, f"{prefix}:plan_w": pvp.ins_weight})
    join_tr.handoff_table(ds)
    ds.set_current_phase(0)
    ds.postprocess_instance()
    res[f"{prefix}:upd_sid"], res[f"{prefix}:upd_rank"] = st.search_ids[ds._order], st.rank[ds._order]
    upd_tr = _trainer(plan, local_batch, SPARSE, model=model)
    upd_tr.params = {k: v.clone() for k, v in join_tr.params.items()}
    upd_tr.opt_state = upd_tr.dense_opt.init(upd_tr.params)
    out_u = upd_tr.train_pass(ds)
    res.update({
        f"{prefix}:n_pvs": np.int64(n_pvs), f"{prefix}:local_pv_batches": np.int64(local_pv_batches),
        f"{prefix}:join_batches": np.float64(out_j["batches"]), f"{prefix}:join_loss": np.float64(out_j["loss"]),
        f"{prefix}:join_auc": np.float64(out_j["auc"]), f"{prefix}:join_ins": np.float64(out_j["ins_num"]),
        f"{prefix}:upd_batches": np.float64(out_u["batches"]), f"{prefix}:upd_loss": np.float64(out_u["loss"]),
        f"{prefix}:upd_feed": np.array(upd_tr.last_feed),
    })
    res[f"{prefix}:upd_trained"] = upd_tr.trained_table()
    ds.end_pass(upd_tr.trained_table(), shrink=False)
    res[f"{prefix}:host_keys"], res[f"{prefix}:host_vals"] = _host_rows(table)


def rank_main2(plan, d: str, ports, inputs) -> None:
    tp = _transport(plan, ports)
    res = {}
    try:
        config.set_flag("sample_rate", 1.0)
        for feed in FEED_FLAGS:
            _train_mode(plan, tp, res, inputs["train"], GLOBAL_BATCH // 2, feed, f"train_{feed}")
        _replicated_mode(plan, res, inputs["train"], GLOBAL_BATCH // 2, inputs["train_counts"])
        _shuffle_mode(plan, tp, res, inputs["shuffle"])
        _zero_mode(plan, tp, d, res, inputs["zero"], GLOBAL_BATCH // 2)
        for carried in (True, False):
            _carried_mode(plan, tp, res, inputs["carried"], 2, carried, GLOBAL_BATCH // 2)
        for feed in FEED_FLAGS:
            _pv_mode(plan, tp, res, inputs["pv"], GLOBAL_BATCH // 2, feed)
        config.set_flag("enable_resident_feed", 1)
        res["tp:bytes_sent"] = np.int64(_stat("wire.host_bytes_sent"))
    finally:
        tp.close()
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


def rank_main4(plan, d: str, ports, inputs) -> None:
    tp = _transport(plan, ports)
    res = {}
    try:
        config.set_flag("sample_rate", 1.0)
        _train_mode(plan, tp, res, inputs["train"], 16, "resident", "train_resident")
        for carried in (True, False):
            _carried_mode(plan, tp, res, inputs["carried"], 4, carried, 16)
        config.set_flag("enable_resident_feed", 1)
    finally:
        tp.close()
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


def _stat(name):
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    return STAT_GET(name)


def _run(main, world, d, inputs):
    ports = _free_ports(world)
    spawn(main, world, f"file://{d}/rdv", backend="gloo", device="cpu", args=(str(d), ports, inputs),
          threads=1, timeout_s=300)
    return [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost2")
    (d / "pv").mkdir()
    (d / "car").mkdir()
    (d / "shuf").mkdir()
    (d / "zero").mkdir()
    inputs = {  # written before the ranks read them
        "train": write_files(str(d), [64, 64, 64, 64]),
        "train_counts": [64, 64, 64, 64],
        "shuffle": write_files(str(d / "shuf"), [96, 32], with_ins_id=True),
        "zero": write_files(str(d / "zero"), [64, 64]),
        "carried": write_overlapping_pass_files(str(d / "car"), n_passes=3, files_per_pass=2),
    }
    inputs["pv"], inputs["pv_total"] = write_pv_files(str(d / "pv"), n_even_queries=30, n_odd_queries=8)
    return inputs, str(d), _run(rank_main2, 2, d, inputs)


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost4")
    (d / "car").mkdir()
    inputs = {
        "train": write_files(str(d), [32] * 8),
        "carried": write_overlapping_pass_files(str(d / "car"), n_passes=2, files_per_pass=4),
    }
    return inputs, str(d), _run(rank_main4, 4, d, inputs)


# ---- the JAX package's single-process reference ----------------------------


def jax_reference(pass_files, n_ranks, local_batch, sparse=SPARSE, zero=False, counts_of=None, dense_path=None,
                  shrink=False, order_of=None, **schema_kw):
    """The JAX trainer on one process over an n-device mesh, one pass a
    file group, each pass's global batches composed as the hosts compose
    them (``order_of(dataset) -> (order, n_batches)`` where the hosts
    routed their records), classic end_pass (writeback; decay and shrink
    with ``shrink``, as the hosts' end_pass does). Returns the last pass's
    working set, trained table and AUC, every pass's loss, the params and
    the host table."""
    import jax
    import optax

    from paddlebox_tpu import config as jconfig
    from paddlebox_tpu.data import BoxPSDataset as JDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.fleet.zero import Zero1Optimizer as JZero
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.table import HostSparseTable as JTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import CTRTrainer as JTrainer
    from paddlebox_tpu.train import TrainStepConfig as JCfg

    prev = jconfig.get_flag("enable_resident_feed")
    jconfig.set_flag("enable_resident_feed", 1)
    try:
        lay = JLayout(embedx_dim=D)
        table = JTable(lay, JOpt(**sparse), n_shards=4, seed=0)
        plan = make_mesh(n_ranks)
        cfg = JCfg(num_slots=NS, batch_size=local_batch, layout=lay, sparse_opt=JOpt(**sparse), auc_buckets=1000,
                   axis_name=plan.axis)
        opt = JZero(optax.adam(LR), axis_name=plan.axis, n_dev=n_ranks) if zero else optax.adam(LR)
        tr = JTrainer(JTower(), cfg, dense_opt=opt, plan=plan)
        tr.init_params(jax.random.PRNGKey(0))
        losses, aucs = [], []
        for files in pass_files:
            ds = JDataset(schema(JSlotInfo, JSlotSchema, **schema_kw), table, batch_size=local_batch * n_ranks,
                          n_mesh_shards=n_ranks)
            ds.set_filelist(files)
            ds.load_into_memory()
            ds.begin_pass(round_to=ROUND_TO)
            if order_of is not None:
                ds._order, nb = order_of(ds)
            else:
                ds._order, nb = compose_order(files, n_ranks, local_batch, counts_of(files))
            out = tr.train_pass(ds, n_batches=nb)
            losses.append(out["loss"])
            aucs.append(out["auc"])
            ws = ds.ws
            trained = np.asarray(tr.trained_table())
            ds.end_pass(trained, shrink=shrink)
        if dense_path is not None:
            tr.save_dense(dense_path)
        keys = np.sort(table.keys())
        return dict(ws=ws, trained=trained, auc=aucs[-1], aucs=np.array(aucs), losses=np.array(losses),
                    params=jax.tree.map(np.asarray, tr.params), host_keys=keys, host_vals=table.pull_or_create(keys))
    finally:
        jconfig.set_flag("enable_resident_feed", prev)


def _line_counts(files):
    return [sum(1 for _ in open(f)) for f in files]


def check_train_matches_reference(dumps, ref, prefix, num_batches):
    """``tests/test_multihost.py``'s ``_check_train_matches_reference``."""
    for d in dumps:
        assert int(d[f"{prefix}:capacity"]) == ref["ws"].capacity
        np.testing.assert_array_equal(d[f"{prefix}:rows"], ref["ws"].lookup(d[f"{prefix}:sorted_keys"]).astype(np.int64))
        assert int(d[f"{prefix}:num_batches"]) == num_batches == float(d[f"{prefix}:batches"])
    merged = np.concatenate([d[f"{prefix}:local_table"] for d in dumps])
    assert merged.shape == ref["trained"].shape
    np.testing.assert_allclose(merged, ref["trained"], rtol=TABLE_RTOL, atol=TABLE_ATOL)
    check_host_tables(dumps, ref, prefix)
    assert abs(float(dumps[0][f"{prefix}:auc"]) - ref["auc"]) < AUC_TOL
    for d in dumps[1:]:
        assert abs(float(dumps[0][f"{prefix}:auc"]) - float(d[f"{prefix}:auc"])) < 1e-9


def check_host_tables(dumps, ref, prefix):
    for a in range(len(dumps)):
        for b in range(a + 1, len(dumps)):
            assert len(np.intersect1d(dumps[a][f"{prefix}:host_keys"], dumps[b][f"{prefix}:host_keys"])) == 0
    keys = np.concatenate([d[f"{prefix}:host_keys"] for d in dumps])
    vals = np.concatenate([d[f"{prefix}:host_vals"] for d in dumps])
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], ref["host_keys"])
    np.testing.assert_allclose(vals[order], ref["host_vals"], rtol=TABLE_RTOL, atol=TABLE_ATOL)


def jax_pv_reference(files, dumps, local_batch):
    """The JAX trainer's join/update day on one process over a 2-device
    mesh, fed the hosts' batches: the join phase's plan is the hosts'
    plans side by side (their rank matrices are block-local), the update
    phase's order each host's flattened pvs, wrapped to the locksteped
    count. Returns the join and update outputs, the trained table and the
    host table."""
    import jax
    import optax

    from paddlebox_tpu.data import BoxPSDataset as JDataset
    from paddlebox_tpu.data import SlotInfo as JSlotInfo
    from paddlebox_tpu.data import SlotSchema as JSlotSchema
    from paddlebox_tpu.data.pv_instance import PvPlan as JPvPlan
    from paddlebox_tpu.models import RankDeepFM as JRankDeepFM
    from paddlebox_tpu.parallel import make_mesh
    from paddlebox_tpu.table import HostSparseTable as JTable
    from paddlebox_tpu.table import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.table import ValueLayout as JLayout
    from paddlebox_tpu.train import CTRTrainer as JTrainer
    from paddlebox_tpu.train import TrainStepConfig as JCfg
    from test_torch_mesh_join import jax_params

    p = "pv_resident"
    lay = JLayout(embedx_dim=D)
    table = JTable(lay, JOpt(**SPARSE), n_shards=4, seed=0)
    ds = JDataset(schema(JSlotInfo, JSlotSchema, parse_logkey=True), table, batch_size=2 * local_batch,
                  n_mesh_shards=2)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=ROUND_TO)
    where = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(ds.store.search_ids, ds.store.rank))}

    def index(sid, rk):
        return np.vectorize(lambda a, b: where[(int(a), int(b))])(sid, rk).astype(np.int64)

    ds.set_current_phase(1)
    ds.preprocess_instance(max_rank=MAX_RANK)
    plan = JPvPlan(idx=np.concatenate([index(d[f"{p}:plan_sid"], d[f"{p}:plan_rank"]) for d in dumps], axis=1),
                   rank_offset=np.concatenate([d[f"{p}:plan_ro"] for d in dumps], axis=1),
                   ins_weight=np.concatenate([d[f"{p}:plan_w"] for d in dumps], axis=1), n_devices=2)
    ds.pv_plan = lambda n_devices=1, min_batches=0: plan
    mesh = make_mesh(2)
    cfg = dict(num_slots=NS, batch_size=local_batch, layout=lay, sparse_opt=JOpt(**SPARSE), auc_buckets=1000,
               axis_name=mesh.axis)
    model = JRankDeepFM(JTower(), IN_DIM, max_rank=MAX_RANK)
    tr = JTrainer(model, JCfg(**cfg, model_takes_rank_offset=True), dense_opt=optax.adam(LR), plan=mesh)
    tr.init_params(jax.random.PRNGKey(0))
    tr.params = jax.tree.map(jax.numpy.asarray, jax_params())
    tr.opt_state = optax.adam(LR).init(tr.params)
    jout = tr.train_pass(ds)
    tr.handoff_table(ds)
    ds.postprocess_instance()
    ds.set_current_phase(0)
    hosts = [index(d[f"{p}:upd_sid"], d[f"{p}:upd_rank"]) for d in dumps]
    nb = int(dumps[0][f"{p}:upd_batches"])
    b = local_batch
    ds._order = np.concatenate([h[np.arange(i * b, (i + 1) * b) % len(h)] for i in range(nb) for h in hosts])
    tr2 = JTrainer(model, JCfg(**cfg), dense_opt=optax.adam(LR), plan=mesh)
    tr2.params = tr.params
    tr2.opt_state = optax.adam(LR).init(tr.params)
    uout = tr2.train_pass(ds, n_batches=nb)
    trained = np.asarray(tr2.trained_table())
    ds.end_pass(trained, shrink=False)
    keys = np.sort(table.keys())
    return dict(join=jout, update=uout, trained=trained, host_keys=keys, host_vals=table.pull_or_create(keys))


_REFS = {}


def _ref(key, *args, **kw):
    if key not in _REFS:
        _REFS[key] = jax_reference(*args, **kw)
    return _REFS[key]


# ---- tests -----------------------------------------------------------------


@pytest.mark.parametrize("feed", list(FEED_FLAGS))
def test_two_hosts_match_single_process(cluster2, feed):
    """Two hosts, resident and host-packed, against the JAX package's pass
    on one process: layout, trained blocks, host tables, AUC."""
    inputs, _, dumps = cluster2
    for d in dumps:
        assert str(d[f"train_{feed}:last_feed"]) == feed
    ref = _ref("train2", [inputs["train"]], 2, GLOBAL_BATCH // 2, counts_of=_line_counts)
    check_train_matches_reference(dumps, ref, f"train_{feed}", num_batches=4)


def test_two_host_feeds_bitwise_and_match_replicated_mesh(cluster2):
    """The resident and packer feeds agree bitwise, and a two-host pass is
    bitwise the port's single-host replicated mesh on the same global
    batches: the same per-rank blocks, pads and collectives."""
    _, _, dumps = cluster2
    for r, d in enumerate(dumps):
        np.testing.assert_array_equal(d["train_packer:local_table"], d["train_resident:local_table"])
        np.testing.assert_array_equal(d["train_resident:local_table"][0], d["repl:trained"][r])
        assert float(d["train_resident:loss"]) == float(d["repl:loss"])
        assert float(d["train_resident:auc"]) == float(d["repl:auc"])
        for k in [k for k in d if k.startswith("repl:p:")]:
            np.testing.assert_array_equal(d[k], d["train_resident:p:" + k[len("repl:p:"):]])


def test_four_hosts_match_single_process(cluster4):
    """Rank-count generality: the key exchange, the resident feed's
    lockstep and striped batching at four hosts."""
    inputs, _, dumps = cluster4
    for d in dumps:
        assert str(d["train_resident:last_feed"]) == "resident"
    ref = _ref("train4", [inputs["train"]], 4, 16, counts_of=_line_counts)
    check_train_matches_reference(dumps, ref, "train_resident", num_batches=4)


def test_global_shuffle_and_lockstep_unequal_records(cluster2):
    """ins_id routing over TcpShuffleRouter: the record multiset kept, each
    record on the host the JAX package's hash names, the batch count
    all-reduced so the short host wraps around, and the pass against the
    JAX package's on one process fed the hosts' batches (layout, trained
    blocks, host tables, AUC within the bounds)."""
    from paddlebox_tpu.data.dataset import _ins_id_dest

    inputs, _, dumps = cluster2
    merged = np.sort(np.concatenate([d["shuffle:ins_ids"] for d in dumps]))
    assert len(merged) == 128 and len(np.unique(merged)) == 128
    assert merged[0] == "ins00000" and merged[-1] == "ins00127"
    for r, d in enumerate(dumps):
        assert all(_ins_id_dest(str(i), 2) == r for i in d["shuffle:ins_ids"])
    n0, n1 = int(dumps[0]["shuffle:n_records"]), int(dumps[1]["shuffle:n_records"])
    assert n0 + n1 == 128 and n1 > 32 and n0 != n1
    nb = max(n0 // 16, n1 // 16)
    for d in dumps:
        assert int(d["shuffle:num_batches"]) == nb == float(d["shuffle:batches"])
        assert np.isfinite(d["shuffle:loss"]) and 0.0 < float(d["shuffle:auc"]) <= 1.0
        assert str(d["shuffle:last_feed"]) == "resident"
    assert float(dumps[0]["shuffle:loss"]) == float(dumps[1]["shuffle:loss"])

    def order_of(ds):
        """The JAX dataset's order whose batch i is the hosts' batch i: each
        host's block wraps around its own routed records."""
        where = {ds.store.ins_id(i): i for i in range(len(ds.store))}
        hosts = [np.array([where[str(x)] for x in d["shuffle:order"]], np.int64) for d in dumps]
        b = 16
        blocks = [h[np.arange(i * b, (i + 1) * b) % len(h)] for i in range(nb) for h in hosts]
        return np.concatenate(blocks), nb

    ref = jax_reference([inputs["shuffle"]], 2, 16, order_of=order_of, parse_ins_id=True)
    check_train_matches_reference(dumps, ref, "shuffle", num_batches=nb)


def test_zero1_across_hosts_two_passes(cluster2, tmp_path):
    """ZeRO-1 over two hosts and two passes against the JAX package's
    ZeRO-1 on one process: the trained blocks, host tables and AUC within
    the bounds; params within the step bounds and alike on both hosts;
    each host's dense file holding the JAX file's leaves (the stacked
    count and moments)."""
    from paddlebox_tpu_torch.models import params_from_jax

    inputs, d, dumps = cluster2
    jpath = str(tmp_path / "jax_zero.npz")
    ref = jax_reference([inputs["zero"], inputs["zero"]], 2, GLOBAL_BATCH // 2, zero=True,
                        counts_of=_line_counts, dense_path=jpath)
    merged = np.concatenate([x["zero:local_table"] for x in dumps])
    np.testing.assert_allclose(merged, ref["trained"], rtol=TABLE_RTOL, atol=TABLE_ATOL)
    check_host_tables(dumps, ref, "zero")
    assert abs(float(dumps[0]["zero:auc"]) - ref["auc"]) < AUC_TOL
    assert float(dumps[0]["zero:loss"]) == float(dumps[1]["zero:loss"])
    for k, v in params_from_jax(ref["params"]).items():
        for x in dumps:
            np.testing.assert_allclose(x[f"zero:p:{k}"], v.numpy(), atol=PARAMS_ATOL, err_msg=k)
            np.testing.assert_array_equal(x[f"zero:p:{k}"], dumps[0][f"zero:p:{k}"])
    with np.load(jpath) as jf:
        jleaves = [jf[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in jf.files))]
    n_params = len(tower_params())
    for rank in range(2):
        with np.load(os.path.join(d, f"zero-rank{rank}.npz")) as f:
            leaves = [f[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in f.files))]
        assert [a.shape for a in leaves] == [a.shape for a in jleaves]
        for i, (a, b) in enumerate(zip(leaves, jleaves)):
            if i < n_params:
                np.testing.assert_allclose(a, b, atol=PARAMS_ATOL)
            elif a.dtype.kind == "i":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=MOMENT_RTOL, atol=MOMENT_ATOL)


def _check_carried(dumps, n_passes):
    for x in dumps:
        assert int(x["car:spliced_passes"]) == n_passes - 1
        assert int(x["car:splice_common"]) > 0
        assert int(x["cls:spliced_passes"]) == 0
        np.testing.assert_allclose(x["car:losses"], x["cls:losses"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(x["car:aucs"], x["cls:aucs"], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(x["car:host_keys"], x["cls:host_keys"])
        np.testing.assert_allclose(x["car:host_vals"], x["cls:host_vals"], rtol=1e-5, atol=1e-6)
    common = sum(int(x["car:splice_common"]) for x in dumps)
    moved = sum(int(x["car:splice_new"]) + int(x["car:splice_departed"]) for x in dumps)
    assert moved < 0.7 * (2 * common + moved)


@pytest.mark.parametrize("hosts", [2, 4])
def test_carried_boundary_matches_classic_and_reference(cluster2, cluster4, hosts):
    """The per-host carried boundary (a MultiHostCarrier splice) against
    the classic one over a day of overlapping passes: the same losses and
    host tables, only the key-set delta moved; the classic day's host
    tables and losses against the JAX package's on one process."""
    inputs, _, dumps = cluster2 if hosts == 2 else cluster4
    per = 2 if hosts == 2 else 4
    n_passes = len(inputs["carried"]) // per
    _check_carried(dumps, n_passes)
    groups = [inputs["carried"][p * per : (p + 1) * per] for p in range(n_passes)]
    ref = jax_reference(groups, hosts, GLOBAL_BATCH // hosts, sparse=DECAY, counts_of=_line_counts, shrink=True)
    check_host_tables(dumps, ref, "cls")
    for x in dumps:
        np.testing.assert_allclose(x["cls:losses"], ref["losses"], rtol=1e-3)
        np.testing.assert_allclose(x["cls:aucs"], ref["aucs"], atol=AUC_TOL)


def test_pv_join_update_day_lockstep(cluster2):
    """The join then update day over two hosts with unequal pv loads: the
    join batch count is the larger local need on both hosts (ghosts on the
    short one), every real ad is trained once globally, the resident and
    the packer join feeds agree, the update phase runs alike, and the day
    is the JAX package's on one process fed the hosts' batches (trained
    table and host tables within the bounds, losses rtol 1e-3, AUC 5e-3)."""
    inputs, _, dumps = cluster2
    total = inputs["pv_total"]
    for feed, join_feed, upd_feed in (("resident", "resident_pv", "resident"), ("packer", "pv_packer", "packer")):
        p = f"pv_{feed}"
        local = [int(x[f"{p}:local_pv_batches"]) for x in dumps]
        assert local[0] != local[1], "the data must give unequal pv loads"
        for x in dumps:
            assert str(x[f"{p}:join_feed"]) == join_feed and str(x[f"{p}:upd_feed"]) == upd_feed
            assert float(x[f"{p}:join_batches"]) == max(local)
            assert float(x[f"{p}:join_ins"]) == total
            assert float(x[f"{p}:upd_batches"]) > 0
            assert np.isfinite(x[f"{p}:join_loss"]) and np.isfinite(x[f"{p}:upd_loss"])
        assert float(dumps[0][f"{p}:upd_batches"]) == float(dumps[1][f"{p}:upd_batches"])
    for key, tol in (("join_loss", 1e-5), ("join_auc", 1e-6), ("upd_loss", 1e-5)):
        for x in dumps:
            assert abs(float(x[f"pv_resident:{key}"]) - float(x[f"pv_packer:{key}"])) < tol, key
    for x in dumps:
        np.testing.assert_array_equal(x["pv_resident:host_keys"], x["pv_packer:host_keys"])
        np.testing.assert_allclose(x["pv_resident:host_vals"], x["pv_packer:host_vals"], rtol=1e-5, atol=1e-6)
    # against the JAX package's join/update day on one process fed the
    # hosts' batches
    ref = jax_pv_reference(inputs["pv"], dumps, GLOBAL_BATCH // 2)
    merged = np.concatenate([x["pv_resident:upd_trained"] for x in dumps])
    np.testing.assert_allclose(merged, ref["trained"], rtol=TABLE_RTOL, atol=TABLE_ATOL)
    check_host_tables(dumps, ref, "pv_resident")
    assert ref["join"]["ins_num"] == total and ref["join"]["batches"] == float(dumps[0]["pv_resident:join_batches"])
    assert abs(float(dumps[0]["pv_resident:join_auc"]) - ref["join"]["auc"]) < AUC_TOL
    np.testing.assert_allclose(float(dumps[0]["pv_resident:join_loss"]), ref["join"]["loss"], rtol=1e-3)
    np.testing.assert_allclose(float(dumps[0]["pv_resident:upd_loss"]), ref["update"]["loss"], rtol=1e-3)


def test_host_plane_measured(cluster2):
    """The key exchange ran over the transport and was timed, and frames
    were sent."""
    _, _, dumps = cluster2
    for x in dumps:
        assert float(x["train_resident:exchange_s"]) > 0.0
        assert int(x["tp:bytes_sent"]) > 0


def test_role_carries_the_host_plane_endpoints():
    """``PADDLE_TRAINER_ENDPOINTS`` becomes the role's endpoints, one a
    rank, and ``host_transport`` builds this rank's node over them; a
    count or an entry that does not fit raises."""
    from paddlebox_tpu_torch.fleet import RoleMaker

    p0, p1 = _free_ports(2)
    env = {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
           "PADDLE_TRAINER_ENDPOINTS": f"127.0.0.1:{p0},127.0.0.1:{p1}"}
    role = RoleMaker.from_env(env)
    assert role.endpoints == (f"127.0.0.1:{p0}", f"127.0.0.1:{p1}")
    roles = [RoleMaker.from_env(dict(env, RANK=str(r))) for r in range(2)]
    tps = [ro.host_transport(timeout=10.0) for ro in roles]
    try:
        assert tps[1].port == p1
        tps[0].send(1, "hello", b"from rank 0")
        assert tps[1].recv("hello", 0) == b"from rank 0"
    finally:
        for t in tps:
            t.close()
    with pytest.raises(ValueError, match="2 endpoints for world 3"):
        RoleMaker.from_env(dict(env, WORLD_SIZE="3"))
    with pytest.raises(ValueError, match="not host:port"):
        RoleMaker.from_env(dict(env, PADDLE_TRAINER_ENDPOINTS="127.0.0.1:1,nohost"))
    with pytest.raises(ValueError, match="PADDLE_TRAINER_ENDPOINTS"):
        RoleMaker.from_env({"RANK": "0", "WORLD_SIZE": "1"}).host_transport()


def test_multi_host_placements_are_the_ranks_own_block():
    """One process a card: ``put_sharded`` takes the global array or this
    rank's block (leading dim 1, a DistributedWorkingSet's finalize), and
    the JAX package's multi-host placements reduce to this rank's block."""
    from paddlebox_tpu_torch.parallel import MeshPlan, put_axis1_blocks, put_per_device_copies, put_sharded

    plan = MeshPlan(rank=1, world=2, device=torch.device("cpu"), backend="gloo")
    glob = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(put_sharded(plan, glob).numpy(), glob[1])
    np.testing.assert_array_equal(put_sharded(plan, glob[1:]).numpy(), glob[1])
    with pytest.raises(ValueError, match="leading dim 3"):
        put_sharded(plan, np.zeros((3, 4), np.float32))
    arr = np.arange(6, dtype=np.int32)
    np.testing.assert_array_equal(put_per_device_copies(plan, arr).numpy(), arr)
    blocks = np.arange(5 * 1 * 7, dtype=np.int32).reshape(5, 1, 7)
    np.testing.assert_array_equal(put_axis1_blocks(plan, blocks).numpy(), blocks[:, 0])
    with pytest.raises(ValueError, match="axis-1"):
        put_axis1_blocks(plan, np.zeros((5, 2, 7), np.int32))

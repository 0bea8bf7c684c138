"""The coordinated PassSupervisor over a real two-host training day.

Two host processes (gloo on the CPU, one thread a rank, spawned once a
module as ``tests/test_torch_multihost.py``'s ``cluster2`` is), each with
its own ``TcpTransport`` on a free localhost port, its stripe of the files,
its ``HostSparseTable`` and a ``CTRTrainer(plan=)``, each under its own
``PassSupervisor(transport=tp)`` with a checkpoint chain under
``rank_root(root, rank)``. A day is three passes over overlapping file
groups (a base then two deltas, through ``run_day``).

- The clean supervised day against the JAX package's trainer on one
  process over the same global batches, within ``test_torch_multihost.py``'s
  bounds (host tables rtol 2e-3 / atol 1e-4, losses rtol 1e-3, AUC 5e-3).
- The faulted day: rank 1's health gate rejects the first attempt of pass
  1 once (a harness subclass overriding ``_gate``, as the JAX tests drive
  the gate with a trainer double). Rank 0 hears the no and reverts too;
  both ranks revert exactly once, both epochs become 1, and each host's
  table, its dense params, its Adam state, every pass's AUC and its chain's
  arrays are bitwise the clean day's.
- A supervisor over a mesh trainer without its rank's transport raises.
- What the trainer still refuses over several hosts names its reason and
  its ROADMAP entry: async dense, a registry or a dump (the JAX trainer
  cannot run them over several processes), and a rank an elastic change
  gave several mesh shards.

The rank function lives at module level and the module imports no jax at
its top (the spawned child imports it by name). Every transport is closed
in a ``finally``.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
from test_torch_multihost import (
    AUC_TOL,
    DECAY,
    GLOBAL_BATCH,
    LAY,
    _free_ports,
    _host_ds,
    _line_counts,
    _trainer,
    _transport,
    check_host_tables,
    jax_reference,
    write_overlapping_pass_files,
)

torch.set_num_threads(2)

DATE = "20260101"
PASSES, FILES_PER_PASS = 3, 2
LOCAL_BATCH = GLOBAL_BATCH // 2
FAULT_PASS = 2  # the supervisor's pass_seq of pass 1


def _supervisor_cls(reject_rank):
    """The port's PassSupervisor whose gate rejects the first attempt of
    pass 1 once on ``reject_rank``."""
    from paddlebox_tpu_torch.train.supervisor import PassRejected, PassSupervisor

    class OnceRejecting(PassSupervisor):
        fired = False

        def _gate(self, out):
            if self.coord.transport.rank == reject_rank and self._pass_seq == FAULT_PASS and not self.fired:
                self.fired = True
                raise PassRejected("auc", "one-shot rejection on this rank")
            super()._gate(out)

    return OnceRejecting


def _chain_arrays(root):
    """Every array of a rank's published chain, by file and member (npz
    members carry a zip timestamp, so the bytes are not compared)."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.endswith(".npz"):
                rel = os.path.relpath(os.path.join(dirpath, n), root)
                with np.load(os.path.join(dirpath, n)) as f:
                    for k in f.files:
                        out[f"{rel}:{k}"] = f[k]
    return out


def _day(plan, tp, res, groups, root, prefix, reject_rank):
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter
    from paddlebox_tpu_torch.train import CheckpointManager, HealthGates, RetryPolicy
    from paddlebox_tpu_torch.train.checkpoint import rank_root

    config.set_flag("enable_resident_feed", 1)
    table = HostSparseTable(LAY, SparseOptimizerConfig(**DECAY), n_shards=4, seed=0)
    ds = _host_ds(plan, tp, TcpShuffleRouter(tp), table, LOCAL_BATCH)
    tr = _trainer(plan, LOCAL_BATCH, DECAY)
    sup = _supervisor_cls(reject_rank)(
        ds, tr, checkpoint=CheckpointManager(rank_root(root, plan.rank)), gates=HealthGates(auc_min_history=99),
        retry=RetryPolicy(backoff_s=0.0, sleep=lambda s: None), round_to=32, transport=tp,
    )
    reverts = []
    orig = ds.revert_pass

    def counted_revert():
        reverts.append(1)
        orig()

    ds.revert_pass = counted_revert
    outs = sup.run_day(DATE, groups)
    table.drain_pending()
    keys = np.sort(table.keys())
    res.update({
        f"{prefix}:host_keys": keys, f"{prefix}:host_vals": table.pull_or_create(keys),
        f"{prefix}:losses": np.array([o["loss"] for o in outs]), f"{prefix}:aucs": np.array([o["auc"] for o in outs]),
        f"{prefix}:epoch": np.int64(sup.coord.epoch), f"{prefix}:reverts": np.int64(len(reverts)),
        f"{prefix}:incidents": np.array([f"{i.kind}/{i.action}/{i.attempt}" for i in sup.incidents] or [""]),
    })
    for k, v in tr.params.items():
        res[f"{prefix}:p:{k}"] = v.numpy()
    res[f"{prefix}:opt:count"] = np.asarray(tr.opt_state.count)
    for k, v in tr.opt_state.mu.items():
        res[f"{prefix}:opt:mu:{k}"] = v.numpy()
    for k, v in tr.opt_state.nu.items():
        res[f"{prefix}:opt:nu:{k}"] = v.numpy()
    for k, v in _chain_arrays(rank_root(root, plan.rank)).items():
        res[f"{prefix}:chain:{k}"] = v


def rank_main(plan, d: str, ports, groups) -> None:
    from paddlebox_tpu_torch.train import PassSupervisor

    tp = _transport(plan, ports)
    res = {}
    try:
        config.set_flag("sample_rate", 1.0)
        _day(plan, tp, res, groups, os.path.join(d, "clean"), "clean", reject_rank=-1)
        _day(plan, tp, res, groups, os.path.join(d, "fault"), "fault", reject_rank=1)
        tr = _trainer(plan, LOCAL_BATCH, DECAY)
        table = HostSparseTable(LAY, SparseOptimizerConfig(**DECAY), n_shards=4, seed=0)
        try:
            PassSupervisor(_host_ds(plan, tp, None, table, LOCAL_BATCH), tr)
            res["no_transport"] = np.array("constructed")
        except ValueError as e:
            res["no_transport"] = np.array(str(e))
    finally:
        tp.close()
    np.savez(os.path.join(d, f"rank{plan.rank}.npz"), **res)


@pytest.fixture(scope="module")
def sup2(tmp_path_factory):
    from paddlebox_tpu_torch.fleet.launch import spawn

    d = tmp_path_factory.mktemp("suphosts")
    (d / "data").mkdir()
    files = write_overlapping_pass_files(str(d / "data"), n_passes=PASSES, files_per_pass=FILES_PER_PASS)
    groups = [files[p * FILES_PER_PASS : (p + 1) * FILES_PER_PASS] for p in range(PASSES)]
    spawn(rank_main, 2, f"file://{d}/rdv", backend="gloo", device="cpu", args=(str(d), _free_ports(2), groups),
          threads=1, timeout_s=300)
    return groups, [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(2)]


def test_one_gate_rejection_reverts_both_hosts_bitwise(sup2):
    _, dumps = sup2
    want = {0: ["peer_abort/revert_retry/0"], 1: ["gate_auc/revert_retry/0"]}
    for r, x in enumerate(dumps):
        assert list(x["fault:incidents"]) == want[r]
        assert list(x["clean:incidents"]) == [""]
        assert int(x["fault:reverts"]) == 1 and int(x["clean:reverts"]) == 0
        assert int(x["fault:epoch"]) == 1 and int(x["clean:epoch"]) == 0
        clean = {k[len("clean:"):]: v for k, v in x.items() if k.startswith("clean:") and "incidents" not in k}
        for k, v in clean.items():
            if k in ("epoch", "reverts"):
                continue
            np.testing.assert_array_equal(x["fault:" + k], v, err_msg=f"rank {r}: {k}")
        assert any(k.startswith("chain:") for k in clean)
        assert set(k for k in x if k.startswith("fault:chain:")) == set("fault:" + k for k in clean if k.startswith("chain:"))


def test_clean_supervised_day_matches_single_process(sup2):
    groups, dumps = sup2
    ref = jax_reference(groups, 2, LOCAL_BATCH, sparse=DECAY, counts_of=_line_counts, shrink=True)
    check_host_tables(dumps, ref, "clean")
    for x in dumps:
        np.testing.assert_allclose(x["clean:losses"], ref["losses"], rtol=1e-3)
        np.testing.assert_allclose(x["clean:aucs"], ref["aucs"], atol=AUC_TOL)
    np.testing.assert_array_equal(dumps[0]["clean:aucs"], dumps[1]["clean:aucs"])


def test_supervisor_over_a_mesh_needs_its_transport(sup2):
    _, dumps = sup2
    for x in dumps:
        assert "needs transport=" in str(x["no_transport"])


def _hosts_check(**over):
    """``CTRTrainer._check_hosts`` on doubles: a two-host rank 0 whose
    checks all pass unless ``over`` changes one."""
    from types import SimpleNamespace

    from paddlebox_tpu_torch.parallel.membership import OwnershipMap
    from paddlebox_tpu_torch.train import CTRTrainer

    omap = over.pop("ownership", OwnershipMap.even(2, 2))
    ds = SimpleNamespace(transport=SimpleNamespace(rank=0, n_ranks=2), ws=SimpleNamespace(ownership=omap,
                         n_mesh_shards=2), store=object(), batch_size=LOCAL_BATCH)
    tr = SimpleNamespace(plan=SimpleNamespace(rank=0, world=2), cfg=SimpleNamespace(batch_size=LOCAL_BATCH),
                         metric_registry=None, dump_pool=None, async_dense=None)
    for k, v in over.items():
        setattr(tr, k, v)
    CTRTrainer._check_hosts(tr, ds)
    return ds


@pytest.mark.parametrize("option,match", [
    ("async_dense", "async dense over several hosts.*ROADMAP Queue 4 item 1"),
    ("metric_registry", "registry or a dump over several hosts.*ROADMAP Queue 4 item 2"),
    ("dump_pool", "registry or a dump over several hosts.*ROADMAP Queue 4 item 2"),
])
def test_options_the_reference_cannot_run_over_hosts_are_refused(option, match):
    assert _hosts_check().mesh_plan is not None
    with pytest.raises(NotImplementedError, match=match):
        _hosts_check(**{option: object()})


def test_a_rank_an_elastic_change_moved_cannot_train_on_the_mesh():
    from paddlebox_tpu_torch.parallel.membership import OwnershipMap

    shrunk = OwnershipMap.even(2, 2).shrink([1])  # rank 0 owns both shards
    with pytest.raises(RuntimeError, match=r"owns mesh shards \(0, 2\) of ownership epoch 1"):
        _hosts_check(ownership=shrunk)

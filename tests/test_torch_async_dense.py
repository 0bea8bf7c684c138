"""The port's async dense mode against the JAX package's.

``AsyncDenseTable._apply`` is numpy fp32 in both packages: one merge of
1-4 gradient packages gives bitwise-equal params and moments (a Linear's
weight is the transpose of the JAX leaf). ``lr_map`` keys match each
param by its port name or its JAX path, exactly or as a suffix, so a map
written for the JAX package gives every param the same lr in the port.
``finalize`` drains what was pushed.

A trainer pass in async mode is driven deterministically in both
packages: ``merge_limit=1`` and an ``on_batch`` that waits until the
table has applied the batch's gradients (the port's
``wait_for_updates``; the JAX table has no such call, so its side spins
on ``n_updates``), so batch i trains on the params of i updates, each of
one batch. Nothing waits on a clock. Tolerances: the pass loss rtol 1e-3
and the pass table by key rtol 1e-3 / atol 2e-5, as
``test_torch_trainer.py``; the params within atol 2e-4, the bound
``test_torch_train_step.py`` gives Adam (measured 4.4e-5: the table's rule
also divides by each element's own magnitude). Async dense stays off the
resident feed in both packages under the same predicate.
"""

import contextlib
import os
import time

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
from paddlebox_tpu.train.async_dense import AsyncDenseTable as JAsyncDenseTable
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import WideDeep, jax_path, params_to_jax, wide_deep_params_from_jax
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import AsyncDenseTable, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

S, B, D, DD = 3, 16, 4, 2
HIDDEN = (16, 8)
LR = 1e-3
N_BATCHES = 6
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
LOSS_RTOL = 1e-3
PARAMS_ATOL = 2e-4
SPARSE = dict(embedx_threshold=0.0)
WAIT_S = 60.0


def _jmodel():
    return JWideDeep(S, JValueLayout(embedx_dim=D).pull_width, dense_dim=DD, hidden=HIDDEN)


def _both_params(seed=3):
    jparams = jax.tree.map(lambda a: np.asarray(a) + 0.02, _jmodel().init(jax.random.PRNGKey(seed)))
    return jparams, wide_deep_params_from_jax(jparams)


def _jax_order(port_tree):
    """A port params dict as the JAX tree's leaves, in flatten order."""
    return jax.tree.leaves(params_to_jax({k: torch.as_tensor(v) for k, v in port_tree.items()}))


def _jax_grads(rng, jparams):
    return jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), jparams)


@pytest.mark.parametrize("n_merge", [1, 2, 3, 4])
def test_apply_is_bitwise_jax(n_merge):
    jparams, params = _both_params()
    lr_map = {"b": 0.5, "mlp/1/w": 0.25}
    jt = JAsyncDenseTable(jparams, base_lr=0.1, lr_map=lr_map, merge_limit=4)
    t = AsyncDenseTable(params, base_lr=0.1, lr_map=lr_map, merge_limit=4)
    try:
        rng = np.random.default_rng(n_merge)
        for _ in range(3):  # three updates, each a merge of n_merge packages
            jg = [_jax_grads(rng, jparams) for _ in range(n_merge)]
            pg = [{k: v.numpy() for k, v in wide_deep_params_from_jax(g).items()} for g in jg]
            jt._apply([jax.tree.leaves(g) for g in jg])
            t._apply([[g[k] for k in t._names] for g in pg])
        got, want = _jax_order(t.pull_dense()), jax.tree.leaves(jt.pull_dense())
        for a, b in zip(got, want):
            assert a.tobytes() == np.asarray(b, np.float32).tobytes()
        for mom, jmom in ((t._mom1, jt._mom1), (t._mom2, jt._mom2)):
            for a, b in zip(_jax_order(dict(zip(t._names, mom))), jmom):
                assert a.tobytes() == b.tobytes()
        assert t.n_updates == jt.n_updates == 3
    finally:
        t.finalize()
        jt.finalize()


@pytest.mark.parametrize("lr_map", [
    {"b": 0.5},  # the scalar exactly; every bias as a suffix
    {"w": 0.5, "out/b": 0.25},  # every weight as a suffix; one bias exactly-by-suffix
    {"mlp/0/w": 0.5, "0/w": 0.25, "wide_dense/b": 0.125},  # exact beats suffix
    {"mlp": 0.5},  # a dict key is no leaf: matches nothing
])
def test_lr_map_matches_jax_across_namings(lr_map):
    jparams, params = _both_params()
    jt = JAsyncDenseTable(jparams, base_lr=0.1, lr_map=lr_map)
    t = AsyncDenseTable(params, base_lr=0.1, lr_map=lr_map)
    try:
        want = dict(zip([jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]],
                        jt._leaf_lr))
        got = {"".join(f"[{int(p)}]" if p.isdigit() else f"['{p}']" for p in jax_path(n).split("/")): lr
               for n, lr in zip(t._names, t._leaf_lr)}
        assert got == want
        # the same exact entries spelled with the port's names
        port_map = {n: lr_map[jax_path(n)] for n in params if jax_path(n) in lr_map}
        if port_map:
            t2 = AsyncDenseTable(params, base_lr=0.1, lr_map=port_map)
            try:
                for n, lr in zip(t2._names, t2._leaf_lr):
                    if n in port_map:
                        assert lr == np.float32(port_map[n])
            finally:
                t2.finalize()
    finally:
        t.finalize()
        jt.finalize()


def test_finalize_drains_and_closes():
    _, params = _both_params()
    rng = np.random.default_rng(0)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()} for _ in range(5)]
    t = AsyncDenseTable(params, base_lr=0.1, merge_limit=1)
    for g in grads:
        t.push_dense(g)
    final = t.finalize()
    assert t.n_updates == 5 and t._queue.empty()
    ref = AsyncDenseTable(params, base_lr=0.1, merge_limit=1)
    for g in grads:  # the same packages one at a time, in order
        ref._apply([[g[k] for k in ref._names]])
    try:
        for k in params:
            assert final[k].tobytes() == ref.pull_dense()[k].tobytes()
        with pytest.raises(RuntimeError, match="finalized"):
            t.push_dense(grads[0])
        assert t.wait_for_updates(5, timeout=0)
    finally:
        ref.finalize()


# ---- a trainer pass ---------------------------------------------------------


def _write_files(tmp_path, n_files=2, n_rec=48, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        lines = []
        for _ in range(n_rec):
            keys = rng.integers(1, 100, S)
            dense = rng.normal(size=DD)
            label = 1.0 if dense[0] + (keys % 4 == 0).sum() > 0.8 else 0.0
            lines.append(" ".join([f"1 {label}", f"{DD} " + " ".join(f"{v:.4f}" for v in dense)]
                                  + [f"1 {k}" for k in keys]))
        path = os.path.join(str(tmp_path), f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def _schema(info, schema):
    slots = [info("label", type="float", dense=True, dim=1), info("d", type="float", dense=True, dim=DD)]
    return schema(slots + [info(f"s{i}") for i in range(S)], label_slot="label")


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


def _jax_pass(files, jparams):
    lay = JValueLayout(embedx_dim=D)
    table = JHostSparseTable(lay, JSparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = JBoxPSDataset(_schema(JSlotInfo, JSlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=JSparseOptimizerConfig(**SPARSE),
                           auc_buckets=1000, dense_sync_mode="async")
    adt = JAsyncDenseTable(jparams, base_lr=LR, merge_limit=1)
    with pytest.raises(ValueError, match="AsyncDenseTable"):
        JCTRTrainer(_jmodel(), cfg)
    tr = JCTRTrainer(_jmodel(), cfg, dense_opt=optax.adam(1e-3), async_dense=adt, dense_slot="d", dense_dim=DD)
    tr.params = jparams
    tr.opt_state = optax.adam(1e-3).init(jparams)

    def wait(i, m):
        deadline = time.monotonic() + WAIT_S
        while adt.n_updates < i + 1:  # spin: the JAX table has no wait call
            if time.monotonic() > deadline:
                raise TimeoutError(f"update {i + 1} never applied")

    assert tr._use_resident(ds, False, True) is False and tr._use_resident(ds, False, False) is True
    out = tr.train_pass(ds, n_batches=N_BATCHES, on_batch=wait)
    assert adt.n_updates == N_BATCHES
    final = adt.finalize()
    return out, _by_key(ds.ws, tr.trained_table()), jax.tree.leaves(final), tr


def _port_pass(files, params, device="cpu"):
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                          auc_buckets=1000, dense_sync_mode="async")
    model = WideDeep(S, lay.pull_width, dense_dim=DD, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    with pytest.raises(ValueError, match="AsyncDenseTable"):
        CTRTrainer(model, cfg, device=device)
    adt = AsyncDenseTable(params, base_lr=LR, merge_limit=1)
    tr = CTRTrainer(model, cfg, device=device, async_dense=adt, dense_slot="d", dense_dim=DD)
    tr.init_params()
    opt0 = {k: v.clone() for k, v in tr.opt_state.mu.items()}
    def wait(i, m):
        assert adt.wait_for_updates(i + 1, timeout=WAIT_S), f"update {i + 1} never applied"

    assert tr._use_resident(ds, False, True) is False and tr._use_resident(ds, False, False) is True
    out = tr.train_pass(ds, n_batches=N_BATCHES, on_batch=wait)
    assert tr.last_feed == "packer"  # the resident feed is not taken under async
    assert adt.n_updates == N_BATCHES
    # the pass's params are the table's; Adam's state is untouched
    for k, v in adt.pull_dense().items():
        assert v.tobytes() == tr.params[k].numpy().tobytes()
    assert int(tr.opt_state.count) == 0 and all(torch.equal(tr.opt_state.mu[k], v) for k, v in opt0.items())
    final = adt.finalize()
    return out, _by_key(ds.ws, tr.trained_table()), _jax_order(final), tr


def test_deterministic_async_pass_matches_jax(tmp_path):
    files = _write_files(tmp_path)
    jparams, params = _both_params()
    with _flags(jconfig, enable_native_parser=True, enable_resident_feed=True), \
            _flags(config, enable_native_parser=True, enable_resident_feed=True):
        jout, (jkeys, jrows), jfinal, _ = _jax_pass(files, jparams)
        out, (keys, rows), final, _ = _port_pass(files, params)
        out2, (_, rows2), final2, _ = _port_pass(files, params)
    assert out["batches"] == jout["batches"] == N_BATCHES
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_allclose(rows, jrows, rtol=ROWS_RTOL, atol=ROWS_ATOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(final, jax.tree.leaves(jparams)))
    assert moved > LR / 2  # the table trained the params
    for a, b in zip(final, jfinal):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAMS_ATOL)
    # the port against itself: the drive is deterministic, bitwise
    assert out2["loss"] == out["loss"] and rows2.tobytes() == rows.tobytes()
    assert all(a.tobytes() == b.tobytes() for a, b in zip(final, final2))


def test_eval_pass_never_pushes(tmp_path):
    """An eval pass under async mode runs the eval step: no gradients go
    to the table, and params come back as they were."""
    files = _write_files(tmp_path, n_files=1)
    _, params = _both_params()
    with _flags(config, enable_native_parser=True, enable_resident_feed=True):
        lay = ValueLayout(embedx_dim=D)
        table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
        ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B)
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                              auc_buckets=1000, dense_sync_mode="async")
        model = WideDeep(S, lay.pull_width, dense_dim=DD, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
        model.load_state_dict(params)
        adt = AsyncDenseTable(params, base_lr=LR)
        tr = CTRTrainer(model, cfg, device="cpu", async_dense=adt, dense_slot="d", dense_dim=DD)
        tr.set_test_mode(True)
        seen = []
        out = tr.train_pass(ds, on_batch=lambda i, m: seen.append("gparams" in m))
        # eval is not async: the resident feed is taken, as in the JAX package
        assert tr.last_feed == "resident" and seen and not any(seen)
        assert out["batches"] > 0 and adt.finalize() and adt.n_updates == 0
        assert all(torch.equal(tr.params[k], v) for k, v in params.items())

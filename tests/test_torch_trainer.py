"""One pass through the port's BoxPSDataset + CTRTrainer against the JAX
package's, over a few slot files, ending in end_pass.

Both packages run their Python tier: the pure-Python host store
(``PBOX_NATIVE_TABLE=0``), the line parser instead of the native columnar
one (``enable_native_parser`` off in each package's flags, so both take
the slow packed feed), a numpy trained table into end_pass (so the JAX
package's carried boundary stays off), and the same local-shuffle seed. Both start from the same dense weights. Tolerances follow
``test_torch_train_step.py`` (bf16 MLP rounding, Adam): host rows after
end_pass within rtol 1e-3, atol 2e-5 (measured max |diff| 7.5e-6);
the kept keys and the show/clk counters exact; pass loss rtol 1e-3.
"""

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
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DeepFM, deepfm_params_from_jax
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

S, B, D = 5, 16, 4
HIDDEN = (32, 16)
ROWS_RTOL, ROWS_ATOL = 1e-3, 2e-5
LOSS_RTOL = 1e-3
SPARSE = dict(embedx_threshold=2.0, shrink_threshold=1.5)


def _write_files(tmp_path, n_files=3, n_rec=40, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        keys = rng.integers(1, 120, (n_rec, S))  # small key space: keys repeat
        labels = (rng.random(n_rec) < 0.3).astype(int)
        path = os.path.join(str(tmp_path), f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            for i in range(n_rec):
                f.write(f"1 {labels[i]}.0 " + " ".join(f"1 {k}" for k in keys[i]) + "\n")
        files.append(path)
    return files


def _slots(info_cls):
    return [info_cls("label", type="float", dense=True, dim=1)] + [
        info_cls(f"s{i}") for i in range(S)
    ]


@pytest.fixture
def jax_python_tier(monkeypatch):
    """Both packages on their Python tier: store, parser, slow feed."""
    monkeypatch.setenv("PBOX_NATIVE_TABLE", "0")
    before = jconfig.get_flag("enable_native_parser"), config.get_flag("enable_native_parser")
    jconfig.set_flag("enable_native_parser", False)
    config.set_flag("enable_native_parser", False)
    try:
        yield
    finally:
        jconfig.set_flag("enable_native_parser", before[0])
        config.set_flag("enable_native_parser", before[1])


def _run_jax(files, jparams):
    lay = JValueLayout(embedx_dim=D)
    table = JHostSparseTable(lay, JSparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    assert table._native is None
    ds = JBoxPSDataset(
        JSlotSchema(_slots(JSlotInfo), label_slot="label"), table, batch_size=B,
        shuffle_mode="local", seed=5,
    )
    ds.set_filelist(files)
    ds.load_into_memory()
    assert ds.store is None  # the Python tier: records, slow feed
    ds.begin_pass(round_to=64)
    cfg = JTrainStepConfig(
        num_slots=S, batch_size=B, layout=lay, sparse_opt=JSparseOptimizerConfig(**SPARSE),
        auc_buckets=1000,
    )
    model = JDeepFM(S, lay.pull_width, D, hidden=HIDDEN)
    tr = JCTRTrainer(model, cfg, dense_opt=optax.adam(1e-3))
    tr.init_params(jax.random.PRNGKey(0))
    tr.params = jparams
    out = tr.train_pass(ds)
    ended = ds.end_pass(tr.trained_table())
    return table, out, ended


def _run_port(files, jparams, device="cpu"):
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=4, seed=0)
    ds = BoxPSDataset(
        SlotSchema(_slots(SlotInfo), label_slot="label"), table, batch_size=B,
        shuffle_mode="local", seed=5, read_threads=2,
    )
    ds.set_filelist(files)
    ds.load_into_memory()
    assert ds.store is None and not table.native  # the Python tier
    ds.begin_pass(round_to=64)
    cfg = TrainStepConfig(
        num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
        auc_buckets=1000,
    )
    model = DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(deepfm_params_from_jax(jax.tree.map(np.asarray, jparams)))
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device=device)
    n_steps = []
    out = tr.train_pass(ds, on_batch=lambda i, m: n_steps.append(i), profile=True)
    assert n_steps == list(range(ds.num_batches()))
    ended = ds.end_pass(tr.trained_table())
    return table, out, ended


def _contents(table):
    keys = np.sort(table.keys())
    return keys, table.pull_or_create(keys)


def test_one_pass_matches_jax(tmp_path, jax_python_tier):
    files = _write_files(tmp_path)
    jmodel = JDeepFM(S, JValueLayout(embedx_dim=D).pull_width, D, hidden=HIDDEN)
    jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(3)))
    jtable, jout, jended = _run_jax(files, jparams)
    table, out, ended = _run_port(files, jparams)

    assert out["batches"] == jout["batches"] == 7.0
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=LOSS_RTOL)
    assert out["ins_num"] == jout["ins_num"]
    assert set(out["profile"]) == {
        "feed_wait_s", "step_dispatch_s", "device_step_s", "host_metrics_s",
        "build_batch_s", "pack_batch_s", "h2d_s",
    }
    assert ended["dropped"] == jended["dropped"]
    keys, rows = _contents(table)
    jkeys, jrows = _contents(jtable)
    np.testing.assert_array_equal(keys, jkeys)
    lay = ValueLayout(embedx_dim=D)
    np.testing.assert_array_equal(rows[:, [lay.SHOW, lay.CLK]], jrows[:, [lay.SHOW, lay.CLK]])
    np.testing.assert_allclose(rows, jrows, rtol=ROWS_RTOL, atol=ROWS_ATOL)


def test_a_second_train_pass_in_one_pass_continues_the_table(tmp_path):
    """Within one working set the second call sees the first call's rows."""
    files = _write_files(tmp_path, n_files=1, n_rec=32)
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = BoxPSDataset(SlotSchema(_slots(SlotInfo), label_slot="label"), table, batch_size=B)
    ds.set_filelist(files)
    ds.load_into_memory()
    dev0 = ds.begin_pass(round_to=64).copy()
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE))
    tr = CTRTrainer(
        DeepFM(S, lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(0)),
        cfg, device="cpu",
    )
    tr.train_pass(ds)
    after_one = tr.trained_table()
    np.testing.assert_array_equal(ds.device_table, dev0)  # the dataset's copy is untouched
    tr.train_pass(ds)
    after_two = tr.trained_table()
    shows = lay.SHOW
    np.testing.assert_array_equal(
        after_two[:, shows] - after_one[:, shows], after_one[:, shows] - dev0.reshape(-1, lay.width)[:, shows]
    )
    assert int(tr.opt_state.count) == 4
    ds.end_pass(after_two)
    assert len(table) > 0

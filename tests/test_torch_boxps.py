"""The port's ``BoxWrapper`` façade against the JAX package's.

The flow of ``tests/test_user_api.py::test_boxwrapper_facade`` (phases,
test mode, a dataset bound to the wrapper's table, a metric read and
reset, a base saved and loaded into a second wrapper) and the ``box=``
case of ``tests/test_eval_mode.py`` (the box's test mode makes the next
pass an eval pass: table, params and Adam state bitwise as they were, the
writeback exactly the trained rows, training again once cleared), with
``device="cpu"``. A base saved through the port's wrapper loads into the
JAX one and the reverse, rows bitwise; the cache and whitelist saves
count the same keys in both.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu.boxps import BoxWrapper as JBoxWrapper
from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu_torch import BoxWrapper
from paddlebox_tpu_torch.data import SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.table import SparseOptimizerConfig
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

NS = 4
OPT = dict(embed_lr=0.2, embedx_lr=0.2, embedx_threshold=0.0, initial_range=0.01, show_clk_decay=1.0,
           shrink_threshold=0.0)


def _schema(info=SlotInfo, schema=SlotSchema):
    return schema([info("label", type="float", dense=True, dim=1)] + [info(f"s{i}") for i in range(NS)],
                  label_slot="label")


def _write_day(tmp_path, rng, name, n=96):
    key_w = rng.normal(size=300) * 1.5
    lines = []
    for _ in range(n):
        ks = rng.integers(1, 300, NS)
        lab = 1.0 if key_w[ks].sum() + rng.normal() * 0.3 > 0 else 0.0
        lines.append(f"1 {lab:.1f} " + " ".join(f"1 {k}" for k in ks))
    path = os.path.join(str(tmp_path), name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_box_wrapper_facade(tmp_path):
    box = BoxWrapper(embedx_dim=8, sparse_opt=SparseOptimizerConfig(**OPT), n_host_shards=4, device="cpu")
    assert box.phase == 1
    assert box.flip_phase() == 0 and box.flip_phase() == 1
    box.set_test_mode()
    assert box.test_mode

    rng = np.random.default_rng(3)
    f = _write_day(str(tmp_path), rng, "d.txt", n=64)
    ds = box.make_dataset(_schema(), batch_size=32, read_threads=1)
    assert ds.table is box.table
    ds.set_date("20260101")
    ds.set_filelist([f])
    ds.load_into_memory()
    ds.begin_pass(round_to=32)

    box.init_metric("join_auc", phase=1)
    preds = torch.from_numpy(rng.uniform(size=64).astype(np.float32))
    labels = (preds > 0.5).to(torch.float32)  # perfectly separable
    box.metrics.add_all({"preds": preds, "labels": labels}, phase=1)
    msg = box.get_metric_msg("join_auc")  # reads and resets
    assert "AUC=1.0" in msg, msg
    assert box.get_metric("join_auc")["ins_num"] == 0

    ds.end_pass(None, shrink=False)
    box.save_base(str(tmp_path / "m"), "20260101")
    box2 = BoxWrapper(embedx_dim=8, sparse_opt=SparseOptimizerConfig(**OPT), n_host_shards=4, device="cpu")
    assert box2.load_model(str(tmp_path / "m"))["date"] == "20260101"
    assert len(box2.table) == len(box.table) > 0


def test_box_wrapper_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BoxWrapper(embedx_dim=4, n_host_shards=2)


def _state(tr):
    return (
        tr.trained_table().copy(), {k: v.clone() for k, v in tr.params.items()},
        {k: v.clone() for k, v in tr.opt_state.mu.items()}, {k: v.clone() for k, v in tr.opt_state.nu.items()},
        tr.opt_state.count.clone(),
    )


def test_box_test_mode_makes_an_eval_pass(tmp_path):
    box = BoxWrapper(embedx_dim=4, sparse_opt=SparseOptimizerConfig(embedx_threshold=0.0, initial_range=0.01),
                     n_host_shards=4, device="cpu")
    f = _write_day(str(tmp_path), np.random.default_rng(0), "data.txt")
    ds = box.make_dataset(_schema(), batch_size=16, seed=0)
    ds.set_filelist([f])
    lay = box.layout
    model = DeepFM(NS, lay.pull_width, 4, hidden=(8,), generator=torch.Generator().manual_seed(0))
    cfg = TrainStepConfig(num_slots=NS, batch_size=16, layout=lay, sparse_opt=box.sparse_opt, auc_buckets=500)
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-2), device="cpu", box=box, metric_registry=box.metrics)
    box.init_metric("auc", phase=-1)

    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    tr.train_pass(ds)
    before = _state(tr)
    assert int(before[4]) > 0

    box.set_test_mode(True)
    out = tr.train_pass(ds)
    assert out["batches"] > 0 and np.isfinite(out["loss"]) and 0.0 < out["auc"] <= 1.0
    after = _state(tr)
    assert after[0].tobytes() == before[0].tobytes()
    for i in (1, 2, 3):
        assert all(torch.equal(after[i][k], before[i][k]) for k in before[i])
    assert torch.equal(after[4], before[4])
    assert box.get_metric("auc")["ins_num"] == 2 * 96  # the eval pass counted too

    # the writeback lands the pre-eval trained rows
    keys, rows = ds.ws.sorted_keys.copy(), ds.ws.row_of_sorted.copy()
    ds.end_pass(tr.trained_table(), shrink=False)
    flat = before[0].reshape(-1, lay.width)
    np.testing.assert_array_equal(box.table.pull_or_create(keys), flat[rows])

    box.set_test_mode(False)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    tr.train_pass(ds)
    assert not np.array_equal(tr.trained_table(), before[0])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bases_cross_packages(tmp_path, direction):
    rng = np.random.default_rng(5)
    days = [_write_day(str(tmp_path), rng, f"d{i}.txt") for i in range(2)]
    port = BoxWrapper(embedx_dim=4, sparse_opt=SparseOptimizerConfig(**OPT), n_host_shards=4, device="cpu")
    jbox = JBoxWrapper(embedx_dim=4, sparse_opt=JSparseOptimizerConfig(**OPT), n_host_shards=4)
    src, dst = (port, jbox) if direction == "port_to_jax" else (jbox, port)
    schema = _schema() if src is port else _schema(JSlotInfo, JSlotSchema)
    ds = src.make_dataset(schema, batch_size=16, read_threads=1)
    for i, f in enumerate(days):
        ds.set_date(f"2026010{i + 1}")
        ds.set_filelist([f])
        ds.load_into_memory()
        dev = ds.begin_pass(round_to=32)
        # a stand-in for training: every row moves
        trained = np.asarray(dev).copy()
        trained[..., 2:] += 0.25 * (i + 1)
        ds.end_pass(trained, shrink=False)
    root = str(tmp_path / "m")
    src.save_base(root, "20260102")
    assert dst.load_model(root)["date"] == "20260102"
    keys = np.sort(src.table.keys())
    np.testing.assert_array_equal(np.sort(dst.table.keys()), keys)
    assert dst.table.pull_or_create(keys).tobytes() == src.table.pull_or_create(keys).tobytes()
    # the serving cache and the whitelist count the same keys in both
    assert port.save_cache_model(str(tmp_path / "pc"), "d", 0.25) == jbox.save_cache_model(
        str(tmp_path / "jc"), "d", 0.25) > 0
    white = keys[::3]
    assert port.save_model_with_whitelist(str(tmp_path / "pw"), "d", white) == jbox.save_model_with_whitelist(
        str(tmp_path / "jw"), "d", white) == len(white)

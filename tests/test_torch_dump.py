"""The port's dumps against the JAX package's.

With one writer thread a ``DumpWorkerPool``'s part file holds the lines in
the order they were written, so the same ``dump_fields`` / ``dump_param``
calls give byte-identical files in both packages (line format
``ins_id\\tname:v,...`` with ``{v:.6g}``, blake2b sampling for mode 1,
``part-NNNNN``). A trainer pass with a dump writes the same instance ids
in the same order as the JAX trainer's pass, on each of the port's flat
feeds. In an eval pass (params as loaded) each dumped pred is within 1e-5
of the JAX one after parsing, and the param lines are the JAX package's
byte for byte, under its leaf names. In a training pass the preds drift
apart as the params do (Adam over the bf16 tower's rounding): within
1e-3 (measured 2.0e-4), the bound ``test_torch_train_step.py`` puts on
the loss. ``fs_open_write`` pipes through a converter command
in ``sh``, gzips a ``.gz`` path and fires ``fs.open_write``.
"""

import contextlib
import gzip
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
from paddlebox_tpu.models import DCN as JDCN
from paddlebox_tpu.table import HostSparseTable as JHostSparseTable
from paddlebox_tpu.table import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import CTRTrainer as JCTRTrainer
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.utils import dump as jdump
from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data import BoxPSDataset, SlotInfo, SlotSchema
from paddlebox_tpu_torch.models import DCN, dcn_params_from_jax
from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig
from paddlebox_tpu_torch.utils import dump, faultinject
from paddlebox_tpu_torch.utils.fs import fs_open_write

torch.set_num_threads(2)

S, B, D = 3, 16, 4
PRED_ATOL = 1e-5  # an eval pass: the same params
TRAIN_PRED_ATOL = 1e-3  # a training pass
SPARSE = dict(embedx_threshold=0.0)
FEEDS = {
    "resident": dict(enable_resident_feed=1, enable_native_parser=True),
    "packer": dict(enable_resident_feed=0, enable_native_parser=True),
    "slow": dict(enable_resident_feed=1, enable_native_parser=False),
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _drive(mod, root, calls):
    pool = mod.DumpWorkerPool(root, n_threads=1)
    pool.start()
    for fn, args, kw in calls:
        getattr(mod, fn)(pool, *args, **kw)
    pool.finalize()
    return _read(os.path.join(root, "part-00000"))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_part_files_are_jax_bytes(tmp_path, mode):
    rng = np.random.default_rng(mode)
    calls = []
    for step in range(4):
        n = 12
        ids = [f"{step:02d}{j:03d}{rng.integers(1 << 30):x}" for j in range(n)]
        fields = {
            "preds": rng.random(n).astype(np.float32),
            "labels": (rng.random(n) < 0.3).astype(np.float32),
            "emb": rng.standard_normal((n, 3)).astype(np.float32) * 1e3,
        }
        calls.append(("dump_fields", (ids, fields), dict(step=step, dump_mode=mode, dump_interval=3)))
    calls.append(("dump_param", ("mlp/0/w", rng.standard_normal((4, 2)).astype(np.float32)), {}))
    calls.append(("dump_param", ("b", np.asarray(0.125, np.float32)), {}))
    got = _drive(dump, str(tmp_path / "port"), calls)
    want = _drive(jdump, str(tmp_path / "jax"), calls)
    assert got == want and got.count(b"\n") > 2


def _logkey(sid, rank):
    return "0" * 11 + format(222, "03x") + format(rank, "02x") + format(sid, "016x")


def _write_files(tmp_path, n_files=2, n_queries=24, seed=0):
    rng = np.random.default_rng(seed)
    files, sid = [], 1
    for fi in range(n_files):
        lines = []
        for _ in range(n_queries):
            for r in range(1, int(rng.integers(1, 4)) + 1):
                keys = rng.integers(1, 120, S)
                label = 1.0 if (keys % 5 == 0).any() else 0.0
                lines.append(" ".join([f"1 {_logkey(sid, r)}", f"1 {label}"] + [f"1 {k}" for k in keys]))
            sid += 1
        path = os.path.join(str(tmp_path), f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def _schema(info, schema):
    return schema([info("label", type="float", dense=True, dim=1)] + [info(f"s{i}") for i in range(S)],
                  label_slot="label", parse_logkey=True)


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


def _parse(path):
    """(ids, {field: values}) of a field dump, and {name: line} of its
    param lines, in file order."""
    ids, preds, params = [], [], {}
    with open(path) as f:
        for line in f.read().splitlines():
            head, rest = line.split("\t", 1)
            if rest.startswith("preds:"):
                ids.append(head)
                preds.append(float(rest.split("\t")[0][len("preds:"):]))
            else:
                params[head] = line
    return ids, np.asarray(preds), params


def _jax_model():
    return JDCN(S, JValueLayout(embedx_dim=D).pull_width, n_cross=2, hidden=(16, 8))


def _jax_pass(files, jparams, root, test_mode):
    lay = JValueLayout(embedx_dim=D)
    table = JHostSparseTable(lay, JSparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = JBoxPSDataset(_schema(JSlotInfo, JSlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=64)
    cfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=JSparseOptimizerConfig(**SPARSE),
                           auc_buckets=1000)
    pool = jdump.DumpWorkerPool(root, n_threads=1)
    tr = JCTRTrainer(_jax_model(), cfg, dense_opt=optax.adam(1e-3), dump_pool=pool, dump_params_at_end=True)
    tr.params = jparams
    tr.opt_state = optax.adam(1e-3).init(jparams)
    tr.set_test_mode(test_mode)
    tr.train_pass(ds)
    pool.finalize()
    return _parse(os.path.join(root, "part-00000"))


def _port_pass(files, jparams, root, test_mode, flags):
    lay = ValueLayout(embedx_dim=D)
    table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
    ds = BoxPSDataset(_schema(SlotInfo, SlotSchema), table, batch_size=B, shuffle_mode="local", seed=5)
    ds.set_filelist(files)
    with _flags(config, **flags):
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, sparse_opt=SparseOptimizerConfig(**SPARSE),
                              auc_buckets=1000)
        model = DCN(S, lay.pull_width, n_cross=2, hidden=(16, 8), generator=torch.Generator().manual_seed(0))
        model.load_state_dict(dcn_params_from_jax(jparams))
        pool = dump.DumpWorkerPool(root, n_threads=1)
        tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device="cpu", dump_pool=pool, dump_params_at_end=True)
        tr.set_test_mode(test_mode)
        out = tr.train_pass(ds)
        pool.finalize()
    return _parse(os.path.join(root, "part-00000")), tr.last_feed, out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dump")
    files = _write_files(tmp)
    jparams = jax.tree.map(lambda a: np.asarray(a) + 0.02, _jax_model().init(jax.random.PRNGKey(2)))
    with _flags(jconfig, enable_native_parser=True, enable_resident_feed=True):
        return {
            "files": files, "jparams": jparams,
            "train": _jax_pass(files, jparams, str(tmp / "jtrain"), False),
            "eval": _jax_pass(files, jparams, str(tmp / "jeval"), True),
        }


@pytest.mark.parametrize("feed", list(FEEDS))
def test_trainer_dump_matches_jax(ref, feed, tmp_path):
    (ids, preds, params), last_feed, out = _port_pass(
        ref["files"], ref["jparams"], str(tmp_path / "train"), False, FEEDS[feed]
    )
    assert last_feed == feed
    jids, jpreds, jparams = ref["train"]
    assert len(ids) == out["batches"] * B and ids == jids
    assert ids[0].startswith("0" * 11)  # the parsed ids, not batch ordinals
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=TRAIN_PRED_ATOL)
    assert list(params) == list(jparams) and "cross_w/0" in params and "mlp/0/w" in params

    # an eval pass: the loaded params, so the preds agree closely and the
    # param lines are the JAX package's bytes
    (eids, epreds, eparams), _, _ = _port_pass(
        ref["files"], ref["jparams"], str(tmp_path / "eval"), True, FEEDS[feed]
    )
    assert eids == ref["eval"][0] and eparams == ref["eval"][2]
    np.testing.assert_allclose(epreds, ref["eval"][1], rtol=0, atol=PRED_ATOL)


def test_dump_without_ids_uses_batch_ordinals(tmp_path):
    files = _write_files(tmp_path, n_files=1)
    with _flags(config, enable_native_parser=True, enable_resident_feed=0):
        lay = ValueLayout(embedx_dim=D)
        table = HostSparseTable(lay, SparseOptimizerConfig(**SPARSE), n_shards=2, seed=0)
        schema = SlotSchema([SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(S)],
                            label_slot="label")
        ds = BoxPSDataset(schema, table, batch_size=B)
        # the same files without their logkey column
        plain = os.path.join(str(tmp_path), "plain.txt")
        with open(files[0]) as f, open(plain, "w") as g:
            g.writelines(line.split(" ", 2)[2] for line in f)
        ds.set_filelist([plain])
        ds.load_into_memory()
        ds.begin_pass(round_to=64)
        cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=100)
        model = DCN(S, lay.pull_width, n_cross=1, hidden=(8,), generator=torch.Generator().manual_seed(0))
        pool = dump.DumpWorkerPool(str(tmp_path / "d"), n_threads=1)
        tr = CTRTrainer(model, cfg, device="cpu", dump_pool=pool, dump_mode=2, dump_interval=2)
        out = tr.train_pass(ds)
        pool.finalize()
    ids, _, _ = _parse(str(tmp_path / "d" / "part-00000"))
    n = int(out["batches"])
    assert ids == [f"b{i}:{j}" for i in range(0, n, 2) for j in range(B)]


def test_converter_pipe_and_gzip(tmp_path):
    pool = dump.DumpWorkerPool(str(tmp_path / "up"), n_threads=1, converter="tr a-z A-Z")
    pool.start()
    dump.dump_fields(pool, ["id1", "id2"], {"preds": np.array([0.5, 0.25], np.float32)})
    pool.finalize()
    assert _read(str(tmp_path / "up" / "part-00000")) == b"ID1\tPREDS:0.5\nID2\tPREDS:0.25\n"
    gz = str(tmp_path / "sub" / "x.txt.gz")
    with fs_open_write(gz) as f:
        f.write("a\tb\n")
    with gzip.open(gz, "rt") as f:
        assert f.read() == "a\tb\n"
    with pytest.raises(RuntimeError, match="pipe command failed"):
        with fs_open_write(str(tmp_path / "y.txt"), converter="exit 3") as f:
            f.write("z\n")
    with faultinject.inject(faultinject.fail_once("fs.open_write")):
        with pytest.raises(faultinject.InjectedFault):
            fs_open_write(str(tmp_path / "z.txt"))

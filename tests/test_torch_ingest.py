"""The port's ingest tier against the JAX package's: the fs read tier under
the same fault plans, line sampling, the data generator's text, the
``pipe_command`` / ``line_parser`` / ``drop_remainder`` loads, and the
shuffle modes on one node and over a 2-node ``LocalShuffleRouter``.

Exact throughout: the lines each reader yields and the retries it counts,
the generator's bytes, and each node's records in order (keys, offsets,
floats, ins ids, search ids). The remote (``hdfs:``) branch runs against
a stub ``hadoop`` client written into the test's directory, set as
``hadoop_bin`` in both registries.
"""

from __future__ import annotations

import gzip
import io
import os
import stat
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as jconfig
import paddlebox_tpu.data as jdata
import paddlebox_tpu.data.parser as jparser
import paddlebox_tpu.table as jtable
import paddlebox_tpu.table.replica_cache as jrc
import paddlebox_tpu.utils.faultinject as jfault
import paddlebox_tpu.utils.fs as jfs
import paddlebox_tpu.utils.line_reader as jlr
import paddlebox_tpu.utils.monitor as jmon
import paddlebox_tpu_torch.config as tconfig
import paddlebox_tpu_torch.data as tdata
import paddlebox_tpu_torch.data.parser as tparser
import paddlebox_tpu_torch.table as ttable
import paddlebox_tpu_torch.table.replica_cache as trc
import paddlebox_tpu_torch.utils.faultinject as tfault
import paddlebox_tpu_torch.utils.fs as tfs
import paddlebox_tpu_torch.utils.line_reader as tlr
import paddlebox_tpu_torch.utils.monitor as tmon

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(config=jconfig, data=jdata, table=jtable, fault=jfault, fs=jfs, lr=jlr, mon=jmon,
                           parser=jparser, rc=jrc),
    "torch": SimpleNamespace(config=tconfig, data=tdata, table=ttable, fault=tfault, fs=tfs, lr=tlr, mon=tmon,
                             parser=tparser, rc=trc),
}
FLAGS = ("fs_open_backoff_s", "fs_open_retries", "hadoop_bin", "sample_rate", "enable_native_parser", "data_quarantine")
S = 3


@pytest.fixture(autouse=True)
def _flags():
    prev = {(k, n): p.config.get_flag(n) for k, p in PKGS.items() for n in FLAGS}
    set_both(fs_open_backoff_s=0.0)
    yield
    for (k, n), v in prev.items():
        PKGS[k].config.set_flag(n, v)


def set_both(**flags):
    for p in PKGS.values():
        for n, v in flags.items():
            p.config.set_flag(n, v)


def _lines(rng, n, logkey=False, ins_id=False):
    out = []
    for i in range(n):
        parts = []
        if ins_id:
            parts.append(f"1 ins-{int(rng.integers(0, 1 << 30)):x}")
        if logkey:
            sid = int(rng.integers(0, 16))
            parts.append(f"1 {'0' * 11}{i % 7:03x}{i % 3:02x}{sid:016x}")
        parts.append(f"1 {float(rng.integers(0, 2))}")
        for _ in range(S):
            k = int(rng.integers(1, 3))
            parts.append(f"{k} " + " ".join(str(v) for v in rng.integers(1, 500, k)))
        out.append(" ".join(parts))
    return out


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # fixture writer: every caller passes a path under its tmp_path
    with open(path, "w") as f:  # pbox-lint: disable=IO004
        f.write("\n".join(lines) + "\n")
    return path


def _schema(pkg, **kw):
    d = PKGS[pkg].data
    return d.SlotSchema(
        [d.SlotInfo("label", type="float", dense=True, dim=1)] + [d.SlotInfo(f"s{i}") for i in range(S)],
        label_slot="label", **kw,
    )


def _ds(pkg, schema=None, batch_size=4, **kw):
    t = PKGS[pkg].table
    table = t.HostSparseTable(t.ValueLayout(embedx_dim=4), t.SparseOptimizerConfig(), n_shards=2, seed=0)
    return PKGS[pkg].data.BoxPSDataset(schema or _schema(pkg), table, batch_size=batch_size, **kw)


def _recs(ds):
    return [
        (r.u64_values.tolist(), r.u64_offsets.tolist(), r.f_values.tolist(), r.ins_id, int(r.search_id))
        for r in ds.records
    ]


def _hadoop_stub(tmp_path):
    """A ``hadoop`` client over a local directory: ``fs -cat``, ``-test
    -e``, ``-ls``, ``-mkdir -p`` and ``-rm -r`` on ``hdfs:/<path>``."""
    root = tmp_path / "hdfs-root"
    root.mkdir()
    stub = tmp_path / "hadoop"
    stub.write_text(f"""#!{sys.executable}
import glob, os, shutil, sys
root = {str(root)!r}
def local(p):
    return os.path.join(root, p.split(":", 1)[1].lstrip("/"))
args = sys.argv[2:]
op = args[0]
if op == "-cat":
    with open(local(args[1]), "rb") as f:
        sys.stdout.buffer.write(f.read())
elif op == "-test":
    sys.exit(0 if os.path.exists(local(args[2])) else 1)
elif op == "-ls":
    hits = sorted(glob.glob(local(args[1])))
    print(f"Found {{len(hits)}} items")
    for h in hits:
        print("-rw-r--r-- 1 u g 0 2026-01-01 00:00 hdfs:/" + os.path.relpath(h, root))
elif op == "-mkdir":
    os.makedirs(local(args[-1]), exist_ok=True)
elif op == "-rm":
    shutil.rmtree(local(args[-1]))
else:
    sys.exit(2)
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    set_both(hadoop_bin=str(stub))
    return root


# ---- the fs read tier ---------------------------------------------------------


@pytest.mark.parametrize("plan", ["none", "once", "twice", "always"])
def test_read_tier_under_the_same_fault_plans(tmp_path, plan):
    """fs_open_read_retry, fs_read_bytes_retry and a converter pipe under
    the same ``fs.open_read`` plan: the same lines, the same retries
    counted, and the same failure when the plan outlasts the retries."""
    rng = np.random.default_rng(0)
    lines = _lines(rng, 12)
    plain = _write(str(tmp_path / "a.txt"), lines)
    gz = str(tmp_path / "b.txt.gz")
    with gzip.open(gz, "wt") as f:
        f.write("\n".join(lines) + "\n")
    got = {}
    for pkg, p in PKGS.items():
        rules = {
            "none": lambda fl: (),
            "once": lambda fl: (fl.fail_once("fs.open_read"),),
            "twice": lambda fl: (fl.fail_nth("fs.open_read", 1), fl.fail_nth("fs.open_read", 2)),
            "always": lambda fl: (fl.fail_always("fs.open_read"),),
        }[plan](p.fault)
        out = []
        for fn in (
            lambda: list(p.fs.fs_open_read_retry(plain)),
            lambda: list(p.fs.fs_open_read_retry(gz)),
            lambda: list(p.fs.fs_open_read_retry(gz, converter="tr a-z A-Z")),
            lambda: p.fs.fs_read_bytes_retry(plain),
        ):
            before = p.mon.STAT_GET("fs_open_retries_total")
            with p.fault.inject(*rules):
                try:
                    res = fn()
                except OSError as e:
                    res = ("raised", type(e).__name__)
            out.append((res, p.mon.STAT_GET("fs_open_retries_total") - before))
        got[pkg] = out
    assert got["torch"] == got["jax"]
    if plan != "always":
        assert got["torch"][2][0] == [ln.upper() + "\n" for ln in lines]


def test_remote_reads_and_file_manager_through_a_stub_client(tmp_path):
    root = _hadoop_stub(tmp_path)
    rng = np.random.default_rng(1)
    lines = _lines(rng, 6)
    _write(str(root / "day" / "part-0.txt"), lines)
    _write(str(root / "day" / "part-1.txt"), lines[:2])
    got = {}
    for pkg, p in PKGS.items():
        fm = p.fs.FileMgr()
        got[pkg] = (
            list(p.fs.fs_open_read_retry("hdfs:/day/part-0.txt")),
            list(p.fs.fs_open_read("hdfs:/day/part-0.txt", converter="head -n 2")),
            p.fs.fs_glob("hdfs:/day/part-*.txt"),
            fm.exists("hdfs:/day/part-1.txt"),
            fm.exists("hdfs:/day/nope.txt"),
        )
        fm.mkdir(f"hdfs:/made-{pkg}")
        assert os.path.isdir(root / f"made-{pkg}")
        fm.remove(f"hdfs:/made-{pkg}")
        assert not os.path.exists(root / f"made-{pkg}")
        # a missing remote file is retried, then raised as OSError
        set_both(fs_open_retries=2)
        before = p.mon.STAT_GET("fs_open_retries_total")
        with pytest.raises(OSError):
            p.fs.fs_open_read_retry("hdfs:/day/late.txt")
        assert p.mon.STAT_GET("fs_open_retries_total") == before + 1
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == ["hdfs:/day/part-0.txt", "hdfs:/day/part-1.txt"]


def test_pipe_stream_raises_on_a_failed_converter_and_closes_early(tmp_path):
    path = _write(str(tmp_path / "a.txt"), ["x"] * 5000)
    with pytest.raises(RuntimeError, match="pipe command failed"):
        with tfs.fs_open_read(path, converter="cat; exit 3") as f:
            f.read()
    # a reader that stops early kills the pipeline instead of waiting on it
    f = tfs.fs_open_read(path, converter="cat")
    next(iter(f))
    f.close()
    assert f.proc.returncode is not None


def test_file_manager_local_roundtrip(tmp_path):
    fm = tfs.FileMgr()
    src = _write(str(tmp_path / "src" / "a.txt"), ["one", "two"])
    fm.upload(src, str(tmp_path / "dst" / "a.txt"))
    fm.download(str(tmp_path / "dst" / "a.txt"), str(tmp_path / "back.txt"))
    assert open(tmp_path / "back.txt").read() == "one\ntwo\n"
    fm.touch(str(tmp_path / "dst" / "t"))
    assert fm.ls(str(tmp_path / "dst")) == jfs.FileMgr().ls(str(tmp_path / "dst"))
    fm.remove(str(tmp_path / "dst"))
    assert not fm.exists(str(tmp_path / "dst"))


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.1])
def test_buffered_line_reader_keeps_the_same_lines(tmp_path, rate):
    lines = [f"line-{i}" for i in range(400)]
    path = _write(str(tmp_path / "a.txt"), lines)
    set_both(sample_rate=rate)
    got = {}
    for pkg, p in PKGS.items():
        r = p.lr.BufferedLineFileReader(path, seed=1234)
        got[pkg] = (list(r), r.lines_read, r.lines_kept)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 400 and (rate < 1.0) == (got["torch"][2] < 400)


# ---- the data generator ---------------------------------------------------------


def _gen_module(pkg):
    return PKGS[pkg].data


class _Gen:
    """A MultiSlotDataGenerator over csv lines, for either package."""

    @staticmethod
    def make(pkg):
        base = _gen_module(pkg).MultiSlotDataGenerator

        class G(base):
            def generate_sample(self, line):
                def it():
                    if line is None:
                        for i in range(5):
                            yield [("label", [np.float32(i % 2)]), ("w", [0.1 * i, np.float64(1 / 3)]), ("s0", [i + 1])]
                        return
                    toks = line.strip().split(",")
                    yield [("label", [float(toks[0])])] + [(f"s{i}", [int(t)]) for i, t in enumerate(toks[1:])]

                return it

        return G()


def test_data_generator_text_is_byte_identical():
    raw = "1.0,7,8,9\n0.0,11,12,13\n0.5,1,2,3\n"
    got = {}
    for pkg in PKGS:
        g = _Gen.make(pkg)
        g.set_batch(2)
        out = io.StringIO()
        n = g.run_from_stdin(stdin=io.StringIO(raw), stdout=out)
        mem = io.StringIO()
        _Gen.make(pkg).run_from_memory(stdout=mem)
        got[pkg] = (n, out.getvalue(), mem.getvalue())
    assert got["torch"] == got["jax"]
    assert got["torch"][1].splitlines()[0] == "1 1.0 1 7 1 8 1 9"
    tg, jg = tdata.MultiSlotDataGenerator(), jdata.MultiSlotDataGenerator()
    sample = [("label", [np.float32(0.5)]), ("w", [0.12345678, np.float32(1e-7)]), ("k", [np.uint64(2**63 + 5)])]
    assert tg._gen_str(sample) == jg._gen_str(sample)
    for bad in ([("a", [])],):
        for g in (tdata.MultiSlotDataGenerator(), jdata.MultiSlotDataGenerator()):
            with pytest.raises(ValueError, match="no values"):
                g._gen_str(bad)
    good = tdata.MultiSlotDataGenerator()
    good._gen_str([("a", [1]), ("b", [2])])
    for bad, msg in (([("a", [1])], "slots"), ([("b", [1]), ("a", [2])], "order"), ([("a", [1.5]), ("b", [2])], "float")):
        with pytest.raises(ValueError, match=msg):
            good._gen_str(bad)
    for g in (tdata.DataGenerator(), jdata.DataGenerator()):
        with pytest.raises(NotImplementedError, match="generate_sample"):
            g.generate_sample("x")
        with pytest.raises(NotImplementedError):
            g._gen_str([("a", [1])])


def _gen_script(tmp_path, pkg):
    """A pipe_command script: csv on stdin -> the slot protocol."""
    mod = "paddlebox_tpu_torch.data" if pkg == "torch" else "paddlebox_tpu.data"
    path = tmp_path / f"gen_{pkg}.py"
    path.write_text(f"""import sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from {mod} import MultiSlotDataGenerator

class G(MultiSlotDataGenerator):
    def generate_sample(self, line):
        def it():
            toks = line.strip().split(",")
            yield [("label", [float(toks[0])])] + [("s%d" % i, [int(t) for t in toks[1 + i].split(":")]) for i in range({S})]
        return it

G().run_from_stdin()
""")
    return f"{sys.executable} {path}"


@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_pipe_command_load_matches_jax_and_the_plain_load(tmp_path, native):
    """csv part files through each package's generator script as the
    ``pipe_command``: the same records in both packages, and the same as
    the slot-protocol text loaded without a pipe."""
    set_both(enable_native_parser=native)
    rng = np.random.default_rng(2)
    csv, text = [], []
    for _ in range(40):
        ks = [rng.integers(1, 300, int(rng.integers(1, 3))) for _ in range(S)]
        lab = float(rng.integers(0, 2))
        csv.append(f"{lab}," + ",".join(":".join(str(v) for v in k) for k in ks))
        text.append(f"1 {lab} " + " ".join(f"{len(k)} " + " ".join(str(v) for v in k) for k in ks))
    files = [_write(str(tmp_path / f"c{i}.csv"), csv[i * 20 : (i + 1) * 20]) for i in range(2)]
    plain = [_write(str(tmp_path / f"t{i}.txt"), text[i * 20 : (i + 1) * 20]) for i in range(2)]
    got = {}
    for pkg in PKGS:
        ds = _ds(pkg, pipe_command=_gen_script(tmp_path, pkg), read_threads=2, shuffle_mode="local", seed=3)
        ds.set_date("20260101")
        ds.set_filelist(files)
        ds.load_into_memory()
        assert ds.store is None  # a pipe takes the Python tier
        ref = _ds(pkg, read_threads=2, shuffle_mode="local", seed=3)
        ref.set_date("20260101")
        ref.set_filelist(plain)
        ref.load_into_memory()
        assert _recs(ds) == _recs(ref)
        got[pkg] = (_recs(ds), ds.stats.lines, ds.stats.parsed)
    assert got["torch"] == got["jax"]


def test_replica_cache_line_parser_and_drop_remainder(tmp_path):
    """``line_parser=ReplicaCacheLineParser`` (with ``begin_file`` a file)
    and ``drop_remainder=False``: the same records, cache rows and batch
    count as the JAX package's; a file without a leading '#' line is
    quarantined in both."""
    lines_a = ["# 1.5 2.5", "1 1.0 1 7 1 11 1 21 1 5", "1 0.0 1 7 1 12 1 22 1 6", "# 3.5 4.5", "1 1.0 1 7 1 13 1 23 1 7"]
    a = _write(str(tmp_path / "a.txt"), lines_a)
    b = _write(str(tmp_path / "b.txt"), ["1 1.0 1 7 1 12 1 3 1 4"])
    got = {}
    for pkg, p in PKGS.items():
        d = p.data
        schema = d.SlotSchema(
            [d.SlotInfo("label", type="float", dense=True, dim=1), d.SlotInfo("cache_idx")]
            + [d.SlotInfo(f"s{i}") for i in range(S - 1)] + [d.SlotInfo("s9")],
            label_slot="label",
        )
        cache = p.rc.ReplicaCache(dim=2)
        ds = _ds(pkg, schema=schema, batch_size=2, read_threads=1,
                 line_parser=p.parser.ReplicaCacheLineParser(cache, "cache_idx"), drop_remainder=False)
        ds.set_date("20260101")
        ds.set_filelist([a, b])
        ds.load_into_memory()
        got[pkg] = (_recs(ds), cache.host_array().tolist(), ds.num_batches(), ds.stats.bad_lines, ds.stats.skipped_benign)
    assert got["torch"] == got["jax"]
    recs, rows, nb, bad, benign = got["torch"]
    assert [r[0][0] for r in recs] == [0, 0, 1] and rows == [[1.5, 2.5], [3.5, 4.5]]
    assert nb == 2 and bad == 1 and benign == 2


@pytest.mark.parametrize("mode", ["local", "search_id", "ins_id", "random"])
@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_shuffle_modes_on_one_node(tmp_path, mode, native):
    set_both(enable_native_parser=native)
    rng = np.random.default_rng(4)
    files = [_write(str(tmp_path / f"p{i}.txt"), _lines(rng, 30, logkey=True)) for i in range(3)]
    got = {}
    for pkg in PKGS:
        ds = _ds(pkg, schema=_schema(pkg, parse_logkey=True), shuffle_mode=mode, seed=11)
        ds.set_date("20260101")
        ds.set_filelist(files)
        ds.load_into_memory()
        got[pkg] = _recs(ds)
    assert got["torch"] == got["jax"] and len(got["torch"]) == 90


@pytest.mark.parametrize("mode", ["search_id", "ins_id", "random"])
@pytest.mark.parametrize("native", [0, 1], ids=["python", "native"])
def test_global_shuffle_over_a_two_node_router(tmp_path, mode, native):
    """Two in-process nodes, each reading its rank-strided files and
    exchanging records through a LocalShuffleRouter: each node's records,
    in order, are the JAX package's node's."""
    set_both(enable_native_parser=native)
    rng = np.random.default_rng(5)
    files = [_write(str(tmp_path / f"p{i}.txt"), _lines(rng, 25, logkey=True)) for i in range(4)]
    got = {}
    for pkg in PKGS:
        router = PKGS[pkg].data.LocalShuffleRouter(2)
        nodes = [
            _ds(pkg, schema=_schema(pkg, parse_logkey=True), rank=r, nranks=2, shuffle_mode=mode,
                router=router, seed=7)
            for r in range(2)
        ]
        for d in nodes:
            d.set_date("20260101")
            d.set_filelist(files)
        # node 0 exchanges before node 1 starts: the JAX package's router
        # keeps arrival order, so its nodes' record order follows the race
        ts = [threading.Thread(target=d.load_into_memory) for d in nodes]
        ts[0].start()
        while router._done < 1:
            time.sleep(0.001)
        ts[1].start()
        [t.join() for t in ts]
        got[pkg] = [_recs(d) for d in nodes]
    assert got["torch"] == got["jax"]
    assert sum(len(n) for n in got["torch"]) == 100 and all(got["torch"])
    if mode == "search_id":
        for r, node in enumerate(got["torch"]):
            assert all(rec[4] % 2 == r for rec in node)


def test_router_order_does_not_follow_the_thread_race(tmp_path):
    """The port's nodes get the same records in the same order whichever
    node exchanges first."""
    rng = np.random.default_rng(6)
    files = [_write(str(tmp_path / f"p{i}.txt"), _lines(rng, 20, logkey=True)) for i in range(4)]
    runs = []
    for first in (0, 1):
        router = tdata.LocalShuffleRouter(2)
        nodes = [
            _ds("torch", schema=_schema("torch", parse_logkey=True), rank=r, nranks=2, shuffle_mode="search_id",
                router=router, seed=7)
            for r in range(2)
        ]
        for d in nodes:
            d.set_filelist(files)
        ts = [threading.Thread(target=d.load_into_memory) for d in nodes]
        ts[first].start()
        while router._done < 1:
            time.sleep(0.001)
        ts[1 - first].start()
        [t.join() for t in ts]
        runs.append([_recs(d) for d in nodes])
    assert runs[0] == runs[1]


def test_shuffle_route_matches_jax():
    recs = [
        tdata.SlotRecord(
            u64_values=np.array([1], np.uint64), u64_offsets=np.array([0, 1], np.uint32),
            f_values=np.zeros(0, np.float32), f_offsets=np.array([0], np.uint32), ins_id=f"ins{i}", search_id=i,
        )
        for i in range(40)
    ]
    from paddlebox_tpu.data.dataset import shuffle_route as jroute
    from paddlebox_tpu_torch.data.dataset import shuffle_route as troute

    for mode in ("search_id", "ins_id", "random"):
        assert [int(x) for x in troute(recs, 4, mode, 5)] == [int(x) for x in jroute(recs, 4, mode, 5)]
    with pytest.raises(ValueError):
        troute(recs, 4, "bogus", 0)
